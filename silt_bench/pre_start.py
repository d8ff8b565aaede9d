"""Freeze the settled starts of the `karman_pre` configuration: for each of
the six Re and each of frames 1000 and 1250 of the `karman_gen`
configuration's frozen hi-res frames, take the hi-res state, its 4x
downsample as the lo-res state and a zero correction, advance them through
the program's PRE frame unit (`apps/karman_pre_gen.py` `PreFrame`, built as
`karman-pre-gen -r 32 -l 100 --beta 1.0` builds it, the pressure histories
cold) until the correction solve's outer and inner counts of the last
`WINDOW` frames each lie within `SPREAD` of their mean, at most `MAX_FRAMES`
frames, and write the states to silt_bench/data/ as systems/karman_pre.py
reads them, with a JSON of their provenance and settle counts:

    python3 -m silt_bench.pre_start --commit COMMIT [--out DIR]

`--commit` names the commit whose program made the states (the card's
copy of the repository is no git checkout); `--out` writes the files to
another directory than silt_bench/data/. The benchmark's runs never run
this. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from silt_bench.inputs import DATA
from silt_bench.systems import karman_gen
from silt_bench.systems.karman_gen import encode
from silt_bench.systems.karman_pre import FIELDS, START

CONFIG = json.loads((Path(__file__).resolve().parent / "configs" / "karman_pre.json").read_text())
WINDOW, SPREAD, MAX_FRAMES = 10, 0.1, 100


def settled(counts) -> bool:
    """Whether the last WINDOW counts lie within SPREAD of their mean."""
    if len(counts) < WINDOW:
        return False
    last = np.asarray(counts[-WINDOW:], np.float64)
    return bool(np.abs(last - last.mean()).max() <= SPREAD * last.mean())


def settle(pre, hi: dict, re: float, device):
    """A start from the hi-res state `hi` (dens, u, v; (1, ...) each),
    advanced until it settles: (the state, frames run, outer and inner
    counts per frame)."""
    import torch

    from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
    from solver_in_the_loop_torch.core.resample import downsample_centered, downsample_staggered

    t = {k: torch.from_numpy(np.ascontiguousarray(hi[k])).to(device) for k in ("dens", "u", "v")}
    s = pre.scale
    state = pre.start(CenteredGrid(t["dens"], pre.dom_hi),
                      StaggeredGrid(t["u"], t["v"], pre.dom_hi),
                      CenteredGrid(downsample_centered(t["dens"], s), pre.dom_lo),
                      StaggeredGrid(*downsample_staggered(t["u"], t["v"], s), pre.dom_lo),
                      torch.zeros(pre.dom_lo.u_shape(1), device=device),
                      torch.zeros(pre.dom_lo.v_shape(1), device=device), re)
    outer, inner = [], []
    with torch.no_grad():
        while len(outer) < MAX_FRAMES and not (settled(outer) and settled(inner)):
            state, _, its = pre(state)
            outer.append(int(its["outer"]))
            inner.append(int(its["inner"]))
    return state, len(outer), outer, inner


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m silt_bench.pre_start")
    p.add_argument("--commit", required=True)
    p.add_argument("--out", type=Path, default=DATA)
    args = p.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    import torch

    if not torch.cuda.is_available():
        print("silt_bench.pre_start: needs a CUDA card", file=sys.stderr)
        return 2
    from solver_in_the_loop_torch.apps.karman_pre_gen import PreFrame

    device = torch.device("cuda", 0)
    cfg = CONFIG
    pre = PreFrame(cfg["res"], cfg["len"], cfg["scale"], cfg["beta"], cfg["advect"],
                   cfg["max_shift"], cfg["pressure"]["precon"], device)
    gen = karman_gen.start_frames()
    if [float(r) for r in gen["re"]] != [float(r) for r in cfg["re"]]:
        raise ValueError("the karman_gen frames are not of the configuration's Re")
    out = {k: [] for k in FIELDS}
    starts = []
    t0 = time.perf_counter()
    for i, re in enumerate(cfg["re"]):
        for f, frame in enumerate(gen["frames"]):
            hi = {k: gen[k][i, f][None] for k in ("dens", "u", "v")}
            state, n, outer, inner = settle(pre, hi, float(re), device)
            for key, value in zip(FIELDS, (state.d_hi.values, state.v_hi.u, state.v_hi.v,
                                           state.d_co.values, state.v_co.u, state.v_co.v,
                                           state.corr_u, state.corr_v)):
                out[key].append(value.cpu().numpy())
            starts.append({"re": float(re), "frame": int(frame), "frames_run": n,
                           "settled": settled(outer) and settled(inner),
                           "outer_last": outer[-WINDOW:], "inner_last": inner[-WINDOW:],
                           "outer_first": outer[:WINDOW], "inner_first": inner[:WINDOW]})
            print(json.dumps(starts[-1]), flush=True)
    seconds = time.perf_counter() - t0
    fields = {}
    for name in FIELDS:
        field = np.ascontiguousarray(np.stack(out[name]), dtype=np.float32)  # (S, 1, ...)
        (args.out / f"{START}.{name}.xz").write_bytes(encode(field))
        fields[name] = {"shape": list(field.shape),
                        "sha256": hashlib.sha256(field.tobytes()).hexdigest()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    meta = {"source": "frames 1000 and 1250 of the Makefile's karman-fdt-hires-set "
                      "(data/karman_gen_start.*) with the lo-res state their 4x downsample and "
                      "a zero correction, settled through the program's PRE frame unit",
            "command": "python3 -m silt_bench.pre_start",
            "frame_unit": "PreFrame as karman-pre-gen -r 32 -l 100 --beta 1.0 builds it",
            "settle_rule": f"the outer and inner counts of the last {WINDOW} frames each within "
                           f"{SPREAD:g} of their mean, at most {MAX_FRAMES} frames",
            "commit": args.commit, "card": card, "torch": torch.__version__,
            "routes": {"hi": pre.flow_hi.pressure_route(1), "lo": pre.flow_lo.pressure_route(1)},
            "re": [s["re"] for s in starts], "frames": [s["frame"] for s in starts],
            "starts": starts, "seconds": seconds, "fields": fields}
    (args.out / f"{START}.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(json.dumps({k: v for k, v in meta.items() if k not in ("fields", "starts")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
