"""Freeze the start frames of the `karman_gen` configuration: run the
program's own `karman-gen` for the Makefile's hi-res set on the card (six
Re batched at 256x128, 1,250 steps, the first 999 not kept), take frames
1000 and 1250 of each Re and write them to silt_bench/data/ as
systems/karman_gen.py reads them, with a JSON of their provenance:

    python3 -m silt_bench.gen_start --commit COMMIT [--out DIR]

`--commit` names the commit whose program made the frames (the card's
copy of the repository is no git checkout); `--out` writes the files to
another directory than silt_bench/data/. The benchmark's runs never
run this. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from silt_bench.inputs import DATA
from silt_bench.systems.karman_gen import FIELDS, START, encode

CONFIG = json.loads((Path(__file__).resolve().parent / "configs" / "karman_gen.json").read_text())
FRAMES = (1000, 1250)
SKIP = CONFIG["skipsteps"]


def command(out_dir: str) -> list:
    """`karman-gen`'s arguments for the configuration's set, up to the last frame."""
    return ["karman-gen", "-o", out_dir, "-r", str(CONFIG["res"]), "-l", f"{CONFIG['len']:g}",
            "--seed", "0", "--re", *map(str, CONFIG["re"]), "-t", str(FRAMES[-1] + 1),
            "-s", str(SKIP)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m silt_bench.gen_start")
    p.add_argument("--commit", required=True)
    p.add_argument("--out", type=Path, default=DATA)
    args = p.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    import torch

    if not torch.cuda.is_available():
        print("silt_bench.gen_start: needs a CUDA card", file=sys.stderr)
        return 2
    from solver_in_the_loop_torch.apps import karman_gen

    with tempfile.TemporaryDirectory() as out_dir:
        cmd = command(out_dir)
        frames = karman_gen.main(cmd[1:])
    kept = [f - SKIP - 1 for f in FRAMES]
    fields = {}
    for name in FIELDS:
        field = frames[name][kept].transpose(0, 1).contiguous().cpu().numpy()  # (S, F, ...)
        (args.out / f"{START}.{name}.xz").write_bytes(encode(field))
        fields[name] = {"shape": list(field.shape),
                        "sha256": hashlib.sha256(field.tobytes()).hexdigest()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    iters = frames["cg_iters"].cpu().numpy()
    meta = {"source": "frames 1000 and 1250 of the Makefile's karman-fdt-hires-set "
                      "(6 Re batched, 256x128), made by the program's karman-gen",
            "command": "python -m solver_in_the_loop_torch " + " ".join(command("OUT")),
            "commit": args.commit, "card": card, "torch": torch.__version__,
            "route": frames["route"], "re": [float(r) for r in CONFIG["re"]],
            "frames": list(FRAMES),
            "iterations": {str(f): int(iters[k]) for f, k in zip(FRAMES, kept)},
            "iterations_note": "the batch's solve at the step that made the frame; the six Re "
                               "stop together, so each Re's count is the batch's",
            "iterations_kept_steps": {"median": float(np.median(iters)), "max": int(iters.max())},
            "rollout_seconds": frames["rollout_seconds"], "fields": fields}
    (args.out / f"{START}.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(json.dumps({k: v for k, v in meta.items() if k != "fields"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
