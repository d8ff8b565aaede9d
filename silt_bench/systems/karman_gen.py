"""The karman generator (`karman-gen`, the Makefile's hi-res set): its
frozen start frames, the program's uncorrected rollout, and the
reference's side of the check.

The program is driven through the calls `apps/karman_gen.py` `run` makes:
a `KarmanFlow` with the gather advection and the FD option (at (6, 256,
128) `pressure_route` takes multigrid), then `karman_rollout` with no
model. The scene and thumbnail writes are left out. Its modules are
imported inside the functions, so that importing this file loads nothing
of it.

The start frames are frames 1000 and 1250 of the six training Re, made
on the card by the program's own `karman-gen` (`python3 -m
silt_bench.gen_start`): each field's float32 bit patterns split into byte
planes and xz-compressed in `data/karman_gen_start.<field>.xz`, shapes,
sha256 and provenance in `data/karman_gen_start.json`.
"""

from __future__ import annotations

import hashlib
import json
import lzma
from typing import Dict, Iterator

import numpy as np
import torch

from silt_bench.inputs import DATA, sub_seeds
from silt_bench.reference.gen import KarmanGen

START = "karman_gen_start"
FIELDS = ("dens", "u", "v")


def encode(field: np.ndarray) -> bytes:
    """A float32 field as the xz-compressed byte planes of its bit patterns."""
    bits = np.ascontiguousarray(field, dtype="<f4").view(np.uint8).reshape(-1, 4)
    return lzma.compress(np.ascontiguousarray(bits.T).tobytes(), preset=9 | lzma.PRESET_EXTREME)


def decode(blob: bytes, shape, sha256: str) -> np.ndarray:
    """`encode`'s inverse, checked against the field's sha256."""
    planes = np.frombuffer(lzma.decompress(blob), np.uint8).reshape(4, -1)
    field = np.ascontiguousarray(planes.T).view("<f4").reshape(shape)
    if hashlib.sha256(field.tobytes()).hexdigest() != sha256:
        raise ValueError("the frozen start frames do not decode to the fields they froze")
    return field


def start_frames() -> Dict[str, np.ndarray]:
    """The frozen start frames: dens (S, F, Y, X), u, v (S Re, F frames),
    and "re" (S,), "frames" (F,), the frame numbers."""
    meta = json.loads((DATA / f"{START}.json").read_text())
    out = {"re": np.asarray(meta["re"], np.float32), "frames": np.asarray(meta["frames"])}
    for name in FIELDS:
        spec = meta["fields"][name]
        out[name] = decode((DATA / f"{START}.{name}.xz").read_bytes(), spec["shape"],
                           spec["sha256"])
    return out


def make_inputs(config: dict, kind: str, seed: int, device) -> dict:
    """The frozen start frames on `device` as (F, S, ...) (the same for every
    seed; the seed picks the frame of each rollout); no weights."""
    frames = start_frames()
    if list(frames["re"]) != [float(r) for r in config["re"]]:
        raise ValueError("the frozen start frames are not of the configuration's Re")
    data = {k: torch.from_numpy(np.ascontiguousarray(frames[k].swapaxes(0, 1))).to(device)
            for k in FIELDS}
    return {"data": data, "re": torch.tensor(frames["re"], device=device), "weights": {}}


def jobs(config: dict, workload: dict, inp: dict, seed: int) -> Iterator[dict]:
    """Rollouts of the six Re at once, as the Makefile batches them, each
    from one of the frozen frames drawn from the seed."""
    data = inp["data"]
    rng = np.random.default_rng(sub_seeds(seed, 2)[1])
    n_frames = data["u"].shape[0]
    while True:
        f = int(rng.integers(n_frames))
        yield {"d": data["dens"][f], "u": data["u"][f], "v": data["v"][f], "re": inp["re"],
               "frame": f}


class Program:
    """The port's flow, built as `karman-gen` builds it."""

    def __init__(self, config: dict, inp: dict, device):
        from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain

        p = config["pressure"]
        self.domain = karman_domain(config["res"], config["len"])
        self.flow = KarmanFlow(self.domain, advection=config["advect"],
                               max_shift=config["max_shift"], pressure_tol=p["tol"],
                               pressure_max_iter=p["max_iter"], pressure_precon=p["precon"],
                               device=device)

    def rollout(self, job: dict, steps: int) -> Dict[str, torch.Tensor]:
        from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
        from solver_in_the_loop_torch.train.rollout import karman_rollout

        return karman_rollout(self.flow, CenteredGrid(job["d"], self.domain),
                              StaggeredGrid(job["u"], job["v"], self.domain), job["re"],
                              steps=steps)


def reference(config: dict, inp: dict, device, tf32: bool = False) -> KarmanGen:
    return KarmanGen(config["res"], config["len"], config["pressure"]["max_iter"], device, tf32)


def reference_rollout(ref: KarmanGen, params, job: dict, steps: int):
    return ref.rollout(job["d"], job["u"], job["v"], job["re"], steps)


@torch.no_grad()
def judge_rollout(ref: KarmanGen, params, job: dict, frames: Dict[str, torch.Tensor]) -> dict:
    """Every step of a rollout recomputed by the reference from the frame
    before it (the first from the job's start), all steps as one batch:
    the widest gap of the frames (density, u, v), each over the
    reference's largest value of that field."""
    steps, batch = frames["u"].shape[:2]

    def before(key, start):
        return torch.cat([start[None], frames[key][:-1]]).reshape((steps * batch,)
                                                                  + start.shape[1:])

    d, u, v = before("dens", job["d"]), before("u", job["u"]), before("v", job["v"])
    d, u, v, _, _ = ref.step(d, u, v, job["re"].repeat(steps))
    gaps = [float((frames[k].reshape(r.shape) - r).abs().max() / r.abs().max().clamp_min(1e-30))
            for k, r in (("dens", d), ("u", u), ("v", v))]
    return {"frame_gap": max(gaps)}


def rollout_failed(frames: Dict[str, torch.Tensor], config: dict) -> torch.Tensor:
    """A frame not finite, or a solve stopped at its iteration limit: a
    flag on the device, read without a synchronise."""
    bad = ~torch.stack([torch.isfinite(frames[k]).all() for k in FIELDS]).all()
    at_limit = frames["cg_iters"].max().to(bad.device) >= config["pressure"]["max_iter"]
    return bad | at_limit
