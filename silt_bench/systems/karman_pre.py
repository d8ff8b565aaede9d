"""The PRE set generator (`karman-pre-gen`, the Makefile's
`karman-fdt-pre-set`): its frozen settled starts, the program's PRE
rollout through its frame unit, and the reference's side of the check.

The program is driven through the frame unit `apps/karman_pre_gen.py`
`PreFrame` alone, built as `karman-pre-gen` builds it (-r 32, scale 4,
gather advection, max shift 4, the FD option; beta 1.0), one frame after
another from a settled start with the pressure histories cold. The
scene and thumbnail writes are left out. Its modules are imported inside
the functions, so that importing this file loads nothing of it.

The starts are frames 1000 and 1250 of the six training Re (the
`karman_gen` configuration's frozen frames) with the lo-res state their
4x downsample and a zero correction, each advanced through the program's
frame unit until the correction solve's counts settle (`python3 -m
silt_bench.pre_start`), and frozen in `data/karman_pre_start.<field>.xz`
as systems/karman_gen.py freezes its frames; shapes, sha256 and
provenance in `data/karman_pre_start.json`.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator

import numpy as np
import torch

from silt_bench.inputs import DATA, cycled
from silt_bench.reference.pre import KarmanPre
from silt_bench.systems.karman_gen import decode

START = "karman_pre_start"
HI = ("dens_hi", "u_hi", "v_hi")
LO = ("dens", "u", "v")
FIELDS = HI + LO + ("corr_u", "corr_v")


def start_frames() -> Dict[str, np.ndarray]:
    """The frozen starts: each field (S, ...) with a batch axis of 1, "re"
    (S,), "frames" (S,), the frame number each start was taken at."""
    meta = json.loads((DATA / f"{START}.json").read_text())
    out = {"re": np.asarray(meta["re"], np.float32), "frames": np.asarray(meta["frames"])}
    for name in FIELDS:
        spec = meta["fields"][name]
        out[name] = decode((DATA / f"{START}.{name}.xz").read_bytes(), spec["shape"],
                           spec["sha256"])
    return out


def make_inputs(config: dict, kind: str, seed: int, device) -> dict:
    """The frozen starts on `device` (the same for every seed; the seed
    picks each rollout's start); no weights."""
    frames = start_frames()
    if not set(float(r) for r in frames["re"]) <= set(float(r) for r in config["re"]):
        raise ValueError("the frozen starts are not of the configuration's Re")
    data = {k: torch.from_numpy(np.ascontiguousarray(frames[k])).to(device) for k in FIELDS}
    return {"data": data, "re": [float(r) for r in frames["re"]], "weights": {}}


def jobs(config: dict, workload: dict, inp: dict, seed: int) -> Iterator[dict]:
    """Rollouts at batch 1, each from one of the frozen starts (and so of
    one of the six Re), every start once in each seeded order of them: the
    starts' costs differ by up to 1.4x, so that a window's mix of them
    varies less from seed to seed than independent draws would."""
    data = inp["data"]
    for s in cycled(len(inp["re"]), seed):
        yield dict({k: data[k][s] for k in FIELDS}, re=inp["re"][s], start=s)


class Program:
    """The port's PRE frame unit, built as `karman-pre-gen` builds it."""

    def __init__(self, config: dict, inp: dict, device):
        from solver_in_the_loop_torch.apps.karman_pre_gen import PreFrame

        self.pre = PreFrame(config["res"], config["len"], config["scale"], config["beta"],
                            config["advect"], config["max_shift"],
                            config["pressure"]["precon"], device)
        flow = self.pre.flow_hi
        if (flow.pressure_tol, flow.pressure_max_iter) != (config["pressure"]["tol"],
                                                            config["pressure"]["max_iter"]):
            raise ValueError("the configuration's pressure solve is not the generator's")

    @torch.no_grad()
    def rollout(self, job: dict, steps: int) -> Dict[str, torch.Tensor]:
        """Frames 1..steps from the job's start: each field (T, 1, ...),
        the correction solve's counts "lsq_outer", "lsq_inner" (T,)."""
        from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid

        pre = self.pre
        state = pre.start(CenteredGrid(job["dens_hi"], pre.dom_hi),
                          StaggeredGrid(job["u_hi"], job["v_hi"], pre.dom_hi),
                          CenteredGrid(job["dens"], pre.dom_lo),
                          StaggeredGrid(job["u"], job["v"], pre.dom_lo), job["corr_u"],
                          job["corr_v"], job["re"])
        out = {k: [] for k in FIELDS + ("lsq_outer", "lsq_inner")}
        for _ in range(steps):
            state, _, its = pre(state)
            for key, value in zip(out, (state.d_hi.values, state.v_hi.u, state.v_hi.v,
                                        state.d_co.values, state.v_co.u, state.v_co.v,
                                        state.corr_u, state.corr_v, its["outer"], its["inner"])):
                out[key].append(value)
        return {k: torch.stack(v) for k, v in out.items()}


def reference(config: dict, inp: dict, device, tf32: bool = False) -> KarmanPre:
    return KarmanPre(config["res"], config["len"], config["scale"], config["beta"],
                     config["pressure"]["max_iter"], device, tf32)


def _re(job: dict, n: int, device) -> torch.Tensor:
    return torch.full((n,), job["re"], dtype=torch.float32, device=device)


def reference_rollout(ref: KarmanPre, params, job: dict, steps: int):
    return ref.rollout({k: job[k] for k in FIELDS}, _re(job, 1, job["u"].device), steps)


@torch.no_grad()
def judge_rollout(ref: KarmanPre, params, job: dict, frames: Dict[str, torch.Tensor]) -> dict:
    """Every frame of a rollout recomputed by the reference from the frame
    before it (the first from the job's start), all frames as one batch:
    `frame_gap`, the widest gap of the hi-res and the corrected lo-res
    fields, each over the reference's largest value of that field;
    `corr_gap`, the corrections', likewise."""
    steps = frames["u"].shape[0]
    before = {k: torch.cat([job[k][None], frames[k][:-1]]).reshape((steps,) + job[k].shape[1:])
              for k in FIELDS}
    ref_frames = ref.frame(before, _re(job, steps, job["u"].device))
    gaps = {k: float((frames[k].reshape(r.shape) - r).abs().max() / r.abs().max().clamp_min(1e-30))
            for k, r in ref_frames.items()}
    return {"frame_gap": max(gaps[k] for k in HI + LO),
            "corr_gap": max(gaps["corr_u"], gaps["corr_v"])}


def rollout_failed(frames: Dict[str, torch.Tensor], config: dict) -> torch.Tensor:
    """A field not finite, or a correction solve stopped at its iteration
    limit: a flag on the device, read without a synchronise."""
    bad = ~torch.stack([torch.isfinite(frames[k]).all() for k in FIELDS]).all()
    at_limit = frames["lsq_outer"].max().to(bad.device) >= config["lsq"]["max_iter"]
    return bad | at_limit
