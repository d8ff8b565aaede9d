"""Back-to-back rollouts: the program's rollout of the cell's length, one
after another from starts drawn from the seed, the window ending on a
synchronise.

The window keeps the frames of `checked_rollouts` of its rollouts, a
sample drawn from the seed as they come (a reservoir), and drops every
other rollout's; once the window has closed the reference judges the
sample: each step recomputed from the program's frame before it.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from silt_bench.inputs import sub_seeds


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def setup(system, config, workload, seed, device, fault=None) -> dict:
    t0 = time.perf_counter()
    inp = system.make_inputs(config, "apply", seed, device)
    t1 = time.perf_counter()
    program = system.Program(config, inp, device)
    spans = {"inputs_s": t1 - t0, "program_s": time.perf_counter() - t1}
    state = {"system": system, "config": config, "workload": workload, "device": device,
             "inputs": inp, "program": program, "jobs": system.jobs(config, workload, inp, seed),
             "seed": seed, "fault": fault, "checked": [], "spans": spans}
    t0 = time.perf_counter()
    program.rollout(next(state["jobs"]), workload["warmup_steps"])
    _sync(device)
    state["spans"]["warmup_s"] = time.perf_counter() - t0
    return state


def _rollout(state):
    job = next(state["jobs"])
    with torch.profiler.record_function("silt_bench.rollout"):
        frames = state["program"].rollout(job, state["workload"]["steps"])
    if state["fault"] is not None:
        frames = state["fault"](frames)
    return job, frames


def window(state, seconds: float) -> dict:
    """Rollouts until `seconds` have passed, and at least `checked_rollouts`;
    the window ends on a synchronise. Each rollout's failure is flagged on
    the device and read once the window has closed."""
    device, steps = state["device"], state["workload"]["steps"]
    n_checked = state["workload"]["checked_rollouts"]
    rng = np.random.default_rng(sub_seeds(state["seed"], 3)[2])
    flags, times = [], []
    _sync(device)
    t0 = last = time.perf_counter()
    while len(flags) < n_checked or last - t0 < seconds:
        job, frames = _rollout(state)
        flags.append(state["system"].rollout_failed(frames, state["config"]))
        if len(state["checked"]) < n_checked:
            state["checked"].append((job, frames))
        else:
            slot = int(rng.integers(len(flags)))
            if slot < n_checked:
                state["checked"][slot] = (job, frames)
        now = time.perf_counter()
        times.append(now - last)
        last = now
    _sync(device)
    wall = time.perf_counter() - t0
    return {"kind": "apply", "units": len(flags) * steps, "wall_s": wall,
            "attempted": len(flags), "failed": int(torch.stack(flags).sum()),
            "rollout_s": times}


def profile(state) -> dict:
    """The traced stretch: `profile_rollouts` more rollouts; the solves'
    iteration counts they report, where they report them."""
    n = state["workload"]["profile_rollouts"]
    runs = [_rollout(state)[1] for _ in range(n)]
    _sync(state["device"])
    out = {"units": n * state["workload"]["steps"]}
    if "cg_iters" in runs[0]:
        out["cg_iters"] = [int(k) for f in runs for k in f["cg_iters"].cpu()]
    return out


def free(state) -> None:
    state.pop("program", None)


def _judge(state, device, runs) -> dict:
    sys_ = state["system"]
    sol = sys_.reference(state["config"], state["inputs"], device)
    params = {k: t.to(device) for k, t in state["inputs"]["weights"].items()}
    out = {}
    for job, frames in runs:
        for name, value in sys_.judge_rollout(sol, params, job, frames).items():
            out[name] = max(out.get(name, 0.0), value if math.isfinite(value) else math.inf)
    return out


def check(state, device) -> dict:
    return _judge(state, device, state["checked"])


def control(state, device) -> dict:
    """The reference in TF32 operands put in the program's place on the
    sampled rollouts' starts, judged by the float32 reference."""
    sys_, steps = state["system"], state["workload"]["steps"]
    sol = sys_.reference(state["config"], state["inputs"], device, tf32=True)
    params = {k: t.to(device) for k, t in state["inputs"]["weights"].items()}
    runs = [(job, sys_.reference_rollout(sol, params, job, steps)) for job, _ in state["checked"]]
    return _judge(state, device, runs)
