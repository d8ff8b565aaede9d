"""A closed loop of training iterations: the program's train step, fed index
rows drawn from the seed, one iteration after another, each ending when
its loss has been read back (as the program's epoch loop reads it).

Set-up builds the one train step the window then drives, and warms it up
with `warmup_iterations` iterations through the same call and feed; the
window's first `checked_iterations` iterations are recorded. The
reference follows all of these from the same start on the same rows and
judges their losses and step losses, the first gradient as Adam got it
(read back from Adam's first moment) and each parameter's change over
them, so that what is judged includes iterations the timed window ran.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from silt_bench.reference.sol import (
    ADAM_B1,
    leaf_gap,
    leaf_gaps,
    moving_leaves,
    rel_gap,
    train_iterations,
)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _iterate(state, batch_rows):
    """One iteration through the window's own call and feed: (loss, step
    losses, whether it failed). A failure is a loss that is not finite, an
    update the guard skipped, or a solve stopped at its iteration limit."""
    with torch.profiler.record_function("silt_bench.train_step"):
        loss, steps, iters, applied = state["program"].train_step(batch_rows)
    with torch.profiler.record_function("silt_bench.read_loss"):
        value = float(loss)
    if iters is not None:
        state["solve_iters"].append(iters)
    return value, steps, not (math.isfinite(value) and applied)


def _record(chk, batch_rows, value, steps):
    chk["rows"].append(batch_rows)
    chk["losses"].append(value)
    chk["step_losses"].append(steps.detach().cpu())


def setup(system, config, workload, seed, device, fault=None) -> dict:
    t0 = time.perf_counter()
    inp = system.make_inputs(config, "train", seed, device)
    t1 = time.perf_counter()
    program = system.Program(config, inp, device)
    spans = {"inputs_s": t1 - t0, "program_s": time.perf_counter() - t1}
    if fault is not None:
        fault(program)
    state = {"system": system, "config": config, "workload": workload, "device": device,
             "inputs": inp, "program": program, "rows": system.rows(config, seed),
             "solve_iters": [], "spans": spans}
    params = dict(program.model.named_parameters())
    chk = {"rows": [], "start": {k: t.detach().clone() for k, t in params.items()},
           "losses": [], "step_losses": [], "first_grads": None}
    t0 = time.perf_counter()
    for i in range(workload["warmup_iterations"]):
        batch_rows = next(state["rows"])
        value, steps, _ = _iterate(state, batch_rows)
        _record(chk, batch_rows, value, steps)
        if i == 0:
            adam = program.optimizer.adam
            chk["first_grads"] = {k: adam.state[p]["exp_avg"].detach() / (1 - ADAM_B1)
                                  for k, p in params.items() if p in adam.state}
    _sync(device)
    state["spans"]["warmup_s"] = time.perf_counter() - t0
    state["checked"] = chk
    return state


def window(state, seconds: float) -> dict:
    """Iterations until `seconds` have passed, and at least the checked
    ones; the window ends on a synchronise after the last iteration. Its
    first `checked_iterations` are recorded for the check, and the
    parameters after them."""
    device, times, failed = state["device"], [], 0
    chk, n_checked = state["checked"], state["workload"]["checked_iterations"]
    state["solve_iters"] = []
    _sync(device)
    t0 = last = time.perf_counter()
    while len(times) < n_checked or last - t0 < seconds:
        batch_rows = next(state["rows"])
        value, steps, bad = _iterate(state, batch_rows)
        failed += bad
        if len(times) < n_checked:
            _record(chk, batch_rows, value, steps)
            if len(times) == n_checked - 1:
                chk["params"] = {k: t.detach().clone()
                                 for k, t in state["program"].model.named_parameters()}
        now = time.perf_counter()
        times.append(now - last)
        last = now
    _sync(device)
    wall = time.perf_counter() - t0
    max_iter = state["config"].get("pressure", {}).get("max_iter")
    if max_iter is not None and state["solve_iters"]:
        failed += int((torch.stack(state["solve_iters"]).max(dim=1).values >= max_iter).sum())
    return {"kind": "train", "units": len(times), "wall_s": wall, "unit_s": times,
            "attempted": len(times), "failed": failed}


def profile(state) -> dict:
    """The traced stretch: `profile_units` more iterations."""
    state["solve_iters"] = []
    for _ in range(state["workload"]["profile_units"]):
        _iterate(state, next(state["rows"]))
    _sync(state["device"])
    return {"units": state["workload"]["profile_units"]}


def free(state) -> None:
    state.pop("program", None)
    state.pop("solve_iters", None)


def reference(state, device, tf32: bool = False) -> dict:
    """The reference's readings of the warm-up and checked iterations, from
    the same start on the same rows; in TF32 operands where `tf32` (the
    control)."""
    config, chk = state["config"], state["checked"]
    sol = state["system"].reference(config, state["inputs"], device, tf32)
    batches = [torch.from_numpy(r).to(device) for r in chk["rows"]]
    return train_iterations(sol, chk["start"], state["inputs"]["data"], batches,
                            config["msteps"], config["lr"], config["clip_grad"])


def numbers(readings: dict, ref: dict, start: dict) -> dict:
    """The numbers compared, over the leaves the reference moves:
    `loss_gap`, the widest relative gap of an iteration's loss or of one of
    its unrolled steps' losses; `change_gap`, the median leaf's gap of the
    norm of its change over the warm-up and checked iterations. Beside them, read and
    not compared: `grad_gap`, the worst leaf's gap of the first gradient's
    norm as Adam got it (the clip makes it 1e-3 on both sides), and
    `change_gap_worst`, the worst leaf's change gap (a leaf of 32 biases
    moves by round-off in a sign-like Adam step)."""
    keep = moving_leaves(ref["first_raw_grads"]) if ref["first_raw_grads"] else []
    change = leaf_gaps({k: readings["params"][k] - start[k] for k in start},
                       {k: ref["params"][k] - start[k] for k in start}, keep)
    gaps = [rel_gap(a, b) for a, b in zip(readings["losses"], ref["losses"])]
    for a, b in zip(readings["step_losses"], ref["step_losses"]):
        gaps += [rel_gap(x, y) for x, y in zip(a.tolist(), b.tolist())]
    grad_gap = (leaf_gap(readings["first_grads"], ref["first_grads"], keep)
                if readings["first_grads"] and ref["first_grads"] else math.inf)
    return {"loss_gap": max(gaps), "change_gap": statistics.median(change.values()),
            "grad_gap": grad_gap, "change_gap_worst": max(change.values())}


def check(state, device) -> dict:
    return numbers(state["checked"], reference(state, device), state["checked"]["start"])


def control(state, device) -> dict:
    """The numbers of the reference in TF32 operands put in the program's
    place, judged by the float32 reference."""
    start = state["checked"]["start"]
    return numbers(reference(state, device, tf32=True), reference(state, device), start)
