"""Back-to-back generator rollouts: the apply kind's set-up, window, check,
control and free (its record's kind stays "apply"), with a traced stretch
that also records the program's own counters.

`profile` opens the program's `profiling.recording()` around the traced
rollouts and returns, per rollout step, the solves' iterations
(`pressure.iters`), their host reads (`pressure.host_reads`) and their
V-cycles (`multigrid.vcycles`), each where the program counts it.
"""

from __future__ import annotations

from silt_bench.kinds.apply import _rollout, _sync, check, control, free, setup, window

__all__ = ["setup", "window", "profile", "check", "control", "free"]
COUNTERS = ("pressure.iters", "pressure.host_reads", "multigrid.vcycles")


def profile(state) -> dict:
    """`profile_rollouts` more rollouts, recorded: their units, the solves'
    iterations the frames report (`cg_iters`) and the program's counters
    per unit."""
    from solver_in_the_loop_torch.utils import profiling

    n = state["workload"]["profile_rollouts"]
    with profiling.recording() as rec:
        runs = [_rollout(state)[1] for _ in range(n)]
        _sync(state["device"])
    counted = rec.read()["counters"]
    units = n * state["workload"]["steps"]
    out = {"units": units, "cg_iters": [int(k) for f in runs for k in f["cg_iters"].cpu()]}
    for name in COUNTERS:
        if counted.get(name):
            out[name] = sum(counted[name]) / units
    return out
