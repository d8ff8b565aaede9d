"""Back-to-back PRE rollouts: the apply kind's set-up, window, check,
control and free (its record's kind stays "apply"), with a traced stretch
that also records the program's own spans and counters.

`profile` opens the program's `profiling.recording()` around the traced
rollouts and returns, per frame, the correction solve's milliseconds (the
`silt.pre.lsq` spans), its outer and inner iterations
(`pre.lsq_outer_iters`, `pre.lsq_inner_iters`) and its host reads
(`pre.lsq_host_reads`), each where the program has it.
"""

from __future__ import annotations

from silt_bench.kinds.apply import _rollout, _sync, check, control, free, setup, window
from silt_bench.spans import span_ms_per_unit

__all__ = ["setup", "window", "profile", "check", "control", "free"]
COUNTERS = ("pre.lsq_outer_iters", "pre.lsq_inner_iters", "pre.lsq_host_reads")


def profile(state) -> dict:
    """`profile_rollouts` more rollouts, recorded: their units (frames),
    the correction solve's ms and the program's counters per frame."""
    from solver_in_the_loop_torch.utils import profiling

    n = state["workload"]["profile_rollouts"]
    with profiling.recording() as rec:
        for _ in range(n):
            _rollout(state)
        _sync(state["device"])
    got = rec.read()
    units = n * state["workload"]["steps"]
    out = {"units": units}
    lsq_ms = span_ms_per_unit(got, "silt.pre.lsq", units)
    if lsq_ms is not None:
        out["pre.lsq_ms"] = lsq_ms
    for name in COUNTERS:
        if got["counters"].get(name):
            out[name] = sum(got["counters"][name]) / units
    return out
