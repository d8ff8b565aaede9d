"""The PRE correction solve's inner CG iterations per frame (its
projections' solves, summed), from the program's `pre.lsq_inner_iters`
counter over the traced rollouts."""

LAYER = "PRE correction solve (pre/lsq.py)"
UNIT = "iters/step"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "rollout_step_ms"
WORKLOADS = ["karman_pre.gen"]


def read(ctx):
    return ctx["counters"].get("pre.lsq_inner_iters") if ctx["kind"] == "pre" else None
