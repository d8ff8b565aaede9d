"""The PRE correction solve's milliseconds per frame: the program's
`silt.pre.lsq` spans over the traced rollouts (recorded beside the
profiler, whose cost on the host they include)."""

LAYER = "PRE correction solve (pre/lsq.py)"
UNIT = "ms/step"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "rollout_step_ms"
WORKLOADS = ["karman_pre.gen"]


def read(ctx):
    return ctx["counters"].get("pre.lsq_ms") if ctx["kind"] == "pre" else None
