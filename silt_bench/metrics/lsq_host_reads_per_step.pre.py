"""The PRE correction solve's host reads per frame: the reads of its CG
loops' stop flags, from the program's `pre.lsq_host_reads` counter over the
traced rollouts."""

LAYER = "PRE correction solve (pre/lsq.py)"
UNIT = "reads/step"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "rollout_step_ms"
WORKLOADS = ["karman_pre.gen"]


def read(ctx):
    return ctx["counters"].get("pre.lsq_host_reads") if ctx["kind"] == "pre" else None
