"""The pressure solve's host reads per rollout step: the stop tests of the
plain (P)CG loop (the multigrid route's), from the program's
`pressure.host_reads` counter over the traced rollouts."""

LAYER = "pressure solve (ops/poisson.py, kernels/cg.py)"
UNIT = "reads/step"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "rollout_step_ms"
WORKLOADS = ["karman_gen.hires_b6"]


def read(ctx):
    return ctx["counters"].get("pressure.host_reads") if ctx["kind"] == "gen" else None
