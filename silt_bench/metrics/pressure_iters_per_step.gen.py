"""The pressure solve's iterations per rollout step, from the program's
`pressure.iters` counter over the traced rollouts."""

LAYER = "pressure solve (ops/poisson.py, kernels/cg.py)"
UNIT = "iters/step"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "rollout_step_ms"
WORKLOADS = ["karman_gen.hires_b6"]


def read(ctx):
    return ctx["counters"].get("pressure.iters") if ctx["kind"] == "gen" else None
