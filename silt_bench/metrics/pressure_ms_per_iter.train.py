"""Device time of the fused (P)CG launches per training iteration, the
forward solves and their adjoints. A time and not a roofline: the program
reports no adjoint iteration count."""

from silt_bench.readers import group_per_unit

LAYER = "pressure solve (ops/poisson.py, kernels/cg.py)"
UNIT = "ms/iter"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_iter_ms"
WORKLOADS = ["karman_sol32.train"]


def read(ctx):
    solve = group_per_unit(ctx, "pressure")
    if ctx["kind"] != "train" or solve is None:
        return None
    return 1e3 * solve["s"]
