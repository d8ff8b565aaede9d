"""The least time of the rollout's pressure solves (`pcg_bound_ms` at the
iteration counts the rollout reports) over the (P)CG kernels' device
time."""

from silt_bench import work
from silt_bench.readers import group_per_unit

LAYER = "pressure solve (ops/poisson.py, kernels/cg.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "rollout_step_ms"
WORKLOADS = ["karman_sol32.apply_b1"]


def read(ctx):
    solve = group_per_unit(ctx, "pressure")
    iters = ctx["counters"].get("cg_iters")
    if ctx["kind"] != "apply" or solve is None or not iters:
        return None
    shape = (ctx["workload"]["batch"],) + work.grid(ctx["config"])
    bound = sum(work.pcg_bound_ms(shape, k) for k in iters) / ctx["profiled_units"]
    return 100.0 * bound / (1e3 * solve["s"])
