"""The least time of a rollout step's conv forwards over the device time of
the conv kernels and their layout copies."""

from silt_bench import work
from silt_bench.readers import group_per_unit

LAYER = "correction net (models/networks.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "rollout_step_ms"
WORKLOADS = ["karman_sol32.apply_b1", "burgers_sol04.apply_b1"]


def read(ctx):
    conv = group_per_unit(ctx, "conv")
    if ctx["kind"] != "apply" or conv is None:
        return None
    return 100.0 * work.unit_work(ctx["config"], ctx["workload"])["bound_ms"] / (1e3 * conv["s"])
