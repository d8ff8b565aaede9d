"""The least time of a training iteration's conv work (forward, input and
weight gradients at the card's peaks) over the device time of the conv
kernels and their layout copies, whatever implements them."""

from silt_bench import work
from silt_bench.readers import group_per_unit

LAYER = "correction net (models/networks.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_iter_ms"
WORKLOADS = ["karman_sol32.train", "burgers_sol04.train"]


def read(ctx):
    conv = group_per_unit(ctx, "conv")
    if ctx["kind"] != "train" or conv is None:
        return None
    return 100.0 * work.unit_work(ctx["config"], ctx["workload"])["bound_ms"] / (1e3 * conv["s"])
