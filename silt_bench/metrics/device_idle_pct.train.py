"""The device's idle share of a training iteration's wall time."""

from silt_bench.readers import idle_pct

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_iter_ms"
WORKLOADS = ["karman_sol32.train", "burgers_sol04.train"]


def read(ctx):
    return idle_pct(ctx) if ctx["kind"] == "train" else None
