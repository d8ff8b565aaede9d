"""The device's idle share of a rollout step's wall time."""

from silt_bench.readers import idle_pct

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "rollout_step_ms"
WORKLOADS = ["karman_sol32.apply_b1", "burgers_sol04.apply_b1"]


def read(ctx):
    return idle_pct(ctx) if ctx["kind"] == "apply" else None
