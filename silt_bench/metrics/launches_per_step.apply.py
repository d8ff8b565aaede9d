"""Device kernels and copies per rollout step."""

LAYER = "rollout loop (train/rollout.py)"
UNIT = "launches/step"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "rollout_step_ms"
WORKLOADS = ["karman_sol32.apply_b1", "burgers_sol04.apply_b1"]


def read(ctx):
    if ctx["kind"] != "apply" or not ctx["trace"]["launches"]:
        return None
    return ctx["trace"]["launches"] / ctx["profiled_units"]
