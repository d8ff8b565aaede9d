"""The correction net's forward operations per rollout step over the
step's wall time, against the float32-accurate product rate."""

from silt_bench import work

LAYER = "whole step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "rollout_step_ms"
WORKLOADS = ["karman_sol32.apply_b1", "burgers_sol04.apply_b1"]


def read(ctx):
    if ctx["kind"] != "apply":
        return None
    flops = work.unit_work(ctx["config"], ctx["workload"])["flops"]
    return 100.0 * flops / ctx["unit_wall_s"] / work.FP32_ACCURATE_FLOPS
