"""The correction net's operations per training iteration (forward, input
and weight gradients of every conv, from MarsMoon's shapes; the solver's
are left out) over the iteration's wall time, against the float32-accurate
product rate of the card (three TF32 products a term)."""

from silt_bench import work

LAYER = "whole step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "train_iter_ms"
WORKLOADS = ["karman_sol32.train", "burgers_sol04.train"]


def read(ctx):
    if ctx["kind"] != "train":
        return None
    flops = work.unit_work(ctx["config"], ctx["workload"])["flops"]
    return 100.0 * flops / ctx["unit_wall_s"] / work.FP32_ACCURATE_FLOPS
