"""Seconds of the warm-up of the cell's own shapes (the warm-up training
iterations, or a short rollout): cuDNN's choice of algorithms, the kernel
libraries loaded, first launches. A span of the benchmark's own."""

LAYER = "start-up (apps/, kernels/build.py)"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "setup_s"
WORKLOADS = None


def read(ctx):
    return ctx["spans"].get("setup_warmup_s")
