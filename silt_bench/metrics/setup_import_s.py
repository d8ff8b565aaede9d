"""Seconds from the harness's start to torch, the program and a CUDA
context loaded: a span of the benchmark's own."""

LAYER = "start-up (apps/, kernels/build.py)"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "setup_s"
WORKLOADS = None


def read(ctx):
    return ctx["spans"].get("setup_import_s")
