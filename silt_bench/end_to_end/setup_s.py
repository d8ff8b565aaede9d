"""Seconds from the harness's first statement to the start of the window:
imports, the CUDA context, the kernel libraries (built on a checkout's
first run), inputs and weights, the warm-up of the cell's shapes."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(record, setup_s):
    return setup_s
