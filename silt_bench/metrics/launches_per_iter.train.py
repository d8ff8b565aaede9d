"""Device kernels and copies per training iteration (unroll, remat,
backward, clip, Adam): the host's dispatch work."""

LAYER = "train step (train/trainer.py)"
UNIT = "launches/iter"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_iter_ms"
WORKLOADS = ["karman_sol32.train", "burgers_sol04.train"]


def read(ctx):
    if ctx["kind"] != "train" or not ctx["trace"]["launches"]:
        return None
    return ctx["trace"]["launches"] / ctx["profiled_units"]
