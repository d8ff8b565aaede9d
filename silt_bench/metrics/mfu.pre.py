"""The least time of a PRE frame on the card's roofline over the window's
wall time per frame.

The frame's work is counted from the configuration's shapes alone, so that
every implementation of its solves reads the same: the hi-res and the
lo-res step as `mfu.gen`'s `step_work` counts a generator step (at batch 1,
res and res x scale); the 4x upsample reads the lo-res faces and writes the
hi-res ones; the projection of the difference reads and writes its fields
once, as a step's divergence, solve and gradient do; the correction solve
reads the difference's hi-res faces and the previous correction and writes
the correction once (its operations: the interpolation and its transpose,
once each). At 67 TFLOP/s fp32 the operations never bound the frame, its
bytes at 3.35 TB/s do.
"""

from silt_bench import work
from silt_bench.harness import load_module

LAYER = "whole step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "rollout_step_ms"
WORKLOADS = ["karman_pre.gen"]

# operations per value written: a bilinear tap sum (four products, three
# additions); the interpolation and its transpose per hi-res face read
OPS = {"upsample": 7, "lsq": 14}


def _faces(res: int):
    h, w = 2 * res, res
    return h * w, h * (w + 1), (h + 1) * w


def frame_work(config: dict, workload: dict) -> dict:
    """Bytes, operations and their least time (ms) of one PRE frame."""
    step_work = load_module("metrics", "mfu.gen").step_work
    b, res, scale = workload["batch"], config["res"], config["scale"]
    hi = step_work(dict(config, res=res * scale), workload)
    lo = step_work(config, workload)
    c, fu, fv = _faces(res * scale)
    _, lu, lv = _faces(res)
    # (values read, values written), the masks read once a frame
    values = {
        "upsample": (b * (lu + lv), b * (fu + fv)),
        "divergence": (b * (fu + fv) + fu + fv, b * c),
        "solve": (b * c + c + fu + fv, b * c),
        "gradient": (b * (c + fu + fv) + fu + fv, b * (fu + fv)),
        "lsq": (b * (fu + fv + lu + lv), b * (lu + lv)),
    }
    nbytes = hi["bytes"] + lo["bytes"] + 4 * sum(r + wr for r, wr in values.values())
    ops = (hi["flops"] + lo["flops"] + OPS["upsample"] * values["upsample"][1]
           + OPS["lsq"] * b * (fu + fv)
           + sum(load_module("metrics", "mfu.gen").OPS[k] * values[k][1]
                 for k in ("divergence", "solve", "gradient")))
    return {"bytes": nbytes, "flops": ops, "bound_ms": work.bound_ms(nbytes, ops)}


def read(ctx):
    if ctx["kind"] != "pre":
        return None
    bound_s = 1e-3 * frame_work(ctx["config"], ctx["workload"])["bound_ms"]
    return 100.0 * bound_s / ctx["unit_wall_s"]
