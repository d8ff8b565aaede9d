"""The least time of a generator step on the card's roofline over the
window's wall time per step.

The step's work is counted from the configuration's shapes alone, so that
every route of the solve (multigrid, a fused kernel) reads the same:
diffusion, the BC blend, the three advections (the density's with the
inflow), the divergence and the gradient each read and write their fields
once, and the solve reads its right-hand side and masks and writes its
solution once. Operations are the stencils' arithmetic per value written
(`OPS`); at 67 TFLOP/s fp32 they never bound the step, its bytes at
3.35 TB/s do.
"""

from silt_bench import work

LAYER = "whole step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "rollout_step_ms"
WORKLOADS = ["karman_gen.hires_b6"]

# operations per value written: a 5-point Laplacian and its scaled add;
# the blend's v (1 - m) + bc; a backtrace (the velocity averaged at the
# point, the offsets, four bilinear taps and their weights); the
# divergence with its face masks; the solve as one pass of the operator;
# the gradient's difference, mask and subtraction
OPS = {"diffuse": 7, "blend": 3, "advect": 24, "divergence": 5, "solve": 10, "gradient": 4}


def step_work(config: dict, workload: dict) -> dict:
    """Bytes, operations and their least time (ms) of one rollout step of
    the cell's batch."""
    b = workload["batch"]
    h, w = 2 * config["res"], config["res"]
    c, fu, fv = h * w, h * (w + 1), (h + 1) * w
    values = {  # (values read, values written), the masks read once per step
        "diffuse": (b * (fu + fv), b * (fu + fv)),
        "blend": (b * fv + fv, b * fv),
        "advect_dens": (b * (c + fu + fv) + c, b * c),
        "advect_u": (b * (fu + fv), b * fu),
        "advect_v": (b * (fu + fv), b * fv),
        "divergence": (b * (fu + fv) + fu + fv, b * c),
        "solve": (b * c + c + fu + fv, b * c),
        "gradient": (b * (c + fu + fv) + fu + fv, b * (fu + fv)),
    }
    nbytes = 4 * sum(r + wr for r, wr in values.values())
    ops = sum(OPS[name.split("_")[0]] * wr for name, (_, wr) in values.items())
    return {"bytes": nbytes, "flops": ops, "bound_ms": work.bound_ms(nbytes, ops)}


def read(ctx):
    if ctx["kind"] != "gen":
        return None
    bound_s = 1e-3 * step_work(ctx["config"], ctx["workload"])["bound_ms"]
    return 100.0 * bound_s / ctx["unit_wall_s"]
