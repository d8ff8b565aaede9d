"""Recurrent karman rollout (test-time application of a trained correction net).

Port of `karman_rollout` in solver_in_the_loop_tpu/train/rollout.py: a Python
loop over solver steps in place of the jitted `lax.scan`, forward only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
from solver_in_the_loop_torch.models.features import (
    Normalization,
    correction_to_staggered,
    karman_features,
)
from solver_in_the_loop_torch.physics.karman import KarmanFlow


@torch.inference_mode()
def karman_rollout(flow: KarmanFlow, d0: CenteredGrid, v0: StaggeredGrid, re, steps: int,
                   model: Optional[nn.Module] = None, norm: Optional[Normalization] = None,
                   dt: float = 1.0):
    """Run `steps` solver steps from (d0, v0), adding the model's correction
    after each one (pure solver rollout when model is None).

    re: (B,) Reynolds numbers. Each pressure solve is warm-started from the
    quadratic extrapolation 3p1 - 3p2 + p3 of the previous pressures (linear,
    previous, then cold on the first steps). Returns a dict of (T, B, ...)
    tensors for frames 1..steps: "dens", "u", "v", "corr_u", "corr_v", and
    "cg_iters" (T,) int32, the pressure solve's iterations per step.
    """
    dom = flow.domain
    d, v = d0, v0
    p1 = p2 = p3 = torch.zeros_like(d0.values)
    out = {k: [] for k in ("dens", "u", "v", "corr_u", "corr_v", "cg_iters")}
    for k in range(steps):
        if k >= 3:
            x0 = 3.0 * p1 - 3.0 * p2 + p3
        elif k >= 2:
            x0 = 2.0 * p1 - p2
        else:
            x0 = p1
        d, v, p, iters = flow.step(d, v, re, dt=dt, p0=x0)
        if model is not None:
            corr = correction_to_staggered(model(karman_features(v, re, norm)), norm, dom)
            v = v + corr
            cu, cv = corr.u, corr.v
        else:
            cu, cv = torch.zeros_like(v.u), torch.zeros_like(v.v)
        p1, p2, p3 = p, p1, p2
        for key, val in zip(out, (d.values, v.u, v.v, cu, cv, iters)):
            out[key].append(val)
    return {key: torch.stack(vals) for key, vals in out.items()}
