"""Recurrent rollouts: test-time application of a trained correction net,
and the Burgers data generation.

Port of `karman_rollout` and `burgers_rollout` in
solver_in_the_loop_tpu/train/rollout.py: Python loops over solver steps in
place of the jitted `lax.scan`s, forward only.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
from solver_in_the_loop_torch.models.features import (
    Normalization,
    burgers_features,
    correction_to_staggered,
    karman_features,
)
from solver_in_the_loop_torch.physics.burgers import BurgersFlow, SinPotentialForce
from solver_in_the_loop_torch.physics.karman import KarmanFlow
from solver_in_the_loop_torch.utils import profiling


@torch.inference_mode()
def karman_rollout(flow: KarmanFlow, d0: CenteredGrid, v0: StaggeredGrid, re, steps: int,
                   model: Optional[nn.Module] = None, norm: Optional[Normalization] = None,
                   dt: float = 1.0, collect_from: int = 0):
    """Run `steps` solver steps from (d0, v0), adding the model's correction
    after each one (pure solver rollout when model is None).

    re: (B,) Reynolds numbers. Each pressure solve is warm-started from the
    quadratic extrapolation 3p1 - 3p2 + p3 of the previous pressures (linear,
    previous, then cold on the first steps). Returns a dict of (T, B, ...)
    tensors for frames collect_from+1..steps: "dens", "u", "v", with a model
    "corr_u" and "corr_v", and "cg_iters" (T,) int32, the pressure solve's
    iterations per step. The first `collect_from` steps (data generation's
    skipped steps) keep their warm-start history and stack nothing.
    """
    dom = flow.domain
    d, v = d0, v0
    p1 = p2 = p3 = torch.zeros_like(d0.values)
    keys = ("dens", "u", "v", "cg_iters") + (("corr_u", "corr_v") if model is not None else ())
    out = {k: [] for k in keys}
    for k in range(steps):
        with profiling.span("silt.rollout.step"):
            if k >= 3:
                x0 = 3.0 * p1 - 3.0 * p2 + p3
            elif k >= 2:
                x0 = 2.0 * p1 - p2
            else:
                x0 = p1
            d, v, p, iters = flow.step(d, v, re, dt=dt, p0=x0)
            corr = None
            if model is not None:
                with profiling.span("silt.net"):
                    corr = correction_to_staggered(model(karman_features(v, re, norm)), norm, dom)
                    v = v + corr
            p1, p2, p3 = p, p1, p2
            if k < collect_from:
                continue
            vals = (d.values, v.u, v.v, iters) + ((corr.u, corr.v) if corr is not None else ())
            for key, val in zip(keys, vals):
                out[key].append(val)
    return {key: torch.stack(vals) for key, vals in out.items()}


def burgers_rollout(flow: BurgersFlow, steps: int, model: Optional[nn.Module] = None,
                    norm: Optional[Normalization] = None, dt: float = 0.1,
                    use_force_features: bool = True) -> Tuple[Callable, Callable]:
    """(rollout_analytic, rollout_replay) for `steps` forced Burgers steps,
    each adding the model's correction after the solver step (pure solver
    rollout when model is None).

    * rollout_analytic(v0, forces): forces a list of SinPotentialForce, their
      phases advanced in closed form (phase + dt * omega * t) for step t
      (data generation). Returns (T, B, ...) tensors "u", "v" and "fu", "fv",
      the force of the step after each frame.
    * rollout_replay(v0, fu, fv): per-step force components fu (T, B, Y, X+1),
      fv (T, B, Y+1, X) replayed from disk (test rollouts). Returns "u", "v".
    """
    dom = flow.domain

    def advance(v: StaggeredGrid, force: StaggeredGrid) -> StaggeredGrid:
        v = flow.step_with_f(v, force, dt=dt)
        if model is not None:
            with profiling.span("silt.net"):
                feat = burgers_features(v, force if use_force_features else None, norm)
                v = v + correction_to_staggered(model(feat), norm, dom)
        return v

    @torch.inference_mode()
    def rollout_analytic(v0: StaggeredGrid, forces: Sequence[SinPotentialForce]):
        batch = v0.u.shape[0]

        def sample_sum(t: int) -> StaggeredGrid:
            sampled = [SinPotentialForce(f.k, f.amplitude, f.phase + dt * f.omega * t,
                                         f.omega).sample(dom, batch) for f in forces]
            return StaggeredGrid(torch.stack([s.u for s in sampled]).sum(0),
                                 torch.stack([s.v for s in sampled]).sum(0), dom)

        v = v0
        out = {k: [] for k in ("u", "v", "fu", "fv")}
        for t in range(steps):
            with profiling.span("silt.rollout.step"):
                v = advance(v, sample_sum(t))
                nxt = sample_sum(t + 1)
                for key, val in zip(out, (v.u, v.v, nxt.u, nxt.v)):
                    out[key].append(val)
        return {key: torch.stack(vals) for key, vals in out.items()}

    @torch.inference_mode()
    def rollout_replay(v0: StaggeredGrid, fu: torch.Tensor, fv: torch.Tensor):
        v = v0
        us, vs = [], []
        for t in range(fu.shape[0]):
            with profiling.span("silt.rollout.step"):
                v = advance(v, StaggeredGrid(fu[t], fv[t], dom))
                us.append(v.u)
                vs.append(v.v)
        return {"u": torch.stack(us), "v": torch.stack(vs)}

    return rollout_analytic, rollout_replay
