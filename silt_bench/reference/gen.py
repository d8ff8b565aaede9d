"""Plain float32 reference of the karman generator's step (`karman-gen`, the
Makefile's hi-res set): the uncorrected karman wake at (2 res, res) cells
with the gather backtrace, built on fluid.py's stencils, `gather_sample`,
`Pressure` and `project`. It runs at any `res`; the judge calls `step` on
every step of a rollout at once.

Written for the benchmark in plain PyTorch; it imports nothing of the
program. Departures from the program:

* The pressure solve is fluid.py's FD-preconditioned CG, not the
  program's CG preconditioned by a multigrid V-cycle. Both solve the same
  masked system to a relative residual; this one stops at `TOL` = 1e-7
  (the program at its configuration's 1e-5), so that its own stopping
  error lies two orders below the program's and does not blur the gap.
* The edge-clamped bilinear sample clamps the coordinates into the field
  and samples with `gather_sample`, whose wrapped upper neighbour on the
  last row or column carries the weight 0; the program clamps the lower
  index to the last cell but one and gives the upper one the weight 1.
  Both give the edge value there.
* `tf32=True` rounds every field to TF32's 10-bit mantissa after each
  operator (diffusion, the BC blend, each advection, the inflow, the
  projection): the control of the correctness check, the precision one
  step below the configuration's float32.
"""

from __future__ import annotations

import torch

from silt_bench.reference.fluid import (
    Karman,
    _center_velocity,
    _u_face_velocity,
    _v_face_velocity,
    gather_sample,
    laplacian,
    project,
    warm_start,
)
from silt_bench.reference.net import tf32_round

TOL = 1e-7


def clamped_sample(values, y, x) -> torch.Tensor:
    """Bilinear sample of an OPEN field at fractional index coordinates,
    the coordinates clamped to the field (edge values outside)."""
    h, w = values.shape[-2:]
    return gather_sample(values, y.clamp(0.0, h - 1.0), x.clamp(0.0, w - 1.0))


def backtrace(values, at_u, at_v, dt, spacing):
    """`values` sampled where its points were dt ago, by the velocity
    (at_u, at_v) at those points (semi-Lagrangian, gather)."""
    h, w = values.shape[-2:]
    jj = torch.arange(h, dtype=values.dtype, device=values.device)[None, :, None]
    ii = torch.arange(w, dtype=values.dtype, device=values.device)[None, None, :]
    return clamped_sample(values, jj - dt * at_v / spacing[0], ii - dt * at_u / spacing[1])


class KarmanGen(Karman):
    """The generator's karman step: diffusion alpha = res^2 / Re, the
    freestream blend on v, gather advection of density (plus the inflow)
    and of velocity, the projection."""

    def __init__(self, res: int, length: float, max_iter: int, device, tf32: bool = False):
        super().__init__(res, length, 0, TOL, max_iter, device)
        self.round = tf32_round if tf32 else (lambda t: t)

    def step(self, d, u, v, re, x0=None, dt: float = 1.0):
        """One step from (density, u, v) at Reynolds numbers re (B,):
        (d, u, v, p, iterations)."""
        rnd = self.round
        alpha = dt * float(self.nx) ** 2 / re.reshape(-1, 1, 1)
        u = rnd(u + alpha * laplacian(u, False))
        v = rnd(v + alpha * laplacian(v, False))
        v = rnd(v * (1.0 - self.bc) + self.bc)
        uc, vc = _center_velocity(u, v)
        d = rnd(backtrace(d, uc, vc, dt, self.spacing))
        d = rnd(d + self.inflow * dt)
        uu, vu = _u_face_velocity(u, v, False)
        uv, vv = _v_face_velocity(u, v, False)
        u = rnd(backtrace(u, uu, vu, dt, self.spacing))
        v = rnd(backtrace(v, uv, vv, dt, self.spacing))
        u, v, p, it = project(u, v, self.pressure, x0)
        return d, rnd(u), rnd(v), rnd(p), it

    @torch.no_grad()
    def rollout(self, d, u, v, re, steps: int):
        """Frames 1..steps of an uncorrected rollout, each solve warm-started
        by the program's extrapolation of the last pressures: dens, u, v
        (T, B, ...) and the solves' iterations (T,)."""
        out = {k: [] for k in ("dens", "u", "v")}
        history, iters = [], []
        for _ in range(steps):
            d, u, v, p, it = self.step(d, u, v, re, warm_start(history))
            history = (history + [p])[-3:]
            iters.append(it)
            for key, val in zip(out, (d, u, v)):
                out[key].append(val)
        frames = {k: torch.stack(vals) for k, vals in out.items()}
        frames["cg_iters"] = torch.tensor(iters)
        return frames
