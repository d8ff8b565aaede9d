"""Plain float32 reference of the two solvers the benchmark drives: the
karman wake step (64x32 OPEN, sphere obstacle, pressure solve) and the
forced periodic Burgers step, with the shift advection, the FD-preconditioned
CG and their derivatives.

Written for the benchmark in plain PyTorch; it imports nothing of the
program. Fields are plain tensors in the MAC layout: u (B, Y, X+1), v
(B, Y+1, X), centered (B, Y, X). Derivatives follow the JAX conventions
that the program reproduces: `clip` passes half the gradient at a bound,
the bilinear sample's slope at an integer offset is that of the hat taps
(-0.5, -1, +0.5 on the rows j-1, j, j+1), and the pressure solve's
derivative is a cold solve of the same system.

`tf32` switches the preconditioner's products to TF32 operands (the
control of the correctness check; see net.py).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from silt_bench.reference.net import tf32_round


# ---------------------------------------------------------------- stencils

def pad_hw(x: torch.Tensor, pad, periodic: bool) -> torch.Tensor:
    """Pad the last two axes of (B, H, W); pad = (left, right, top, bottom)."""
    return F.pad(x[:, None], pad, mode="circular" if periodic else "replicate")[:, 0]


def laplacian(x: torch.Tensor, periodic: bool) -> torch.Tensor:
    p = pad_hw(x, (1, 1, 1, 1), periodic)
    return p[:, 1:-1, :-2] + p[:, 1:-1, 2:] + p[:, :-2, 1:-1] + p[:, 2:, 1:-1] - 4.0 * x


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """min(max(x, lo), hi), whose gradient is one half at a tie."""
    return torch.minimum(torch.maximum(x, torch.tensor(lo, dtype=x.dtype)),
                         torch.tensor(hi, dtype=x.dtype))


# ------------------------------------------------------- bilinear sampling

def _index(idx: torch.Tensor, n: int, periodic: bool) -> torch.Tensor:
    return torch.remainder(idx, n) if periodic else idx.clamp(0, n - 1)


def _gather(values: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    b, h, w = values.shape
    return torch.gather(values.reshape(b, -1), 1, (rows * w + cols).reshape(b, -1)).reshape(
        rows.shape)


def _hat_slope(t: torch.Tensor) -> torch.Tensor:
    """d/dt max(0, 1 - |t|) with abs'(0) = +1 and half of each branch at |t| = 1."""
    a = t.abs()
    return -torch.where(t >= 0, 1.0, -1.0) * torch.where(a < 1, 1.0, torch.where(a == 1, 0.5, 0.0))


class _ShiftSample(torch.autograd.Function):
    """V sampled at (j + dy, i + dx), offsets already clamped to
    [-m, m] (and inside the field where OPEN): the two-by-two bilinear
    window, edge indices clamped (OPEN) or wrapped (PERIODIC)."""

    @staticmethod
    def forward(ctx, values, dy, dx, max_shift: int, periodic: bool):
        _, h, w = values.shape
        jj = torch.arange(h, device=values.device)[None, :, None]
        ii = torch.arange(w, device=values.device)[None, None, :]
        ny, nx = torch.floor(dy), torch.floor(dx)
        fy, fx = dy - ny, dx - nx
        r0 = jj + ny.long()
        c0 = ii + nx.long()
        rows = [_index(r0 + k, h, periodic) for k in (0, 1)]
        cols = [_index(c0 + k, w, periodic) for k in (0, 1)]
        out = ((1 - fy) * ((1 - fx) * _gather(values, rows[0], cols[0])
                           + fx * _gather(values, rows[0], cols[1]))
               + fy * ((1 - fx) * _gather(values, rows[1], cols[0])
                       + fx * _gather(values, rows[1], cols[1])))
        ctx.save_for_backward(values, dy, dx)
        ctx.max_shift, ctx.periodic = max_shift, periodic
        return out

    @staticmethod
    def backward(ctx, g):
        values, dy, dx = ctx.saved_tensors
        m, periodic = ctx.max_shift, ctx.periodic
        _, h, w = values.shape
        jj = torch.arange(h, device=values.device)[None, :, None]
        ii = torch.arange(w, device=values.device)[None, None, :]
        ny, nx = torch.floor(dy), torch.floor(dx)
        fy, fx = dy - ny, dx - nx
        r0, c0 = jj + ny.long(), ii + nx.long()

        def row_interp(k):  # sum over the column taps of the row j + ny + k
            r = _index(r0 + k, h, periodic)
            return ((1 - fx) * _gather(values, r, _index(c0, w, periodic))
                    + fx * _gather(values, r, _index(c0 + 1, w, periodic)))

        def col_interp(k):
            c = _index(c0 + k, w, periodic)
            return ((1 - fy) * _gather(values, _index(r0, h, periodic), c)
                    + fy * _gather(values, _index(r0 + 1, h, periodic), c))

        def slope_sum(d, n, interp):
            # the taps n-1, n, n+1 of the tap range [-m, m+1]; the others have no slope
            total = torch.zeros_like(d)
            for k in (-1, 0, 1):
                tap = n + k
                live = (tap >= -m) & (tap <= m + 1)
                total = total + torch.where(live, _hat_slope(d - tap), 0.0) * interp(k)
            return total

        ddy = g * slope_sum(dy, ny, row_interp)
        ddx = g * slope_sum(dx, nx, col_interp)
        dv = torch.zeros_like(values).reshape(values.shape[0], -1)
        for ky, wy in ((0, 1 - fy), (1, fy)):
            for kx, wx in ((0, 1 - fx), (1, fx)):
                idx = _index(r0 + ky, h, periodic) * w + _index(c0 + kx, w, periodic)
                dv.scatter_add_(1, idx.reshape(dv.shape[0], -1), (g * wy * wx).reshape(
                    dv.shape[0], -1))
        return dv.reshape(values.shape), ddy, ddx, None, None


def shift_sample(values, off_y, off_x, max_shift: int, periodic: bool) -> torch.Tensor:
    """Sample at (j + off_y, i + off_x), the offsets clamped to max_shift
    cells and, OPEN, to the field."""
    h, w = values.shape[-2:]
    dy = clip(off_y, -max_shift, max_shift)
    dx = clip(off_x, -max_shift, max_shift)
    if not periodic:
        jj = torch.arange(h, dtype=values.dtype, device=values.device)[None, :, None]
        ii = torch.arange(w, dtype=values.dtype, device=values.device)[None, None, :]
        dy = clip(jj + dy, 0.0, h - 1.0) - jj
        dx = clip(ii + dx, 0.0, w - 1.0) - ii
    return _ShiftSample.apply(values, dy.expand(values.shape), dx.expand(values.shape),
                              max_shift, periodic)


def gather_sample(values, y, x) -> torch.Tensor:
    """Bilinear sample of a periodic field at fractional index coordinates
    (no gradient path): the generator's advection (`burgers-gen` advects
    with gathers)."""
    h, w = values.shape[-2:]
    y, x = torch.remainder(y, h), torch.remainder(x, w)
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    y0, x0 = y0.long(), x0.long()
    y1, x1 = torch.remainder(y0 + 1, h), torch.remainder(x0 + 1, w)
    y0, x0 = torch.remainder(y0, h), torch.remainder(x0, w)
    return ((1 - fy) * ((1 - fx) * _gather(values, y0, x0) + fx * _gather(values, y0, x1))
            + fy * ((1 - fx) * _gather(values, y1, x0) + fx * _gather(values, y1, x1)))


# --------------------------------------------------------------- advection

def _u_face_velocity(u, v, periodic):
    vp = pad_hw(v, (1, 1, 0, 0), periodic)
    return u, 0.25 * (vp[:, :-1, :-1] + vp[:, :-1, 1:] + vp[:, 1:, :-1] + vp[:, 1:, 1:])


def _v_face_velocity(u, v, periodic):
    up = pad_hw(u, (0, 0, 1, 1), periodic)
    return 0.25 * (up[:, :-1, :-1] + up[:, :-1, 1:] + up[:, 1:, :-1] + up[:, 1:, 1:]), v


def _center_velocity(u, v):
    return 0.5 * (u[:, :, :-1] + u[:, :, 1:]), 0.5 * (v[:, :-1, :] + v[:, 1:, :])


def advect(values, at_u, at_v, dt, spacing, periodic, max_shift):
    """Semi-Lagrangian backtrace of `values` by the velocity (at_u, at_v)
    sampled at its own points, with the shift sample."""
    return shift_sample(values, -dt * at_v / spacing[0], -dt * at_u / spacing[1], max_shift,
                        periodic)


def advect_velocity(u, v, dt, spacing, periodic, max_shift):
    uu, vu = _u_face_velocity(u, v, periodic)
    uv, vv = _v_face_velocity(u, v, periodic)
    return (advect(u, uu, vu, dt, spacing, periodic, max_shift),
            advect(v, uv, vv, dt, spacing, periodic, max_shift))


# ----------------------------------------------------------- pressure solve

def divergence(u, v):
    return (u[:, :, 1:] - u[:, :, :-1]) + (v[:, 1:, :] - v[:, :-1, :])


def pressure_gradient(p):
    """OPEN: Dirichlet-0 ghost pressure outside."""
    pe, pn = F.pad(p, (1, 1)), F.pad(p, (0, 0, 1, 1))
    return pe[:, :, 1:] - pe[:, :, :-1], pn[:, 1:, :] - pn[:, :-1, :]


def _dot(a, b):
    return torch.sum(a * b, dim=(1, 2), keepdim=True)


@functools.lru_cache(maxsize=4)
def _fd_numpy(ny: int, nx: int):
    def lap1d(n):
        a = 2.0 * np.eye(n)
        k = np.arange(n - 1)
        a[k, k + 1] = a[k + 1, k] = -1.0
        return a

    ly, vy = np.linalg.eigh(lap1d(ny))
    lx, vx = np.linalg.eigh(lap1d(nx))
    return (vy.astype(np.float32), vx.astype(np.float32),
            (1.0 / (ly[:, None] + lx[None, :])).astype(np.float32))


class Pressure:
    """The masked Poisson system of an obstacle layout and its
    FD-preconditioned CG: stop when every element's r.r is at most
    tol^2 max(b.b, 1e-30), or at max_iter."""

    def __init__(self, fluid: torch.Tensor, tol: float, max_iter: int, tf32: bool = False):
        self.fluid = fluid
        fx, fy = F.pad(fluid, (1, 1), value=1.0), F.pad(fluid, (0, 0, 1, 1), value=1.0)
        self.face_u = fx[:, :, 1:] * fx[:, :, :-1]
        self.face_v = fy[:, 1:, :] * fy[:, :-1, :]
        self.tol, self.max_iter, self.tf32 = tol, max_iter, tf32
        vy, vx, invd = _fd_numpy(*fluid.shape[1:])
        self.vy, self.vx, self.invd = (torch.from_numpy(a).to(fluid.device) for a in (vy, vx, invd))

    def matvec(self, p):
        gu, gv = pressure_gradient(p)
        lp = divergence(gu * self.face_u, gv * self.face_v)
        return torch.where(self.fluid > 0, -lp, p)

    def minv(self, r):
        rnd = tf32_round if self.tf32 else (lambda t: t)
        vy, vx = rnd(self.vy), rnd(self.vx)
        t = torch.einsum("jy,bjx->byx", vy, rnd(r))
        t = torch.einsum("byj,jx->byx", rnd(t), vx)
        t = t * self.invd
        t = torch.einsum("yj,bjx->byx", vy, rnd(t))
        return torch.einsum("byj,xj->byx", rnd(t), vx)

    def solve(self, b, x0=None):
        """(x, iterations) for A x = b, from x0 (else zero)."""
        thresh = (self.tol ** 2) * _dot(b, b).clamp_min(1e-30)
        if x0 is None:
            x, r = torch.zeros_like(b), b
        else:
            x, r = x0, b - self.matvec(x0)
        rs = _dot(r, r)
        z = self.minv(r)
        p, rz = z, _dot(r, z)
        it = 0
        while it < self.max_iter and bool((rs > thresh).any()):
            ap = self.matvec(p)
            pap = _dot(p, ap)
            alpha = torch.where(pap == 0, 0.0, rz / torch.where(pap == 0, 1.0, pap))
            x = x + alpha * p
            r = r - alpha * ap
            z = self.minv(r)
            rz_new = _dot(r, z)
            p = z + rz_new / torch.where(rz == 0, 1.0, rz) * p
            rz, rs = rz_new, _dot(r, r)
            it += 1
        return x, it


class _Solve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, x0, system: Pressure):
        ctx.system = system
        x, system.last_iterations = system.solve(b, x0)
        return x

    @staticmethod
    def backward(ctx, g):
        x, _ = ctx.system.solve(g.contiguous())
        return x, None, None


def project(u, v, system: Pressure, x0: Optional[torch.Tensor]):
    """Pressure projection: (u, v, p, iterations)."""
    u, v = u * system.face_u, v * system.face_v
    rhs = torch.where(system.fluid > 0, -divergence(u, v), 0.0)
    start = None if x0 is None else torch.where(system.fluid > 0, x0.detach(), 0.0)
    if not torch.is_grad_enabled() or not rhs.requires_grad:
        p, it = system.solve(rhs, start)
    else:
        p = _Solve.apply(rhs, start, system)
        it = system.last_iterations
    gu, gv = pressure_gradient(p)
    return u - gu * system.face_u, v - gv * system.face_v, p, it


def warm_start(history):
    """The quadratic extrapolation 3p1 - 3p2 + p3 of the last pressures
    (linear, previous, then none on the first steps)."""
    if len(history) >= 3:
        return 3.0 * history[-1] - 3.0 * history[-2] + history[-3]
    if len(history) == 2:
        return 2.0 * history[-1] - history[-2]
    return history[-1] if history else None


# ------------------------------------------------------------------ karman

class Karman:
    """The karman wake at (2 res, res) cells over [0, 2 len] x [0, len]:
    viscosity alpha = res^2 / Re, the freestream blend on v, advection of
    density (plus the inflow box) and velocity, the pressure projection."""

    CENTER, RADIUS = (50.0, 50.0), 10.0
    INFLOW_Y, INFLOW_X = (5.0, 10.0), (25.0, 75.0)

    def __init__(self, res: int, length: float, max_shift: int, tol: float, max_iter: int,
                 device, tf32: bool = False):
        self.ny, self.nx = 2 * res, res
        self.spacing = (2 * length / self.ny, length / self.nx)
        self.max_shift = max_shift
        yy = (torch.arange(self.ny, device=device, dtype=torch.float32) + 0.5) * self.spacing[0]
        xx = (torch.arange(self.nx, device=device, dtype=torch.float32) + 0.5) * self.spacing[1]
        yy, xx = torch.meshgrid(yy, xx, indexing="ij")
        inside = (yy - self.CENTER[0]) ** 2 + (xx - self.CENTER[1]) ** 2 < self.RADIUS ** 2
        self.pressure = Pressure(torch.where(inside, 0.0, 1.0)[None], tol, max_iter, tf32)
        self.inflow = ((yy >= self.INFLOW_Y[0]) & (yy < self.INFLOW_Y[1]) & (xx >= self.INFLOW_X[0])
                       & (xx < self.INFLOW_X[1])).to(torch.float32)[None]
        bc = torch.zeros((1, self.ny + 1, self.nx), device=device)
        bc[:, 0:2, :] = 1.0
        bc[:, :, 0] = 1.0
        bc[:, :, -1] = 1.0
        self.bc = bc

    def step(self, d, u, v, re, x0=None, dt: float = 1.0):
        """One step from (density, u, v) at Reynolds numbers re (B,):
        (d, u, v, p, iterations)."""
        alpha = dt * float(self.nx) ** 2 / re.reshape(-1, 1, 1)
        u = u + alpha * laplacian(u, False)
        v = v + alpha * laplacian(v, False)
        v = v * (1.0 - self.bc) + self.bc
        uc, vc = _center_velocity(u, v)
        d = advect(d, uc, vc, dt, self.spacing, False, self.max_shift) + self.inflow * dt
        u, v = advect_velocity(u, v, dt, self.spacing, False, self.max_shift)
        u, v, p, it = project(u, v, self.pressure, x0)
        return d, u, v, p, it


# ----------------------------------------------------------------- burgers

class Burgers:
    """Forced viscous Burgers on (res, res) periodic cells over [0, len]^2:
    advection, explicit diffusion (viscosity 0.1), then + dt force."""

    def __init__(self, res: int, length: float, max_shift: int, viscosity: float = 0.1):
        self.res = res
        self.spacing = (length / res, length / res)
        self.max_shift = max_shift
        self.viscosity = viscosity

    def step(self, u, v, fu, fv, dt: float, advection: str = "shift"):
        if advection == "shift":
            u, v = advect_velocity(u, v, dt, self.spacing, True, self.max_shift)
        else:
            u, v = self._gather_advect(u, v, dt)
        amount = self.viscosity * dt / self.spacing[1] ** 2
        u = u + amount * laplacian(u, True)
        v = v + amount * laplacian(v, True)
        return u + dt * fu, v + dt * fv

    def _gather_advect(self, u, v, dt):
        out = []
        for values, (at_u, at_v) in ((u, _u_face_velocity(u, v, True)),
                                     (v, _v_face_velocity(u, v, True))):
            h, w = values.shape[-2:]
            jj = torch.arange(h, dtype=values.dtype, device=values.device)[None, :, None]
            ii = torch.arange(w, dtype=values.dtype, device=values.device)[None, None, :]
            out.append(gather_sample(values, jj - dt * at_v / self.spacing[0],
                                     ii - dt * at_u / self.spacing[1]))
        return out
