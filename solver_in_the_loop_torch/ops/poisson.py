"""Masked Poisson solve and pressure projection (make_incompressible).

Port of solver_in_the_loop_tpu/ops/poisson.py: matrix-free CG on the masked
5-point Poisson operator with the fast-diagonalization preconditioner. On
CUDA, `solve_pressure` dispatches to the fused kernel of kernels/cg.py
wherever it fits; on the CPU it runs the plain loops, as the JAX package does
off the TPU. The plain preconditioned loop, `pcg_solve_info`, lives beside the
kernel in kernels/cg.py. The OPEN-boundary solve is differentiable in its
right-hand side: the backward is a cold solve of the same system
(kernels/cg.py `pcg_solve_op`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from solver_in_the_loop_torch.core.grids import Domain, StaggeredGrid
from solver_in_the_loop_torch.kernels.cg import (
    batch_dot,
    fd_apply,
    masked_matvec,
    pcg_kernel_fits,
    pcg_solve_op,
)
from solver_in_the_loop_torch.ops.stencils import divergence, pressure_gradient


@dataclasses.dataclass
class ProjectionMasks:
    """Accessibility masks for a domain with obstacles.

    fluid  (1, Y, X):   1 where the cell is fluid (outside all obstacles)
    face_u (1, Y, X+1): 1 where flow may cross the u-face (both neighbour cells
                        fluid; domain-edge faces are 1 for OPEN boundaries)
    face_v (1, Y+1, X): likewise for v-faces
    """

    fluid: torch.Tensor
    face_u: torch.Tensor
    face_v: torch.Tensor


def masks_from_fluid_cells(fluid: torch.Tensor, domain: Domain) -> ProjectionMasks:
    """Face masks from a (1, Y, X) fluid-cell indicator. OPEN boundaries treat
    the outside as accessible fluid; PERIODIC wraps neighbours."""
    if domain.periodic:
        fx = F.pad(fluid[:, None], (1, 1, 0, 0), mode="circular")[:, 0]
        fy = F.pad(fluid[:, None], (0, 0, 1, 1), mode="circular")[:, 0]
    else:
        fx = F.pad(fluid, (1, 1), value=1.0)
        fy = F.pad(fluid, (0, 0, 1, 1), value=1.0)
    face_u = fx[:, :, 1:] * fx[:, :, :-1]
    face_v = fy[:, 1:, :] * fy[:, :-1, :]
    return ProjectionMasks(fluid=fluid, face_u=face_u, face_v=face_v)


def _mg_applicable(shape) -> bool:
    """Where the JAX package solves with multigrid-preconditioned CG."""
    _, ny, nx = shape
    return min(ny, nx) >= 64 and ny % 4 == 0 and nx % 4 == 0


def cg_solve_info(matvec, b: torch.Tensor, tol: float, max_iter: int,
                  x0: Optional[torch.Tensor] = None):
    """Batched matrix-free CG (no preconditioner); same stopping rule as
    pcg_solve_info. Returns (x, iterations)."""
    b_norm_sq = batch_dot(b, b)
    thresh = (tol * tol) * torch.clamp_min(b_norm_sq, 1e-30)
    if x0 is None:
        x, r, rs = torch.zeros_like(b), b, b_norm_sq
    else:
        x = x0
        r = b - matvec(x0)
        rs = batch_dot(r, r)
    p = r
    i = 0
    while i < max_iter and bool((rs > thresh).any().item()):
        ap = matvec(p)
        p_ap = batch_dot(p, ap)
        alpha = rs / torch.where(p_ap == 0, 1.0, p_ap)
        alpha = torch.where(p_ap == 0, 0.0, alpha)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = batch_dot(r, r)
        beta = rs_new / torch.where(rs == 0, 1.0, rs)
        p = r + beta * p
        rs = rs_new
        i += 1
    return x, i


@functools.lru_cache(maxsize=8)
def _fd_precon_np(ny: int, nx: int):
    """Eigenvectors and inverse eigenvalue sums of the 1-D Dirichlet
    Laplacians: the exact inverse of the obstacle-free operator."""
    def lap1d(n):
        a = 2.0 * np.eye(n)
        idx = np.arange(n - 1)
        a[idx, idx + 1] = a[idx + 1, idx] = -1.0
        return a

    ly, vy = np.linalg.eigh(lap1d(ny))
    lx, vx = np.linalg.eigh(lap1d(nx))
    inv_denom = 1.0 / (ly[:, None] + lx[None, :])
    return (vy.astype(np.float32), vx.astype(np.float32), inv_denom.astype(np.float32))


@functools.lru_cache(maxsize=8)
def fd_factors(ny: int, nx: int, device: torch.device):
    """(vy (ny, ny), vx (nx, nx), invd (ny, nx)) float32 tensors on `device`;
    cached so a rollout copies them to the device once. Read-only. Made
    outside inference mode, so that a solve under autograd can save them
    after a rollout cached them."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device) for a in _fd_precon_np(ny, nx))


def fd_minv(ny: int, nx: int, device=None):
    """The fast-diagonalization preconditioner apply: (B, ny, nx) -> (B, ny, nx)."""
    return fd_apply(*fd_factors(ny, nx, torch.device(device or "cpu")))


def solve_pressure(div: torch.Tensor, masks: ProjectionMasks, periodic: bool = False,
                   tol: float = 1e-5, max_iter: int = 1000, x0: Optional[torch.Tensor] = None):
    """Solve div(mask*grad(p)) = div on fluid cells (p = 0 in obstacles).

    x0 warm-starts the forward solve only: it is masked to the fluid cells
    and detached (JAX's stop_gradient), since the solution does not depend on
    it beyond the CG tolerance. The gradient w.r.t. div is a cold solve of
    the same system. Returns (p, iterations as a 0-d int32 tensor on div's
    device). On CUDA the fused kernel runs; where it does not fit, or for
    PERIODIC domains, this raises NotImplementedError rather than run the
    plain loop on the card.
    """
    fluid = masks.fluid
    rhs = torch.where(fluid > 0, -div, 0.0)
    x0 = (torch.zeros_like(rhs) if x0 is None
          else torch.where(fluid > 0, x0.detach(), 0.0))
    on_card = div.device.type == "cuda"
    if periodic:
        if on_card:
            raise NotImplementedError(
                "periodic pressure solve on CUDA: the JAX package solves periodic systems "
                "with its XLA CG loop (ops/poisson.py cg_solve_info), which is no Pallas "
                "kernel and is on no ported path yet")
        x, iters = cg_solve_info(masked_matvec(fluid, masks.face_u, masks.face_v, True),
                                 rhs, tol, max_iter, x0)
        return x, torch.tensor(iters, dtype=torch.int32, device=div.device)
    if on_card and not pcg_kernel_fits(rhs.shape):
        raise NotImplementedError(
            f"pressure solve at {tuple(rhs.shape)} does not fit the fused PCG kernel; the "
            "JAX package takes multigrid or the XLA PCG there, which are not ported yet "
            "(ROADMAP.md, 'Modules to port': multigrid)")
    if not on_card and _mg_applicable(rhs.shape):
        raise NotImplementedError(
            f"pressure solve at {tuple(rhs.shape)}: the JAX package solves this size with "
            "multigrid, which is not ported yet (ROADMAP.md, 'Modules to port': multigrid)")
    _, ny, nx = rhs.shape
    vy, vx, invd = fd_factors(ny, nx, div.device)
    return pcg_solve_op(rhs.contiguous(), x0.contiguous(), fluid, masks.face_u,
                        masks.face_v, vy, vx, invd, tol, max_iter)


def make_incompressible(velocity: StaggeredGrid, masks: ProjectionMasks, tol: float = 1e-5,
                        max_iter: int = 1000, p0: Optional[torch.Tensor] = None):
    """Project a MAC velocity to a divergence-free field.

    1. zero velocity on inaccessible faces
    2. solve the masked Poisson system for pressure (warm-started from p0)
    3. subtract the masked pressure gradient

    Returns (velocity, pressure, CG iterations as a 0-d int32 tensor).
    """
    dom = velocity.domain
    periodic = dom.periodic
    u = velocity.u * masks.face_u
    v = velocity.v * masks.face_v
    div = divergence(u, v)
    p, iters = solve_pressure(div, masks, periodic=periodic, tol=tol, max_iter=max_iter,
                              x0=p0)
    gu, gv = pressure_gradient(p, periodic=periodic)
    u = u - gu * masks.face_u
    v = v - gv * masks.face_v
    return StaggeredGrid(u, v, dom), p, iters
