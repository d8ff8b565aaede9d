"""Masked Poisson solve and pressure projection (make_incompressible).

Port of solver_in_the_loop_tpu/ops/poisson.py: matrix-free CG on the masked
5-point Poisson operator, with the fast-diagonalization (FD) preconditioner,
without it, or with a multigrid V-cycle. `solve_pressure` dispatches as the
JAX package does (`pressure_route`): on CUDA to the fused kernel of
kernels/cg.py that the preconditioner option names (csrc/pcg.cu or
csrc/cg.cu) wherever its gate takes the shape, else to multigrid
(ops/multigrid.py) where the JAX package takes it; on the CPU to multigrid
where the JAX package takes it off the TPU, else to the kernel's plain twin;
on either device a batch above the kernels' MAX_BATCH, off multigrid, to the
plain FD-PCG loop, the JAX package's route there. The plain loops, `pcg_solve_info` and
`cg_solve_info`, live beside the kernels in kernels/cg.py. The OPEN-boundary
solve is differentiable in its right-hand side on every route: the backward
is a cold solve of the same system by the same solver (`pcg_solve_op`,
`cg_solve_op`, `mg_solve_op`, `pcg_plain_solve_op`).
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
    MAX_BATCH,
    cg_kernel_fits,
    cg_solve_info,
    cg_solve_op,
    fd_apply,
    masked_matvec,
    pcg_kernel_fits,
    pcg_plain_solve_op,
    pcg_solve_op,
)
from solver_in_the_loop_torch.ops.stencils import divergence, pressure_gradient

# the fused kernel's FD preconditioner on ("fd", JAX's `fd_pcg_ok` marker) or
# off ("none", JAX's SILT_PALLAS_FDPCG=0)
PRECONS = ("fd", "none")


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


def pressure_route(shape, device, periodic: bool = False, precon: str = "fd") -> str:
    """The solver `solve_pressure` runs for a (B, H, W) problem on `device`:
    "pcg" or "cg" (the fused kernel with the FD preconditioner or without it
    on CUDA, its plain twin on the CPU), "multigrid", "pcg_plain" (the plain
    FD-PCG loop, a batch above MAX_BATCH) or "periodic_cg" (the plain CG
    loop, CPU only).

    On CUDA it takes the kernel where its gate takes the shape (a batch of
    at most MAX_BATCH: one cluster up to 8, a cooperative grid above), as
    the JAX package takes its Pallas kernel where the VMEM gate of
    ops/pallas/cg.py takes it, and else multigrid where the JAX package
    would (`_mg_applicable`); on the CPU multigrid where the JAX package
    takes it off the TPU and else the kernel's twin. A batch above MAX_BATCH
    that multigrid does not take runs the plain FD-PCG loop on either
    device, whichever `precon` names: that is the JAX package's route there.
    Its VMEM gate (ops/pallas/cg.py:29-60) sizes the batched kernel, 16 live
    (B, H, W) fields and the (B*W)^2 segment-sum and Vx matrices, far above
    its 12 MiB budget at (129, 64, 32), and its XLA route off the Pallas
    kernel (ops/poisson.py:292-299) is FD-preconditioned in either case. The
    route depends on the shape alone: no kernel error lands there. Raises
    NotImplementedError for what no route of the port solves on the card:
    a periodic problem, and an element beyond both kernels' gates off
    multigrid's sizes (with the preconditioner, (1, 134, 67))."""
    if precon not in PRECONS:
        raise ValueError(f"precon must be one of {PRECONS}, got {precon!r}")
    on_card = torch.device(device).type == "cuda"
    if periodic:
        if on_card:
            raise NotImplementedError(
                "periodic pressure solve on CUDA: the JAX package solves periodic systems "
                "with its XLA CG loop (ops/poisson.py cg_solve_info), which is no Pallas "
                "kernel and is on no ported path yet")
        return "periodic_cg"
    kernel = "pcg" if precon == "fd" else "cg"
    fits = pcg_kernel_fits if precon == "fd" else cg_kernel_fits
    if on_card and fits(shape):
        return kernel
    if _mg_applicable(shape):
        return "multigrid"
    if shape[0] > MAX_BATCH:
        return "pcg_plain"
    if on_card:
        raise NotImplementedError(
            f"pressure solve at {tuple(shape)} on CUDA: the fused {kernel.upper()} kernel does "
            "not take the element (kernels/cg.py pcg_kernel_fits, cg_kernel_fits) and the JAX "
            "package would not take multigrid there (ops/poisson.py _mg_applicable)")
    return kernel


def solve_pressure(div: torch.Tensor, masks: ProjectionMasks, periodic: bool = False,
                   tol: float = 1e-5, max_iter: int = 1000, x0: Optional[torch.Tensor] = None,
                   precon: str = "fd"):
    """Solve div(mask*grad(p)) = div on fluid cells (p = 0 in obstacles), by
    the solver `pressure_route` names for the shape, device and precon.

    The RHS and x0 are zeroed on solid cells before any route. x0 warm-starts
    the forward solve only: it is detached (JAX's stop_gradient), since the
    solution does not depend on it beyond the CG tolerance. The gradient
    w.r.t. div is a cold solve of the same system by the same solver.
    Returns (p, iterations as a 0-d int32 tensor on div's device).
    """
    fluid = masks.fluid
    rhs = torch.where(fluid > 0, -div, 0.0).contiguous()
    x0 = (torch.zeros_like(rhs) if x0 is None
          else torch.where(fluid > 0, x0.detach(), 0.0)).contiguous()
    route = pressure_route(rhs.shape, div.device, periodic, precon)
    if route == "periodic_cg":
        x, iters = cg_solve_info(masked_matvec(fluid, masks.face_u, masks.face_v, True),
                                 rhs, tol, max_iter, x0)
        return x, torch.tensor(iters, dtype=torch.int32, device=div.device)
    if route == "multigrid":
        from solver_in_the_loop_torch.ops.multigrid import mg_solve_op

        return mg_solve_op(rhs, x0, fluid, masks.face_u, masks.face_v, tol, max_iter)
    if route == "cg":
        return cg_solve_op(rhs, x0, fluid, masks.face_u, masks.face_v, tol, max_iter)
    _, ny, nx = rhs.shape
    vy, vx, invd = fd_factors(ny, nx, div.device)
    solve = pcg_plain_solve_op if route == "pcg_plain" else pcg_solve_op
    return solve(rhs, x0, fluid, masks.face_u, masks.face_v, vy, vx, invd, tol, max_iter)


def make_incompressible(velocity: StaggeredGrid, masks: ProjectionMasks, tol: float = 1e-5,
                        max_iter: int = 1000, p0: Optional[torch.Tensor] = None,
                        precon: str = "fd"):
    """Project a MAC velocity to a divergence-free field.

    1. zero velocity on inaccessible faces
    2. solve the masked Poisson system for pressure (warm-started from p0;
       the solver as `solve_pressure` picks it)
    3. subtract the masked pressure gradient

    Returns (velocity, pressure, CG iterations as a 0-d int32 tensor).
    """
    dom = velocity.domain
    periodic = dom.periodic
    u = velocity.u * masks.face_u
    v = velocity.v * masks.face_v
    div = divergence(u, v)
    p, iters = solve_pressure(div, masks, periodic=periodic, tol=tol, max_iter=max_iter,
                              x0=p0, precon=precon)
    gu, gv = pressure_gradient(p, periodic=periodic)
    u = u - gu * masks.face_u
    v = v - gv * masks.face_v
    return StaggeredGrid(u, v, dom), p, iters
