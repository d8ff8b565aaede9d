"""Masked Poisson solve and pressure projection (make_incompressible).

Port of solver_in_the_loop_tpu/ops/poisson.py: matrix-free CG on the masked
5-point Poisson operator, with the fast-diagonalization (FD) preconditioner,
without it, or with a multigrid V-cycle. `solve_pressure` dispatches as the
JAX package does (`pressure_route`): on CUDA to the fused kernel of
kernels/cg.py that the preconditioner option names wherever the JAX
package's Pallas gate takes the shape, else to multigrid (ops/multigrid.py)
where the JAX package takes it, else to the kernel where it takes the shape
and to the plain FD-PCG loop where it does not; on the CPU to multigrid
where the JAX package takes it off the TPU, else to the kernel's plain twin
(the plain FD-PCG loop above the kernels' MAX_BATCH). A periodic problem
takes the plain CG loop on either device. The plain loops, `pcg_solve_info`
and `cg_solve_info`, live beside the kernels in kernels/cg.py.

`pressure_cg_solve` (`torch.ops.silt.pressure_cg_solve`) is the one
differentiable solve, on every route: it takes the route's name and runs its
solver (`_SOLVERS`), and its backward is a cold solve of the same system by
the same route (the implicit-function adjoint of `lax.custom_linear_solve`
with `transpose_solve`, solver_in_the_loop_tpu/ops/poisson.py:304-310). It is
a registered custom op whose call site (`solve_pressure`) a remat policy can
tape, its formula registered with utils/remat.py. Each route reaches its
solver only through the module-level wrapper (kernels/cg.py `pcg_solve`,
`cg_solve`, ...), looked up at call time, so replacing that wrapper replaces
the kernel in both directions. The forward solve is a `silt.pressure` span
with its iterations counted as `pressure.iters`, the adjoint a
`silt.pressure.adjoint` span counted as `pressure.adjoint_iters`
(utils/profiling.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from solver_in_the_loop_torch.core.grids import Domain, StaggeredGrid
from solver_in_the_loop_torch.kernels import cg
from solver_in_the_loop_torch.ops.stencils import divergence, pressure_gradient
from solver_in_the_loop_torch.utils import profiling, remat

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
    return cg.fd_apply(*fd_factors(ny, nx, torch.device(device or "cpu")))


# The JAX package's gate of its fused Pallas CG kernel, the port's own copy
# of its arithmetic (solver_in_the_loop_tpu/ops/pallas/cg.py:17-60
# `_vmem_estimate`), as the kernel runs with both hardware markers of
# artifacts/perf/ (batched_cg_ok, and fd_pcg_ok where precon is "fd"): 16
# live (B, H, W) fields, and for a batch the (B*W)^2 segment-sum matrix (with
# the preconditioner also kron(I_B, Vx) twice, Vy twice and invd), under 12
# MiB of VMEM.
_JAX_VMEM_BUDGET_BYTES = 12 * 1024 * 1024
_JAX_CG_BUFFERS = 16


def jax_kernel_gate(shape, precon: str = "fd") -> bool:
    """Whether the JAX package runs its Pallas CG kernel on a (B, H, W) OPEN
    problem on the TPU: at 256x128 a batch up to 3 with the preconditioner
    and up to 5 without; one element up to (534, 267) and (626, 313)."""
    b, h, w = shape
    field = 4 * h * w
    fd = precon == "fd"
    if b > 1:
        bw = b * w
        total = _JAX_CG_BUFFERS * b * field + 4 * bw * bw
        if fd:
            total += 8 * bw * bw + 8 * h * h + b * field
    else:
        total = _JAX_CG_BUFFERS * field
        if fd:
            total += 8 * h * h + 8 * w * w + field
    return total < _JAX_VMEM_BUDGET_BYTES


def pressure_route(shape, device, periodic: bool = False, precon: str = "fd") -> str:
    """The solver `solve_pressure` runs for a (B, H, W) problem on `device`:
    "pcg" or "cg" (the fused kernels with the FD preconditioner or without it
    on CUDA, their plain twin on the CPU), "multigrid", "pcg_plain" (the
    plain FD-PCG loop) or "periodic_cg" (the plain CG loop).

    On CUDA it follows the JAX package on the TPU: the kernel wherever the
    JAX package's Pallas gate takes the shape (`jax_kernel_gate`), which the
    port's kernels all take (the fast layouts of csrc/pcg.cu and csrc/cg.cu,
    else the cluster layout of csrc/cg_cluster.cu); else multigrid where the
    JAX package takes it (`_mg_applicable`); else the kernel where it takes
    the shape (a batch up to MAX_BATCH at 64x32, where the JAX package runs
    its XLA FD-PCG loop), and the plain FD-PCG loop, which that loop is,
    where it does not. The JAX package's XLA route off its Pallas kernel
    (ops/poisson.py:275-283) is FD-preconditioned whichever precon names.
    On the CPU multigrid where the JAX package takes it off the TPU, the
    plain FD-PCG loop above MAX_BATCH, else the kernel's twin. A periodic
    problem takes the plain CG loop on either device, the JAX package's
    route there on any backend. The route depends on the shape alone: no
    kernel error lands on another route."""
    if precon not in PRECONS:
        raise ValueError(f"precon must be one of {PRECONS}, got {precon!r}")
    if periodic:
        return "periodic_cg"
    kernel = "pcg" if precon == "fd" else "cg"
    if torch.device(device).type == "cuda":
        fits = (cg.pcg_kernel_fits if precon == "fd" else cg.cg_kernel_fits)(shape)
        if fits and jax_kernel_gate(shape, precon):
            return kernel
        if _mg_applicable(shape):
            return "multigrid"
        return kernel if fits else "pcg_plain"
    if _mg_applicable(shape):
        return "multigrid"
    return "pcg_plain" if shape[0] > cg.MAX_BATCH else kernel


def _fd(name: str):
    """The FD-preconditioned kernels/cg.py solver `name`, given the FD factors
    of b's shape."""
    def solve(b, x0, fluid, face_u, face_v, tol, max_iter):
        fd = fd_factors(b.shape[1], b.shape[2], b.device)
        return getattr(cg, name)(b, x0, fluid, face_u, face_v, *fd, tol, max_iter)
    return solve


def _multigrid(*args):
    from solver_in_the_loop_torch.ops import multigrid  # it imports this module

    return multigrid.mg_solve(*args)


# route (`pressure_route`) -> its solver (b, x0, fluid, face_u, face_v, tol,
# max_iter) -> (x, iterations as a 0-d int32 tensor), each looking its
# wrapper up at call time
_SOLVERS = {
    "pcg": _fd("pcg_solve"),
    "cg": lambda *args: cg.cg_solve(*args),
    "pcg_plain": _fd("pcg_solve_plain"),
    "periodic_cg": lambda *args: cg.periodic_cg_solve(*args),
    "multigrid": _multigrid,
}


@torch.library.custom_op(
    "silt::pressure_cg_solve", mutates_args=(),
    schema="(Tensor b, Tensor x0, Tensor fluid, Tensor face_u, Tensor face_v, str route, "
           "float tol, int max_iter) -> (Tensor, Tensor)")
def pressure_cg_solve(b, x0, fluid, face_u, face_v, route, tol, max_iter):
    """The solve of A x = b by `route`'s solver, warm-started at x0, as an op
    differentiable in b (x0 and the operator are constants). Returns (x,
    iterations). The span and counter live here, not in `solve_pressure`,
    whose Python a remat step runs again in its recompute: the op's body
    runs once a solve."""
    with profiling.span("silt.pressure"):
        x, iters = _SOLVERS[route](b, x0, fluid, face_u, face_v, tol, max_iter)
    profiling.count("pressure.iters", iters)
    # a plain loop hands back x0 itself when it is already converged; an op's
    # output may not alias its input
    return (x.clone() if x is x0 else x), iters


def _solve_setup(ctx, inputs, output):
    _, _, fluid, face_u, face_v, route, tol, max_iter = inputs
    ctx.save_for_backward(fluid, face_u, face_v)
    ctx.route, ctx.tol, ctx.max_iter = route, tol, max_iter


def _solve_backward(ctx, grad_x, _grad_iters):
    """A (and the multigrid V-cycle) is symmetric, so the cotangent of b is
    A^-1 grad_x: a cold solve by the same route with the forward's tolerance
    and iteration limit."""
    grad_b = None
    if ctx.needs_input_grad[0]:
        g = grad_x.contiguous()
        with profiling.span("silt.pressure.adjoint"):
            grad_b, iters = _SOLVERS[ctx.route](g, torch.zeros_like(g), *ctx.saved_tensors,
                                                ctx.tol, ctx.max_iter)
        profiling.count("pressure.adjoint_iters", iters)
    return (grad_b,) + (None,) * 7


pressure_cg_solve.register_autograd(_solve_backward, setup_context=_solve_setup)
remat.register(torch.ops.silt.pressure_cg_solve.default, _solve_setup, _solve_backward)


def solve_pressure(div: torch.Tensor, masks: ProjectionMasks, periodic: bool = False,
                   tol: float = 1e-5, max_iter: int = 1000, x0: Optional[torch.Tensor] = None,
                   precon: str = "fd"):
    """Solve div(mask*grad(p)) = div on fluid cells (p = 0 in obstacles), by
    the solver `pressure_route` names for the shape, device and precon.

    The RHS and x0 are zeroed on solid cells before any route. x0 warm-starts
    the forward solve only: it is detached (JAX's stop_gradient), since the
    solution does not depend on it beyond the CG tolerance. The gradient
    w.r.t. div is a cold solve of the same system by the same solver.
    Returns (p, iterations as a 0-d int32 tensor on div's device). Every
    route is a site a remat policy can tape (utils/remat.py): every policy
    saves the solve.
    """
    fluid = masks.fluid
    rhs = torch.where(fluid > 0, -div, 0.0).contiguous()
    x0 = (torch.zeros_like(rhs) if x0 is None
          else torch.where(fluid > 0, x0.detach(), 0.0)).contiguous()
    route = pressure_route(rhs.shape, div.device, periodic, precon)
    return remat.site(torch.ops.silt.pressure_cg_solve.default, rhs, x0, fluid, masks.face_u,
                      masks.face_v, route, tol, max_iter)


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
