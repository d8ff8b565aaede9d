"""Fused FD-preconditioned CG for the masked Poisson system: CUDA kernel and
its plain twin.

`pcg_solve` replaces the TPU kernels
solver_in_the_loop_tpu/ops/pallas/cg_kernel.py `_pcg_kernel` and
`_pcg_kernel_folded` (dispatched by ops/pallas/cg.py). On a CUDA tensor it
launches csrc/pcg.cu, which runs the whole loop in one launch; on a CPU
tensor it runs `pcg_solve_plain`, the XLA reference's loop
(`pcg_solve_info`, solver_in_the_loop_tpu/ops/poisson.py:191-228) with
`.item()` stop checks.

`pcg_solve_op` (`torch.ops.silt.pcg_solve`) is the differentiable solve the
pressure projection calls: its forward is `pcg_solve` from the given start,
and its backward solves the same SPD system cold for the cotangent, through
`pcg_solve` again (the implicit-function adjoint of `lax.custom_linear_solve`
with `transpose_solve`, solver_in_the_loop_tpu/ops/poisson.py:304-310). It is
a registered custom op so that a selective-checkpoint policy can save its
output (train/trainer.py), and it reaches the kernel only through the
module-level `pcg_solve`, so replacing that wrapper replaces the kernel in
both directions.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from solver_in_the_loop_torch.kernels import build
from solver_in_the_loop_torch.ops.stencils import masked_laplacian

MAX_BATCH = 8  # one thread-block cluster, one block per batch element
# 227 KB of dynamic shared memory per block on Hopper, less room for the
# kernel's static reduction scratch
SMEM_LIMIT_BYTES = 232448 - 1024


def pcg_smem_bytes(h: int, w: int) -> int:
    """Dynamic shared memory the kernel needs per block, in the layout that
    csrc/pcg.cu carves: nine (h, w) vectors, both face masks, Vy, Vx, Vx^T.
    The one source of this size: the gate reads it and the launch passes it."""
    return 4 * (9 * h * w + h * (w + 1) + (h + 1) * w + h * h + 2 * w * w)


def pcg_kernel_fits(shape) -> bool:
    """Whether the fused kernel takes a (B, H, W) problem: the batch fits one
    cluster and one element fits a block's shared memory (the port of the
    VMEM gate in solver_in_the_loop_tpu/ops/pallas/cg.py)."""
    b, h, w = shape
    return 1 <= b <= MAX_BATCH and pcg_smem_bytes(h, w) <= SMEM_LIMIT_BYTES


def batch_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-batch inner product over spatial axes: (B, Y, X) x 2 -> (B, 1, 1)."""
    return torch.sum(a * b, dim=(1, 2), keepdim=True)


def pcg_solve_info(matvec: Callable, minv: Callable, b: torch.Tensor, tol: float,
                   max_iter: int, x0: Optional[torch.Tensor] = None):
    """Preconditioned CG; stops when every batch element's true residual r.r
    is at most tol^2 * max(b.b, 1e-30), or at max_iter. Returns (x, iterations)."""
    b_norm_sq = batch_dot(b, b)
    thresh = (tol * tol) * torch.clamp_min(b_norm_sq, 1e-30)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
        rs = b_norm_sq
    else:
        x = x0
        r = b - matvec(x0)
        rs = batch_dot(r, r)
    z = minv(r)
    p = z
    rz = batch_dot(r, z)
    i = 0
    while i < max_iter and bool((rs > thresh).any().item()):
        ap = matvec(p)
        p_ap = batch_dot(p, ap)
        alpha = torch.where(p_ap == 0, 0.0, rz / torch.where(p_ap == 0, 1.0, p_ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = minv(r)
        rz_new = batch_dot(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        rs = batch_dot(r, r)
        i += 1
    return x, i


def masked_matvec(fluid: torch.Tensor, face_u: torch.Tensor, face_v: torch.Tensor,
                  periodic: bool = False) -> Callable:
    """The SPD pressure operator: -div(mask grad p) on fluid cells, identity on solids."""
    def matvec(p):
        lp = masked_laplacian(p, face_u, face_v, periodic=periodic)
        return torch.where(fluid > 0, -lp, p)
    return matvec


def fd_apply(vy: torch.Tensor, vx: torch.Tensor, invd: torch.Tensor) -> Callable:
    """The fast-diagonalization preconditioner z = Vy ((Vy^T r Vx) * invd) Vx^T."""
    def minv(r):
        t = torch.einsum("jy,bjx->byx", vy, r)
        t = torch.einsum("byj,jx->byx", t, vx)
        t = t * invd
        t = torch.einsum("yj,bjx->byx", vy, t)
        return torch.einsum("byj,xj->byx", t, vx)
    return minv


def pcg_solve_plain(b, x0, fluid, face_u, face_v, vy, vx, invd, tol: float, max_iter: int):
    """The kernel's function in plain PyTorch: returns (x, iterations as a
    0-d int32 tensor on b's device)."""
    x, iters = pcg_solve_info(masked_matvec(fluid, face_u, face_v), fd_apply(vy, vx, invd),
                              b, tol, max_iter, x0)
    return x, torch.tensor(iters, dtype=torch.int32, device=b.device)


def _check(b, x0, fluid, face_u, face_v, vy, vx, invd):
    if b.dim() != 3:
        raise ValueError(f"pcg_solve: b must be (B, H, W), got {tuple(b.shape)}")
    bsz, h, w = b.shape
    want = {"b": (bsz, h, w), "x0": (bsz, h, w), "fluid": (1, h, w),
            "face_u": (1, h, w + 1), "face_v": (1, h + 1, w), "vy": (h, h),
            "vx": (w, w), "invd": (h, w)}
    for name, t in zip(want, (b, x0, fluid, face_u, face_v, vy, vx, invd)):
        if (t.dtype != torch.float32 or tuple(t.shape) != want[name]
                or not t.is_contiguous() or t.device != b.device):
            raise ValueError(f"pcg_solve: {name} must be a contiguous float32 {want[name]} "
                             f"tensor on {b.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not pcg_kernel_fits(b.shape):
        raise ValueError(f"pcg_solve: {tuple(b.shape)} does not fit the kernel "
                         f"(batch <= {MAX_BATCH}, {pcg_smem_bytes(h, w)} B shared memory "
                         f"> {SMEM_LIMIT_BYTES} B)")


def pcg_solve(b, x0, fluid, face_u, face_v, vy, vx, invd, tol: float, max_iter: int):
    """Solve A x = b per element with FD-preconditioned CG, warm-started at x0.

    b, x0 (B, H, W); fluid (1, H, W); face_u (1, H, W+1); face_v (1, H+1, W);
    vy (H, H), vx (W, W), invd (H, W) from ops.poisson.fd_factors. The whole
    batch stops together. Returns (x, iterations as a 0-d int32 tensor).
    CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    if b.device.type == "cpu":
        return pcg_solve_plain(b, x0, fluid, face_u, face_v, vy, vx, invd, tol, max_iter)
    if b.device.type != "cuda":
        raise ValueError(f"pcg_solve: unsupported device {b.device}")
    _check(b, x0, fluid, face_u, face_v, vy, vx, invd)
    fn = build.function("pcg", "silt_pcg_solve", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    bsz, h, w = b.shape
    x = torch.empty_like(b)
    iters = torch.empty((), dtype=torch.int32, device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (b, x0, fluid, face_u, face_v, vy, vx, invd, x, iters)),
                 bsz, h, w, tol * tol, max_iter, pcg_smem_bytes(h, w), stream)
    build.check(err, "pcg_solve")
    pcg_solve.launches += 1
    return x, iters


pcg_solve.launches = 0


@torch.library.custom_op(
    "silt::pcg_solve", mutates_args=(),
    schema="(Tensor b, Tensor x0, Tensor fluid, Tensor face_u, Tensor face_v, Tensor vy, "
           "Tensor vx, Tensor invd, float tol, int max_iter) -> (Tensor, Tensor)")
def pcg_solve_op(b, x0, fluid, face_u, face_v, vy, vx, invd, tol, max_iter):
    """`pcg_solve` as a differentiable op in b (x0 and the operator are
    constants). Returns (x, iterations)."""
    x, iters = pcg_solve(b, x0, fluid, face_u, face_v, vy, vx, invd, tol, max_iter)
    # the plain loop hands back x0 itself when it is already converged; an
    # op's output may not alias its input
    return (x.clone() if x is x0 else x), iters


def _pcg_setup(ctx, inputs, output):
    _, _, fluid, face_u, face_v, vy, vx, invd, tol, max_iter = inputs
    ctx.save_for_backward(fluid, face_u, face_v, vy, vx, invd)
    ctx.tol, ctx.max_iter = tol, max_iter


def _pcg_backward(ctx, grad_x, _grad_iters):
    """A is symmetric, so the cotangent of b is A^-1 grad_x: a cold solve
    with the forward's tolerance and iteration limit."""
    grad_b = None
    if ctx.needs_input_grad[0]:
        g = grad_x.contiguous()
        grad_b, _ = pcg_solve(g, torch.zeros_like(g), *ctx.saved_tensors, ctx.tol, ctx.max_iter)
    return (grad_b,) + (None,) * 9


pcg_solve_op.register_autograd(_pcg_backward, setup_context=_pcg_setup)
