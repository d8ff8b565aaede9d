"""Fused CG for the masked Poisson system, with and without the FD
preconditioner: CUDA kernels and their plain twins.

`pcg_solve` replaces the TPU kernels
solver_in_the_loop_tpu/ops/pallas/cg_kernel.py `_pcg_kernel` and
`_pcg_kernel_folded`, `cg_solve` the unpreconditioned `_cg_kernel` and
`_cg_kernel_folded` (all dispatched by ops/pallas/cg.py). On a CUDA tensor
each launches its kernel (csrc/pcg.cu, csrc/cg.cu), which runs the whole loop
in one launch; on a CPU tensor each runs its plain twin, the XLA reference's
loop (`pcg_solve_info` and `cg_solve_info`,
solver_in_the_loop_tpu/ops/poisson.py:92-135, 191-228) with `.item()` stop
checks.

`pcg_solve_op` (`torch.ops.silt.pcg_solve`) and `cg_solve_op`
(`torch.ops.silt.cg_solve`) are the differentiable solves the pressure
projection calls: the forward solves from the given start, and the backward
solves the same SPD system cold for the cotangent with the same solver (the
implicit-function adjoint of `lax.custom_linear_solve` with
`transpose_solve`, solver_in_the_loop_tpu/ops/poisson.py:304-310). They are
registered custom ops so that a selective-checkpoint policy can save their
output (train/trainer.py), and each reaches its kernel only through the
module-level wrapper (`pcg_solve`, `cg_solve`), so replacing that wrapper
replaces the kernel in both directions. `pcg_plain_solve_op`
(`torch.ops.silt.pcg_plain_solve`) is the same differentiable solve on the
plain FD-PCG loop, on any device: the route of a batch above MAX_BATCH
(ops/poisson.py `pressure_route`).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from solver_in_the_loop_torch.kernels import build
from solver_in_the_loop_torch.ops.stencils import masked_laplacian

# One thread block per batch element. A batch of at most MAX_CLUSTER is one
# thread-block cluster; a larger one a cooperative grid, whose blocks (one
# SM each) must all be resident at once: at most the H100 SXM's 132 SMs,
# rounded down.
MAX_CLUSTER = 8
MAX_BATCH = 128
# 227 KB of dynamic shared memory per block on Hopper, less room for the
# kernel's static reduction scratch
SMEM_LIMIT_BYTES = 232448 - 1024
# csrc/cg.cu keeps each thread's cells of x, r, p and A p in registers: at
# most 12 cells for each of its threads, 1,024 on the largest fields
CG_MAX_CELLS = 1024 * 12
# csrc/pcg.cu cuts the field into 16x8 tiles: in its fast layout (both sides
# multiples of 16, at most PCG_FAST_TILES tiles in at most 15 stripes of 16
# rows) 8 warps own two each; else up to 16 warps own up to 6 each
PCG_FAST_TILES = 16
PCG_MAX_TILES = 16 * 6


def _stride_mod32(n: int, m: int) -> int:
    """The smallest stride >= n that is m modulo 32 (csrc/pcg.cu `stride_mod32`)."""
    return n + (m - n) % 32


def _pcg_tiles(h: int, w: int) -> int:
    return -(-h // 16) * -(-w // 8)


def _pcg_layout_words(h: int, w: int, fast: bool) -> int:
    """The floats of csrc/pcg.cu `pcg_layout`: p in its halo, r, t0, t1, Vy
    and Vx, each once (general) or padded and Vy and Vx twice (fast)."""
    ps, ldr, ld0, ldy, ldx = ((_stride_mod32(w + 1, 8), _stride_mod32(w, 8), _stride_mod32(w, 4),
                               _stride_mod32(h, 4), _stride_mod32(w, 4)) if fast
                              else (w + 1, w, w, h, w))
    copies = 2 if fast else 1
    return (h + 2) * ps + h * (2 * ldr + ld0) + copies * (h * ldy + w * ldx)


def pcg_smem_bytes(h: int, w: int) -> int:
    """Dynamic shared memory a block of csrc/pcg.cu gets: the bytes of the
    layout it takes, the fast one (at 64x32: 84,288) where the field's sides
    are multiples of 16, it has at most PCG_FAST_TILES tiles and the layout
    fits SMEM_LIMIT_BYTES, else the unpadded one (at (130, 65): 220,748). The
    kernel takes the fast layout exactly where it is given its bytes. The one
    source of this size: the gate reads it and the launch passes it."""
    fast = (h % 16 == 0 and w % 16 == 0 and _pcg_tiles(h, w) <= PCG_FAST_TILES and h // 16 <= 15
            and 4 * _pcg_layout_words(h, w, True) <= SMEM_LIMIT_BYTES)
    return 4 * _pcg_layout_words(h, w, fast)


def pcg_kernel_fits(shape) -> bool:
    """Whether the fused kernel takes a (B, H, W) problem: the batch fits one
    resident grid (MAX_BATCH), and one element's tiles the block's warps
    (PCG_MAX_TILES) and its layout the block's shared memory. It stands for
    the VMEM gate of solver_in_the_loop_tpu/ops/pallas/cg.py, which takes
    far larger fields (16 live fields in 12 MiB: 196,608 cells)."""
    b, h, w = shape
    return (1 <= b <= MAX_BATCH and _pcg_tiles(h, w) <= PCG_MAX_TILES
            and pcg_smem_bytes(h, w) <= SMEM_LIMIT_BYTES)


def cg_smem_bytes(h: int, w: int) -> int:
    """Dynamic shared memory csrc/cg.cu needs per block: p in a halo of
    zeros, (h + 2) x (w + 1) floats (csrc/cg_common.cuh `halo_index`). The
    one source of this size: the launch passes it."""
    return 4 * (h + 2) * (w + 1)


def cg_kernel_fits(shape) -> bool:
    """Whether the unpreconditioned kernel takes a (B, H, W) problem: the
    batch fits one resident grid and an element's cells the block's registers
    (then its shared memory, cg_smem_bytes, is at most 96 KB)."""
    b, h, w = shape
    return 1 <= b <= MAX_BATCH and h * w <= CG_MAX_CELLS


def batch_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-batch inner product over spatial axes: (B, Y, X) x 2 -> (B, 1, 1)."""
    return torch.sum(a * b, dim=(1, 2), keepdim=True)


def cg_solve_info(matvec: Callable, b: torch.Tensor, tol: float, max_iter: int,
                  x0: Optional[torch.Tensor] = None):
    """Batched matrix-free CG (no preconditioner); same stopping rule as
    pcg_solve_info, the threshold from ||b|| also when warm-started. Returns
    (x, iterations)."""
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


def pcg_solve_info(matvec: Callable, minv: Callable, b: torch.Tensor, tol: float,
                   max_iter: int, x0: Optional[torch.Tensor] = None,
                   dot: Callable = batch_dot):
    """Preconditioned CG; stops when every batch element's true residual r.r
    is at most tol^2 * max(b.b, 1e-30), or at max_iter. `dot` is the
    per-element inner product (parallel/spatial.py passes one summed over
    the ranks that hold the field's rows). Returns (x, iterations)."""
    b_norm_sq = dot(b, b)
    thresh = (tol * tol) * torch.clamp_min(b_norm_sq, 1e-30)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
        rs = b_norm_sq
    else:
        x = x0
        r = b - matvec(x0)
        rs = dot(r, r)
    z = minv(r)
    p = z
    rz = dot(r, z)
    i = 0
    while i < max_iter and bool((rs > thresh).any().item()):
        ap = matvec(p)
        p_ap = dot(p, ap)
        alpha = torch.where(p_ap == 0, 0.0, rz / torch.where(p_ap == 0, 1.0, p_ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = minv(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        rs = dot(r, r)
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


def _stop_flags(b: torch.Tensor) -> torch.Tensor:
    """The kernels' stop flags in global memory (2 x batch ints of scratch)
    for a batch above one cluster; empty, a null pointer, for one cluster,
    which keeps them in shared memory."""
    bsz = b.shape[0]
    return torch.empty(2 * bsz if bsz > MAX_CLUSTER else 0, dtype=torch.int32, device=b.device)


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
                         f"(batch <= {MAX_BATCH}, at most {PCG_MAX_TILES} tiles, "
                         f"{pcg_smem_bytes(h, w)} B shared memory <= {SMEM_LIMIT_BYTES} B)")


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
    fn = build.function("pcg", "silt_pcg_solve", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    bsz, h, w = b.shape
    x = torch.empty_like(b)
    iters = torch.empty((), dtype=torch.int32, device=b.device)
    flags = _stop_flags(b)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (b, x0, fluid, face_u, face_v, vy, vx, invd, x, iters,
                                          flags)),
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


@torch.library.custom_op(
    "silt::pcg_plain_solve", mutates_args=(),
    schema="(Tensor b, Tensor x0, Tensor fluid, Tensor face_u, Tensor face_v, Tensor vy, "
           "Tensor vx, Tensor invd, float tol, int max_iter) -> (Tensor, Tensor)")
def pcg_plain_solve_op(b, x0, fluid, face_u, face_v, vy, vx, invd, tol, max_iter):
    """The FD-preconditioned loop in plain PyTorch (`pcg_solve_plain`) as a
    differentiable op in b, on any device: the pressure route of a batch
    above MAX_BATCH (ops/poisson.py `pressure_route`, "pcg_plain"), as the
    JAX package takes its XLA FD-PCG there. Returns (x, iterations)."""
    x, iters = pcg_solve_plain(b, x0, fluid, face_u, face_v, vy, vx, invd, tol, max_iter)
    return (x.clone() if x is x0 else x), iters


def _pcg_plain_backward(ctx, grad_x, _grad_iters):
    """The cotangent of b is A^-1 grad_x: a cold solve by the same loop."""
    grad_b = None
    if ctx.needs_input_grad[0]:
        g = grad_x.contiguous()
        grad_b, _ = pcg_solve_plain(g, torch.zeros_like(g), *ctx.saved_tensors, ctx.tol,
                                    ctx.max_iter)
    return (grad_b,) + (None,) * 9


pcg_plain_solve_op.register_autograd(_pcg_plain_backward, setup_context=_pcg_setup)


def cg_solve_plain(b, x0, fluid, face_u, face_v, tol: float, max_iter: int):
    """The unpreconditioned kernel's function in plain PyTorch: returns (x,
    iterations as a 0-d int32 tensor on b's device)."""
    x, iters = cg_solve_info(masked_matvec(fluid, face_u, face_v), b, tol, max_iter, x0)
    return x, torch.tensor(iters, dtype=torch.int32, device=b.device)


def _check_cg(b, x0, fluid, face_u, face_v):
    if b.dim() != 3:
        raise ValueError(f"cg_solve: b must be (B, H, W), got {tuple(b.shape)}")
    bsz, h, w = b.shape
    want = {"b": (bsz, h, w), "x0": (bsz, h, w), "fluid": (1, h, w),
            "face_u": (1, h, w + 1), "face_v": (1, h + 1, w)}
    for name, t in zip(want, (b, x0, fluid, face_u, face_v)):
        if (t.dtype != torch.float32 or tuple(t.shape) != want[name]
                or not t.is_contiguous() or t.device != b.device):
            raise ValueError(f"cg_solve: {name} must be a contiguous float32 {want[name]} "
                             f"tensor on {b.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not cg_kernel_fits(b.shape):
        raise ValueError(f"cg_solve: {tuple(b.shape)} does not fit the kernel "
                         f"(batch <= {MAX_BATCH}, at most {CG_MAX_CELLS} cells per element)")


def cg_solve(b, x0, fluid, face_u, face_v, tol: float, max_iter: int):
    """Solve A x = b per element with unpreconditioned CG, warm-started at x0.

    b, x0 (B, H, W); fluid (1, H, W); face_u (1, H, W+1); face_v (1, H+1, W).
    The whole batch stops together. Returns (x, iterations as a 0-d int32
    tensor). CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    if b.device.type == "cpu":
        return cg_solve_plain(b, x0, fluid, face_u, face_v, tol, max_iter)
    if b.device.type != "cuda":
        raise ValueError(f"cg_solve: unsupported device {b.device}")
    _check_cg(b, x0, fluid, face_u, face_v)
    fn = build.function("cg", "silt_cg_solve", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    bsz, h, w = b.shape
    x = torch.empty_like(b)
    iters = torch.empty((), dtype=torch.int32, device=b.device)
    flags = _stop_flags(b)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (b, x0, fluid, face_u, face_v, x, iters, flags)),
                 bsz, h, w, tol * tol, max_iter, cg_smem_bytes(h, w), stream)
    build.check(err, "cg_solve")
    cg_solve.launches += 1
    return x, iters


cg_solve.launches = 0


@torch.library.custom_op(
    "silt::cg_solve", mutates_args=(),
    schema="(Tensor b, Tensor x0, Tensor fluid, Tensor face_u, Tensor face_v, float tol, "
           "int max_iter) -> (Tensor, Tensor)")
def cg_solve_op(b, x0, fluid, face_u, face_v, tol, max_iter):
    """`cg_solve` as a differentiable op in b (x0 and the operator are
    constants). Returns (x, iterations)."""
    x, iters = cg_solve(b, x0, fluid, face_u, face_v, tol, max_iter)
    # the plain loop hands back x0 itself when it is already converged
    return (x.clone() if x is x0 else x), iters


def _cg_setup(ctx, inputs, output):
    _, _, fluid, face_u, face_v, tol, max_iter = inputs
    ctx.save_for_backward(fluid, face_u, face_v)
    ctx.tol, ctx.max_iter = tol, max_iter


def _cg_backward(ctx, grad_x, _grad_iters):
    """The cotangent of b is A^-1 grad_x: a cold solve, as `_pcg_backward`."""
    grad_b = None
    if ctx.needs_input_grad[0]:
        g = grad_x.contiguous()
        grad_b, _ = cg_solve(g, torch.zeros_like(g), *ctx.saved_tensors, ctx.tol, ctx.max_iter)
    return (grad_b,) + (None,) * 6


cg_solve_op.register_autograd(_cg_backward, setup_context=_cg_setup)
