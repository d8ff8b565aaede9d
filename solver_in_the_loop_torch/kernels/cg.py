"""Fused CG for the masked Poisson system, with and without the FD
preconditioner: CUDA kernels and their plain twins.

`pcg_solve` replaces the TPU kernels
solver_in_the_loop_tpu/ops/pallas/cg_kernel.py `_pcg_kernel` and
`_pcg_kernel_folded`, `cg_solve` the unpreconditioned `_cg_kernel` and
`_cg_kernel_folded` (all dispatched by ops/pallas/cg.py). On a CUDA tensor
each launches a kernel that runs the whole loop in one launch: its one-block
layout (csrc/pcg.cu, csrc/cg.cu: one element per thread block, the karman
64x32) where that takes the element, else the cluster layout
(csrc/cg_cluster.cu through `pcg_cluster_solve` and `cg_cluster_solve`: one
element over a cluster of up to 16 blocks, sized by `cluster_plan`). On a
CPU tensor each runs its plain twin, the XLA reference's loop
(`pcg_solve_info` and `cg_solve_info`,
solver_in_the_loop_tpu/ops/poisson.py:92-135, 191-228) with `.item()` stop
checks. `periodic_cg_solve` is the plain CG loop on the periodic operator.
ops/poisson.py `pressure_cg_solve` is the differentiable solve that calls
these wrappers. Each stop test of the plain loops, a host read of the
residuals, is counted as `pressure.host_reads` (`_unconverged`); the kernels
read no host in their loop.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from solver_in_the_loop_torch.kernels import build
from solver_in_the_loop_torch.ops.stencils import masked_laplacian
from solver_in_the_loop_torch.utils import profiling

# The fast layouts (csrc/pcg.cu, csrc/cg.cu) run one thread block per batch
# element. A batch of at most MAX_CLUSTER is one thread-block cluster; a
# larger one a cooperative grid, whose blocks (one SM each) must all be
# resident at once: at most the H100 SXM's 132 SMs, rounded down.
MAX_CLUSTER = 8
MAX_BATCH = 128
# 227 KB of dynamic shared memory per block on Hopper, less room for the
# kernel's static reduction scratch
SMEM_LIMIT_BYTES = 232448 - 1024
# csrc/cg.cu keeps each thread's cells of x, r, p and A p in registers: 8
# cells for each of 256 threads, up to 2,048 cells (the karman 64x32), or of
# 1,024 threads, up to CG_MAX_CELLS
CG_MAX_CELLS = 1024 * 8
# csrc/pcg.cu cuts the field into 16x8 tiles, 8 warps owning two each: both
# sides multiples of 16, at most PCG_FAST_TILES tiles in at most 15 stripes
# of 16 rows
PCG_FAST_TILES = 16
# csrc/cg_cluster.cu, every other shape, with or without the preconditioner:
# one element over a cluster of up to CLUSTER_MAX blocks of CLUSTER_THREADS,
# each owning a band of whole 16-row stripes; a batch of several elements
# meets at a barrier of the whole grid, so its clusters must all be
# resident at once. Where a block's share fits its shared memory
# (`cluster_on_chip`), the band's vectors (x, r, both p buffers, A p, z)
# live there, the two Vy slices (split into their TF32 parts) and Vx are
# staged once per launch, p's halo rows come from the other blocks' shared
# memory (DSMEM), Vy^T r and Vy t1 read r and t1 through L2 from padded
# copies (`cluster_work_shape`), and an iteration has four cluster barriers
# with the preconditioner and two without; elsewhere the vectors stay in a
# scratch in global memory (L2), and the products, p and the barriers (five
# and three) are the layout's before (csrc/cg_cluster.cu's header).
CLUSTER_MAX = 16
CLUSTER_THREADS = 512
# cudaOccupancyMaxActiveClusters of csrc/cg_cluster.cu by cluster size
# (1..CLUSTER_MAX blocks, one block per SM), read on an NVIDIA H100 80GB
# HBM3 by chip_smoke.py's build phase, which requires the card to keep at
# least these resident
CLUSTER_RESIDENT = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)


def _stride_mod32(n: int, m: int) -> int:
    """The smallest stride >= n that is m modulo 32 (csrc/pcg.cu `stride_mod32`)."""
    return n + (m - n) % 32


def _pcg_fast(h: int, w: int) -> bool:
    """Whether csrc/pcg.cu takes an (h, w) element in its layout of 8 warps of
    two 16x8 tiles each (at 64x32: 84,288 bytes of shared memory)."""
    tiles = -(-h // 16) * -(-w // 8)
    return (h % 16 == 0 and w % 16 == 0 and tiles <= PCG_FAST_TILES and h // 16 <= 15
            and pcg_smem_bytes(h, w) <= SMEM_LIMIT_BYTES)


def pcg_smem_bytes(h: int, w: int) -> int:
    """Dynamic shared memory of a block of csrc/pcg.cu (`pcg_layout`): p in
    its halo, r, t0 and t1, and Vy and Vx twice each, with row strides that
    put every fragment load on 32 banks. The one source of this size: the
    gate reads it and the launch passes it."""
    ps, ldr, ld0, ldy, ldx = (_stride_mod32(w + 1, 8), _stride_mod32(w, 8), _stride_mod32(w, 4),
                              _stride_mod32(h, 4), _stride_mod32(w, 4))
    return 4 * ((h + 2) * ps + h * (2 * ldr + ld0) + 2 * (h * ldy + w * ldx))


def cluster_strides(h: int, w: int):
    """Row strides (in floats) of csrc/cg_cluster.cu's buffers (`Layout`):
    `b` for the band vectors and the padded copies of r and t1, read as B
    operands on chip (lanes (t, g) at 8t + g), 8 mod 32; `a` for t0 / t2 in
    the L2 variant, an A operand (lanes (g, t) at 4g + t), 4 mod 32; `sw` and
    `sh` for split rows (`split_index`) of t0 / t2 and of the Vy slices on
    chip, twice w and h rounded up to 8, 16 mod 32, a lane reading a float4
    (8 lanes on 32 banks); `vx` for Vx on chip, 8 mod 32 and at least w
    rounded up to 16, with the XOR swizzle of `vx_index` that makes both
    (.) Vx and (.) Vx^T conflict-free."""
    w8, h8 = -(-w // 8) * 8, -(-h // 8) * 8
    return {"b": _stride_mod32(w, 8), "a": _stride_mod32(w, 4), "sw": _stride_mod32(2 * w8, 16),
            "sh": _stride_mod32(2 * h8, 16), "vx": _stride_mod32(-(-w // 16) * 16, 8)}


def split_index(k: int) -> int:
    """Where the TF32 big part of element k of a split row lies in
    csrc/cg_cluster.cu (`split_at`; its small part two floats on): 16
    floats a k-step of 8, lane t's float4 holding k = t and t + 4."""
    return (k >> 3) * 16 + 4 * (k & 3) + ((k >> 2) & 1)


def vx_index(row: int, col: int, ld: int) -> int:
    """Where Vx[row, col] lies in csrc/cg_cluster.cu's staged copy (`vx_at`):
    bits 2-3 of the column flipped by bits 2-3 of the row."""
    return row * ld + (col ^ (((row >> 2) & 3) << 2))


def cluster_smem_bytes(band: int, h: int, w: int, precon: bool, on_chip: bool) -> int:
    """Dynamic shared memory of a block of csrc/cg_cluster.cu (`Layout`): on
    chip p's two halo rows and the band's vectors (x, r, two p buffers and A
    p); with the preconditioner z and t0 / t2 (on chip in split rows), and
    on chip also the two Vy slices (band x h) in split rows and Vx (w x w,
    w rounded up to 8 rows)."""
    ld = cluster_strides(h, w)
    floats = (2 + 5 * band) * ld["b"] if on_chip else 0
    if precon:
        floats += band * (ld["b"] + ld["sw" if on_chip else "a"])
        if on_chip:
            floats += 2 * band * ld["sh"] + -(-w // 8) * 8 * ld["vx"]
    return 4 * floats


def cluster_plan(shape, precon: bool):
    """(blocks per element, rows per block) that csrc/cg_cluster.cu takes for
    a (B, H, W) problem, or None: the element's 16-row stripes cut into the
    most bands of whole stripes, at most CLUSTER_MAX, such that the batch's
    clusters can all be resident at once (CLUSTER_RESIDENT) and a block's
    buffers of the L2 variant fit its shared memory (cluster_smem_bytes).
    At 256x128: 16 blocks of 16 rows; at 534x267: 12 of 48."""
    b, h, w = shape
    if not 1 <= b <= MAX_BATCH or h < 1 or w < 1:
        return None
    stripes = -(-h // 16)
    for blocks in range(min(CLUSTER_MAX, stripes), 0, -1):
        per = -(-stripes // blocks)
        if -(-stripes // per) != blocks:  # the same bands as more blocks would take
            continue
        if (b <= CLUSTER_RESIDENT[blocks - 1]
                and cluster_smem_bytes(16 * per, h, w, precon, False) <= SMEM_LIMIT_BYTES):
            return blocks, 16 * per
    return None


def cluster_work_shape(shape, precon: bool, on_chip: bool):
    """The global scratch csrc/cg_cluster.cu takes for a (B, H, W) problem
    (`work_floats`), (B, floats per element), or None: on chip with the
    preconditioner padded copies of r and t1 (H and W rounded up to 8, rows
    at the band vectors' stride), which Vy^T r and Vy t1 read through L2,
    none without; in L2 p, r, A p and, with the preconditioner, t1 (H x W
    each)."""
    b, h, w = shape
    if on_chip:
        return (b, 2 * -(-h // 8) * 8 * cluster_strides(h, w)["b"]) if precon else None
    return (b, (4 if precon else 3) * h * w)


def cluster_on_chip(shape, precon: bool) -> bool:
    """Whether csrc/cg_cluster.cu keeps a (B, H, W) problem's band vectors in
    shared memory (the plan's flag; else in L2): the plan's block fits its
    shared memory with them. At 256x128 and 134x67 both ways; not at
    384x192 and 534x267 with the preconditioner, nor 534x267 and 626x313
    without."""
    plan = cluster_plan(shape, precon)
    _, h, w = shape
    return plan is not None and cluster_smem_bytes(plan[1], h, w, precon, True) <= SMEM_LIMIT_BYTES


def pcg_kernel_fits(shape) -> bool:
    """Whether the FD-preconditioned kernels take a (B, H, W) problem: the
    fast layout of csrc/pcg.cu (a batch up to MAX_BATCH) or the cluster
    layout of csrc/cg_cluster.cu (cluster_plan). Between them they take
    every OPEN shape the VMEM gate of solver_in_the_loop_tpu/ops/pallas/
    cg.py takes (ops/poisson.py `jax_kernel_gate`)."""
    b, h, w = shape
    return (1 <= b <= MAX_BATCH and _pcg_fast(h, w)) or cluster_plan(shape, True) is not None


def cg_smem_bytes(h: int, w: int) -> int:
    """Dynamic shared memory csrc/cg.cu needs per block: p in a halo of
    zeros, (h + 2) x (w + 1) floats (csrc/cg_common.cuh `halo_index`). The
    one source of this size: the launch passes it."""
    return 4 * (h + 2) * (w + 1)


def cg_kernel_fits(shape) -> bool:
    """Whether the unpreconditioned kernels take a (B, H, W) problem:
    csrc/cg.cu where an element's cells fit its block's registers (up to
    CG_MAX_CELLS, a batch up to MAX_BATCH), else the cluster layout of
    csrc/cg_cluster.cu (cluster_plan)."""
    b, h, w = shape
    return (1 <= b <= MAX_BATCH and h * w <= CG_MAX_CELLS) or cluster_plan(shape, False) is not None


def batch_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-batch inner product over spatial axes: (B, Y, X) x 2 -> (B, 1, 1)."""
    return torch.sum(a * b, dim=(1, 2), keepdim=True)


def _unconverged(rs: torch.Tensor, thresh: torch.Tensor) -> bool:
    """The plain loops' stop test: whether any element's r.r is above its
    threshold, a host read counted as `pressure.host_reads`."""
    profiling.count("pressure.host_reads", 1)
    return bool((rs > thresh).any().item())


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
    while i < max_iter and _unconverged(rs, thresh):
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
    while i < max_iter and _unconverged(rs, thresh):
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
        raise ValueError(f"pcg_solve: {tuple(b.shape)} does not fit the kernels (csrc/pcg.cu's "
                         "layout, csrc/cg_cluster.cu's plans: kernels/cg.py cluster_plan)")


def pcg_solve(b, x0, fluid, face_u, face_v, vy, vx, invd, tol: float, max_iter: int):
    """Solve A x = b per element with FD-preconditioned CG, warm-started at x0.

    b, x0 (B, H, W); fluid (1, H, W); face_u (1, H, W+1); face_v (1, H+1, W);
    vy (H, H), vx (W, W), invd (H, W) from ops.poisson.fd_factors. The whole
    batch stops together. Returns (x, iterations as a 0-d int32 tensor).
    CPU tensors take the plain twin; CUDA tensors launch the kernel: the
    fast layout of csrc/pcg.cu where it takes the element, else the cluster
    layout (`pcg_cluster_solve`)."""
    if b.device.type == "cpu":
        return pcg_solve_plain(b, x0, fluid, face_u, face_v, vy, vx, invd, tol, max_iter)
    if b.device.type != "cuda":
        raise ValueError(f"pcg_solve: unsupported device {b.device}")
    _check(b, x0, fluid, face_u, face_v, vy, vx, invd)
    bsz, h, w = b.shape
    if not (bsz <= MAX_BATCH and _pcg_fast(h, w)):
        return pcg_cluster_solve(b, x0, fluid, face_u, face_v, vy, vx, invd, tol, max_iter)
    fn = build.function("pcg", "silt_pcg_solve", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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


def cg_cluster_solve(b, x0, fluid, face_u, face_v, tol: float, max_iter: int):
    """`cg_solve` in the cluster layout of csrc/cg_cluster.cu (z = r): the
    shapes csrc/cg.cu does not take. CPU tensors take the plain twin."""
    if b.device.type == "cpu":
        return cg_solve_plain(b, x0, fluid, face_u, face_v, tol, max_iter)
    _check_cg(b, x0, fluid, face_u, face_v)
    out = _cluster_launch("cg_cluster_solve", b, x0, fluid, face_u, face_v, None, tol, max_iter)
    cg_cluster_solve.launches += 1
    return out


cg_cluster_solve.launches = 0


def _cluster_launch(what: str, b, x0, fluid, face_u, face_v, fd, tol: float, max_iter: int):
    """One launch of csrc/cg_cluster.cu on the plan `cluster_plan` gives the
    shape, in the variant `cluster_on_chip` names, with the FD factors `fd`
    (vy, vx, invd) or without (None): returns (x, iterations as a 0-d int32
    tensor)."""
    bsz, h, w = b.shape
    pre = fd is not None
    plan = cluster_plan(b.shape, pre)
    if plan is None:
        raise ValueError(f"{what}: csrc/cg_cluster.cu takes no plan for {tuple(b.shape)} "
                         "(kernels/cg.py cluster_plan)")
    blocks, band = plan
    on_chip = cluster_on_chip(b.shape, pre)
    fn = build.function("cg_cluster", "silt_cg_cluster_solve",
                        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    x = torch.empty_like(b)
    iters = torch.empty((), dtype=torch.int32, device=b.device)
    shape = cluster_work_shape(b.shape, pre, on_chip)
    work = None if shape is None else torch.empty(shape, dtype=torch.float32, device=b.device)
    # the grid barrier's counter and the stop flags of a batch of clusters
    sync = torch.zeros(1 + 2 * bsz, dtype=torch.int32, device=b.device) if bsz > 1 else None
    ptr = [None if t is None else t.data_ptr()
           for t in (b, x0, fluid, face_u, face_v, *(fd or (None,) * 3), x, iters, work, sync)]
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(int(pre), int(on_chip), *ptr, bsz, h, w, blocks, band, tol * tol, max_iter,
                 stream)
    build.check(err, what)
    return x, iters


def pcg_cluster_solve(b, x0, fluid, face_u, face_v, vy, vx, invd, tol: float, max_iter: int):
    """`pcg_solve` in the cluster layout of csrc/cg_cluster.cu, one element
    over a cluster of blocks: the shapes the fast layout does not take.
    CPU tensors take the plain twin."""
    if b.device.type == "cpu":
        return pcg_solve_plain(b, x0, fluid, face_u, face_v, vy, vx, invd, tol, max_iter)
    _check(b, x0, fluid, face_u, face_v, vy, vx, invd)
    out = _cluster_launch("pcg_cluster_solve", b, x0, fluid, face_u, face_v, (vy, vx, invd), tol,
                          max_iter)
    pcg_cluster_solve.launches += 1
    return out


pcg_cluster_solve.launches = 0


def cluster_resident(precon: bool, on_chip: bool, h: int, w: int, blocks: int, band: int) -> int:
    """The clusters of csrc/cg_cluster.cu (`blocks` blocks of `band` rows, an
    (h, w) element, the variant on_chip) the current card keeps resident at
    once (cudaOccupancyMaxActiveClusters): CLUSTER_RESIDENT's source."""
    fn = build.function("cg_cluster", "silt_cg_cluster_resident",
                        [ctypes.c_int] * 6 + [ctypes.c_void_p])
    most = ctypes.c_int(0)
    build.check(fn(int(precon), int(on_chip), h, w, blocks, band, ctypes.addressof(most)),
                "cluster_resident")
    return most.value


def cluster_smem_native(precon: bool, on_chip: bool, h: int, w: int, band: int) -> int:
    """csrc/cg_cluster.cu's own count of a block's dynamic shared memory
    (`silt_cg_cluster_smem`), which cluster_smem_bytes mirrors."""
    fn = build.function("cg_cluster", "silt_cg_cluster_smem", [ctypes.c_int] * 5)
    return fn(int(precon), int(on_chip), h, w, band)


def periodic_cg_solve(b, x0, fluid, face_u, face_v, tol: float, max_iter: int):
    """The plain CG loop on the PERIODIC operator: (x, iterations as a 0-d
    int32 tensor on b's device)."""
    x, iters = cg_solve_info(masked_matvec(fluid, face_u, face_v, True), b, tol, max_iter, x0)
    return x, torch.tensor(iters, dtype=torch.int32, device=b.device)


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
        raise ValueError(f"cg_solve: {tuple(b.shape)} does not fit the kernels (csrc/cg.cu's "
                         f"layouts: batch <= {MAX_BATCH}, at most {CG_MAX_CELLS} cells per "
                         "element; csrc/cg_cluster.cu's plans: kernels/cg.py cluster_plan)")


def cg_solve(b, x0, fluid, face_u, face_v, tol: float, max_iter: int):
    """Solve A x = b per element with unpreconditioned CG, warm-started at x0.

    b, x0 (B, H, W); fluid (1, H, W); face_u (1, H, W+1); face_v (1, H+1, W).
    The whole batch stops together. Returns (x, iterations as a 0-d int32
    tensor). CPU tensors take the plain twin; CUDA tensors launch the kernel:
    csrc/cg.cu where an element's cells fit its registers, else the cluster
    layout (`cg_cluster_solve`)."""
    if b.device.type == "cpu":
        return cg_solve_plain(b, x0, fluid, face_u, face_v, tol, max_iter)
    if b.device.type != "cuda":
        raise ValueError(f"cg_solve: unsupported device {b.device}")
    _check_cg(b, x0, fluid, face_u, face_v)
    bsz, h, w = b.shape
    if not (bsz <= MAX_BATCH and h * w <= CG_MAX_CELLS):
        return cg_cluster_solve(b, x0, fluid, face_u, face_v, tol, max_iter)
    fn = build.function("cg", "silt_cg_solve", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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
