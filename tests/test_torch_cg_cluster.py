"""The cluster layout of the fused (P)CG (csrc/cg_cluster.cu) on the CPU.

* kernels/cg.py's mirror of the layout against the source: the block size,
  the widest cluster, the flush interval of csrc/pcg.cu, the row strides
  of the shared buffers, the split rows and a block's shared memory in
  each variant;
* the strides, the split rows and Vx's swizzle put every fragment load of
  the four products on 32 banks;
* `cluster_plan`, the cluster sizing: the plans of the shapes the card
  refused before this layout and of the PRE generator's 256x128, and over
  every OPEN (B, 2W, W) shape the JAX package's gate takes (W 32 to 300,
  B up to 16), bands of whole 16-row stripes covering the rows, the most
  blocks that fit, clusters that can all be resident, shared memory that
  fits; `cluster_on_chip`, the variant: the band vectors in shared memory
  where the block fits, else in L2, also at a smaller shared-memory limit
  on miniatures of the shapes that do not fit (384x192, 534x267, 626x313);
* the layout's partition emulated: the preconditioner's four products band
  by band, read through the kernel's own (pointer, stride, stride) views of
  Vy and Vx and summed in its flush groups of 32 k-rows, and the dot
  products summed per block and then over the cluster,
  inside the (P)CG loop, against the plain twins `pcg_solve_plain` and
  `cg_solve_plain` and against the JAX package's XLA loop
  (`pcg_solve_info`), in either variant. The TF32 split of the products is
  tests/test_torch_pcg_tf32.py's.

Tolerances: the emulation is the twin's arithmetic in another summation
order, so its iterations stay within PCG_ITER_TOL / CG_ITER_TOL and its
solution within PCG_REL_TOL / CG_REL_TOL of the solution's max.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.ops import poisson as jp
from solver_in_the_loop_tpu.ops.pallas import cg as jax_pallas_cg
from solver_in_the_loop_tpu.physics import karman as jk

from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.kernels import build
from solver_in_the_loop_torch.kernels import cg as tcg
from solver_in_the_loop_torch.ops import poisson as tp
from solver_in_the_loop_torch.physics import karman as tk

torch.set_num_threads(1)

CSRC = Path(tcg.__file__).resolve().parent.parent / "csrc"


def _constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text()).group(1))


def test_mirror_matches_the_source():
    assert _constant("cg_cluster.cu", "kThreads") == tcg.CLUSTER_THREADS
    assert _constant("cg_cluster.cu", "kMaxClusterWide") == tcg.CLUSTER_MAX
    assert _constant("cg_cluster.cu", "kFlushSteps") == _constant("pcg.cu", "kFlushSteps")
    assert len(tcg.CLUSTER_RESIDENT) == tcg.CLUSTER_MAX
    assert "cg_cluster" in build.SOURCES
    # stride_mod32: n + (((m - n) % 32) + 32) % 32 with C's truncated modulo
    for w in range(1, 700):
        ld = tcg.cluster_strides(2 * w, w)
        w8 = -(-w // 8) * 8
        for key, n, m in (("b", w, 8), ("a", w, 4), ("sw", 2 * w8, 16),
                          ("sh", 2 * -(-2 * w // 8) * 8, 16),
                          ("vx", -(-w // 16) * 16, 8)):
            assert ld[key] == n + (int(np.fmod(m - n, 32)) + 32) % 32, (w, key)
            assert ld[key] % 32 == m and n <= ld[key] < n + 32
    # split rows: each k-step of 8 is 16 floats, lane t's float4 the big parts
    # of k = t and t + 4 and then their small parts; every float used once
    for k0 in range(0, 64, 8):
        spots = sorted(tcg.split_index(k) + half for k in range(k0, k0 + 8) for half in (0, 2))
        assert spots == list(range(2 * k0, 2 * k0 + 16))
        for t in range(4):
            assert tcg.split_index(k0 + t) == 2 * k0 + 4 * t
            assert tcg.split_index(k0 + t + 4) == 2 * k0 + 4 * t + 1
    # a block's shared memory (`Layout`), counted by hand: at 256x128 with the
    # preconditioner the halo (2 x 136), six band vectors (16 x 136), t0 in
    # split rows (16 x 272), the Vy slices in split rows (2 x 16 x 528) and Vx
    # (128 x 136); in L2 z and t0; without the preconditioner the halo and
    # five band vectors, or nothing
    assert tcg.cluster_smem_bytes(16, 256, 128, True, True) == 4 * (
        272 + 6 * 2176 + 4352 + 16896 + 17408) == 207936
    assert tcg.cluster_smem_bytes(16, 256, 128, True, False) == 4 * (2176 + 2112)
    assert tcg.cluster_smem_bytes(48, 534, 267, True, False) == 4 * 48 * (296 + 292)
    # the global scratch (`work_floats`): on chip with the preconditioner
    # padded copies of r and t1 (rows to a multiple of 8, the band vectors'
    # stride); in L2 p, r, A p and with the preconditioner t1
    assert tcg.cluster_work_shape((3, 134, 67), True, True) == (3, 2 * 136 * 72)
    assert tcg.cluster_work_shape((3, 134, 67), False, True) is None
    assert tcg.cluster_work_shape((1, 534, 267), True, False) == (1, 4 * 534 * 267)
    assert tcg.cluster_work_shape((1, 626, 313), False, False) == (1, 3 * 626 * 313)
    assert tcg.cluster_smem_bytes(16, 256, 128, False, True) == 4 * (272 + 5 * 2176)
    assert tcg.cluster_smem_bytes(48, 626, 313, False, False) == 0


def _banks(addresses):
    return len({a % 32 for a in addresses})


@pytest.mark.parametrize("h,w", [(256, 128), (134, 67), (158, 79), (36, 18)])
def test_fragment_loads_hit_32_banks(h, w):
    """Every fragment load of the products from shared memory reads 32
    banks: on chip A as a float4 a lane from the split rows of t0 / t2 and
    of the Vy slices (a quarter warp's 8 lanes, rows g and g + 1, on 8
    distinct groups of 4 banks), in L2 A from t0 / t2 (lanes (g, t),
    (g + 8, t + 4)), B from rows at the band vectors' stride (lanes
    (t, g), (t + 4, g)), and B from Vx as Vx and as Vx^T through the
    swizzle; the swizzle keeps every row of Vx a permutation of its columns
    inside the row's stride."""
    ld = tcg.cluster_strides(h, w)
    lanes = [(g, t) for g in range(8) for t in range(4)]
    for k in range(0, max(h, w), 8):
        for mb in range(0, 32, 16):
            for stride in (ld["sw"], ld["sh"]):
                for quarter in range(4):
                    for dg in (0, 8):
                        groups = {((mb + g + dg) * stride + 2 * k + 4 * t) // 4 % 8
                                  for g in (2 * quarter, 2 * quarter + 1) for t in range(4)}
                        assert len(groups) == 8
            for dg, dt in ((0, 0), (8, 0), (0, 4), (8, 4)):
                assert _banks((mb + g + dg) * ld["a"] + k + t + dt for g, t in lanes) == 32
        for nb in range(0, w, 8):
            for dt in (0, 4):
                assert _banks((k % 32 + t + dt) * ld["b"] + nb + g for g, t in lanes) == 32
                assert _banks(tcg.vx_index(k + t + dt, nb + g, ld["vx"]) for g, t in lanes) == 32
                assert _banks(tcg.vx_index(nb + g, k + t + dt, ld["vx"]) for g, t in lanes) == 32
    for i in range(w):
        row = {tcg.vx_index(i, j, ld["vx"]) - i * ld["vx"] for j in range(w)}
        assert len(row) == w and max(row) < ld["vx"]


@pytest.mark.parametrize("shape,plan", [
    ((1, 256, 128), (16, 16)), ((3, 256, 128), (16, 16)), ((5, 256, 128), (16, 16)),
    ((1, 534, 267), (12, 48)), ((1, 626, 313), (14, 48)), ((1, 134, 67), (9, 16)),
    ((1, 158, 79), (10, 16)), ((1, 384, 192), (12, 32)), ((2, 128, 64), (8, 16)),
    ((1, 36, 18), (3, 16)), ((1, 272, 136), (9, 32)),
])
def test_cluster_plan(shape, plan):
    assert tcg.cluster_plan(shape, True) == plan
    assert tcg.cluster_plan(shape, False) == plan
    assert tcg.cluster_plan((0,) + shape[1:], True) is None
    assert tcg.cluster_plan((tcg.MAX_BATCH + 1,) + shape[1:], True) is None


@pytest.mark.parametrize("precon", ["fd", "none"])
def test_cluster_plan_covers_the_jax_gate(precon):
    """Every OPEN (B, 2W, W) shape the JAX package's gate takes, W 32..300
    and B up to 16, has a plan: bands of whole 16-row stripes, every block
    at least one row, the most blocks up to CLUSTER_MAX whose clusters can
    all be resident, band buffers within shared memory."""
    pre = precon == "fd"
    taken = 0
    for w in range(32, 301):
        for b in range(1, 17):
            shape = (b, 2 * w, w)
            est = jax_pallas_cg._vmem_estimate(shape, batched=True, precon=pre)
            if est >= jax_pallas_cg._VMEM_BUDGET_BYTES:
                continue
            taken += 1
            plan = tcg.cluster_plan(shape, pre)
            assert plan is not None, shape
            blocks, band = plan
            h, stripes = 2 * w, -(-2 * w // 16)
            assert band % 16 == 0 and (blocks - 1) * band < h <= blocks * band, (shape, plan)
            assert blocks <= tcg.CLUSTER_MAX and b <= tcg.CLUSTER_RESIDENT[blocks - 1]
            assert tcg.cluster_smem_bytes(band, 2 * w, w, pre, False) <= tcg.SMEM_LIMIT_BYTES
            # no wider cluster of whole stripes would do: each has a batch
            # beyond what the card keeps resident
            for wider in range(blocks + 1, min(tcg.CLUSTER_MAX, stripes) + 1):
                per = -(-stripes // wider)
                assert -(-stripes // per) != wider or b > tcg.CLUSTER_RESIDENT[wider - 1]
    assert taken > 1000


@pytest.mark.parametrize("shape,precon,on_chip", [
    ((1, 256, 128), "fd", True), ((3, 256, 128), "fd", True), ((6, 256, 128), "fd", True),
    ((5, 256, 128), "none", True), ((1, 134, 67), "fd", True), ((1, 134, 67), "none", True),
    ((1, 158, 79), "none", True), ((1, 384, 192), "none", True), ((1, 384, 192), "fd", False),
    ((1, 534, 267), "fd", False), ((1, 534, 267), "none", False), ((1, 626, 313), "none", False),
])
def test_cluster_on_chip(shape, precon, on_chip):
    """The variant of csrc/cg_cluster.cu: the band vectors in shared memory
    where the block fits (with the preconditioner also t0 / t2, its Vy
    slices and Vx), else in L2; the plan is the same either way."""
    pre = precon == "fd"
    blocks, band = tcg.cluster_plan(shape, pre)
    _, h, w = shape
    assert tcg.cluster_on_chip(shape, pre) == on_chip
    assert (tcg.cluster_smem_bytes(band, h, w, pre, True) <= tcg.SMEM_LIMIT_BYTES) == on_chip
    assert tcg.cluster_smem_bytes(band, h, w, pre, False) <= tcg.SMEM_LIMIT_BYTES
    assert not tcg.cluster_on_chip((0,) + shape[1:], pre)


def _view(flat, off, s0, s1, m, k):
    """The (m, k) matrix a kernel View reads: element (a, b) at
    flat[off + a * s0 + b * s1]."""
    return flat[off + torch.arange(m)[:, None] * s0 + torch.arange(k)[None, :] * s1]


def _emulate(b, x0, fluid, face_u, face_v, fd, tol, max_iter):
    """The cluster layout's loop with its partition: per block of the plan a
    band of rows; the products of the preconditioner band by band (Vy^T r
    and Vy t1 over every row, once t1 is complete), in flush groups of 32
    k-rows; each dot product summed per block and then over the blocks in
    rank order. Both variants of the kernel sum in this order."""
    bsz, h, w = b.shape
    blocks, band = tcg.cluster_plan(b.shape, fd is not None)
    bands = [(q * band, min(band, h - q * band)) for q in range(blocks)]
    matvec = tcg.masked_matvec(fluid, face_u, face_v)

    def dot(u, v):
        parts = [(u[:, r0:r0 + n] * v[:, r0:r0 + n]).sum(dim=(1, 2)) for r0, n in bands]
        return torch.stack(parts).sum(0)[:, None, None]

    def product(a, b):
        """a @ b with the k axis cut into the kernel's flush groups of 32 rows
        (kFlushSteps k-steps of 8), their products added in k order."""
        k, step = a.shape[-1], 8 * _constant("cg_cluster.cu", "kFlushSteps")
        out = a[..., :step] @ b[..., :step, :]
        for k0 in range(step, k, step):
            out = out + a[..., k0:k0 + step] @ b[..., k0:k0 + step, :]
        return out

    def minv(r):
        if fd is None:
            return r
        vy, vx, invd = (t.flatten() for t in fd)
        t1, z = torch.empty_like(r), torch.empty_like(r)
        for r0, n in bands:  # t0 = Vy^T r, then t1 = (t0 Vx) * invd on the band
            t0 = product(_view(vy, r0, 1, h, n, h), r)
            t1[:, r0:r0 + n] = (product(t0, _view(vx, 0, w, 1, w, w))
                                * _view(invd, r0 * w, w, 1, n, w))
        for r0, n in bands:  # t2 = Vy t1, then z = t2 Vx^T on the band
            t2 = product(_view(vy, r0 * h, h, 1, n, h), t1)
            z[:, r0:r0 + n] = product(t2, _view(vx, 0, 1, w, w, w))
        return z

    thresh = tol * tol * torch.clamp_min(dot(b, b), 1e-30)
    x = x0
    r = b - matvec(x0)
    z = minv(r)
    p, rz, rs = z, dot(r, z), dot(r, r)
    it = 0
    while it < max_iter and bool((rs > thresh).any()):
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = torch.where(pap == 0, 0.0, rz / torch.where(pap == 0, 1.0, pap))
        x = x + alpha * p
        r = r - alpha * ap
        z = minv(r)
        rz_new, rs = dot(r, z), dot(r, r)
        p = z + rz_new / torch.where(rz == 0, 1.0, rz) * p
        rz = rz_new
        it += 1
    return x, it


def _check_partition(batch, res, precon, jax_iters=True):
    """The emulated partition against the twin and the JAX package's XLA
    loop on karman masks, from a warm start: the iterations and the
    solution (the iterations against JAX's only where `jax_iters`)."""
    jdom, tdom = jk.karman_domain(res), tk.karman_domain(res)
    jm, tm = jk.KarmanFlow(jdom).masks, tk.KarmanFlow(tdom).masks
    rng = np.random.RandomState(res + batch)
    fluid = np.asarray(jm.fluid)
    rhs = (rng.randn(batch, jdom.ny, jdom.nx) * fluid).astype(np.float32)
    x0 = (0.1 * rng.randn(batch, jdom.ny, jdom.nx) * fluid).astype(np.float32)
    ops = (torch.from_numpy(rhs), torch.from_numpy(x0), tm.fluid, tm.face_u, tm.face_v)
    fd = tp.fd_factors(jdom.ny, jdom.nx, torch.device("cpu")) if precon == "fd" else None
    x_e, it_e = _emulate(*ops, fd, 1e-5, 1000)
    if fd is None:
        x_p, it_p = tcg.cg_solve_plain(*ops, 1e-5, 1000)
        iter_tol, rel_tol = parity.CG_ITER_TOL, parity.CG_REL_TOL
    else:
        x_p, it_p = tcg.pcg_solve_plain(*ops, *fd, 1e-5, 1000)
        iter_tol, rel_tol = parity.PCG_ITER_TOL, parity.PCG_REL_TOL
    assert abs(it_e - int(it_p)) <= iter_tol
    scale = float(x_p.abs().max())
    assert float((x_e - x_p).abs().max()) <= rel_tol * scale
    if fd is not None:
        minv = jp.fd_minv(jdom.ny, jdom.nx)

        def matvec(p):
            return jnp.where(jm.fluid > 0, -jp.masked_laplacian(p, jm.face_u, jm.face_v), p)

        x_j, it_j = jp.pcg_solve_info(matvec, minv, jnp.asarray(rhs), tol=1e-5, max_iter=1000,
                                      x0=jnp.asarray(x0))
        assert abs(it_e - int(it_j)) <= iter_tol or not jax_iters
        assert float(np.abs(x_e.numpy() - np.asarray(x_j)).max()) <= rel_tol * scale


@pytest.mark.parametrize("batch,res", [(1, 20), (2, 24), (3, 9)])
@pytest.mark.parametrize("precon", ["fd", "none"])
def test_partition_matches_the_twin_and_jax(batch, res, precon):
    """The emulated partition against the twin and the JAX package's XLA
    loop, on chip. At -r 20, 40 rows in three bands of 16 (the last one of
    8); at -r 9, 18 rows in two."""
    shape = (batch, 2 * res, res)
    assert tcg.cluster_on_chip(shape, precon == "fd")
    _check_partition(batch, res, precon)


@pytest.mark.parametrize("res,precon,cluster_max,plan,of", [
    (32, "fd", 2, (2, 32), "384x192: 12 bands of 32"),
    (51, "fd", 3, (3, 48), "534x267: 12 bands of 48, the last of 6"),
    (49, "none", 3, (3, 48), "626x313: 14 bands of 48, the last of 2"),
])
def test_band_does_not_fit_in_miniature(monkeypatch, res, precon, cluster_max, plan, of):
    """The L2 variant where a block's band vectors do not fit, on miniatures
    of the shapes where that happens on the card: the same plan logic with
    fewer blocks a cluster and 48 KB of shared memory, which hold the L2
    variant's buffers and not the on-chip ones; the plan's bands as on the
    card, on chip once the limit is back; and the emulated partition with
    those bands against the twin (iterations and solution) and JAX (the
    solution: at 98x49 and 102x51 the twin's float32 loop itself takes 2
    iterations more or fewer than JAX's, 26 against 28 and 31 against 33,
    where float64 takes 23 and 25; PERF.md §7)."""
    shape, pre = (1, 2 * res, res), precon == "fd"
    monkeypatch.setattr(tcg, "CLUSTER_MAX", cluster_max)
    assert tcg.cluster_plan(shape, pre) == plan and tcg.cluster_on_chip(shape, pre), of
    monkeypatch.setattr(tcg, "SMEM_LIMIT_BYTES", 48 * 1024)
    assert tcg.cluster_plan(shape, pre) == plan and not tcg.cluster_on_chip(shape, pre), of
    _check_partition(1, res, precon, jax_iters=res < 48)
