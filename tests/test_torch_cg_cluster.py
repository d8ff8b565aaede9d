"""The cluster layout of the fused (P)CG (csrc/cg_cluster.cu) on the CPU.

* kernels/cg.py's mirror of the layout against the source: the block size,
  the widest cluster, the flush interval of csrc/pcg.cu, the band buffers'
  row stride;
* `cluster_plan`, the cluster sizing: the plans of the shapes the card
  refused before this layout and of the PRE generator's 256x128, and over
  every OPEN (B, 2W, W) shape the JAX package's gate takes (W 32 to 300,
  B up to 16), bands of whole 16-row stripes covering the rows, the most
  blocks that fit, clusters that can all be resident, shared memory that
  fits;
* the layout's partition emulated: the preconditioner's four products band
  by band, read through the kernel's own (pointer, stride, stride) views of
  Vy and Vx, and the dot products summed per block and then over the
  cluster, inside the (P)CG loop, against the plain twins `pcg_solve_plain`
  and `cg_solve_plain` and against the JAX package's XLA loop
  (`pcg_solve_info`). The TF32 split of the products is
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
    # band_stride: w + (((4 - w) % 32) + 32) % 32 with C's truncated modulo
    for w in range(1, 700):
        c_mod = int(np.fmod(4 - w, 32))
        assert tcg.cluster_smem_bytes(1, w, True) == 8 * (w + (c_mod + 32) % 32)
        assert (w + (c_mod + 32) % 32) % 32 == 4
    assert tcg.cluster_smem_bytes(48, 267, False) == 0


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
            assert tcg.cluster_smem_bytes(band, w, pre) <= tcg.SMEM_LIMIT_BYTES
            # no wider cluster of whole stripes would do: each has a batch
            # beyond what the card keeps resident
            for wider in range(blocks + 1, min(tcg.CLUSTER_MAX, stripes) + 1):
                per = -(-stripes // wider)
                assert -(-stripes // per) != wider or b > tcg.CLUSTER_RESIDENT[wider - 1]
    assert taken > 1000


def _view(flat, off, s0, s1, m, k):
    """The (m, k) matrix a kernel View reads: element (a, b) at
    flat[off + a * s0 + b * s1]."""
    return flat[off + torch.arange(m)[:, None] * s0 + torch.arange(k)[None, :] * s1]


def _emulate(b, x0, fluid, face_u, face_v, fd, tol, max_iter):
    """The cluster layout's loop with its partition: per block of the plan a
    band of rows; the products of the preconditioner band by band (Vy^T r
    and Vy t1 over every row, once t1 is complete), each dot product summed
    per block and then over the blocks in rank order."""
    bsz, h, w = b.shape
    blocks, band = tcg.cluster_plan(b.shape, fd is not None)
    bands = [(q * band, min(band, h - q * band)) for q in range(blocks)]
    matvec = tcg.masked_matvec(fluid, face_u, face_v)

    def dot(u, v):
        parts = [(u[:, r0:r0 + n] * v[:, r0:r0 + n]).sum(dim=(1, 2)) for r0, n in bands]
        return torch.stack(parts).sum(0)[:, None, None]

    def minv(r):
        if fd is None:
            return r
        vy, vx, invd = (t.flatten() for t in fd)
        t1, z = torch.empty_like(r), torch.empty_like(r)
        for r0, n in bands:  # t0 = Vy^T r, then t1 = (t0 Vx) * invd on the band
            t0 = _view(vy, r0, 1, h, n, h) @ r
            t1[:, r0:r0 + n] = (t0 @ _view(vx, 0, w, 1, w, w)) * _view(invd, r0 * w, w, 1, n, w)
        for r0, n in bands:  # t2 = Vy t1, then z = t2 Vx^T on the band
            t2 = _view(vy, r0 * h, h, 1, n, h) @ t1
            z[:, r0:r0 + n] = t2 @ _view(vx, 0, 1, w, w, w)
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


@pytest.mark.parametrize("batch,res", [(1, 20), (2, 24), (3, 9)])
@pytest.mark.parametrize("precon", ["fd", "none"])
def test_partition_matches_the_twin_and_jax(batch, res, precon):
    """The emulated partition against the twin and the JAX package's XLA
    loop on karman masks, from a warm start: the iterations and the
    solution. At -r 20, 40 rows in three bands of 16 (the last one of 8);
    at -r 9, 18 rows in two."""
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
        assert abs(it_e - int(it_j)) <= iter_tol
        assert float(np.abs(x_e.numpy() - np.asarray(x_j)).max()) <= rel_tol * scale
