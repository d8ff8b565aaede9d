"""The PCG kernel's preconditioner in 3xTF32, emulated on the CPU, against the
JAX package's PCG.

csrc/pcg.cu runs the four products of z = Vy ((Vy^T r Vx) * invd) Vx^T on the
tensor cores in TF32 and cannot run here. This test runs the port's PCG loop
(kernels/cg.py `pcg_solve_info`, the loop of the kernel's twin) with a
preconditioner whose products round as the kernel's do: each operand split
into big = tf32(a) and small = tf32(a - big) (csrc/tf32.cuh `split_tf32`,
emulated bit for bit by `_tf32`, as in tests/test_torch_conv.py), the products
big*big + (big*small + small*big) in fp32, flushed into an fp32 total every
4 k-steps of 8 (32 terms), the products in the kernel's order (Vy^T r, its
product with Vx times invd, Vy times that, its product with Vx^T). The
tensor cores' own order within a k-step is not emulated, so the emulation
is held to the kernel's tolerances, not to its bits.

On karman masks at (1, 64, 32) and (3, 64, 32), cold and warm, built as
tests/test_torch_poisson.py builds them, it stays within PCG_ITER_TOL
iterations and PCG_REL_TOL of the solution's max of the JAX package's CPU
`pcg_solve_info` (the XLA reference, in fp32). One TF32 product (1xTF32) is
recorded beside it: at 64x32 it takes 24 iterations where JAX takes 20, so
the kernel pays for three.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.ops import poisson as jp
from solver_in_the_loop_tpu.physics import karman as jk

from solver_in_the_loop_torch.kernels import cg as tcg
from solver_in_the_loop_torch.ops import poisson as tp
from solver_in_the_loop_torch.parity import PCG_ITER_TOL, PCG_REL_TOL
from solver_in_the_loop_torch.physics import karman as tk

torch.set_num_threads(1)

FLUSH_TERMS = 32  # csrc/pcg.cu: kFlushSteps (4) k-steps of 8


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, on the bits: as csrc/tf32.cuh `split_tf32` rounds (a copy of
    tests/test_torch_conv.py `_tf32`)."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b over the last two axes with TF32 operands and fp32 sums, in
    chunks of FLUSH_TERMS along k, each chunk's three products added as
    big*big + (big*small + small*big) into the running total (terms=3), or
    big*big alone (terms=1)."""
    total = None
    for k0 in range(0, a.shape[-1], FLUSH_TERMS):
        ac, bc = a[..., k0:k0 + FLUSH_TERMS], b[..., k0:k0 + FLUSH_TERMS, :]
        a_big, b_big = _tf32(ac), _tf32(bc)
        part = a_big @ b_big
        if terms == 3:
            part = part + (a_big @ _tf32(bc - b_big) + _tf32(ac - a_big) @ b_big)
        total = part if total is None else total + part
    return total


def tf32_fd_apply(vy, vx, invd, terms: int):
    """The FD preconditioner with its four products as the kernel runs them."""
    vy_t, vx_t = vy.T.contiguous(), vx.T.contiguous()

    def minv(r):
        t0 = _tf32_matmul(vy_t, r, terms)  # Vy^T r
        t1 = _tf32_matmul(t0, vx, terms) * invd
        t0 = _tf32_matmul(vy, t1, terms)  # Vy t1
        return _tf32_matmul(t0, vx_t, terms)

    return minv


def _problem(batch, seed=0):
    """Karman masks (64x32, sphere obstacle) and a random RHS and warm start
    on the fluid cells, as tests/test_torch_poisson.py builds them."""
    jdom, tdom = jk.karman_domain(32), tk.karman_domain(32)
    jflow, tflow = jk.KarmanFlow(jdom), tk.KarmanFlow(tdom)
    rng = np.random.RandomState(seed)
    fluid = np.asarray(jflow.masks.fluid)
    rhs = (rng.randn(batch, jdom.ny, jdom.nx) * fluid).astype(np.float32)
    x0 = (0.1 * rng.randn(batch, jdom.ny, jdom.nx) * fluid).astype(np.float32)
    return jflow.masks, tflow.masks, rhs, x0


def _solves(batch, warm, terms):
    """(port's PCG with the emulated preconditioner, JAX's PCG): each (x, iterations)."""
    jm, tm, rhs, x0 = _problem(batch)
    if not warm:
        x0 = np.zeros_like(x0)

    def matvec(p):
        return jnp.where(jm.fluid > 0, -jp.masked_laplacian(p, jm.face_u, jm.face_v), p)

    want, want_it = jp.pcg_solve_info(matvec, jp.fd_minv(64, 32), jnp.asarray(rhs), 1e-5, 1000,
                                      jnp.asarray(x0))
    vy, vx, invd = tp.fd_factors(64, 32, torch.device("cpu"))
    got, got_it = tcg.pcg_solve_info(tcg.masked_matvec(tm.fluid, tm.face_u, tm.face_v),
                                     tf32_fd_apply(vy, vx, invd, terms), torch.from_numpy(rhs),
                                     1e-5, 1000, torch.from_numpy(x0))
    return (got.numpy(), got_it), (np.asarray(want), int(want_it))


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_three_tf32_preconditioner_matches_jax_pcg(batch, warm):
    (got, got_it), (want, want_it) = _solves(batch, warm, terms=3)
    assert abs(got_it - want_it) <= PCG_ITER_TOL, (got_it, want_it)
    assert _rel(got, want) <= PCG_REL_TOL


@pytest.mark.parametrize("warm", [False, True])
def test_one_tf32_product_is_recorded_and_misses_the_iteration_bound(warm):
    """The record beside the kernel's choice: with one TF32 product per
    matrix product the PCG still converges, within 2e-5 of JAX's solution,
    but 4 iterations later at 64x32 (24 against 20), beyond PCG_ITER_TOL."""
    (got, got_it), (want, want_it) = _solves(3, warm, terms=1)
    assert got_it - want_it > PCG_ITER_TOL, (got_it, want_it)
    assert got_it < 1000 and _rel(got, want) <= 2e-5, (got_it, _rel(got, want))


def test_split_matches_the_kernel_rule():
    """The emulated split is the kernel's: big keeps 10 mantissa bits,
    rounded to nearest with ties away from zero, and big + small is the
    operand to within 2^-22 of its magnitude."""
    a = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -12), 3.0e-3])
    big = _tf32(a)
    assert big.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), float(_tf32(a[4:]))]
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((big + _tf32(a - big) - a).abs() <= a.abs() * 2.0 ** -22).all()
