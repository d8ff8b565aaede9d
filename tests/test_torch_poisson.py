"""Pressure solve of the PyTorch port against the JAX package on the CPU.

* projection masks and the fast-diagonalization (FD) preconditioner;
* the plain PCG (kernels/cg.py, the CPU twin of csrc/pcg.cu) against the JAX
  XLA `pcg_solve_info` and against the Pallas PCG kernels in interpret mode,
  `_pcg_kernel` (batch 1) and `_pcg_kernel_folded` (batch 3), as
  tests/test_pallas_cg.py runs them: truncated at a small iteration count,
  where CG is a fixed sequence of float32 operations;
* `solve_pressure` with a warm start and `make_incompressible`;
* the CUDA dispatch gate, the multigrid route at the size where the JAX
  package takes it, and a batch of more than one cluster (9, 64, 32), which
  the kernels take: solution and gradient against the JAX package's.

Tolerances: truncated iterates are the same arithmetic in another summation
order (XLA/Pallas reductions and matmuls vs PyTorch's), 1e-5 relative.
Converged solves stop at the CG tolerance 1e-5 of ||b||, and the two sides
may stop one iteration apart: rtol 1e-4 of the solution's max.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.core import grids as jg
from solver_in_the_loop_tpu.ops import poisson as jp
from solver_in_the_loop_tpu.ops.pallas.cg_kernel import fused_cg_solve
from solver_in_the_loop_tpu.physics import karman as jk

from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.core import grids as tg
from solver_in_the_loop_torch.kernels import cg as tcg
from solver_in_the_loop_torch.ops import poisson as tp
from solver_in_the_loop_torch.physics import karman as tk

torch.set_num_threads(1)


def _rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err} > {rtol}"


def _problem(batch, res=8, seed=0):
    """Karman masks (sphere obstacle) and a random RHS on the fluid cells."""
    jdom, tdom = jk.karman_domain(res), tk.karman_domain(res)
    jflow, tflow = jk.KarmanFlow(jdom), tk.KarmanFlow(tdom)
    rng = np.random.RandomState(seed)
    fluid = np.asarray(jflow.masks.fluid)
    rhs = (rng.randn(batch, jdom.ny, jdom.nx) * fluid).astype(np.float32)
    x0 = (0.1 * rng.randn(batch, jdom.ny, jdom.nx) * fluid).astype(np.float32)
    return jflow.masks, tflow.masks, rhs, x0


@pytest.mark.parametrize("boundary", ["OPEN", "PERIODIC"])
def test_masks_from_fluid_cells(boundary):
    fluid = (np.random.RandomState(1).rand(1, 10, 6) > 0.3).astype(np.float32)
    jm = jp.masks_from_fluid_cells(jnp.asarray(fluid),
                                   jg.Domain((10, 6), (10.0, 6.0), jg.Boundary[boundary]))
    tm = tp.masks_from_fluid_cells(torch.from_numpy(fluid),
                                   tg.Domain((10, 6), (10.0, 6.0), tg.Boundary[boundary]))
    for name in ("fluid", "face_u", "face_v"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))


def test_fd_preconditioner():
    for a, b in zip(tp._fd_precon_np(16, 8), jp._fd_precon_np(16, 8)):
        np.testing.assert_array_equal(a, b)
    r = np.random.RandomState(2).randn(2, 16, 8).astype(np.float32)
    _rel_close(tp.fd_minv(16, 8)(torch.from_numpy(r)).numpy(), jp.fd_minv(16, 8)(jnp.asarray(r)),
               1e-5)


def _plain(tmasks, rhs, x0, tol, max_iter):
    vy, vx, invd = tp.fd_factors(rhs.shape[1], rhs.shape[2], torch.device("cpu"))
    x, iters = tcg.pcg_solve_plain(torch.from_numpy(rhs), torch.from_numpy(x0), tmasks.fluid,
                                   tmasks.face_u, tmasks.face_v, vy, vx, invd, tol, max_iter)
    return x.numpy(), int(iters)


@pytest.mark.parametrize("batch", [1, 3])
def test_plain_pcg_matches_jax_pcg_solve_info(batch):
    jm, tm, rhs, x0 = _problem(batch)

    def matvec(p):
        return jnp.where(jm.fluid > 0, -jp.masked_laplacian(p, jm.face_u, jm.face_v), p)

    minv = jp.fd_minv(rhs.shape[1], rhs.shape[2])
    for max_iter, tol in ((4, 1e-12), (1000, 1e-5)):
        want, want_it = jp.pcg_solve_info(matvec, minv, jnp.asarray(rhs), tol, max_iter,
                                          jnp.asarray(x0))
        got, got_it = _plain(tm, rhs, x0, tol, max_iter)
        assert abs(got_it - int(want_it)) <= 1
        _rel_close(got, want, 1e-5 if max_iter == 4 else 1e-4)


@pytest.mark.parametrize("batch", [1, 3])  # _pcg_kernel at 1, _pcg_kernel_folded at 3
@pytest.mark.parametrize("warm", [False, True])
def test_plain_pcg_matches_pallas_pcg_kernels(batch, warm):
    jm, tm, rhs, x0 = _problem(batch, seed=3)
    if not warm:
        x0 = np.zeros_like(x0)
    iters = 5
    want = fused_cg_solve(jnp.asarray(rhs), jm.fluid, jm.face_u, jm.face_v, tol=1e-12,
                          max_iter=iters, interpret=True, x0=jnp.asarray(x0), batched=True,
                          precon=True)
    got, got_it = _plain(tm, rhs, x0, 1e-12, iters)
    assert got_it == iters
    _rel_close(got, want, 1e-5)


def test_pcg_solve_wrapper_takes_plain_twin_on_cpu():
    _, tm, rhs, x0 = _problem(2, seed=4)
    vy, vx, invd = tp.fd_factors(rhs.shape[1], rhs.shape[2], torch.device("cpu"))
    args = (torch.from_numpy(rhs), torch.from_numpy(x0), tm.fluid, tm.face_u, tm.face_v,
            vy, vx, invd, 1e-5, 1000)
    launches = tcg.pcg_solve.launches
    x, iters = tcg.pcg_solve(*args)
    x_p, iters_p = tcg.pcg_solve_plain(*args)
    assert tcg.pcg_solve.launches == launches
    assert torch.equal(x, x_p) and int(iters) == int(iters_p)
    assert iters.dtype == torch.int32 and iters.dim() == 0


@pytest.mark.parametrize("warm", [False, True])
def test_solve_pressure(warm):
    jm, tm, div, p0 = _problem(2, seed=5)
    x0 = (jnp.asarray(p0), torch.from_numpy(p0)) if warm else (None, None)
    want = jp.solve_pressure(jnp.asarray(div), jm, x0=x0[0])
    got, iters = tp.solve_pressure(torch.from_numpy(div), tm, x0=x0[1])
    _rel_close(got.numpy(), want, 1e-4)
    assert 0 < int(iters) < 1000


def test_make_incompressible():
    jdom, tdom = jk.karman_domain(8), tk.karman_domain(8)
    jm, tm = jk.KarmanFlow(jdom).masks, tk.KarmanFlow(tdom).masks
    rng = np.random.RandomState(6)
    u = rng.randn(2, jdom.ny, jdom.nx + 1).astype(np.float32)
    v = (1.0 + rng.randn(2, jdom.ny + 1, jdom.nx)).astype(np.float32)
    p0 = rng.randn(2, jdom.ny, jdom.nx).astype(np.float32)
    jvel, jpres = jp.make_incompressible(jg.StaggeredGrid(jnp.asarray(u), jnp.asarray(v), jdom),
                                         jm, p0=jnp.asarray(p0))
    tvel, tpres, _ = tp.make_incompressible(
        tg.StaggeredGrid(torch.from_numpy(u), torch.from_numpy(v), tdom), tm,
        p0=torch.from_numpy(p0))
    _rel_close(tpres.numpy(), jpres, 1e-4)
    _rel_close(tvel.u.numpy(), jvel.u, 1e-4)
    _rel_close(tvel.v.numpy(), jvel.v, 1e-4)


def test_kernel_gate():
    assert tcg.pcg_kernel_fits((1, 64, 32))
    assert tcg.pcg_kernel_fits((5, 64, 32))
    assert tcg.pcg_kernel_fits((8, 64, 32))
    assert tcg.pcg_kernel_fits((9, 64, 32))  # more than one cluster: a cooperative grid
    assert not tcg.pcg_kernel_fits((129, 64, 32))  # more blocks than a grid keeps resident
    # off the fast layout, the cluster layout: -r 48, -r 65, 128x64, -r 67
    # (once beyond shared memory), 256x128 at the JAX gate's batches and the
    # largest element it takes
    for shape in ((1, 96, 48), (1, 130, 65), (3, 128, 64), (1, 134, 67), (1, 256, 128),
                  (3, 256, 128), (1, 534, 267)):
        assert tcg.pcg_kernel_fits(shape) and tcg.cluster_plan(shape, True) is not None
    assert tcg.cluster_plan((1, 64, 32), True) == (4, 16)  # takes it, but the fast layout runs
    # the fast layout at 64x32 (csrc/pcg.cu pcg_layout); the cluster layout's
    # buffers at 256x128 in its L2 variant: z (16 rows of stride 136) and t0
    # (16 of 132)
    assert tcg.pcg_smem_bytes(64, 32) == 4 * 21072
    assert tcg.cluster_smem_bytes(16, 256, 128, True, False) == 4 * (16 * 136 + 16 * 132)


def test_multigrid_sizes_raise_on_cpu():
    """Where the JAX package solves with multigrid (128x64 and up), the port
    once raised; it now takes its own multigrid there, on the CPU as the JAX
    package does off the TPU, and agrees with the JAX solve."""
    jm, tm, div, p0 = _problem(2, res=64, seed=7)
    assert tp.pressure_route(div.shape, "cpu") == "multigrid"
    want = jp.solve_pressure(jnp.asarray(div), jm, x0=jnp.asarray(p0))
    got, iters = tp.solve_pressure(torch.from_numpy(div), tm, x0=torch.from_numpy(p0))
    _rel_close(got.numpy(), want, 1e-4)
    assert 0 < int(iters) < 200


@pytest.mark.parametrize("precon", ["fd", "none"])
@pytest.mark.parametrize("warm", [False, True])
def test_batch_above_a_cluster_matches_jax(precon, warm):
    """At (9, 64, 32), more than one cluster, the card runs the kernel that
    precon names as a cooperative grid, and the CPU its twin, which stops
    the whole batch together as the JAX package's solves do. Solution within
    PCG_REL_TOL and gradient within the train-gradient tolerance of the JAX
    package's solve_pressure (its XLA FD-PCG off the TPU)."""
    kernel = {"fd": "pcg", "none": "cg"}[precon]
    assert tp.pressure_route((9, 64, 32), "cuda", precon=precon) == kernel
    assert tp.pressure_route((9, 64, 32), "cpu", precon=precon) == kernel
    jm, tm, div, p0 = _problem(9, res=32, seed=8 + warm)
    cot = np.random.RandomState(10).randn(*div.shape).astype(np.float32)
    x0 = (jnp.asarray(p0), torch.from_numpy(p0)) if warm else (None, None)
    p_j, vjp = jax.vjp(lambda d: jp.solve_pressure(d, jm, x0=x0[0]), jnp.asarray(div))
    (want,) = vjp(jnp.asarray(cot))
    div_t = torch.from_numpy(div).requires_grad_()
    p_t, iters = tp.solve_pressure(div_t, tm, x0=x0[1], precon=precon)
    (got,) = torch.autograd.grad(p_t, div_t, torch.from_numpy(cot))
    _rel_close(p_t.detach().numpy(), p_j, parity.PCG_REL_TOL)
    _rel_close(got.numpy(), want, parity.TRAIN_PARITY_TOL["head_grad"])
    assert 0 < int(iters) < 1000


# (B, H, W, precon) of a batch above MAX_BATCH: the gate is on the batch,
# so a narrow field
PLAIN_ROUTE_CASES = [(129, 16, 8, "fd"), (129, 16, 8, "none")]


@pytest.mark.parametrize("case", PLAIN_ROUTE_CASES)
@pytest.mark.parametrize("warm", [False, True])
def test_plain_fd_pcg_route_matches_jax(case, warm):
    """A batch above MAX_BATCH runs the plain FD-PCG loop on either device
    and with either precon (`pressure_route` "pcg_plain"), the JAX
    package's XLA FD-PCG there: the solution within PCG_REL_TOL and the
    gradient within the train-gradient tolerance of its solve_pressure."""
    *shape, precon = case
    assert tp.pressure_route(shape, "cuda", precon=precon) == "pcg_plain"
    jm, tm, div, p0 = _problem(shape[0], res=shape[2], seed=11 + warm)
    cot = np.random.RandomState(12).randn(*div.shape).astype(np.float32)
    x0 = (jnp.asarray(p0), torch.from_numpy(p0)) if warm else (None, None)
    p_j, vjp = jax.vjp(lambda d: jp.solve_pressure(d, jm, x0=x0[0]), jnp.asarray(div))
    (want,) = vjp(jnp.asarray(cot))
    div_t = torch.from_numpy(div).requires_grad_()
    p_t, iters = tp.solve_pressure(div_t, tm, x0=x0[1], precon=precon)
    assert p_t.grad_fn.route == "pcg_plain"
    (got,) = torch.autograd.grad(p_t, div_t, torch.from_numpy(cot))
    _rel_close(p_t.detach().numpy(), p_j, parity.PCG_REL_TOL)
    _rel_close(got.numpy(), want, parity.TRAIN_PARITY_TOL["head_grad"])
    assert 0 < int(iters) < 1000


# (B, H, W, precon) off multigrid's sizes and off the one-block layouts,
# where the JAX package takes its Pallas kernel and the port the cluster
# layout: -r 48, -r 65, and -r 67 and -r 79, which the card once refused
GENERAL_LAYOUT_CASES = [(1, 96, 48, "fd"), (1, 130, 65, "fd"), (1, 130, 65, "none"),
                        (1, 134, 67, "fd"), (1, 158, 79, "none")]


@pytest.mark.parametrize("case", GENERAL_LAYOUT_CASES)
@pytest.mark.parametrize("warm", [False, True])
def test_general_layout_route_matches_jax(case, warm):
    """Where the JAX package takes its Pallas kernel off multigrid's sizes
    and the port's kernels take the element only in their cluster layout,
    solve_pressure takes the kernel the precon names, here its plain twin:
    the solution and gradient against the JAX package's solve_pressure
    (its XLA FD-PCG off the TPU), with the tolerances above."""
    *shape, precon = case
    route = "pcg" if precon == "fd" else "cg"
    assert tp.pressure_route(shape, "cuda", precon=precon) == route
    jm, tm, div, p0 = _problem(shape[0], res=shape[2], seed=13 + warm)
    cot = np.random.RandomState(14).randn(*div.shape).astype(np.float32)
    x0 = (jnp.asarray(p0), torch.from_numpy(p0)) if warm else (None, None)
    p_j, vjp = jax.vjp(lambda d: jp.solve_pressure(d, jm, x0=x0[0]), jnp.asarray(div))
    (want,) = vjp(jnp.asarray(cot))
    div_t = torch.from_numpy(div).requires_grad_()
    p_t, iters = tp.solve_pressure(div_t, tm, x0=x0[1], precon=precon)
    assert p_t.grad_fn.route == route
    (got,) = torch.autograd.grad(p_t, div_t, torch.from_numpy(cot))
    _rel_close(p_t.detach().numpy(), p_j, parity.PCG_REL_TOL)
    _rel_close(got.numpy(), want, parity.TRAIN_PARITY_TOL["head_grad"])
    assert 0 < int(iters) < 1000


@pytest.mark.parametrize("warm", [False, True])
def test_periodic_solve_matches_jax(warm):
    """A periodic problem takes the plain CG loop on either device
    (`pressure_route` "periodic_cg"), the JAX package's XLA CG there, as a
    differentiable op whose backward is a cold solve of the same system, as
    the JAX package's custom_linear_solve transposes it: the solution and
    the gradient of a random cotangent against JAX solve_pressure(periodic=
    True), with the tolerances above and the train-gradient tolerance. The
    right-hand side and the cotangent have zero mean on the fluid cells,
    whose constants are the periodic operator's null space."""
    h, w = 24, 20
    fluid = np.ones((1, h, w), np.float32)
    fluid[:, 8:14, 6:11] = 0.0
    jm = jp.masks_from_fluid_cells(jnp.asarray(fluid),
                                   jg.Domain((h, w), (float(h), float(w)), jg.Boundary.PERIODIC))
    tm = tp.masks_from_fluid_cells(torch.from_numpy(fluid),
                                   tg.Domain((h, w), (float(h), float(w)), tg.Boundary.PERIODIC))
    rng = np.random.RandomState(15 + warm)

    def zero_mean(a):
        a = a * fluid
        return (a - fluid * a.sum(axis=(1, 2), keepdims=True) / fluid.sum()).astype(np.float32)

    div, cot = zero_mean(rng.randn(2, h, w)), zero_mean(rng.randn(2, h, w))
    p0 = (0.1 * rng.randn(2, h, w) * fluid).astype(np.float32)
    x0 = (jnp.asarray(p0), torch.from_numpy(p0)) if warm else (None, None)
    assert tp.pressure_route(div.shape, "cuda", periodic=True) == "periodic_cg"
    p_j, vjp = jax.vjp(lambda d: jp.solve_pressure(d, jm, periodic=True, x0=x0[0]),
                       jnp.asarray(div))
    (want,) = vjp(jnp.asarray(cot))
    div_t = torch.from_numpy(div).requires_grad_()
    p_t, iters = tp.solve_pressure(div_t, tm, periodic=True, x0=x0[1])
    assert p_t.grad_fn.route == "periodic_cg"
    (got,) = torch.autograd.grad(p_t, div_t, torch.from_numpy(cot))
    _rel_close(p_t.detach().numpy(), p_j, parity.PCG_REL_TOL)
    _rel_close(got.numpy(), want, parity.TRAIN_PARITY_TOL["head_grad"])
    assert 0 < int(iters) < 1000
