"""The unpreconditioned CG of the PyTorch port against the JAX package (CPU).

* `cg_solve_plain` (kernels/cg.py, the CPU twin of csrc/cg.cu) against the
  Pallas CG kernels in interpret mode with precon=False, as
  tests/test_pallas_cg.py runs them: `_cg_kernel_folded` (batched=True at
  batch 3 and 5) and `_cg_kernel` (batched=False at batch 1), truncated at a
  few iterations and converged, cold and warm;
* its iteration counts against the JAX XLA loop `cg_solve_info`;
* the stopping threshold taken from b, also when warm-started;
* the "cg" route's gradient (`silt::pressure_cg_solve`) against `jax.vjp` of the JAX solve;
* the wrapper's CPU dispatch, the gate, and the route `solve_pressure` takes
  with the preconditioner off (the kernel up to a batch of 128, as the JAX
  package's Pallas kernel).

Tolerances. Truncated iterates are the same float32 arithmetic summed in
another order (the Pallas kernel's folded segment sums, XLA's reductions, and
PyTorch's), 1e-5 of the solution's max. Converged solves stop at the CG
tolerance 1e-5 of ||b|| and the two sides may stop an iteration apart: 1e-4
of the solution's max. The gradient compares at CG tolerance 1e-7, where the
two sides' solves agree to float32 rounding (1e-5), as the train-step test
does: at 1e-5 the JAX side's FD-PCG and the port's plain CG stop at iterates
that differ by the tolerance itself.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.ops import poisson as jp
from solver_in_the_loop_tpu.ops.pallas import cg as jax_pallas_cg
from solver_in_the_loop_tpu.ops.pallas.cg_kernel import fused_cg_solve
from solver_in_the_loop_tpu.physics import karman as jk

from solver_in_the_loop_torch.kernels import cg as tcg
from solver_in_the_loop_torch.ops import poisson as tp
from solver_in_the_loop_torch.physics import karman as tk

torch.set_num_threads(1)


def _rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err} > {rtol}"


def _problem(batch, res=8, seed=0):
    """Karman masks (sphere obstacle), a random RHS and warm start on the
    fluid cells."""
    jdom, tdom = jk.karman_domain(res), tk.karman_domain(res)
    jm, tm = jk.KarmanFlow(jdom).masks, tk.KarmanFlow(tdom).masks
    rng = np.random.RandomState(seed)
    fluid = np.asarray(jm.fluid)
    rhs = (rng.randn(batch, jdom.ny, jdom.nx) * fluid).astype(np.float32)
    x0 = (0.1 * rng.randn(batch, jdom.ny, jdom.nx) * fluid).astype(np.float32)
    return jm, tm, rhs, x0


def _plain(tm, rhs, x0, tol, max_iter):
    x, iters = tcg.cg_solve_plain(torch.from_numpy(rhs), torch.from_numpy(x0), tm.fluid,
                                  tm.face_u, tm.face_v, tol, max_iter)
    return x.numpy(), int(iters)


def _pallas(jm, rhs, x0, tol, max_iter, batched):
    return np.asarray(fused_cg_solve(jnp.asarray(rhs), jm.fluid, jm.face_u, jm.face_v, tol=tol,
                                     max_iter=max_iter, interpret=True, x0=jnp.asarray(x0),
                                     batched=batched, precon=False))


# _cg_kernel_folded at batch 3 and 5, _cg_kernel at batch 1
KERNELS = [(3, True), (5, True), (1, False)]


@pytest.mark.parametrize("batch,batched", KERNELS)
@pytest.mark.parametrize("warm", [False, True])
def test_plain_cg_matches_pallas_cg_kernels_truncated(batch, batched, warm):
    jm, tm, rhs, x0 = _problem(batch, seed=batch + 10 * warm)
    if not warm:
        x0 = np.zeros_like(x0)
    got, iters = _plain(tm, rhs, x0, 1e-12, 6)
    assert iters == 6
    _rel_close(got, _pallas(jm, rhs, x0, 1e-12, 6, batched), 1e-5)


@pytest.mark.parametrize("batch,batched", KERNELS)
def test_plain_cg_matches_pallas_cg_kernels_converged(batch, batched):
    jm, tm, rhs, x0 = _problem(batch, seed=20 + batch)
    got, iters = _plain(tm, rhs, x0, 1e-5, 1000)
    assert 6 < iters < 1000
    _rel_close(got, _pallas(jm, rhs, x0, 1e-5, 1000, batched), 1e-4)


@pytest.mark.parametrize("batch", [1, 3])
def test_plain_cg_matches_jax_cg_solve_info(batch):
    jm, tm, rhs, x0 = _problem(batch, seed=30 + batch)

    def matvec(p):
        return jnp.where(jm.fluid > 0, -jp.masked_laplacian(p, jm.face_u, jm.face_v), p)

    for max_iter, tol in ((5, 1e-12), (1000, 1e-5)):
        want, want_it = jp.cg_solve_info(matvec, jnp.asarray(rhs), tol, max_iter, jnp.asarray(x0))
        got, got_it = _plain(tm, rhs, x0, tol, max_iter)
        assert abs(got_it - int(want_it)) <= 1
        _rel_close(got, want, 1e-5 if max_iter == 5 else 1e-4)


@pytest.mark.parametrize("batch,batched", [(3, True), (1, False)])
def test_threshold_from_b_when_warm_started(batch, batched):
    """Started at a solution whose residual is below tol * ||b||, both sides
    stop at once and hand back the start: the threshold is tol * ||b||, not
    tol * ||r0||, which this start's residual is far above."""
    jm, tm, rhs, _ = _problem(batch, seed=40 + batch)
    near, _ = _plain(tm, rhs, np.zeros_like(rhs), 1e-6, 1000)
    got, iters = _plain(tm, rhs, near, 1e-5, 1000)
    assert iters == 0
    np.testing.assert_array_equal(got, near)
    np.testing.assert_array_equal(_pallas(jm, rhs, near, 1e-5, 1000, batched), near)


@pytest.mark.parametrize("warm", [False, True])
def test_cg_route_gradient_matches_jax_vjp(warm, monkeypatch):
    """solve_pressure with the preconditioner off (the "cg" route, whose
    backward is a cold plain-CG solve) against jax.vjp of the JAX solve."""
    jdom, tdom = jk.karman_domain(8), tk.karman_domain(8)
    jm, tm = jk.KarmanFlow(jdom).masks, tk.KarmanFlow(tdom).masks
    rng = np.random.RandomState(50 + warm)
    fluid = np.asarray(jm.fluid)
    div = (rng.randn(2, jdom.ny, jdom.nx) * fluid).astype(np.float32)
    p0 = (0.1 * rng.randn(2, jdom.ny, jdom.nx)).astype(np.float32)
    cot = rng.randn(2, jdom.ny, jdom.nx).astype(np.float32)  # nonzero on solids too
    x0 = (jnp.asarray(p0), torch.from_numpy(p0)) if warm else (None, None)
    p_j, vjp = jax.vjp(lambda d: jp.solve_pressure(d, jm, tol=1e-7, x0=x0[0]), jnp.asarray(div))
    (want,) = vjp(jnp.asarray(cot))
    div_t = torch.from_numpy(div).requires_grad_()
    calls = []
    real = tcg.cg_solve

    def counted(*args):
        calls.append(args[1].abs().max().item())  # x0 of each solve
        return real(*args)

    monkeypatch.setattr(tcg, "cg_solve", counted)
    p_t, _ = tp.solve_pressure(div_t, tm, tol=1e-7, x0=x0[1], precon="none")
    (got,) = torch.autograd.grad(p_t, div_t, torch.from_numpy(cot))
    assert len(calls) == 2 and calls[1] == 0.0  # the forward, then a cold adjoint
    _rel_close(p_t.detach().numpy(), p_j, 1e-5)
    _rel_close(got.numpy(), want, 1e-5)


def test_cg_solve_wrapper_takes_plain_twin_on_cpu():
    _, tm, rhs, x0 = _problem(2, seed=60)
    args = (torch.from_numpy(rhs), torch.from_numpy(x0), tm.fluid, tm.face_u, tm.face_v,
            1e-5, 1000)
    launches = tcg.cg_solve.launches
    x, iters = tcg.cg_solve(*args)
    x_p, iters_p = tcg.cg_solve_plain(*args)
    assert tcg.cg_solve.launches == launches
    assert torch.equal(x, x_p) and int(iters) == int(iters_p)
    assert iters.dtype == torch.int32 and iters.dim() == 0


def test_cg_kernel_gate():
    for batch in (1, 5, 8):
        assert tcg.cg_kernel_fits((batch, 64, 32))
    assert tcg.cg_kernel_fits((8, 128, 64))  # 8 cells per thread of csrc/cg.cu
    # beyond csrc/cg.cu's registers: the cluster layout, up to the largest
    # element and 256x128 batch the JAX package's gate takes without the
    # preconditioner
    for shape in ((1, 130, 65), (1, 158, 79), (5, 256, 128), (1, 626, 313)):
        assert tcg.cg_kernel_fits(shape) and tcg.cluster_plan(shape, False) is not None
    assert tcg.cg_kernel_fits((9, 64, 32))  # more than one cluster: a cooperative grid
    assert not tcg.cg_kernel_fits((129, 64, 32))  # more blocks than a grid keeps resident
    assert not tcg.cg_kernel_fits((0, 64, 32))
    assert tcg.cg_smem_bytes(64, 32) == 4 * 66 * 33  # p in a halo of zeros


@pytest.mark.parametrize("shape,device,precon,route", [
    ((3, 64, 32), "cuda", "none", "cg"), ((1, 64, 32), "cuda", "fd", "pcg"),
    ((6, 256, 128), "cuda", "none", "multigrid"), ((6, 256, 128), "cuda", "fd", "multigrid"),
    ((2, 128, 64), "cuda", "none", "cg"), ((2, 128, 64), "cuda", "fd", "pcg"),
    ((3, 64, 32), "cpu", "none", "cg"), ((3, 64, 32), "cpu", "fd", "pcg"),
    ((2, 128, 64), "cpu", "none", "multigrid"), ((6, 256, 128), "cpu", "fd", "multigrid"),
])
def test_pressure_route(shape, device, precon, route):
    """The JAX package's dispatch at the Makefile's shapes: the fused kernel
    where its gate takes the shape (at 128x64 both, as the JAX package's
    Pallas kernel takes it on the TPU), multigrid on large open grids; the
    CPU takes multigrid where the JAX package does off the TPU."""
    assert tp.pressure_route(shape, device, precon=precon) == route


# the widths of the grid of OPEN (B, 2W, W) shapes the CUDA route is held to:
# every 12th from 32 to 300, and the karman resolutions at the JAX gate's
# edges (-r 67 and -r 79, refused on the card before the cluster layout;
# 128 and 192; 267 and 268, the largest element and the first beyond)
ROUTE_GRID_W = sorted(set(range(32, 301, 12)) | {64, 67, 79, 128, 192, 267, 268, 300})


def _jax_route(shape, precon):
    """The JAX package's route on the TPU, with both hardware markers: its
    Pallas kernel where its VMEM gate takes the shape, else multigrid where
    it applies, else its XLA FD-PCG loop."""
    est = jax_pallas_cg._vmem_estimate(shape, batched=True, precon=precon == "fd")
    if est < jax_pallas_cg._VMEM_BUDGET_BYTES:
        return "kernel"
    return "multigrid" if jp._mg_applicable(shape) else "xla"


@pytest.mark.parametrize("case", [("grid", w) for w in ROUTE_GRID_W] + [
    ("periodic",), ("cluster",), ("above_max_batch",), ("general",), ("refused_before",),
    ("precon",)])
def test_pressure_route_refusals(case):
    """No OPEN or periodic shape raises on either device. On the grid (B up to
    16 at each width, both precons) the CUDA route is the kernel wherever the
    JAX package's gate takes the shape (its own function, imported), and the
    kernel takes it; multigrid where the JAX package takes that; elsewhere
    the kernel where it takes the shape, else the plain FD-PCG loop, the
    JAX package's XLA route. The port's copy of the gate agrees with it; the
    CPU route is multigrid where it applies, else the kernel's twin."""
    kind = case[0]
    if kind == "grid":
        w = case[1]
        for precon, kernel in (("fd", "pcg"), ("none", "cg")):
            fits = tcg.pcg_kernel_fits if precon == "fd" else tcg.cg_kernel_fits
            for b in range(1, 17):
                shape = (b, 2 * w, w)
                jax_route = _jax_route(shape, precon)
                route = tp.pressure_route(shape, "cuda", precon=precon)
                assert tp.jax_kernel_gate(shape, precon) == (jax_route == "kernel"), shape
                if jax_route == "kernel":
                    assert route == kernel and fits(shape), (shape, precon, route)
                elif jax_route == "multigrid":
                    assert route == "multigrid", (shape, precon, route)
                else:
                    assert route == (kernel if fits(shape) else "pcg_plain"), (shape, precon)
                cpu = tp.pressure_route(shape, "cpu", precon=precon)
                assert cpu == ("multigrid" if jp._mg_applicable(shape) else kernel), shape
    elif kind == "periodic":
        # the plain CG loop on either device, the JAX package's route there
        for device in ("cuda", "cpu"):
            for precon in ("fd", "none"):
                assert tp.pressure_route((1, 32, 32), device, periodic=True,
                                         precon=precon) == "periodic_cg"
    elif kind == "cluster":
        # more than one cluster: the kernel as a cooperative grid, as the JAX
        # package's Pallas kernel takes it
        for precon, kernel in (("fd", "pcg"), ("none", "cg")):
            assert tp.pressure_route((9, 64, 32), "cuda", precon=precon) == kernel
            assert tp.pressure_route((9, 64, 32), "cpu", precon=precon) == kernel
    elif kind == "above_max_batch":
        # more than one resident grid: the plain FD-PCG loop on either device,
        # the JAX package's XLA route there, either precon
        for precon in ("fd", "none"):
            assert tp.pressure_route((129, 64, 32), "cuda", precon=precon) == "pcg_plain"
            assert tp.pressure_route((129, 64, 32), "cpu", precon=precon) == "pcg_plain"
    elif kind == "general":
        # -r 48 and -r 65: off multigrid, where the JAX package takes its
        # Pallas kernel
        for precon, kernel in (("fd", "pcg"), ("none", "cg")):
            for shape in ((1, 96, 48), (1, 130, 65)):
                assert tp.pressure_route(shape, "cuda", precon=precon) == kernel
                assert tp.pressure_route(shape, "cpu", precon=precon) == kernel
    elif kind == "refused_before":
        # beyond the one-block layouts off multigrid's sizes, once refused on
        # the card: the cluster layout
        assert tp.pressure_route((1, 134, 67), "cuda", precon="fd") == "pcg"
        assert tp.pressure_route((1, 134, 67), "cuda", precon="none") == "cg"
        assert tp.pressure_route((1, 134, 67), "cpu", precon="fd") == "pcg"
        assert tp.pressure_route((1, 158, 79), "cuda", precon="none") == "cg"
        assert tp.pressure_route((1, 534, 267), "cuda", precon="fd") == "pcg"
        # the PRE generator's hi-res solves: the kernel, as the JAX package
        # takes its Pallas kernel at (1..3, 256, 128), multigrid at 6
        assert tp.pressure_route((3, 256, 128), "cuda", precon="fd") == "pcg"
        assert tp.pressure_route((5, 256, 128), "cuda", precon="none") == "cg"
        assert tp.pressure_route((6, 256, 128), "cuda", precon="fd") == "multigrid"
    else:
        with pytest.raises(ValueError):
            tp.pressure_route((1, 64, 32), "cpu", precon="jacobi")
