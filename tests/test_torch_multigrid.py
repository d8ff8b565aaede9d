"""The port's multigrid-preconditioned CG against the JAX package (CPU).

ops/multigrid.py against solver_in_the_loop_tpu/ops/multigrid.py on the
karman masks: the hierarchy (depth, every level's masks and smoother
diagonal), one V-cycle, the preconditioned CG truncated and converged, cold
and warm, and the multigrid route's gradient through `solve_pressure`.

Tolerances. The masks are exact (0/1 arithmetic). A V-cycle and truncated
iterates are the same float32 formulas summed in another order, 1e-5 of the
result's max. Converged solves stop at the CG tolerance 1e-5 of ||b||, and
the two sides may stop an iteration apart: 1e-4 of the solution's max. The
gradient compares at CG tolerance 1e-7, as tests/test_torch_cg.py does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.ops import multigrid as jmg
from solver_in_the_loop_tpu.ops import poisson as jp
from solver_in_the_loop_tpu.physics import karman as jk

from solver_in_the_loop_torch.ops import multigrid as tmg
from solver_in_the_loop_torch.ops import poisson as tp
from solver_in_the_loop_torch.physics import karman as tk

torch.set_num_threads(1)


def _rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err} > {rtol}"


def _hierarchies(res):
    jdom, tdom = jk.karman_domain(res), tk.karman_domain(res)
    jm, tm = jk.KarmanFlow(jdom).masks, tk.KarmanFlow(tdom).masks
    return (jmg.build_mg_hierarchy(jm, jdom), tmg.build_mg_hierarchy(tm, tdom), jm, tm,
            np.asarray(jm.fluid))


def _rhs(fluid, batch, seed):
    rng = np.random.RandomState(seed)
    shape = (batch,) + fluid.shape[1:]
    return ((rng.randn(*shape) * fluid).astype(np.float32),
            (0.1 * rng.randn(*shape) * fluid).astype(np.float32))


@pytest.mark.parametrize("res,depth", [(8, 1), (16, 2), (32, 3), (64, 4)])
def test_hierarchy_matches_jax(res, depth):
    """Levels down to a smaller side of 8 (64x32 -> 32x16 -> 16x8)."""
    jh, th, *_ = _hierarchies(res)
    assert len(th.levels) == len(jh.levels) == depth
    assert (th.smooth_iters, th.omega) == (jh.smooth_iters, jh.omega) == (2, 0.8)
    for jl, tl in zip(jh.levels, th.levels):
        for name in ("fluid", "face_u", "face_v"):
            np.testing.assert_array_equal(getattr(tl.masks, name).numpy(),
                                          np.asarray(getattr(jl.masks, name)))
        np.testing.assert_array_equal(tl.diag.numpy(), np.asarray(jl.diag))


def test_level_diag_is_not_the_kernels_diag():
    """Solid cells get 1 and fluid cells at least 1e-6, where the CG kernels'
    diag is the face sum as it is."""
    _, th, _, tm, fluid = _hierarchies(32)
    faces = (tm.face_u[:, :, 1:] + tm.face_u[:, :, :-1] + tm.face_v[:, 1:, :]
             + tm.face_v[:, :-1, :]).numpy()
    diag = th.levels[0].diag.numpy()
    assert (fluid == 0).any() and np.all(diag[fluid == 0] == 1.0)
    np.testing.assert_array_equal(diag[fluid > 0], faces[fluid > 0])
    assert np.all(faces[fluid == 0] == 0.0)


@pytest.mark.parametrize("res", [16, 32])
def test_v_cycle_matches_jax(res):
    jh, th, _, _, fluid = _hierarchies(res)
    b, _ = _rhs(fluid, 2, seed=res)
    _rel_close(tmg.v_cycle(th, torch.from_numpy(b)).numpy(),
               jmg.v_cycle(jh, jnp.asarray(b)), 1e-5)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("max_iter,tol", [(3, 1e-12), (200, 1e-5)])
def test_mg_pcg_solve_matches_jax(warm, max_iter, tol):
    jh, th, _, _, fluid = _hierarchies(32)
    b, x0 = _rhs(fluid, 3, seed=7 + warm)
    want = jmg.mg_pcg_solve(jh, jnp.asarray(b), tol, max_iter,
                            jnp.asarray(x0) if warm else None)
    got, iters = tmg.mg_pcg_solve(th, torch.from_numpy(b), tol, max_iter,
                                  torch.from_numpy(x0) if warm else None)
    assert iters == max_iter if max_iter == 3 else 0 < iters < 50
    _rel_close(got.numpy(), want, 1e-5 if max_iter == 3 else 1e-4)


@pytest.mark.parametrize("warm", [False, True])
def test_mg_route_gradient_matches_jax_vjp(warm, monkeypatch):
    """solve_pressure at 128x64, where the CPU takes the multigrid route
    (whose backward is a cold multigrid solve), against
    jax.vjp of the JAX multigrid solve."""
    _, _, jm, tm, fluid = _hierarchies(64)
    div, p0 = _rhs(fluid, 2, seed=11 + warm)
    assert tp.pressure_route(div.shape, "cpu") == "multigrid"
    cot = np.random.RandomState(13).randn(*div.shape).astype(np.float32)  # solids too
    x0 = (jnp.asarray(p0), torch.from_numpy(p0)) if warm else (None, None)
    p_j, vjp = jax.vjp(lambda d: jp.solve_pressure(d, jm, tol=1e-7, backend="mg", x0=x0[0]),
                       jnp.asarray(div))
    (want,) = vjp(jnp.asarray(cot))
    starts = []
    real = tmg.mg_solve

    def counted(*args):
        starts.append(float(args[1].abs().max()))
        return real(*args)

    monkeypatch.setattr(tmg, "mg_solve", counted)
    div_t = torch.from_numpy(div).requires_grad_()
    p_t, iters = tp.solve_pressure(div_t, tm, tol=1e-7, x0=x0[1])
    (got,) = torch.autograd.grad(p_t, div_t, torch.from_numpy(cot))
    assert len(starts) == 2 and starts[1] == 0.0  # the forward, then a cold adjoint
    assert int(iters) > 0
    _rel_close(p_t.detach().numpy(), p_j, 1e-5)
    _rel_close(got.numpy(), want, 1e-5)


def test_hierarchy_built_once_per_mask_set(monkeypatch):
    """The forward solves and their adjoints on one flow's masks share one
    hierarchy; other masks get their own."""
    builds = []
    real = tmg.build_mg_hierarchy

    def counted(*args):
        builds.append(args[0])
        return real(*args)

    monkeypatch.setattr(tmg, "build_mg_hierarchy", counted)
    monkeypatch.setattr(tmg, "_HIERARCHIES", {})
    tm = tk.KarmanFlow(tk.karman_domain(64)).masks
    div = torch.from_numpy(_rhs(tm.fluid.numpy(), 2, seed=3)[0]).requires_grad_()
    for _ in range(2):
        p, _ = tp.solve_pressure(div, tm)
        p.sum().backward()
    assert len(builds) == 1 and builds[0].fluid is tm.fluid
    other = tk.KarmanFlow(tk.karman_domain(64)).masks
    tp.solve_pressure(div.detach(), other)
    assert len(builds) == 2 and builds[1].fluid is other.fluid
