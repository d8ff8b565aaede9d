"""Gradients of the port's advection and pressure solve against the JAX
package on the CPU.

* `tap_sum_bwd_plain` (the CPU twin of csrc/advect.cu's backward kernel)
  against the Pallas `_bwd_kernel` in interpret mode, and the port's
  `shifted_stencil_sample` backward against `jax.vjp` of the JAX XLA loop;
* the offset clamps' gradient at exact bounds against `jax.grad`;
* `semi_lagrangian` (shift) gradients on staggered fields;
* `solve_pressure`'s gradient against `jax.vjp` of the JAX solve, cold and
  warm, with a cotangent that is nonzero on solid cells.

Tolerances. The tap-sum's backward is the same float32 formula on both sides;
the sums run in another order (the Pallas kernel accumulates rolled arrays,
XLA's autodiff its own transposes), so 1e-6 relative to each cotangent's max.
The pressure gradient is a CG solve to tol 1e-5 on both sides, and the two
may stop one iteration apart: 1e-4 of the gradient's max.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.core import grids as jg
from solver_in_the_loop_tpu.ops import advection as ja
from solver_in_the_loop_tpu.ops import interp as ji
from solver_in_the_loop_tpu.ops import poisson as jp
from solver_in_the_loop_tpu.ops.pallas import advect_kernel as ak
from solver_in_the_loop_tpu.physics import karman as jk

from solver_in_the_loop_torch.core import grids as tg
from solver_in_the_loop_torch.kernels.advect import tap_sum, tap_sum_bwd, tap_sum_bwd_plain
from solver_in_the_loop_torch.ops import advection as ta
from solver_in_the_loop_torch.ops import interp as ti
from solver_in_the_loop_torch.ops import poisson as tp
from solver_in_the_loop_torch.physics import karman as tk

torch.set_num_threads(1)

M = 2
TOL = 1e-6


def _rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err} > {rtol}"


def _case(shape, offsets, seed):
    rng = np.random.RandomState(seed)
    values = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    if offsets == "integer":  # exact integers hit the kinks and the max ties
        dy = rng.randint(-M - 1, M + 2, shape).astype(np.float32)
        dx = rng.randint(-M - 1, M + 2, shape).astype(np.float32)
    else:  # beyond +-m, so the clamps act
        dy = (2.0 * rng.randn(*shape)).astype(np.float32)
        dx = (2.0 * rng.randn(*shape)).astype(np.float32)
    return values, dy, dx, g


def _clamped(shape, dy, dx, periodic):
    """The offsets the tap-sum receives: the caller's clamps (interp.py)."""
    dy, dx = np.clip(dy, -M, M), np.clip(dx, -M, M)
    if not periodic:
        jj = np.arange(shape[1], dtype=np.float32)[None, :, None]
        ii = np.arange(shape[2], dtype=np.float32)[None, None, :]
        dy = np.clip(jj + dy, 0.0, shape[1] - 1.0) - jj
        dx = np.clip(ii + dx, 0.0, shape[2] - 1.0) - ii
    return dy.astype(np.float32), dx.astype(np.float32)


SHAPES = [(2, 16, 8), (2, 17, 8)]
CASES = [(s, o, p) for s in SHAPES for o in ("integer", "uniform") for p in (False, True)]


@pytest.mark.parametrize("shape,offsets,periodic", CASES)
def test_tap_sum_bwd_plain_matches_pallas_bwd_kernel(monkeypatch, shape, offsets, periodic):
    monkeypatch.setattr(ak, "_INTERPRET", True)
    values, dy, dx, g = _case(shape, offsets, seed=11)
    dy, dx = _clamped(shape, dy, dx, periodic)
    want = ak._tap_sum_bwd(M, periodic, tuple(jnp.asarray(a) for a in (values, dy, dx)),
                           jnp.asarray(g))
    args = [torch.from_numpy(a) for a in (values, dy, dx, g)]
    got = tap_sum_bwd_plain(*args, M, periodic)
    for a, b in zip(got, want):
        _rel_close(a.numpy(), b, TOL)
    # the wrapper takes the plain twin for CPU tensors and launches nothing
    launches = tap_sum_bwd.launches
    assert all(torch.equal(a, b) for a, b in zip(tap_sum_bwd(*args, M, periodic), got))
    assert tap_sum_bwd.launches == launches


@pytest.mark.parametrize("shape,offsets,periodic", CASES)
def test_shifted_stencil_backward_matches_jax_vjp(monkeypatch, shape, offsets, periodic):
    """The whole shift sampler: clamps (ties at the bounds) and tap-sum."""
    monkeypatch.setenv("SILT_PALLAS_ADVECT", "0")
    values, dy, dx, g = _case(shape, offsets, seed=12)
    _, vjp = jax.vjp(lambda v, a, b: ji.shifted_stencil_sample(v, a, b, M, periodic),
                     *(jnp.asarray(x) for x in (values, dy, dx)))
    want = vjp(jnp.asarray(g))
    inputs = [torch.from_numpy(x).requires_grad_() for x in (values, dy, dx)]
    out = ti.shifted_stencil_sample(*inputs, M, periodic)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    for a, b in zip(got, want):
        _rel_close(a.numpy(), b, TOL)


def test_clip_gradient_at_bounds_matches_jax():
    x = np.array([-3.0, 0.0, 1.0, 3.0, 4.0, 2.999999], np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 3.0) * jnp.arange(6.0)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (ti.clip(xt, 0.0, 3.0) * torch.arange(6.0)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert xt.grad[1] == 0.5 and xt.grad[3] == 1.5  # half of each tie


def test_tap_sum_op_is_differentiable_through_its_twins():
    values, dy, dx, g = _case((2, 9, 7), "uniform", seed=13)
    dy, dx = _clamped(values.shape, dy, dx, False)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (values, dy, dx)]
    got = torch.autograd.grad(tap_sum(*inputs, M, False), inputs, torch.from_numpy(g))
    want = tap_sum_bwd_plain(*(t.detach() for t in inputs), torch.from_numpy(g), M, False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("periodic", [False, True])
def test_semi_lagrangian_shift_gradients(monkeypatch, periodic):
    monkeypatch.setenv("SILT_PALLAS_ADVECT", "0")
    rng = np.random.RandomState(14)
    u = (0.8 * rng.randn(2, 16, 9)).astype(np.float32)
    v = (0.8 * rng.randn(2, 17, 8)).astype(np.float32)
    gu, gv = rng.randn(*u.shape).astype(np.float32), rng.randn(*v.shape).astype(np.float32)
    boundary = "PERIODIC" if periodic else "OPEN"
    jdom = jg.Domain((16, 8), (32.0, 16.0), jg.Boundary[boundary])
    tdom = tg.Domain((16, 8), (32.0, 16.0), tg.Boundary[boundary])

    def jfn(u_, v_):
        vel = jg.StaggeredGrid(u_, v_, jdom)
        out = ja.semi_lagrangian(vel, vel, 1.5, "shift", M)
        return out.u, out.v

    _, vjp = jax.vjp(jfn, jnp.asarray(u), jnp.asarray(v))
    want = vjp((jnp.asarray(gu), jnp.asarray(gv)))
    tu, tv = (torch.from_numpy(a).requires_grad_() for a in (u, v))
    vel = tg.StaggeredGrid(tu, tv, tdom)
    out = ta.semi_lagrangian(vel, vel, 1.5, "shift", M)
    got = torch.autograd.grad((out.u, out.v), (tu, tv),
                              (torch.from_numpy(gu), torch.from_numpy(gv)))
    for a, b in zip(got, want):
        _rel_close(a.numpy(), b, 1e-5)


@pytest.mark.parametrize("warm", [False, True])
def test_solve_pressure_gradient_matches_jax_vjp(warm):
    jdom, tdom = jk.karman_domain(8), tk.karman_domain(8)
    jm, tm = jk.KarmanFlow(jdom).masks, tk.KarmanFlow(tdom).masks
    rng = np.random.RandomState(15 + warm)
    fluid = np.asarray(jm.fluid)
    div = (rng.randn(2, jdom.ny, jdom.nx) * fluid).astype(np.float32)
    p0 = (0.1 * rng.randn(2, jdom.ny, jdom.nx)).astype(np.float32)
    # nonzero on the solid cells too: the operator is the identity there
    cot = rng.randn(2, jdom.ny, jdom.nx).astype(np.float32)
    assert np.abs(cot * (1.0 - fluid)).max() > 0.1
    x0 = (jnp.asarray(p0), torch.from_numpy(p0)) if warm else (None, None)
    p_j, vjp = jax.vjp(lambda d: jp.solve_pressure(d, jm, x0=x0[0]), jnp.asarray(div))
    (want,) = vjp(jnp.asarray(cot))
    div_t = torch.from_numpy(div).requires_grad_()
    p_t, _ = tp.solve_pressure(div_t, tm, x0=x0[1])
    (got,) = torch.autograd.grad(p_t, div_t, torch.from_numpy(cot))
    _rel_close(p_t.detach().numpy(), p_j, 1e-4)
    _rel_close(got.numpy(), want, 1e-4)


def test_solve_pressure_warm_start_gets_no_gradient():
    tdom = tk.karman_domain(8)
    tm = tk.KarmanFlow(tdom).masks
    div = torch.randn(1, tdom.ny, tdom.nx).mul(tm.fluid).requires_grad_()
    x0 = torch.randn(1, tdom.ny, tdom.nx, requires_grad=True)
    p, _ = tp.solve_pressure(div, tm, x0=x0)
    p.sum().backward()
    assert x0.grad is None and div.grad is not None
