"""Advection of the PyTorch port against the JAX package on the CPU.

* the plain tap-sum (kernels/advect.py, the CPU twin of csrc/advect.cu)
  against the JAX XLA tap loop and against the Pallas `_fwd_kernel` run in
  interpret mode (as tests/test_pallas_advect.py runs it);
* `semi_lagrangian` on centered and staggered fields, shift and gather;
* `bilinear_sample`.

The tap-sum evaluates the same float32 formula in the same tap order on
both sides (the Pallas kernel sums in that order too), so it must agree to
float32 rounding: rtol = atol = 1e-6. The gather path's weights are products
in the same order: also 1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.core import grids as jg
from solver_in_the_loop_tpu.ops import advection as ja
from solver_in_the_loop_tpu.ops import interp as ji
from solver_in_the_loop_tpu.ops.pallas import advect_kernel as ak

from solver_in_the_loop_torch.core import grids as tg
from solver_in_the_loop_torch.kernels.advect import tap_sum_fwd, tap_sum_fwd_plain
from solver_in_the_loop_torch.ops import advection as ta
from solver_in_the_loop_torch.ops import interp as ti

torch.set_num_threads(1)

TOL = 1e-6
M = 2


def _case(shape, offsets, seed=0):
    rng = np.random.RandomState(seed)
    values = rng.randn(*shape).astype(np.float32)
    if offsets == "integer":  # exact integers hit the hat weights' kinks and ties
        dy = rng.randint(-M - 1, M + 2, shape).astype(np.float32)
        dx = rng.randint(-M - 1, M + 2, shape).astype(np.float32)
    else:  # beyond +-m, so the clamps act
        dy = (3.0 * rng.randn(*shape)).astype(np.float32)
        dx = (3.0 * rng.randn(*shape)).astype(np.float32)
    return values, dy, dx


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


SHAPES = [(2, 16, 8), (2, 17, 8)]


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("offsets", ["integer", "clamped"])
@pytest.mark.parametrize("shape", SHAPES)
def test_shifted_stencil_matches_jax_xla_loop(monkeypatch, shape, offsets, periodic):
    monkeypatch.setenv("SILT_PALLAS_ADVECT", "0")
    values, dy, dx = _case(shape, offsets)
    want = ji.shifted_stencil_sample(jnp.asarray(values), jnp.asarray(dy), jnp.asarray(dx),
                                     M, periodic)
    got = ti.shifted_stencil_sample(torch.from_numpy(values), torch.from_numpy(dy),
                                    torch.from_numpy(dx), M, periodic)
    _close(got, want)


def _clamped_offsets(shape, dy, dx, periodic):
    """The offsets the tap-sum receives: the caller's clamps (interp.py)."""
    dy, dx = np.clip(dy, -M, M), np.clip(dx, -M, M)
    if not periodic:
        jj = np.arange(shape[1], dtype=np.float32)[None, :, None]
        ii = np.arange(shape[2], dtype=np.float32)[None, None, :]
        dy = np.clip(jj + dy, 0.0, shape[1] - 1.0) - jj
        dx = np.clip(ii + dx, 0.0, shape[2] - 1.0) - ii
    return dy.astype(np.float32), dx.astype(np.float32)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("offsets", ["integer", "clamped"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_tap_sum_matches_pallas_fwd_kernel(monkeypatch, shape, offsets, periodic):
    monkeypatch.setattr(ak, "_INTERPRET", True)
    values, dy, dx = _case(shape, offsets, seed=1)
    dy, dx = _clamped_offsets(shape, dy, dx, periodic)
    want = ak._tap_sum_fwd_impl(jnp.asarray(values), jnp.asarray(dy), jnp.asarray(dx),
                                M, periodic)
    args = (torch.from_numpy(values), torch.from_numpy(dy), torch.from_numpy(dx), M, periodic)
    got = tap_sum_fwd_plain(*args)
    _close(got, want)
    # the wrapper takes the plain twin for CPU tensors, and launches nothing
    launches = tap_sum_fwd.launches
    assert torch.equal(tap_sum_fwd(*args), got)
    assert tap_sum_fwd.launches == launches


def _fields(batch, ny, nx, seed):
    rng = np.random.RandomState(seed)
    d = rng.rand(batch, ny, nx).astype(np.float32)
    u = (1.2 * rng.randn(batch, ny, nx + 1)).astype(np.float32)
    v = (1.2 * rng.randn(batch, ny + 1, nx)).astype(np.float32)
    return d, u, v


@pytest.mark.parametrize("method", ["shift", "gather"])
@pytest.mark.parametrize("periodic", [False, True])
def test_semi_lagrangian_centered_and_staggered(monkeypatch, method, periodic):
    monkeypatch.setenv("SILT_PALLAS_ADVECT", "0")
    d, u, v = _fields(2, 16, 8, seed=2)
    boundary = "PERIODIC" if periodic else "OPEN"
    jdom = jg.Domain((16, 8), (32.0, 16.0), jg.Boundary[boundary])
    tdom = tg.Domain((16, 8), (32.0, 16.0), tg.Boundary[boundary])
    jvel = jg.StaggeredGrid(jnp.asarray(u), jnp.asarray(v), jdom)
    tvel = tg.StaggeredGrid(torch.from_numpy(u), torch.from_numpy(v), tdom)
    dt = 1.5
    want_d = ja.semi_lagrangian(jg.CenteredGrid(jnp.asarray(d), jdom), jvel, dt, method, M)
    got_d = ta.semi_lagrangian(tg.CenteredGrid(torch.from_numpy(d), tdom), tvel, dt, method, M)
    _close(got_d.values, want_d.values)
    want_v = ja.semi_lagrangian(jvel, jvel, dt, method, M)
    got_v = ta.semi_lagrangian(tvel, tvel, dt, method, M)
    _close(got_v.u, want_v.u)
    _close(got_v.v, want_v.v)


@pytest.mark.parametrize("periodic", [False, True])
def test_bilinear_sample(periodic):
    rng = np.random.RandomState(5)
    values = rng.randn(2, 9, 7).astype(np.float32)
    y = (rng.rand(2, 5, 4) * 14.0 - 3.0).astype(np.float32)
    x = (rng.rand(2, 5, 4) * 12.0 - 3.0).astype(np.float32)
    want = ji.bilinear_sample(jnp.asarray(values), jnp.asarray(y), jnp.asarray(x), periodic)
    got = ti.bilinear_sample(torch.from_numpy(values), torch.from_numpy(y),
                             torch.from_numpy(x), periodic)
    _close(got, want)
