"""One karman solver step of the PyTorch port against the JAX package (CPU).

`KarmanFlow.step` at karman_domain(8), batch 2 (two Re), on density,
velocity and pressure, for both advection backends, cold and warm-started.
Diffusion, BC blend and advection are the same float32 formulas (1e-6);
the projection stops at the CG tolerance 1e-5 of ||b||, so velocity and
pressure agree to rtol 1e-4 of their max.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.core import grids as jg
from solver_in_the_loop_tpu.physics import karman as jk

from solver_in_the_loop_torch.core import grids as tg
from solver_in_the_loop_torch.physics import karman as tk

torch.set_num_threads(1)

RE = [160000.0, 640000.0]


def _rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err} > {rtol}"


def _state(dom, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.rand(2, dom.ny, dom.nx).astype(np.float32)
    u = (0.5 * rng.randn(2, dom.ny, dom.nx + 1)).astype(np.float32)
    v = (1.0 + 0.5 * rng.randn(2, dom.ny + 1, dom.nx)).astype(np.float32)
    p0 = rng.randn(2, dom.ny, dom.nx).astype(np.float32)
    return d, u, v, p0


@pytest.mark.parametrize("advection", ["shift", "gather"])
@pytest.mark.parametrize("warm", [False, True])
def test_step_matches_jax(advection, warm):
    jdom, tdom = jk.karman_domain(8), tk.karman_domain(8)
    d, u, v, p0 = _state(jdom)
    jflow = jk.KarmanFlow(jdom, advection=advection, max_shift=2)
    tflow = tk.KarmanFlow(tdom, advection=advection, max_shift=2)
    jd, jv, jpres = jflow.step(jg.CenteredGrid(jnp.asarray(d), jdom),
                               jg.StaggeredGrid(jnp.asarray(u), jnp.asarray(v), jdom),
                               jnp.asarray(RE, jnp.float32),
                               p0=jnp.asarray(p0) if warm else None)
    td, tv, tpres, iters = tflow.step(tg.CenteredGrid(torch.from_numpy(d), tdom),
                                      tg.StaggeredGrid(torch.from_numpy(u), torch.from_numpy(v),
                                                       tdom),
                                      torch.tensor(RE), p0=torch.from_numpy(p0) if warm else None)
    np.testing.assert_allclose(td.values.numpy(), np.asarray(jd.values), rtol=1e-6, atol=1e-6)
    _rel_close(tv.u.numpy(), jv.u, 1e-4)
    _rel_close(tv.v.numpy(), jv.v, 1e-4)
    _rel_close(tpres.numpy(), jpres, 1e-4)
    assert 0 < int(iters) < tflow.pressure_max_iter


def test_pre_projection_matches_jax():
    jdom, tdom = jk.karman_domain(8), tk.karman_domain(8)
    d, u, v, _ = _state(jdom, seed=1)
    jd, jv = jk.KarmanFlow(jdom, advection="shift").pre_projection(
        jg.CenteredGrid(jnp.asarray(d), jdom),
        jg.StaggeredGrid(jnp.asarray(u), jnp.asarray(v), jdom), jnp.asarray(RE, jnp.float32))
    td, tv = tk.KarmanFlow(tdom, advection="shift").pre_projection(
        tg.CenteredGrid(torch.from_numpy(d), tdom),
        tg.StaggeredGrid(torch.from_numpy(u), torch.from_numpy(v), tdom), torch.tensor(RE))
    for got, want in ((td.values, jd.values), (tv.u, jv.u), (tv.v, jv.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
