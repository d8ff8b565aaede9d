"""Grids, geometry, stencils, diffusion and downsampling of the PyTorch port
against the JAX package on the CPU.

Inputs come from a numpy seed, cast to float32 for both packages. These are
elementwise float32 formulas evaluated in the same order on both sides, so
they agree to float32 rounding: rtol 1e-6 (atol 1e-6 for values near 0).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.core import grids as jg
from solver_in_the_loop_tpu.core import resample as jr
from solver_in_the_loop_tpu.ops import diffusion as jd
from solver_in_the_loop_tpu.ops import stencils as js
from solver_in_the_loop_tpu.ops.poisson import masks_from_fluid_cells as j_masks
from solver_in_the_loop_tpu.physics import geometry as jgeo
from solver_in_the_loop_tpu.physics import karman as jk

from solver_in_the_loop_torch.core import grids as tg
from solver_in_the_loop_torch.core import resample as tr
from solver_in_the_loop_torch.ops import diffusion as td
from solver_in_the_loop_torch.ops import stencils as ts
from solver_in_the_loop_torch.ops.poisson import masks_from_fluid_cells as t_masks
from solver_in_the_loop_torch.physics import geometry as tgeo
from solver_in_the_loop_torch.physics import karman as tk

torch.set_num_threads(1)

RTOL = ATOL = 1e-6


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("boundary", ["OPEN", "PERIODIC"])
def test_domain_shapes_and_coords(boundary):
    jdom = jg.Domain((12, 7), (24.0, 10.0), jg.Boundary[boundary])
    tdom = tg.Domain((12, 7), (24.0, 10.0), tg.Boundary[boundary])
    assert tdom.dx == jdom.dx
    assert tdom.periodic == jdom.periodic
    for b in (1, 3):
        assert tdom.centered_shape(b) == jdom.centered_shape(b)
        assert tdom.u_shape(b) == jdom.u_shape(b)
        assert tdom.v_shape(b) == jdom.v_shape(b)
    for got, want in zip(tdom.cell_center_coords(), jdom.cell_center_coords()):
        _close(got, want)


def test_collocated_round_trip():
    u, v = _rand(2, 6, 5), _rand(2, 7, 4, seed=1)
    jdom = jg.Domain((6, 4), (6.0, 4.0))
    tdom = tg.Domain((6, 4), (6.0, 4.0))
    jgrid = jg.StaggeredGrid(jnp.asarray(u), jnp.asarray(v), jdom)
    tgrid = tg.StaggeredGrid(torch.from_numpy(u), torch.from_numpy(v), tdom)
    col = tgrid.to_collocated()
    _close(col, jgrid.to_collocated())
    back_t = tg.StaggeredGrid.from_collocated(col, tdom)
    back_j = jg.StaggeredGrid.from_collocated(jgrid.to_collocated(), jdom)
    _close(back_t.u, back_j.u)
    _close(back_t.v, back_j.v)
    _close((tgrid + tgrid).u, (jgrid + jgrid).u)


@pytest.mark.parametrize("res", [8, 16])
def test_geometry_masks(res):
    jdom, tdom = jk.karman_domain(res), tk.karman_domain(res)
    _close(tgeo.sphere_fluid_mask(tdom, (50.0, 50.0), 10.0),
           jgeo.sphere_fluid_mask(jdom, (50.0, 50.0), 10.0))
    _close(tgeo.box_mask(tdom, (5.0, 10.0), (25.0, 75.0)),
           jgeo.box_mask(jdom, (5.0, 10.0), (25.0, 75.0)))
    # strict '<': a cell center exactly on the circle stays fluid
    dom = tg.Domain((4, 4), (4.0, 4.0))
    assert float(tgeo.sphere_fluid_mask(dom, (1.5, 0.5), 1.0)[0, 2, 0]) == 1.0


@pytest.mark.parametrize("periodic", [False, True])
def test_stencils(periodic):
    p = _rand(2, 9, 6)
    u, v = _rand(2, 9, 7, seed=1), _rand(2, 10, 6, seed=2)
    _close(ts.laplacian(torch.from_numpy(p), periodic), js.laplacian(jnp.asarray(p), periodic))
    _close(ts.divergence(torch.from_numpy(u), torch.from_numpy(v)),
           js.divergence(jnp.asarray(u), jnp.asarray(v)))
    for got, want in zip(ts.pressure_gradient(torch.from_numpy(p), periodic),
                         js.pressure_gradient(jnp.asarray(p), periodic)):
        _close(got, want)
    boundary = "PERIODIC" if periodic else "OPEN"
    jdom = jg.Domain((9, 6), (9.0, 6.0), jg.Boundary[boundary])
    tdom = tg.Domain((9, 6), (9.0, 6.0), tg.Boundary[boundary])
    fluid = (np.random.RandomState(4).rand(1, 9, 6) > 0.2).astype(np.float32)
    jm, tm = j_masks(jnp.asarray(fluid), jdom), t_masks(torch.from_numpy(fluid), tdom)
    _close(ts.masked_laplacian(torch.from_numpy(p), tm.face_u, tm.face_v, periodic),
           js.masked_laplacian(jnp.asarray(p), jm.face_u, jm.face_v, periodic))


@pytest.mark.parametrize("periodic", [False, True])
def test_diffuse_explicit(periodic):
    vals = _rand(2, 8, 9)
    amount = np.asarray([0.1, 0.2], np.float32).reshape(2, 1, 1)
    got = td.diffuse_explicit(torch.from_numpy(vals), torch.from_numpy(amount), 3, periodic)
    want = jd.diffuse_explicit(jnp.asarray(vals), jnp.asarray(amount), 3, periodic)
    _close(got, want)


def test_downsampling():
    d, u, v = _rand(2, 16, 8), _rand(2, 16, 9, seed=1), _rand(2, 17, 8, seed=2)
    _close(tr.downsample_centered(torch.from_numpy(d), 4), jr.downsample_centered(jnp.asarray(d), 4))
    for got, want in zip(tr.downsample_staggered(torch.from_numpy(u), torch.from_numpy(v), 4),
                         jr.downsample_staggered(jnp.asarray(u), jnp.asarray(v), 4)):
        _close(got, want)


def test_freestream_bc_and_initial_state():
    jdom, tdom = jk.karman_domain(8), tk.karman_domain(8)
    for got, want in zip(tk.freestream_bc(tdom), jk.freestream_bc(jdom)):
        _close(got, want)
    jd0, jv0 = jk.initial_state(jdom, 2)
    td0, tv0 = tk.initial_state(tdom, 2)
    _close(td0.values, jd0.values)
    _close(tv0.u, jv0.u)
    _close(tv0.v, jv0.v)
