"""The port's y-sharded karman step (parallel/spatial.py) against the JAX
package's spatial tests (tests/test_spatial.py) on the CPU.

The port's ranks are processes over gloo (tests/torch_dist_ranks.py), 2 and
4 of them on `karman_domain(16)` (32x16: v's 33 rows padded to 34 and 36),
both sides at `pressure_backend="xla"`, the FD-PCG, as the JAX package's
spatial tests pin it (tests/test_torch_spatial_mg.py holds the multigrid
route); the JAX side runs unsharded:

* the projection of random fields (CG tolerance 1e-7): pressure and u
  within atol 2e-4, the JAX test's;
* the full step from `initial_state` with `advection="gather"` (tolerance
  1e-6): every field within atol 1e-4 and the fluid divergence under 1e-3,
  the JAX test's; the padded staggered layout's step (500 iterations)
  within atol 1e-5, its padding rows zero on every rank;
* the same step with `advection="shift"` (max_shift 2), whose haloed blocks
  run the tap-sum (its plain twin on the CPU), within atol 1e-5;
* the step from a perturbed state in both modes, and at 40x its velocity,
  where the gather's halo spans more than a neighbour's rows on 4 ranks:
  within 1e-5 of each field's largest value;
* the gradient of sum(w * outputs) of one sharded step from a perturbed
  state, through the halo exchanges and the distributed solve's cold
  adjoint, against the unsharded port's, both at CG tolerance 1e-7: within
  1e-4 of each input's largest gradient, in both advection modes;
* `shard_staggered_y`'s blocks are JAX's `addressable_shards` of the same
  arrays on a mesh of the same size; `shard_fields_y` warns (REPLICATED) on
  a y-extent the size does not divide, or raises with `strict`.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.core.grids import CenteredGrid as JCentered, StaggeredGrid as JStaggered
from solver_in_the_loop_tpu.ops.poisson import make_incompressible
from solver_in_the_loop_tpu.parallel import spatial as jspatial
from solver_in_the_loop_tpu.physics import karman as jk

import torch_dist_ranks as ranks

from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
from solver_in_the_loop_torch.parallel import mesh as pmesh
from solver_in_the_loop_torch.parallel import spatial
from solver_in_the_loop_torch.physics import karman as tk

torch.set_num_threads(1)

RES = 16
WORLDS = [2, 4]


def _random_velocity():
    rng = np.random.RandomState(0)
    u = rng.randn(1, 2 * RES, RES + 1).astype(np.float32)
    v = rng.randn(1, 2 * RES + 1, RES).astype(np.float32)
    return np.zeros((1, 2 * RES, RES), np.float32), u, v


def _initial_state():
    d0, v0 = jk.initial_state(jk.karman_domain(RES), 1)
    return tuple(np.asarray(a) for a in (d0.values, v0.u, v0.v))


def _perturbed_state():
    rng = np.random.RandomState(5)
    d, u, v = _initial_state()
    return ((d + 0.5 * rng.rand(*d.shape)).astype(np.float32),
            (u + 0.3 * rng.randn(*u.shape)).astype(np.float32),
            (v + 0.3 * rng.randn(*v.shape)).astype(np.float32))


def _fast_state():
    """The perturbed state at 40x its velocity: the gather's back-trace
    reaches 10 rows, more than a rank's 8 on 4 ranks."""
    d, u, v = _perturbed_state()
    return d, 40.0 * u, 40.0 * v


def _weights():
    rng = np.random.RandomState(6)
    return tuple(rng.randn(*a.shape).astype(np.float32) for a in _initial_state())


CASES = {
    "project": dict(kind="project", advection="gather", ptol=1e-7, pmaxiter=2000,
                    fields=_random_velocity()),
    "gather": dict(kind="step", advection="gather", ptol=1e-6, pmaxiter=1000,
                   fields=_initial_state()),
    "padded": dict(kind="step", advection="gather", ptol=1e-6, pmaxiter=500,
                   fields=_initial_state()),
    "shift": dict(kind="step", advection="shift", ptol=1e-6, pmaxiter=1000,
                  fields=_initial_state()),
    "wide": dict(kind="step", advection="gather", ptol=1e-6, pmaxiter=1000,
                 fields=_fast_state()),
    "grad_gather": dict(kind="grad", advection="gather", ptol=1e-7, pmaxiter=2000,
                        fields=_perturbed_state(), weights=_weights()),
    "grad_shift": dict(kind="grad", advection="shift", ptol=1e-7, pmaxiter=2000,
                       fields=_perturbed_state(), weights=_weights()),
}


@functools.lru_cache(maxsize=None)
def sharded(world: int) -> dict:
    """Every case on `world` ranks, in one group: rank 0's results and
    every rank's padding maximum and v block rows, by case name."""
    cases = [dict(c, res=RES, backend="xla") for c in CASES.values()]
    got = ranks.spawn(ranks.spatial_rank, world, cases)
    out = {}
    for i, name in enumerate(CASES):
        out[name] = dict(got[0][i], padding=[g[i]["padding_max"] for g in got],
                         v_rows=[g[i]["v_rows"] for g in got])
        for g in got[1:]:  # every rank gathered the same fields
            np.testing.assert_array_equal(g[i]["u"], got[0][i]["u"])
    return out


def _jax_flow(case):
    return jk.KarmanFlow(jk.karman_domain(RES), advection=case["advection"], max_shift=2,
                         pressure_tol=case["ptol"], pressure_max_iter=case["pmaxiter"],
                         pressure_backend="xla")


@functools.lru_cache(maxsize=None)
def jax_step(name: str):
    case = CASES[name]
    flow = _jax_flow(case)
    dom = flow.domain
    d, u, v = (jnp.asarray(a) for a in case["fields"])
    d1, v1, _ = jax.jit(flow.step)(JCentered(d, dom), JStaggered(u, v, dom), jnp.asarray([1.6e5]))
    return tuple(np.asarray(a) for a in (d1.values, v1.u, v1.v))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_projection_matches_jax(world):
    case = CASES["project"]
    flow = _jax_flow(case)
    _, u, v = (jnp.asarray(a) for a in case["fields"])
    ref, p_ref = make_incompressible(JStaggered(u, v, flow.domain), flow.masks, tol=1e-7,
                                     max_iter=2000, backend="xla")
    got = sharded(world)["project"]
    np.testing.assert_allclose(got["p"], np.asarray(p_ref), atol=2e-4)
    np.testing.assert_allclose(got["u"], np.asarray(ref.u), atol=2e-4)
    np.testing.assert_allclose(got["v"], np.asarray(ref.v), atol=2e-4)
    assert got["iters"] > 0


def _fluid_divergence(u, v):
    masks = tk.KarmanFlow(tk.karman_domain(RES)).masks
    div = (u[:, :, 1:] - u[:, :, :-1]) + (v[:, 1:, :] - v[:, :-1, :])
    return float(np.abs(div * masks.fluid.numpy()).max())


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_full_karman_step_matches_jax(world):
    got, want = sharded(world)["gather"], jax_step("gather")
    for name, ref in zip(("dens", "u", "v"), want):
        np.testing.assert_allclose(got[name], ref, atol=1e-4, err_msg=name)
    assert _fluid_divergence(got["u"], got["v"]) < 1e-3


@pytest.mark.parametrize("world", WORLDS)
def test_padded_staggered_step_matches_jax(world):
    got, want = sharded(world)["padded"], jax_step("padded")
    for name, ref in zip(("dens", "u", "v"), want):
        np.testing.assert_allclose(got[name], ref, atol=1e-5, err_msg=name)
    rows = -(-(2 * RES + 1) // world)
    assert got["v_rows"] == [rows] * world
    assert got["padding"] == [0.0] * world


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_shift_step_matches_jax(world):
    got, want = sharded(world)["shift"], jax_step("shift")
    for name, ref in zip(("dens", "u", "v"), want):
        np.testing.assert_allclose(got[name], ref, atol=1e-5, err_msg=name)
    assert _fluid_divergence(got["u"], got["v"]) < 1e-3


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["grad_gather", "grad_shift", "wide"])
def test_sharded_step_from_a_moving_state_matches_jax(world, name):
    """From the perturbed state (density advected too) in both modes, and
    at 40x its velocity, where the halo spans more than one neighbour's
    rows: within 1e-5 of each field's largest value."""
    got, want = sharded(world)[name], jax_step(name)
    for field, ref in zip(("dens", "u", "v"), want):
        np.testing.assert_allclose(got[field], ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=field)


@functools.lru_cache(maxsize=None)
def unsharded_grads(name: str):
    case = CASES[name]
    dom = tk.karman_domain(RES)
    flow = tk.KarmanFlow(dom, advection=case["advection"], max_shift=2,
                         pressure_tol=case["ptol"], pressure_max_iter=case["pmaxiter"])
    ins = [torch.from_numpy(a).requires_grad_() for a in case["fields"]]
    d, vel, _, _ = flow.step(CenteredGrid(ins[0], dom), StaggeredGrid(ins[1], ins[2], dom),
                             torch.tensor([1.6e5]))
    w = [torch.from_numpy(a) for a in case["weights"]]
    ((w[0] * d.values).sum() + (w[1] * vel.u).sum() + (w[2] * vel.v).sum()).backward()
    return [t.grad.numpy() for t in ins]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("advection", ["gather", "shift"])
def test_sharded_step_gradient_matches_unsharded(world, advection):
    got = sharded(world)[f"grad_{advection}"]["grads"]
    for name, g, want in zip(("dens", "u", "v"), got, unsharded_grads(f"grad_{advection}")):
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(g - want).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("world", WORLDS)
def test_shard_staggered_y_is_jax_layout(world):
    d, u, v = _perturbed_state()
    jmesh = jspatial.spatial_mesh(world)
    want = [sorted(a.addressable_shards, key=lambda s: s.device.id)
            for a in jspatial.shard_staggered_y(jmesh, jnp.asarray(d), jnp.asarray(u),
                                                jnp.asarray(v))]
    for r in range(world):
        mesh = pmesh.Mesh(world, r, torch.device("cpu"), "gloo")
        got = spatial.shard_staggered_y(mesh, *(torch.from_numpy(a) for a in (d, u, v)))
        for block, shards in zip(got, want):
            np.testing.assert_array_equal(block.numpy(), np.asarray(shards[r].data))
    mesh = pmesh.Mesh(world, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="not divisible"):
        spatial.shard_staggered_y(mesh, torch.zeros(1, world + 1, 4), torch.zeros(1, world, 5),
                                  torch.zeros(1, world + 1, 4))


@pytest.mark.parametrize("world", WORLDS)
def test_shard_fields_y_warns_on_nondivisible(world, caplog):
    mesh = pmesh.Mesh(world, world - 1, torch.device("cpu"), "gloo")
    a = torch.arange(world * 4 * 8, dtype=torch.float32).reshape(1, world * 4, 8)
    b = torch.zeros(1, world * 4 + 1, 8)
    with caplog.at_level(logging.WARNING, logger="solver_in_the_loop_torch.parallel.spatial"):
        got_a, got_b = spatial.shard_fields_y(mesh, a, b)
    assert torch.equal(got_a, a[:, -4:]) and got_b is b
    assert any("REPLICATED" in r.message for r in caplog.records)
    with pytest.raises(ValueError, match="REPLICATED"):
        spatial.shard_fields_y(mesh, b, strict=True)
