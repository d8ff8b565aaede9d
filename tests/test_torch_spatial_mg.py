"""The y-sharded karman step's multigrid route (parallel/spatial.py) against
the JAX package on the CPU.

The JAX package shards its fields and runs its ordinary step, whose
`solve_pressure` takes multigrid wherever `_mg_applicable` holds for the
global shape (`pressure_backend="auto"` off its single-device Pallas kernel)
or wherever `"mg"` names it. The port's sharded step runs a distributed
V-cycle there. Its ranks are processes over gloo
(tests/torch_dist_ranks.py), 2 and 4 of them, every case of a world size in
one group:

* the sharded V-cycle against the unsharded `ops/multigrid.v_cycle` on the
  same right-hand side, within 1e-6 of its max (they are bit-equal on the
  CPU: the same float32 formulas, element by element; the property
  `bit_equal` records it): on `karman_domain(64)` (128x64) at 2 and 4 ranks,
  and at 4 ranks on 136x68 (level 1 has 17 rows a rank: gathered there) and
  144x72 (level 2 has 9 rows a rank), and at 2 ranks on 66x33, whose
  hierarchy has one level (33 is odd) that every rank runs whole, the masks
  from the same `masks_from_fluid_cells` call of `KarmanFlow`;
* the projection of random fields, batch 2 at 128x64, CG tolerance 1e-7,
  against JAX's `make_incompressible(backend="mg")` on fields sharded over
  the fake CPU mesh of as many devices (tests/conftest.py): pressure, u and
  v within atol 2e-4 (tests/test_spatial.py's), and the iterations within
  1 of JAX's unsharded `mg_pcg_solve` on the same right-hand side (its
  count: the fewest max_iter that give its converged result);
* the full step from a perturbed state, batch 2, against JAX's
  `make_sharded_step_y` around `KarmanFlow(pressure_backend="mg")` on that
  mesh: every field within atol 1e-4, the fluid divergence under 1e-3;
* the gradient of sum(w * outputs) of one sharded step (its adjoint a cold
  sharded multigrid solve) against the unsharded port's step, which takes
  multigrid at 128x64 on the CPU, both at tolerance 1e-7: within 1e-5 of
  each input's largest gradient, in both advection modes;
* the route: "auto" names multigrid exactly where JAX's `_mg_applicable`
  holds for the global shape, "xla" the FD-PCG everywhere, "mg" multigrid,
  also on a field whose hierarchy has no coarser level.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.core.grids import CenteredGrid as JCentered, StaggeredGrid as JStaggered
from solver_in_the_loop_tpu.ops import multigrid as jmg
from solver_in_the_loop_tpu.ops import poisson as jp
from solver_in_the_loop_tpu.ops.stencils import divergence as jdivergence
from solver_in_the_loop_tpu.parallel import spatial as jspatial
from solver_in_the_loop_tpu.physics import karman as jk

import torch_dist_ranks as ranks

from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
from solver_in_the_loop_torch.ops import multigrid as tmg
from solver_in_the_loop_torch.parallel import mesh as pmesh
from solver_in_the_loop_torch.parallel import spatial
from solver_in_the_loop_torch.physics import karman as tk

torch.set_num_threads(1)

RES = 64  # karman_domain(64): 128x64, the smallest karman grid JAX's auto solves with multigrid
BATCH = 2
TOL = 1e-7
MAX_ITER = 2000
RE = 1.6e5
WORLDS = [2, 4]
# (res, world): the V-cycle cases, with each sharded level's rows a rank
V_CYCLES = {(64, 2): [64, 32, 16], (64, 4): [32, 16, 8], (68, 4): [34, 17], (72, 4): [36, 18, 9],
            (33, 2): []}


def _fluid(res):
    return tk.KarmanFlow(tk.karman_domain(res)).masks.fluid.numpy()


def _rhs(res):
    rng = np.random.RandomState(res)
    return (rng.randn(BATCH, 2 * res, res) * _fluid(res)).astype(np.float32)


def _random_velocity():
    rng = np.random.RandomState(0)
    u = rng.randn(BATCH, 2 * RES, RES + 1).astype(np.float32)
    v = rng.randn(BATCH, 2 * RES + 1, RES).astype(np.float32)
    return np.zeros((BATCH, 2 * RES, RES), np.float32), u, v


def _perturbed_state():
    """The karman initial state, each batch element perturbed from its own
    draw."""
    rng = np.random.RandomState(5)
    d0, v0 = jk.initial_state(jk.karman_domain(RES), BATCH)
    d, u, v = (np.asarray(a) for a in (d0.values, v0.u, v0.v))
    return ((d + 0.5 * rng.rand(*d.shape)).astype(np.float32),
            (u + 0.3 * rng.randn(*u.shape)).astype(np.float32),
            (v + 0.3 * rng.randn(*v.shape)).astype(np.float32))


def _weights():
    rng = np.random.RandomState(6)
    return tuple(rng.randn(*a.shape).astype(np.float32) for a in _perturbed_state())


CASES = {
    "project": dict(kind="project", advection="gather", fields=_random_velocity()),
    "step": dict(kind="step", advection="gather", fields=_perturbed_state()),
    "grad_gather": dict(kind="grad", advection="gather", fields=_perturbed_state(),
                        weights=_weights()),
    "grad_shift": dict(kind="grad", advection="shift", fields=_perturbed_state(),
                       weights=_weights()),
}


@functools.lru_cache(maxsize=None)
def sharded(world: int) -> dict:
    """Every case of `world` ranks in one group: rank 0's results by name,
    the V-cycles by (res, world)."""
    common = dict(ptol=TOL, pmaxiter=MAX_ITER, backend="mg")
    cases = [dict(c, res=RES, **common) for c in CASES.values()]
    vcycles = [key for key in V_CYCLES if key[1] == world]
    cases += [dict(kind="vcycle", res=res, advection="gather", rhs=_rhs(res), **common)
              for res, _ in vcycles]
    got = ranks.spawn(ranks.spatial_rank, world, cases)
    for i in range(len(CASES)):  # every rank gathered the same fields
        for g in got[1:]:
            np.testing.assert_array_equal(g[i]["u"], got[0][i]["u"])
    return {**dict(zip(CASES, got[0])), **dict(zip(vcycles, got[0][len(CASES):]))}


@pytest.mark.parametrize("res,world", list(V_CYCLES))
def test_sharded_v_cycle_matches_unsharded(res, world, record_property):
    got = sharded(world)[(res, world)]
    masks = tk.KarmanFlow(tk.karman_domain(res)).masks
    h = tmg.build_mg_hierarchy(masks, tk.karman_domain(res))
    want = tmg.v_cycle(h, torch.from_numpy(_rhs(res))).numpy()
    assert got["route"] == "multigrid"
    assert got["level_rows"] == V_CYCLES[(res, world)]
    assert len(h.levels) > len(got["level_rows"])  # the coarsest runs replicated
    record_property("bit_equal", bool(np.array_equal(got["x"], want)))
    assert np.abs(got["x"] - want).max() <= 1e-6 * np.abs(want).max()


def _jax_flow(advection):
    return jk.KarmanFlow(jk.karman_domain(RES), advection=advection, pressure_tol=TOL,
                         pressure_max_iter=MAX_ITER, pressure_backend="mg")


def _jax_iterations(flow, u, v):
    """JAX's unsharded `mg_pcg_solve` iterations on the projection's
    right-hand side: the fewest max_iter whose result is its converged one."""
    masks, dom = flow.masks, flow.domain
    rhs = jnp.where(masks.fluid > 0, -jdivergence(u * masks.face_u, v * masks.face_v), 0.0)
    h = jmg.build_mg_hierarchy(masks, dom)
    solve = jax.jit(lambda b, m: jmg.mg_pcg_solve(h, b, TOL, m))
    done = np.asarray(solve(rhs, MAX_ITER))
    lo, hi = 0, MAX_ITER
    while lo < hi:
        mid = (lo + hi) // 2
        if np.array_equal(np.asarray(solve(rhs, mid)), done):
            hi = mid
        else:
            lo = mid + 1
    return lo


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_mg_projection_matches_jax(world):
    flow = _jax_flow("gather")
    dom = flow.domain
    _, u, v = (jnp.asarray(a) for a in CASES["project"]["fields"])
    u_s, v_s = jspatial.shard_fields_y(jspatial.spatial_mesh(world), u, v)

    @jax.jit
    def project(u, v):
        vel, p = jp.make_incompressible(JStaggered(u, v, dom), flow.masks, tol=TOL,
                                        max_iter=MAX_ITER, backend="mg")
        return vel.u, vel.v, p

    want_u, want_v, want_p = project(u_s, v_s)
    got = sharded(world)["project"]
    assert got["route"] == "multigrid"
    np.testing.assert_allclose(got["p"], np.asarray(want_p), atol=2e-4)
    np.testing.assert_allclose(got["u"], np.asarray(want_u), atol=2e-4)
    np.testing.assert_allclose(got["v"], np.asarray(want_v), atol=2e-4)
    jax_iters = _jax_iterations(flow, u, v)
    assert jax_iters > 0 and abs(got["iters"] - jax_iters) <= 1, (got["iters"], jax_iters)


def _fluid_divergence(u, v):
    div = (u[:, :, 1:] - u[:, :, :-1]) + (v[:, 1:, :] - v[:, :-1, :])
    return float(np.abs(div * _fluid(RES)).max())


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_mg_step_matches_jax_sharded_step(world):
    """JAX's `make_sharded_step_y` around its step at pressure_backend="mg",
    the fields y-sharded over `world` fake devices."""
    flow = _jax_flow("gather")
    dom, ny = flow.domain, flow.domain.ny
    mesh = jspatial.spatial_mesh(world)

    def step(d, u, v, re):
        d1, v1, _ = flow.step(JCentered(d, dom), JStaggered(u, v, dom), re)
        return d1.values, v1.u, v1.v

    blocks = jspatial.shard_staggered_y(mesh, *(jnp.asarray(a) for a in CASES["step"]["fields"]))
    want = jspatial.make_sharded_step_y(step, mesh, ny)(*blocks, jnp.asarray([RE]))
    assert want[0].sharding.spec == jspatial.y_sharding(mesh).spec
    got = sharded(world)["step"]
    for name, ref, rows in zip(("dens", "u", "v"), want, (ny, ny, ny + 1)):
        np.testing.assert_allclose(got[name], np.asarray(ref)[:, :rows], atol=1e-4, err_msg=name)
    assert _fluid_divergence(got["u"], got["v"]) < 1e-3


@functools.lru_cache(maxsize=None)
def unsharded_grads(name: str):
    case = CASES[name]
    dom = tk.karman_domain(RES)
    flow = tk.KarmanFlow(dom, advection=case["advection"], max_shift=2, pressure_tol=TOL,
                         pressure_max_iter=MAX_ITER)
    assert flow.pressure_route(BATCH) == "multigrid"
    ins = [torch.from_numpy(a).requires_grad_() for a in case["fields"]]
    d, vel, _, _ = flow.step(CenteredGrid(ins[0], dom), StaggeredGrid(ins[1], ins[2], dom),
                             torch.tensor([RE]))
    w = [torch.from_numpy(a) for a in case["weights"]]
    ((w[0] * d.values).sum() + (w[1] * vel.u).sum() + (w[2] * vel.v).sum()).backward()
    return [t.grad.numpy() for t in ins]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("advection", ["gather", "shift"])
def test_sharded_mg_step_gradient_matches_unsharded(world, advection):
    got = sharded(world)[f"grad_{advection}"]
    assert got["route"] == "multigrid"
    for name, g, want in zip(("dens", "u", "v"), got["grads"],
                             unsharded_grads(f"grad_{advection}")):
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(g - want).max() <= 1e-5 * scale, name


@pytest.mark.parametrize("res", [32, 64, 66, 128])
def test_sharded_route_matches_jax(res):
    """64x32, 128x64, 132x66 (66 is not a multiple of 4) and 256x128 on 2
    ranks, the route named without a group."""
    dom = tk.karman_domain(res)
    shape = (1, dom.ny, dom.nx)
    flow = tk.KarmanFlow(dom)
    mesh = pmesh.Mesh(2, 0, torch.device("cpu"), "gloo")
    want = "multigrid" if jp._mg_applicable(shape) else "pcg_plain"
    assert want == ("multigrid" if res in (64, 128) else "pcg_plain")
    for backend, route in (("auto", want), ("xla", "pcg_plain"), ("mg", "multigrid")):
        assert spatial.sharded_pressure_route(shape, backend) == route
        assert spatial.YShardedKarman(flow, mesh, backend).pressure_route == route
    assert spatial.YShardedKarman(flow, mesh).pressure_route == want


def test_sharded_route_refusals():
    """The fused kernel is single-device, so "pallas" is refused; "mg" takes
    66x33, whose hierarchy has one level (33 is odd), with no level sharded:
    every rank runs that level whole, as `v_cycle` does."""
    mesh = pmesh.Mesh(2, 1, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="single-device"):
        spatial.sharded_pressure_route((1, 128, 64), "pallas")
    flow = tk.KarmanFlow(tk.karman_domain(33))
    assert spatial.YShardedKarman(flow, mesh, "auto").pressure_route == "pcg_plain"
    shard = spatial.YShardedKarman(flow, mesh, "mg")
    assert shard.pressure_route == "multigrid"
    assert len(shard.mg.levels) == 1 and shard.mg_levels == []
