"""The PRE least-squares solver and the upsamplers of the port against the
JAX package (solver_in_the_loop_tpu/pre/lsq.py, core/resample.py) on the CPU."""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.core import grids as jgrids
from solver_in_the_loop_tpu.core import resample as jres
from solver_in_the_loop_tpu.physics.karman import karman_domain as jax_karman_domain
from solver_in_the_loop_tpu.pre import lsq as jlsq

from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.core import grids as tgrids
from solver_in_the_loop_torch.core import resample as tres
from solver_in_the_loop_torch.kernels.cg import cg_solve_plain, masked_matvec
from solver_in_the_loop_torch.physics.karman import karman_domain
from solver_in_the_loop_torch.pre import lsq
from solver_in_the_loop_torch.utils import profiling

torch.set_num_threads(2)

# single operators (one bilinear sample, one difference): a float32 rounding
# or two apart. The unconstrained solve (CG on M, tol 1e-4) agrees to 1e-6
# of the max (3.7e-7 measured). The constrained solve projects with an
# inner CG that stops at a 1e-4 relative residual, so each projection is
# exact only to that, and two float32 implementations that sum in other
# orders part by up to the solver's own error: on six random karman_domain(8)
# pairs (seeds 0-5, beta 1 and 0) the port is 3e-5 to 4.6e-4 of the max off
# the JAX package, while the JAX package itself is 4e-4 to 1.8e-3 of the
# max off the exact KKT solution (the port 4e-4 to 1.6e-3). Both are held
# to that: the port within CONSTRAINED_REL_TOL of the JAX package, both
# within ORACLE_REL_TOL of the exact solution.
OP_TOL = 1e-6
UNCONSTRAINED_REL_TOL = 1e-6
CONSTRAINED_REL_TOL = parity.CONSTRAINED_REL_TOL
ORACLE_REL_TOL = 2e-3


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.fixture(scope="module")
def geoms():
    """The karman_domain(8) pair at scale 4 of both packages."""
    j = jlsq.build_pre_geometry(jax_karman_domain(8), jax_karman_domain(32), 4, bnd=2)
    t = lsq.build_pre_geometry(karman_domain(8), karman_domain(32), 4, bnd=2)
    return j, t


def _random_pair(geom, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*a.shape).astype(np.float32)
            for a in (geom.hi_fu, geom.hi_fv, geom.lo_fu, geom.lo_fv)]


def test_geometry_masks_match(geoms):
    j, t = geoms
    for name in ("lo_cells", "lo_fu", "lo_fv", "hi_fu", "hi_fv"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_centered_matches_jax(factor):
    x = np.random.RandomState(0).randn(2, 6, 5).astype(np.float32)
    got = tres.upsample_centered(_t(x), factor).numpy()
    want = np.asarray(jres.upsample_centered(jnp.asarray(x), factor))
    assert got.shape == want.shape
    assert _rel(got, want) <= OP_TOL


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_staggered_matches_jax(factor):
    rng = np.random.RandomState(1)
    u, v = rng.randn(2, 6, 6).astype(np.float32), rng.randn(2, 7, 5).astype(np.float32)
    got = tres.upsample_staggered(_t(u), _t(v), factor)
    want = jres.upsample_staggered(jnp.asarray(u), jnp.asarray(v), factor)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= OP_TOL


@pytest.mark.parametrize("boundary", ["OPEN", "PERIODIC"])
def test_resample_centered_grid_matches_jax(boundary):
    x = np.random.RandomState(2).randn(2, 8, 6).astype(np.float32)
    jsrc = jgrids.Domain((8, 6), (16.0, 12.0), getattr(jgrids.Boundary, boundary))
    jdst = jgrids.Domain((13, 5), (16.0, 12.0), getattr(jgrids.Boundary, boundary))
    tsrc = tgrids.Domain((8, 6), (16.0, 12.0), getattr(tgrids.Boundary, boundary))
    tdst = tgrids.Domain((13, 5), (16.0, 12.0), getattr(tgrids.Boundary, boundary))
    got = tres.resample_centered_grid(tgrids.CenteredGrid(_t(x), tsrc), tdst)
    want = jres.resample_centered_grid(jgrids.CenteredGrid(jnp.asarray(x), jsrc), jdst)
    assert got.domain == tdst
    assert _rel(got.values.numpy(), want.values) <= OP_TOL


def test_w_and_its_adjoint_match_jax(geoms):
    j, t = geoms
    hu, hv, lu, lv = _random_pair(j, 3)
    jw = jlsq.make_apply_w(j)
    tw = lsq.make_apply_w(t)
    got = tw({"u": _t(lu), "v": _t(lv)})
    want = jw({"u": jnp.asarray(lu), "v": jnp.asarray(lv)})
    for k in ("u", "v"):
        assert _rel(got[k].numpy(), want[k]) <= OP_TOL, k
    jwt = jax.linear_transpose(jw, {"u": jnp.zeros(j.lo_fu.shape), "v": jnp.zeros(j.lo_fv.shape)})
    twt = lsq.linear_transpose(tw, {"u": torch.zeros(t.lo_fu.shape),
                                    "v": torch.zeros(t.lo_fv.shape)})
    (want_t,) = jwt({"u": jnp.asarray(hu), "v": jnp.asarray(hv)})
    with torch.no_grad():  # as the CLIs call it
        got_t = twt({"u": _t(hu), "v": _t(hv)})
    for k in ("u", "v"):
        assert _rel(got_t[k].numpy(), want_t[k]) <= OP_TOL, k


def test_g_and_its_adjoint_match_jax(geoms):
    j, t = geoms
    _, _, lu, lv = _random_pair(j, 4)
    x = np.random.RandomState(5).randn(*j.lo_cells.shape).astype(np.float32)
    jg = jlsq.make_apply_g(j)
    got = lsq.make_apply_g(t)(_t(x))
    want = jg(jnp.asarray(x))
    for k in ("u", "v"):
        assert _rel(got[k].numpy(), want[k]) <= OP_TOL, k
    (want_t,) = jax.linear_transpose(jg, jnp.zeros(j.lo_cells.shape))(
        {"u": jnp.asarray(lu), "v": jnp.asarray(lv)})
    got_t = lsq.make_apply_gt(t)({"u": _t(lu), "v": _t(lv)})
    assert _rel(got_t.numpy(), want_t) <= OP_TOL


@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_tree_cg_solves_spd_system(check_every):
    """The JAX test's SPD system; any host-read interval stops where the
    per-iteration test does."""
    rng = np.random.RandomState(0)
    m = rng.randn(6, 6).astype(np.float32)
    a = m @ m.T + 0.5 * np.eye(6, dtype=np.float32)
    b = rng.randn(6).astype(np.float32)
    sol, iters = lsq.tree_cg(lambda x: {"x": _t(a) @ x["x"]}, {"x": _t(b)}, tol=1e-10,
                             max_iter=200, check_every=check_every)
    np.testing.assert_allclose(sol["x"].numpy(), np.linalg.solve(a, b), atol=1e-4)
    ref, ref_iters = lsq.tree_cg(lambda x: {"x": _t(a) @ x["x"]}, {"x": _t(b)}, tol=1e-10,
                                 max_iter=200, check_every=1)
    assert int(iters) == int(ref_iters)
    np.testing.assert_array_equal(sol["x"].numpy(), ref["x"].numpy())


def _dense_kkt(geom, hu, hv, pu, pv, beta):
    """The exact constrained solution on the valid faces, from dense W and G
    (the reference's Lagrange construction [M G; G^T 0][v; l] = [b; 0]),
    and the valid-face mask."""
    apply_w, apply_g = lsq.make_apply_w(geom), lsq.make_apply_g(geom)
    fm = np.concatenate([geom.lo_fu.ravel(), geom.lo_fv.ravel()])
    valid = fm > 0
    nu = geom.lo_fu.size

    def flat(vec):
        return np.concatenate([vec["u"].numpy().ravel(), vec["v"].numpy().ravel()])

    cols = []
    for k in np.nonzero(valid)[0]:
        e = np.zeros(fm.size, np.float32)
        e[k] = 1.0
        cols.append(flat(apply_w({"u": _t(e[:nu].reshape(geom.lo_fu.shape)),
                                  "v": _t(e[nu:].reshape(geom.lo_fv.shape))})))
    w = np.stack(cols, 1).astype(np.float64)
    vh = np.concatenate([hu.ravel(), hv.ravel()]) * np.concatenate(
        [geom.hi_fu.ravel(), geom.hi_fv.ravel()])
    prev = (np.concatenate([pu.ravel(), pv.ravel()]) * fm)[valid]
    ridge = 2 * beta if beta > 0 else 1e-6
    m = w.T @ w + ridge * np.eye(w.shape[1])
    b = w.T @ vh + 2 * beta * prev
    cells = geom.lo_cells
    g = []
    for k in np.nonzero(cells.ravel() > 0)[0]:
        e = np.zeros(cells.size, np.float32)
        e[k] = 1.0
        g.append(flat(apply_g(_t(e.reshape(cells.shape))))[valid])
    g = np.stack(g, 1)
    nf, nc = g.shape
    kkt = np.zeros((nf + nc, nf + nc))
    kkt[:nf, :nf], kkt[:nf, nf:], kkt[nf:, :nf] = m, g, g.T
    return np.linalg.lstsq(kkt, np.concatenate([b, np.zeros(nc)]), rcond=None)[0][:nf], valid


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_constrained_correction_matches_jax(geoms, seed, beta):
    """solve_correction at its defaults (tol 1e-4, 600 iterations) on a
    karman_domain(8) pair at scale 4, warm-started from a previous frame,
    held to the JAX package and both to the exact solution (see
    CONSTRAINED_REL_TOL)."""
    j, t = geoms
    hu, hv, lu, lv = _random_pair(j, seed)
    pu, pv = 0.3 * lu, 0.3 * lv
    want = jlsq.solve_correction(j, jnp.asarray(hu), jnp.asarray(hv), jnp.asarray(pu),
                                 jnp.asarray(pv), beta=beta, constrained=True)
    with torch.no_grad():
        cu, cv, info = lsq.solve_correction(t, _t(hu), _t(hv), _t(pu), _t(pv), beta=beta,
                                            constrained=True)
    exact, valid = _dense_kkt(t, hu, hv, pu, pv, beta)
    jax_sol = np.concatenate([np.asarray(w).ravel() for w in want])[valid]
    port = np.concatenate([cu.numpy().ravel(), cv.numpy().ravel()])[valid]
    scale = np.abs(exact).max()
    assert np.abs(port - jax_sol).max() <= CONSTRAINED_REL_TOL * scale
    assert np.abs(port - exact).max() <= ORACLE_REL_TOL * scale
    assert np.abs(jax_sol - exact).max() <= ORACLE_REL_TOL * scale
    assert int(info["outer"]) > 0 and int(info["inner"]) > 0


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_unconstrained_correction_matches_jax(geoms, beta):
    j, t = geoms
    hu, hv, lu, lv = _random_pair(j, 6)
    want = jlsq.solve_correction(j, jnp.asarray(hu), jnp.asarray(hv), jnp.asarray(0.3 * lu),
                                 jnp.asarray(0.3 * lv), beta=beta, constrained=False)
    with torch.no_grad():
        cu, cv, info = lsq.solve_correction(t, _t(hu), _t(hv), _t(0.3 * lu), _t(0.3 * lv),
                                            beta=beta, constrained=False)
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    for got, w in zip((cu, cv), want):
        assert np.abs(got.numpy() - np.asarray(w)).max() <= UNCONSTRAINED_REL_TOL * scale
    assert int(info["outer"]) > 0 and int(info["inner"]) == 0


@pytest.mark.parametrize("seed", range(6))
def test_constrained_solution_is_divergence_free(geoms, seed):
    """The JAX test's bound (tests/test_pre_lsq.py): G^T v on the valid
    cells below 5e-3 of the correction's max, on the karman_domain(8) pair
    at the defaults the generator runs."""
    t = geoms[1]
    rng = np.random.RandomState(seed)
    hu, hv = (rng.randn(*a.shape).astype(np.float32) for a in (t.hi_fu, t.hi_fv))
    zu, zv = np.zeros(t.lo_fu.shape, np.float32), np.zeros(t.lo_fv.shape, np.float32)
    with torch.no_grad():
        cu, cv, _ = lsq.solve_correction(t, _t(hu), _t(hv), _t(zu), _t(zv), beta=1.0,
                                         constrained=True)
    div = lsq.make_apply_gt(t)({"u": cu, "v": cv}) * _t(t.lo_cells)
    scale = float(cu.abs().max()) + 1e-9
    assert float(div.abs().max()) / scale < 5e-3
    assert scale > 1e-4


def _box():
    """The JAX test's geometry: an 8x8 box at scale 4."""
    return lsq.build_pre_geometry(tgrids.Domain((8, 8), (32.0, 32.0)),
                                  tgrids.Domain((32, 32), (32.0, 32.0)), 4, bnd=2)


@pytest.mark.parametrize("seed", range(6))
def test_constrained_box_solution_is_divergence_free(seed):
    """The JAX test itself (tests/test_pre_lsq.py: seed 2, tol 1e-8, 4000
    iterations, the bound 5e-3 of the max) in float32, and five more seeds:
    at tol 1e-8 the projected CG runs into the float32 noise floor, where
    its r.z may stay positive, and stops once r.z rises (7-9 iterations;
    the JAX package stops after 7-8)."""
    box = _box()
    rng = np.random.RandomState(seed)
    hu, hv = (rng.randn(*a.shape).astype(np.float32) for a in (box.hi_fu, box.hi_fv))
    zu, zv = np.zeros(box.lo_fu.shape, np.float32), np.zeros(box.lo_fv.shape, np.float32)
    with torch.no_grad():
        cu, cv, info = lsq.solve_correction(box, _t(hu), _t(hv), _t(zu), _t(zv), beta=1.0,
                                            constrained=True, tol=1e-8, max_iter=4000)
    div = lsq.make_apply_gt(box)({"u": cu, "v": cv}) * _t(box.lo_cells)
    scale = float(cu.abs().max()) + 1e-9
    assert float(div.abs().max()) / scale < 5e-3
    assert scale > 1e-4
    assert 0 < int(info["outer"]) < 20


def test_constrained_box_solve_converges_in_float64():
    """The JAX test's 8x8 box (tests/test_pre_lsq.py) with the port's solve
    in float64: the projected CG stops after a few iterations on an exactly
    divergence-free field."""
    box = _box()
    for name in ("lo_cells", "lo_fu", "lo_fv", "hi_fu", "hi_fv"):
        object.__setattr__(box, name, getattr(box, name).astype(np.float64))
    rng = np.random.RandomState(2)
    hu, hv = (torch.from_numpy(rng.randn(*a.shape)) for a in (box.hi_fu, box.hi_fv))
    zu, zv = torch.zeros(box.lo_fu.shape, dtype=torch.float64), \
        torch.zeros(box.lo_fv.shape, dtype=torch.float64)
    with torch.no_grad():
        cu, cv, info = lsq.solve_correction(box, hu, hv, zu, zv, beta=1.0, constrained=True)
    div = lsq.make_apply_gt(box)({"u": cu, "v": cv}) * torch.from_numpy(box.lo_cells)
    assert float(div.abs().max()) < 1e-10 * float(cu.abs().max())
    assert 0 < int(info["outer"]) < 20


class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def karman_pre_inner():
    """The karman_pre cell's geometry (karman_domain(32) against
    karman_domain(128), scale 4, bnd 2) and the operator, tolerance and cap
    of its projections' inner solve, as `solve_correction` hands them to
    `tree_cg` (captured at the first projection, which ends the solve)."""
    geom = lsq.build_pre_geometry(karman_domain(32), karman_domain(128), 4, bnd=2)
    got = {}

    def capture(matvec, b, tol, max_iter):
        got.update(matvec=matvec, tol=tol, max_iter=max_iter)
        raise _Captured

    zeros = [torch.zeros(getattr(geom, n).shape) for n in ("hi_fu", "hi_fv", "lo_fu", "lo_fv")]
    with mock.patch.object(lsq, "tree_cg", capture), torch.no_grad(), \
            pytest.raises(_Captured):
        lsq.solve_correction(geom, *zeros, beta=1.0)
    return geom, got


def _cells_and_faces(geom):
    return [_t(getattr(geom, n)) for n in ("lo_cells", "lo_fu", "lo_fv")]


@pytest.mark.parametrize("seed", range(4))
def test_kernel_operator_is_the_projections_operator(karman_pre_inner, seed):
    """The fused CG kernel's operator (kernels/cg.py `masked_matvec`, the
    cell mask as its fluid) is the projection's G^T G to the bit on fields
    that are 0 off the cells, as the projection's iterates are."""
    geom, inner = karman_pre_inner
    cells, fu, fv = _cells_and_faces(geom)
    x = _t(np.random.RandomState(seed).randn(*geom.lo_cells.shape)) * cells
    assert torch.equal(masked_matvec(cells, fu, fv)(x), inner["matvec"](x))


@pytest.mark.parametrize("seed", range(4))
def test_kernel_twin_solves_the_projection_as_tree_cg(karman_pre_inner, seed):
    """The kernel's plain twin on a projection's right-hand side G^T v on
    the cells (cold start, the projection's tolerance and cap) gives
    `tree_cg`'s iterations and solution to the bit, 0 off the cells: what
    the card's route runs in place of `tree_cg`."""
    geom, inner = karman_pre_inner
    assert (inner["tol"], inner["max_iter"]) == (1e-4, lsq.INNER_MAX_ITER)
    cells, fu, fv = _cells_and_faces(geom)
    rng = np.random.RandomState(seed)
    v = {"u": _t(rng.randn(*geom.lo_fu.shape)), "v": _t(rng.randn(*geom.lo_fv.shape))}
    rhs = lsq.make_apply_gt(geom)(v) * cells
    want, want_n = lsq.tree_cg(inner["matvec"], rhs, tol=inner["tol"], max_iter=inner["max_iter"])
    got, got_n = cg_solve_plain(rhs, torch.zeros_like(rhs), cells, fu, fv, inner["tol"],
                                inner["max_iter"])
    assert 0 < int(got_n) < inner["max_iter"] and int(got_n) == int(want_n)
    assert torch.equal(got, want)
    assert float(got[cells == 0].abs().max()) == 0.0


def test_projections_on_the_cpu_run_tree_cg(geoms):
    """On the CPU every projection's inner solve is `tree_cg` and none is
    counted as the kernel's."""
    t = geoms[1]
    hu, hv, lu, lv = _random_pair(t, 7)
    assert not lsq.inner_on_kernel(torch.zeros(t.lo_cells.shape))
    with profiling.recording() as rec, torch.no_grad():
        lsq.solve_correction(t, _t(hu), _t(hv), _t(0.3 * lu), _t(0.3 * lv), beta=1.0)
    got = rec.read()
    assert [s[0] for s in got["spans"]].count("silt.pre.lsq.project") > 0
    assert "pre.lsq_kernel_projections" not in got["counters"]
