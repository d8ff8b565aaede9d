"""The one differentiable pressure solve, `silt::pressure_cg_solve`
(ops/poisson.py), on each of the five routes `pressure_route` picks (CPU).

* The op's (x, iterations) are those of the route's wrapper called
  directly, to the bit, cold and warm-started; its forward and adjoint
  iterations are counted as `pressure.iters` and `pressure.adjoint_iters`.
* The gradient of sum(x * w) with respect to b is a cold solve of w by the
  same wrapper, to the bit; the multigrid adjoint reuses the forward's
  hierarchy (`cached_hierarchy`, keyed by the masks).
* `solve_pressure` under a remat step is one taped site per call on every
  route, and the step's gradient through the replayed sites is the one
  without remat, to the bit.

tests/test_torch_poisson.py, test_torch_cg.py and test_torch_multigrid.py
hold each route against the JAX package. This file imports nothing of JAX.
"""

from __future__ import annotations

import pytest
import torch

from solver_in_the_loop_torch.core.grids import Boundary, Domain
from solver_in_the_loop_torch.kernels import cg
from solver_in_the_loop_torch.ops import multigrid as mg
from solver_in_the_loop_torch.ops.poisson import (
    fd_factors,
    masks_from_fluid_cells,
    pressure_cg_solve,
    pressure_route,
    solve_pressure,
)
from solver_in_the_loop_torch.train.trainer import remat_policy_ops
from solver_in_the_loop_torch.utils import profiling, remat

torch.set_num_threads(1)

TOL, MAX_ITER = 1e-5, 1000

# route: (batch, height, width, precon, periodic), a problem that
# `pressure_route` sends there on the CPU
PROBLEMS = {
    "pcg": (2, 16, 8, "fd", False),
    "cg": (2, 16, 8, "none", False),
    "pcg_plain": (cg.MAX_BATCH + 1, 16, 8, "fd", False),
    "periodic_cg": (2, 24, 20, "fd", True),
    "multigrid": (1, 128, 64, "fd", False),
}
ROUTES = list(PROBLEMS)


def _problem(route, seed=0):
    """(masks, b, a warm start, a cotangent, precon, periodic): b and the warm
    start zero on the obstacle's cells and, on the periodic domain, of zero
    mean on the fluid cells (the periodic operator's null space)."""
    batch, h, w, precon, periodic = PROBLEMS[route]
    fluid = torch.ones((1, h, w))
    fluid[:, h // 3:h // 2, w // 4:w // 2] = 0.0
    dom = Domain((h, w), (float(h), float(w)), Boundary.PERIODIC if periodic else Boundary.OPEN)
    masks = masks_from_fluid_cells(fluid, dom)
    gen = torch.Generator().manual_seed(seed)

    def field():
        a = torch.randn((batch, h, w), generator=gen) * fluid
        if periodic:
            a = a - fluid * a.sum(dim=(1, 2), keepdim=True) / fluid.sum()
        return a.contiguous()

    b, warm, cot = field(), field(), field()
    assert pressure_route(b.shape, "cpu", periodic, precon) == route
    return masks, b, (0.1 * warm).contiguous(), cot, precon, periodic


def _direct(route, b, x0, masks):
    """The route's wrapper, called directly."""
    ops = (b, x0, masks.fluid, masks.face_u, masks.face_v)
    fd = fd_factors(b.shape[1], b.shape[2], b.device)
    if route == "pcg":
        return cg.pcg_solve(*ops, *fd, TOL, MAX_ITER)
    if route == "pcg_plain":
        return cg.pcg_solve_plain(*ops, *fd, TOL, MAX_ITER)
    if route == "cg":
        return cg.cg_solve(*ops, TOL, MAX_ITER)
    if route == "periodic_cg":
        return cg.periodic_cg_solve(*ops, TOL, MAX_ITER)
    return mg.mg_solve(*ops, TOL, MAX_ITER)


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("route", ROUTES)
def test_the_op_is_its_routes_solver_forward_and_adjoint(route, start, monkeypatch):
    monkeypatch.setattr(mg, "_HIERARCHIES", {})
    masks, b, warm, w, _, _ = _problem(route)
    x0 = warm if start == "warm" else torch.zeros_like(b)
    want_x, want_iters = _direct(route, b, x0, masks)
    want_grad, want_adjoint_iters = _direct(route, w, torch.zeros_like(w), masks)

    b_in = b.clone().requires_grad_()
    with profiling.recording() as rec:
        x, iters = pressure_cg_solve(b_in, x0, masks.fluid, masks.face_u, masks.face_v, route,
                                     TOL, MAX_ITER)
        (grad,) = torch.autograd.grad((x * w).sum(), b_in)
    counters = rec.read()["counters"]

    assert torch.equal(x.detach(), want_x) and int(iters) == int(want_iters) > 0
    assert torch.equal(grad, want_grad)
    assert [int(k) for k in counters["pressure.iters"]] == [int(want_iters)]
    assert [int(k) for k in counters["pressure.adjoint_iters"]] == [int(want_adjoint_iters)]
    # the adjoint solved on the forward's hierarchy; no other route builds one
    assert list(mg._HIERARCHIES) == ([(id(masks.fluid), id(masks.face_u), id(masks.face_v))]
                                     if route == "multigrid" else [])


@pytest.mark.parametrize("route", ROUTES)
def test_solve_pressure_is_one_remat_site_per_call(route):
    masks, b, _, w, precon, periodic = _problem(route, seed=1)

    def step(div):
        p, _ = solve_pressure(div, masks, periodic, TOL, MAX_ITER, precon=precon)
        p2, _ = solve_pressure(div + p, masks, periodic, TOL, MAX_ITER, x0=p, precon=precon)
        return (p2,)

    saves = frozenset(remat_policy_ops("pressure"))
    grads = []
    for taped in (False, True):
        div = (-b).requires_grad_()
        with profiling.recording() as rec:
            (p2,) = remat.checkpoint(step, saves, (), div) if taped else step(div)
            (grad,) = torch.autograd.grad((p2 * w).sum(), div)
        grads.append(grad)
    counters = rec.read()["counters"]
    assert counters["remat.taped"] == [2] and counters["remat.replayed"] == [2]
    assert len(counters["pressure.iters"]) == 2  # the replay ran no solve again
    assert torch.equal(grads[0], grads[1])
