"""The port's CUDA kernels against their plain PyTorch twins, on the card.

The kernels have no CPU mode, so every test here needs a CUDA card (and
`nvcc` to build csrc/) and skips without one. Run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py configures JAX, which the card's
machine does not have; this file imports nothing of JAX). Tolerances are
those of solver_in_the_loop_torch/parity.py, which chip_smoke.py holds the
card to: the tap-sum forward and backward bit for bit on the
offsets the solver passes, the PCG within one iteration and 1e-4 of the
solution's max, a 10-step rollout within 1e-3, one SOL-32 train step's
losses within 1e-4 and gradients within 1e-3.
"""

from __future__ import annotations

import pytest
import torch

from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.kernels import advect, cg
from solver_in_the_loop_torch.kernels.advect import (
    tap_sum_bwd,
    tap_sum_bwd_plain,
    tap_sum_fwd,
    tap_sum_fwd_plain,
)
from solver_in_the_loop_torch.kernels.cg import pcg_solve, pcg_solve_plain
from solver_in_the_loop_torch.models.networks import disable_tf32
from solver_in_the_loop_torch.ops import interp
from solver_in_the_loop_torch.ops.poisson import fd_factors
from solver_in_the_loop_torch.physics.karman import KarmanFlow, initial_state, karman_domain
from solver_in_the_loop_torch.train.rollout import karman_rollout

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    disable_tf32()
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape", [(1, 64, 32), (1, 64, 33), (1, 65, 32), (5, 64, 32)])
@pytest.mark.parametrize("periodic", [False, True])
def test_tap_sum_kernel_equals_plain(device, shape, periodic):
    gen = torch.Generator(device=device).manual_seed(1)
    vals = torch.randn(shape, generator=gen, device=device)
    dy = torch.rand(shape, generator=gen, device=device) * 5.0 - 2.5
    dx = torch.rand(shape, generator=gen, device=device) * 5.0 - 2.5
    for offsets in ((dy, dx), (dy.round(), dx.round())):
        launches = tap_sum_fwd.launches
        got = tap_sum_fwd(vals, *offsets, 2, periodic)
        assert tap_sum_fwd.launches == launches + 1
        assert torch.equal(got, tap_sum_fwd_plain(vals, *offsets, 2, periodic))


def test_tap_sum_rejects_bad_input(device):
    vals = torch.zeros(1, 8, 8, device=device)
    with pytest.raises(ValueError):
        tap_sum_fwd(vals, vals.double(), vals, 2, False)
    with pytest.raises(ValueError):
        tap_sum_fwd(vals, vals.transpose(1, 2), vals, 2, False)


@pytest.mark.parametrize("batch", [1, 5])
def test_pcg_kernel_matches_plain(device, batch):
    dom = karman_domain(32)
    flow = KarmanFlow(dom, advection="shift", device=device)
    gen = torch.Generator(device=device).manual_seed(batch)
    fluid = flow.masks.fluid
    rhs = (torch.randn((batch, dom.ny, dom.nx), generator=gen, device=device) * fluid).contiguous()
    vy, vx, invd = fd_factors(dom.ny, dom.nx, device)
    for x0 in (torch.zeros_like(rhs), (0.1 * rhs).contiguous()):
        args = (rhs, x0, fluid, flow.masks.face_u, flow.masks.face_v, vy, vx, invd, 1e-5, 1000)
        x_k, it_k = pcg_solve(*args)
        x_p, it_p = pcg_solve_plain(*args)
        assert abs(int(it_k) - int(it_p)) <= 1
        assert _rel(x_k, x_p) <= 1e-4


def test_rollout_with_kernels_matches_plain(device, monkeypatch):
    dom = karman_domain(32)
    re = torch.tensor([240000.0, 960000.0], device=device)
    flow = KarmanFlow(dom, advection="shift", device=device)
    d0, v0 = initial_state(dom, 2, device)
    launches = (tap_sum_fwd.launches, pcg_solve.launches)
    with_kernels = karman_rollout(flow, d0, v0, re, 10)
    assert (tap_sum_fwd.launches, pcg_solve.launches) == (launches[0] + 30, launches[1] + 10)
    # the same solver with both kernels' wrappers swapped for their plain twins
    monkeypatch.setattr(advect, "tap_sum_fwd", tap_sum_fwd_plain)
    monkeypatch.setattr(cg, "pcg_solve", pcg_solve_plain)
    plain = karman_rollout(flow, d0, v0, re, 10)
    assert (tap_sum_fwd.launches, pcg_solve.launches) == (launches[0] + 30, launches[1] + 10)
    for key in ("dens", "u", "v"):
        assert _rel(with_kernels[key], plain[key]) <= 1e-3


@pytest.mark.parametrize("shape", [(3, 64, 32), (3, 64, 33), (3, 65, 32), (1, 64, 32)])
@pytest.mark.parametrize("periodic", [False, True])
def test_tap_sum_bwd_kernel_equals_plain(device, shape, periodic):
    gen = torch.Generator(device=device).manual_seed(2)
    vals, g = (torch.randn(shape, generator=gen, device=device) for _ in range(2))
    dy = torch.rand(shape, generator=gen, device=device) * 5.0 - 2.5
    dx = torch.rand(shape, generator=gen, device=device) * 5.0 - 2.5
    for offsets in ((dy, dx), (dy.round(), dx.round())):
        launches = tap_sum_bwd.launches
        got = tap_sum_bwd(vals, *offsets, g, 2, periodic)
        assert tap_sum_bwd.launches == launches + 1
        want = tap_sum_bwd_plain(vals, *offsets, g, 2, periodic)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert _rel(got[0], want[0]) <= parity.TAP_SUM_BWD_DV_REL_TOL


def test_shift_sampler_gradients_equal_plain(device, monkeypatch):
    """Through the solver's own clamps dV is bit-equal too: every tap that
    leaves the field has a weight of exactly 0."""
    gen = torch.Generator(device=device).manual_seed(3)
    shape = (3, 64, 33)
    inputs = [torch.randn(shape, generator=gen, device=device) * s for s in (1.0, 2.0, 2.0)]
    cot = torch.randn(shape, generator=gen, device=device)

    def grads():
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = interp.shifted_stencil_sample(*leaves, 2, False)
        return torch.autograd.grad(out, leaves, cot)

    launches = (tap_sum_fwd.launches, tap_sum_bwd.launches)
    with_kernels = grads()
    assert (tap_sum_fwd.launches, tap_sum_bwd.launches) == (launches[0] + 1, launches[1] + 1)
    with parity.plain_path():
        plain = grads()
    assert all(torch.equal(a, b) for a, b in zip(with_kernels, plain))


def test_train_step_with_kernels_matches_plain(device):
    kernel = parity.parity_summary(parity.parity_step(device))
    with parity.plain_path():
        plain = parity.parity_summary(parity.parity_step(device))
    errors = parity.parity_errors(kernel, plain)
    for key, tol in parity.TRAIN_PARITY_TOL.items():
        assert errors[key] <= tol, (key, errors)
