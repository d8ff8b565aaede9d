"""The port's CUDA kernels against their plain PyTorch twins, on the card.

The kernels have no CPU mode, so every test here needs a CUDA card (and
`nvcc` to build csrc/) and skips without one. Run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py configures JAX, which the card's
machine does not have; this file imports nothing of JAX). Tolerances are
those of solver_in_the_loop_torch/parity.py, which chip_smoke.py holds the
card to: the tap-sum forward and backward bit for bit on the
offsets the solver passes, the PCG within one iteration and 1e-4 of the
solution's max, the unpreconditioned CG within one iteration and 5e-6, both
bit-equal across launches, the conv forward within 1e-5 and its weight gradient within
1e-4 of the output's max, the bf16 conv forward within one bf16 ulp beyond
that and its fp32 weight gradient within 1e-5, a 10-step rollout within
1e-3, one SOL-32 and one SOL-04 train step's losses within 1e-4 and
gradients within 1e-3, and a bf16 SOL-04 step within TRAIN_PARITY_TOL_BF16.
The data-parallel step and the y-sharded step run on two ranks that share
cuda:0 over gloo (tests/torch_dist_ranks.py), each rank launching the
kernels, against the same ranks on the CPU: the train step within those
train tolerances, the sharded step within 1e-5 of each field's max. The
program's spans (utils/profiling.py) hang from the train step's backward
across the autograd engine's thread, and a kernel library's first load is
a span of its own. The remat step equals the step without remat at SOL-32's
shapes, in no more memory. The multigrid V-cycle's CUDA graph replays the
eager cycle to the bit, in a solve, its adjoint and a generator rollout,
under inference mode and outside it, and goes with its hierarchy. The
V-cycle's kernels (csrc/vcycle.cu) give the plain `_v_cycle` to the bit,
launched directly and from the graph, in 2 (levels - 1) + 1 launches, and
run every V-cycle of a multigrid solve on the card. The PRE correction
solve's projections run their inner CG as one `cg_solve` launch each, within
CONSTRAINED_REL_TOL of the same solve on `tree_cg`, the host reading only
the outer loop's stop flag; a field on the card never falls back to
`tree_cg`.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import weakref

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks

from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.kernels import advect, cg, vcycle
from solver_in_the_loop_torch.kernels import conv as kconv
from solver_in_the_loop_torch.kernels.advect import (
    tap_sum_bwd,
    tap_sum_bwd_plain,
    tap_sum_fwd,
    tap_sum_fwd_plain,
)
from solver_in_the_loop_torch.kernels.cg import cg_solve, cg_solve_plain, pcg_solve, pcg_solve_plain
from solver_in_the_loop_torch.models.networks import build_model, disable_tf32
from solver_in_the_loop_torch.ops import interp
from solver_in_the_loop_torch.ops import multigrid as mg
from solver_in_the_loop_torch.core.grids import Boundary, Domain
from solver_in_the_loop_torch.ops.poisson import (
    fd_factors,
    masks_from_fluid_cells,
    pressure_cg_solve,
    pressure_route,
    solve_pressure,
)
from solver_in_the_loop_torch.physics.karman import KarmanFlow, initial_state, karman_domain
from solver_in_the_loop_torch.train.checkpoint import params_to_jax
from solver_in_the_loop_torch.train.rollout import karman_rollout
from solver_in_the_loop_torch.utils import profiling

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


@pytest.mark.parametrize("batch", [1, 3, 5, 8, 9, 16])
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
        x_again, it_again = pcg_solve(*args)  # fixed-order sums: the same bits
        assert torch.equal(x_k, x_again) and int(it_k) == int(it_again)


def _box_problem(device, shape, seed=0):
    """An OPEN box with a disc obstacle, of any shape: a right-hand side on
    its fluid cells, a warm start and the masks."""
    b, h, w = shape
    jj, ii = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    fluid = (((jj - h / 3) ** 2 + (ii - w / 2) ** 2) > (min(h, w) / 5) ** 2).float()[None]
    masks = masks_from_fluid_cells(fluid.to(device),
                                   Domain((h, w), (float(h), float(w)), Boundary.OPEN))
    gen = torch.Generator(device=device).manual_seed(seed)
    rhs = (torch.randn(shape, generator=gen, device=device) * masks.fluid).contiguous()
    warm = (0.1 * torch.randn(shape, generator=gen, device=device) * masks.fluid).contiguous()
    return rhs, warm, masks


# Fields off the PCG kernel's 16x8 tiles: karman at 36x18 (9 tiles, one per
# warp), 80x40 (25: two per warp) and 88x44 (36: three per warp), and the
# gate's thinnest fields, an obstacle-free box of one column or one row.
OFF_TILE_CASES = [(2, 18), (2, 40), (1, 44), (1, 234, 1), (1, 1, 167)]


@pytest.mark.parametrize("case", OFF_TILE_CASES)
def test_cg_kernels_off_the_tiles_match_plain(device, case):
    """Both CG kernels at shapes the gates take off the 64x32 field: the
    preconditioner's tiles padded with zeros, several tiles per warp; the
    solution and iterations against the twins, the same bits twice."""
    if len(case) == 2:
        rhs, masks = _cg_problem(device, case[0], karman_domain(case[1]), seed=case[1])
        warm = (0.1 * rhs).contiguous()
    else:
        rhs, warm, masks = _box_problem(device, case, seed=sum(case))
    shape = tuple(rhs.shape)
    assert cg.pcg_kernel_fits(shape) and cg.cg_kernel_fits(shape)
    fd = fd_factors(shape[1], shape[2], device)
    for x0 in (torch.zeros_like(rhs), warm):
        ops = (rhs, x0, masks.fluid, masks.face_u, masks.face_v)
        for kernel, plain, extra, rel in ((pcg_solve, pcg_solve_plain, fd, parity.PCG_REL_TOL),
                                          (cg_solve, cg_solve_plain, (), parity.CG_REL_TOL)):
            args = (*ops, *extra, 1e-5, 4000)
            x_k, it_k = kernel(*args)
            x_p, it_p = plain(*args)
            assert abs(int(it_k) - int(it_p)) <= parity.PCG_ITER_TOL, (kernel.__name__, it_k, it_p)
            assert _rel(x_k, x_p) <= rel, kernel.__name__
            x_again, _ = kernel(*args)
            assert torch.equal(x_k, x_again), kernel.__name__


def test_cg_kernels_run_max_iter_at_tol_zero(device):
    """tol 0 makes the threshold 0: each kernel runs exactly max_iter
    iterations (the fixed-iteration timing in chip_smoke.py relies on it)."""
    rhs, _, masks = _box_problem(device, (3, 64, 32))
    ops = (rhs, torch.zeros_like(rhs), masks.fluid, masks.face_u, masks.face_v)
    for max_iter in (8, 24):
        _, it = pcg_solve(*ops, *fd_factors(64, 32, device), 0.0, max_iter)
        assert int(it) == max_iter
        _, it = cg_solve(*ops, 0.0, max_iter)
        assert int(it) == max_iter


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


# (shape, max_shift, periodic): the karman training and apply fields on both
# boundaries, the Burgers SOL-04 fields (PERIODIC), and max_shift 1 and 3
TAP_CASES = ([(s, 2, p) for s in [(3, 64, 32), (3, 64, 33), (3, 65, 32), (1, 64, 32)]
              for p in (False, True)]
             + [((5, 32, 33), 2, True), ((5, 33, 32), 2, True), ((3, 64, 32), 1, False),
                ((3, 64, 32), 3, False), ((5, 32, 33), 1, True), ((3, 65, 33), 3, True)])


@pytest.mark.parametrize("shape,m,periodic", TAP_CASES)
@pytest.mark.parametrize("offsets", ["uniform", "integer", "clamped"])
def test_tap_sum_bwd_kernel_equals_plain(device, shape, m, periodic, offsets):
    """Both kernels bit for bit against their twins; dV within
    TAP_SUM_BWD_DV_REL_TOL on unclamped OPEN offsets (the card twin's
    index_add_ adds several non-zero terms into an edge cell with atomics),
    bit for bit on the solver's clamped ones and on PERIODIC fields (one
    reader per tap)."""
    gen = torch.Generator(device=device).manual_seed(sum(shape) + m)
    vals, g = (torch.randn(shape, generator=gen, device=device) for _ in range(2))
    dy, dx = parity.tap_sum_offsets(shape, offsets, m, periodic, gen, device)
    assert torch.equal(tap_sum_fwd(vals, dy, dx, m, periodic),
                       tap_sum_fwd_plain(vals, dy, dx, m, periodic))
    launches = tap_sum_bwd.launches
    got = tap_sum_bwd(vals, dy, dx, g, m, periodic)
    assert tap_sum_bwd.launches == launches + 1
    want = tap_sum_bwd_plain(vals, dy, dx, g, m, periodic)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    if offsets == "clamped" or periodic:
        assert torch.equal(got[0], want[0])
    else:
        assert _rel(got[0], want[0]) <= parity.TAP_SUM_BWD_DV_REL_TOL


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name,value", [("v", float("inf")), ("v", float("nan")),
                                        ("g", float("inf")), ("dy", float("nan"))])
def test_tap_sum_kernels_spread_non_finite_as_plain(device, periodic, name, value):
    """An inf or a NaN among the inputs lands where the twin puts it (the
    blocks that see it sum every tap as the twin does), so the trainer's
    non-finite guard decides alike; the other blocks keep the twin's bits."""
    shape, m = (3, 64, 32), 2
    gen = torch.Generator(device=device).manual_seed(11)
    vals, g = (torch.randn(shape, generator=gen, device=device) for _ in range(2))
    dy, dx = parity.tap_sum_offsets(shape, "clamped", m, periodic, gen, device)
    {"v": vals, "g": g, "dy": dy, "dx": dx}[name][1, 40, 17] = value
    outs = [(tap_sum_fwd(vals, dy, dx, m, periodic), tap_sum_fwd_plain(vals, dy, dx, m, periodic))]
    outs += zip(tap_sum_bwd(vals, dy, dx, g, m, periodic),
                tap_sum_bwd_plain(vals, dy, dx, g, m, periodic))
    for got, want in outs:
        torch.testing.assert_close(got, want, rtol=0.0, atol=0.0, equal_nan=True)
    assert any(not bool(torch.isfinite(want).all()) for _, want in outs)


def test_tap_sum_bwd_rejects_a_shift_beyond_its_tile(device):
    vals = torch.zeros(1, 8, 8, device=device)
    with pytest.raises(ValueError, match="shared-memory tile"):
        tap_sum_bwd(vals, vals, vals, vals, advect.MAX_SHIFT + 1, False)
    assert advect.launch_config((3, 64, 32), 2, backward=True)["grid"] == [1, 16, 3]
    fwd = advect.launch_config((3, 64, 32), 2, backward=False)
    assert fwd == {"grid": [1, 16, 3], "threads": 128, "smem_bytes": 0}
    # the forward takes any shift: a window wider than 64 columns, wrapped many times
    vals = torch.randn(1, 8, 8, device=device)
    dy = torch.full_like(vals, 0.25)
    assert torch.equal(tap_sum_fwd(vals, dy, dy, 40, True),
                       tap_sum_fwd_plain(vals, dy, dy, 40, True))


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


CONV_SHAPES = [  # (B, H, W, Cin, Cout, K): MarsMoon at the Burgers and karman shapes
    (5, 32, 32, 4, 32, 5), (5, 32, 32, 32, 32, 5), (5, 32, 32, 32, 2, 5), (1, 32, 32, 32, 32, 5),
    (3, 64, 32, 3, 32, 5), (1, 64, 32, 32, 2, 5), (5, 32, 32, 32, 32, 3),
    (2, 16, 16, 64, 64, 7),  # four output tiles, two channel chunks, above 48 KB of shared memory
    (1, 64, 32, 32, 64, 5), (1, 64, 32, 64, 2, 5),  # Mercury's conv2 and head at the karman shape
    (2, 33, 17, 5, 3, 5),  # ragged rows, columns and channels
    (8, 32, 32, 32, 32, 5),  # the largest batch
    (1, 64, 32, 3, 32, 3), (1, 64, 32, 3, 32, 7),  # K = 3 and 7 at Cin = 3
]


# the bf16 kernels also at the karman block and head (their input gradients
# too: a Cin < 16 stem dX at 2 -> 32), a packed Cin = 8 (two taps a row),
# one 32-channel chunk holding 20 with an odd Cout, K = 1, an input gradient
# whose two channel chunks each come in one bulk copy (16 -> 64), and a
# packed Cin = 12 at K = 7 (one tap a row, seven groups)
CONV_BF16_SHAPES = CONV_SHAPES + [(3, 64, 32, 32, 32, 5), (3, 64, 32, 32, 2, 5),
                                  (2, 8, 8, 8, 16, 5), (1, 9, 24, 20, 17, 3),
                                  (1, 12, 20, 16, 9, 1), (2, 16, 16, 16, 64, 3),
                                  (1, 16, 24, 12, 20, 7)]
# the fp32 kernels also at JupiterMoon's widths (burgers-pre-train --model
# jupiter_moon): 32 -> 64, 64 -> 64 and 64 -> 32 at 5x5, 64 -> 64 at 3x3
CONV_SHAPES = CONV_SHAPES + [(4, 32, 32, 32, 64, 5), (4, 32, 32, 64, 64, 5),
                             (4, 32, 32, 64, 32, 5), (4, 32, 32, 64, 64, 3)]


def _conv_inputs(device, shape, seed=0):
    b, h, w, cin, cout, k = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, h, w, cin), generator=gen, device=device)
    wt = 0.1 * torch.randn((cout, cin, k, k), generator=gen, device=device)
    bias = 0.1 * torch.randn((cout,), generator=gen, device=device)
    skip = torch.randn((b, h, w, cout), generator=gen, device=device)
    return x, wt, bias, skip


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("act,with_skip", [("none", False), ("relu", True), ("leaky_relu", False),
                                           ("leaky_relu", True)])
def test_conv_fwd_kernel_matches_plain(device, shape, act, with_skip):
    x, wt, bias, skip = _conv_inputs(device, shape)
    w = wt.permute(2, 3, 1, 0)
    skip = skip if with_skip else None
    launches = kconv.conv_fwd.launches
    got = kconv.conv_fwd(x, w, bias, skip, act, 0.3)
    assert kconv.conv_fwd.launches == launches + 1
    assert _rel(got, kconv.conv_fwd_plain(x, w, bias, skip, act, 0.3)) <= parity.CONV_FWD_REL_TOL


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_dgrad_and_wgrad_kernels_match_plain(device, shape):
    x, wt, _, dz = _conv_inputs(device, shape, seed=1)
    w = wt.permute(2, 3, 1, 0)
    got = kconv.conv_fwd(dz, w.transpose(2, 3), flip=True)
    assert _rel(got, kconv.conv_fwd_plain(dz, w.transpose(2, 3), flip=True)) \
        <= parity.CONV_FWD_REL_TOL
    launches = kconv.conv_wgrad.launches
    dw = kconv.conv_wgrad(x, dz, shape[5])
    assert kconv.conv_wgrad.launches == launches + 1
    assert dw.permute(3, 2, 0, 1).is_contiguous()
    assert _rel(dw, kconv.conv_wgrad_plain(x, dz, shape[5])) <= parity.CONV_WGRAD_REL_TOL
    assert torch.equal(dw, kconv.conv_wgrad(x, dz, shape[5]))  # no atomics: the same bits


def test_conv_wgrad_is_bit_equal_over_launches(device):
    """The cluster's partial sums are added in rank order: five launches at
    the Burgers block shape give the same bits."""
    x, _, _, dz = _conv_inputs(device, (5, 32, 32, 32, 32, 5), seed=2)
    first = kconv.conv_wgrad(x, dz, 5)
    for _ in range(4):
        assert torch.equal(kconv.conv_wgrad(x, dz, 5), first)


def test_conv_rejects_bad_input(device):
    x, wt, bias, _ = _conv_inputs(device, (1, 8, 8, 4, 4, 3))
    w = wt.permute(2, 3, 1, 0)
    with pytest.raises(ValueError):
        kconv.conv_fwd(x.permute(0, 2, 1, 3), w, bias)
    with pytest.raises(ValueError):
        kconv.conv_fwd(x, w[:2, :2], bias)
    with pytest.raises(ValueError):
        kconv.conv_fwd(x, w, bias.double())


def test_burgers_train_step_with_kernels_matches_plain(device):
    launches = (kconv.conv_fwd.launches, kconv.conv_wgrad.launches)
    kernel = parity.parity_summary(parity.burgers_parity_step(device, "kernel"))
    # 4 steps x 12 convs forward, 47 input gradients (not the step-0 stem), 48 weight gradients
    assert (kconv.conv_fwd.launches, kconv.conv_wgrad.launches) == (launches[0] + 95,
                                                                     launches[1] + 48)
    with parity.plain_path():
        plain = parity.parity_summary(parity.burgers_parity_step(device, "kernel"))
    errors = parity.parity_errors(kernel, plain)
    for key, tol in parity.TRAIN_PARITY_TOL.items():
        assert errors[key] <= tol, (key, errors)


@pytest.mark.parametrize("shape", CONV_BF16_SHAPES)
@pytest.mark.parametrize("act,with_skip", [("none", False), ("relu", True), ("leaky_relu", False),
                                           ("leaky_relu", True)])
def test_conv_fwd_bf16_kernel_matches_plain(device, shape, act, with_skip):
    """The bf16 forward kernel (csrc/conv_bf16.cu) within one bf16 ulp of its
    twin beyond the fp32 sums' tolerance (parity.bf16_errors), one launch,
    the same bits on a second launch."""
    x, wt, bias, skip = (t.to(torch.bfloat16) for t in _conv_inputs(device, shape))
    w = wt.permute(2, 3, 1, 0)
    skip = skip if with_skip else None
    launches = (kconv.conv_fwd_bf16.launches, kconv.conv_fwd.launches)
    got = kconv.conv_fwd(x, w, bias, skip, act, 0.3)
    assert (kconv.conv_fwd_bf16.launches, kconv.conv_fwd.launches) == (launches[0] + 1,
                                                                       launches[1])
    assert got.dtype == torch.bfloat16
    want = kconv.conv_fwd_plain(x, w, bias, skip, act, 0.3)
    assert parity.bf16_errors(got, want) <= parity.CONV_BF16_ULPS
    assert torch.equal(got, kconv.conv_fwd(x, w, bias, skip, act, 0.3))  # no atomics


@pytest.mark.parametrize("shape", CONV_BF16_SHAPES)
def test_conv_dgrad_and_wgrad_bf16_kernels_match_plain(device, shape):
    x, wt, _, dz = (t.to(torch.bfloat16) for t in _conv_inputs(device, shape, seed=1))
    w = wt.permute(2, 3, 1, 0)
    got = kconv.conv_fwd_bf16(dz, w.transpose(2, 3), flip=True)
    assert parity.bf16_errors(got, kconv.conv_fwd_plain(dz, w.transpose(2, 3), flip=True)) \
        <= parity.CONV_BF16_ULPS
    assert torch.equal(got, kconv.conv_fwd_bf16(dz, w.transpose(2, 3), flip=True))
    launches = kconv.conv_wgrad_bf16.launches
    dw = kconv.conv_wgrad(x, dz, shape[5])
    assert kconv.conv_wgrad_bf16.launches == launches + 1
    assert dw.dtype == torch.float32 and dw.permute(3, 2, 0, 1).is_contiguous()
    assert _rel(dw, kconv.conv_wgrad_plain(x, dz, shape[5])) <= parity.CONV_WGRAD_BF16_REL_TOL
    assert torch.equal(dw, kconv.conv_wgrad_bf16(x, dz, shape[5]))  # no atomics: the same bits


def test_conv_bf16_rejects_bad_input(device):
    x, wt, bias, _ = (t.to(torch.bfloat16) for t in _conv_inputs(device, (1, 8, 8, 4, 4, 3)))
    w = wt.permute(2, 3, 1, 0)
    with pytest.raises(ValueError):
        kconv.conv_fwd_bf16(x, w.float(), bias)  # mixed dtypes
    with pytest.raises(ValueError):
        kconv.conv_fwd_bf16(x.permute(0, 2, 1, 3), w, bias)
    with pytest.raises(ValueError):
        kconv.conv_wgrad_bf16(x, x.float(), 3)


def test_burgers_bf16_train_step_with_kernels_matches_golden(device):
    """One SOL-04 step with --bf16 on the bf16 kernels: their launches, and
    the JAX golden (the Pallas conv in interpret mode) and the plain path
    within TRAIN_PARITY_TOL_BF16."""
    launches = (kconv.conv_fwd_bf16.launches, kconv.conv_wgrad_bf16.launches,
                kconv.conv_fwd.launches)
    kernel = parity.parity_summary(parity.burgers_parity_step(device, "kernel",
                                                              compute_dtype=torch.bfloat16))
    assert (kconv.conv_fwd_bf16.launches, kconv.conv_wgrad_bf16.launches,
            kconv.conv_fwd.launches) == (launches[0] + 95, launches[1] + 48, launches[2])
    with parity.plain_path():
        plain = parity.parity_summary(parity.burgers_parity_step(device, "kernel",
                                                                 compute_dtype=torch.bfloat16))
    golden = parity.train_golden_summary(parity.BURGERS_TRAIN_GOLDEN_BF16)
    for against in (plain, golden):
        errors = parity.parity_errors(kernel, against)
        for key, tol in parity.TRAIN_PARITY_TOL_BF16.items():
            assert errors[key] <= tol, (key, errors)


def _cg_problem(device, batch, dom=None, seed=0):
    dom = dom or karman_domain(32)
    flow = KarmanFlow(dom, advection="shift", device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rhs = (torch.randn((batch, dom.ny, dom.nx), generator=gen, device=device)
           * flow.masks.fluid).contiguous()
    return rhs, flow.masks


@pytest.mark.parametrize("batch", [1, 3, 5, 8, 9, 16])
def test_cg_kernel_matches_plain(device, batch):
    rhs, masks = _cg_problem(device, batch, seed=batch)
    for x0 in (torch.zeros_like(rhs), (0.1 * rhs).contiguous()):
        args = (rhs, x0, masks.fluid, masks.face_u, masks.face_v, 1e-5, 1000)
        launches = cg_solve.launches
        x_k, it_k = cg_solve(*args)
        assert cg_solve.launches == launches + 1
        x_p, it_p = cg_solve_plain(*args)
        assert abs(int(it_k) - int(it_p)) <= parity.CG_ITER_TOL
        assert _rel(x_k, x_p) <= parity.CG_REL_TOL
        x_again, it_again = cg_solve(*args)  # fixed-order sums: the same bits
        assert torch.equal(x_k, x_again) and int(it_k) == int(it_again)


def test_cg_kernel_at_eight_cells_per_thread(device):
    rhs, masks = _cg_problem(device, 2, karman_domain(64), seed=3)
    args = (rhs, torch.zeros_like(rhs), masks.fluid, masks.face_u, masks.face_v, 1e-5, 2000)
    x_k, it_k = cg_solve(*args)
    x_p, it_p = cg_solve_plain(*args)
    assert abs(int(it_k) - int(it_p)) <= parity.CG_ITER_TOL
    assert _rel(x_k, x_p) <= parity.CG_REL_TOL


def test_cg_kernel_rejects_what_it_does_not_take(device):
    rhs, masks = _cg_problem(device, cg.MAX_BATCH + 1)
    with pytest.raises(ValueError, match="does not fit"):
        cg_solve(rhs, torch.zeros_like(rhs), masks.fluid, masks.face_u, masks.face_v, 1e-5, 10)
    rhs = rhs[:2]
    with pytest.raises(ValueError, match="contiguous float32"):
        cg_solve(rhs.double(), torch.zeros_like(rhs), masks.fluid, masks.face_u, masks.face_v,
                 1e-5, 10)
    with pytest.raises(ValueError, match="contiguous float32"):
        cg_solve(rhs, torch.zeros_like(rhs), masks.fluid,
                 masks.face_u.transpose(1, 2).contiguous().transpose(1, 2), masks.face_v,
                 1e-5, 10)


def test_cg_adjoint_matches_plain(device):
    """The gradient through the "cg" route is a cold solve by the kernel."""
    rhs, masks = _cg_problem(device, 3, seed=4)
    cot = torch.randn(rhs.shape, generator=torch.Generator(device=device).manual_seed(5),
                      device=device)

    def grad():
        b = rhs.clone().requires_grad_()
        x, _ = pressure_cg_solve(b, torch.zeros_like(rhs), masks.fluid, masks.face_u,
                                 masks.face_v, "cg", 1e-5, 1000)
        return torch.autograd.grad(x, b, cot)[0]

    launches = cg_solve.launches
    with_kernel = grad()
    assert cg_solve.launches == launches + 2  # forward and adjoint
    with parity.plain_path():
        plain = grad()
    assert _rel(with_kernel, plain) <= parity.CG_REL_TOL


def test_rollout_without_preconditioner_matches_plain(device):
    dom = karman_domain(32)
    re = torch.tensor([240000.0, 960000.0], device=device)
    flow = KarmanFlow(dom, advection="shift", pressure_precon="none", device=device)
    d0, v0 = initial_state(dom, 2, device)
    launches = (cg_solve.launches, pcg_solve.launches)
    with_kernels = karman_rollout(flow, d0, v0, re, 10)
    assert (cg_solve.launches, pcg_solve.launches) == (launches[0] + 10, launches[1])
    with parity.plain_path():
        plain = karman_rollout(flow, d0, v0, re, 10)
    for key in ("dens", "u", "v"):
        assert _rel(with_kernels[key], plain[key]) <= parity.ROLLOUT_REL_TOL


def test_multigrid_route_on_the_card_matches_cpu(device):
    """At 256x128 and batch 6, beyond the JAX package's Pallas gate, the card
    takes multigrid as the JAX package does (no kernel launch), with the
    CPU's result and a gradient."""
    rhs, masks = _cg_problem(device, 6, karman_domain(128), seed=6)
    assert pressure_route(rhs.shape, device) == "multigrid"
    kernels = (cg_solve, pcg_solve, cg.cg_cluster_solve, cg.pcg_cluster_solve)
    launches = [k.launches for k in kernels]
    div = (-rhs).requires_grad_()
    p, iters = solve_pressure(div, masks)
    p.sum().backward()
    assert [k.launches for k in kernels] == launches
    cpu_masks = KarmanFlow(karman_domain(128), advection="shift").masks
    p_cpu, _ = solve_pressure(-rhs.cpu(), cpu_masks)
    assert 0 < int(iters) < 200 and torch.isfinite(div.grad).all()
    assert _rel(p.detach().cpu(), p_cpu) <= parity.PCG_REL_TOL


@pytest.mark.parametrize("batch,res", [(6, 128), (1, 192)])
@pytest.mark.parametrize("inference", [False, True])
def test_graphed_vcycle_is_bit_equal_to_eager(device, batch, res, inference):
    """The V-cycle's graph gives the eager `_v_cycle` to the bit, at the
    hi-res generator's (6, 256, 128) on the karman masks and at (1, 384,
    192), on the right-hand side it was captured with and on others, under
    `torch.inference_mode()` and outside it; what it returns is a copy that
    the next replay leaves alone."""
    rhs, masks = _cg_problem(device, batch, karman_domain(res), seed=res)
    h = mg.cached_hierarchy(masks.fluid, masks.face_u, masks.face_v)
    gen = torch.Generator(device=device).manual_seed(batch)
    with torch.inference_mode(inference):
        graph = mg.GraphedCycle(h, rhs)
        outs = []
        for b in (rhs, torch.randn(rhs.shape, generator=gen, device=device) * masks.fluid, rhs):
            outs.append(graph(b))
            assert torch.equal(outs[-1], mg._v_cycle(h, b, 0))
        assert torch.equal(outs[0], outs[2]) and not torch.equal(outs[0], outs[1])
    assert not graph.input.is_inference() and not graph.output.is_inference()


@pytest.mark.parametrize("first", ["rollout", "training"])
def test_mg_solve_with_the_graph_equals_the_eager_loop(device, first, monkeypatch):
    """The "multigrid" route of `silt::pressure_cg_solve` at (6, 256, 128), cold and warm-started, and its cold
    adjoint give the eager loop's x, gradient and iterations to the bit:
    `pcg_solve_info` with `apply_a` and the eager `v_cycle`. One hierarchy
    serves a rollout's solves (under `torch.inference_mode()`) and a
    training step's (a solve and its adjoint), in either order, from one
    capture; every V-cycle is a replay."""
    monkeypatch.setattr(mg, "_HIERARCHIES", {})
    rhs, masks = _cg_problem(device, 6, karman_domain(128), seed=7)
    warm = (0.9 * rhs).contiguous()
    cot = torch.randn(rhs.shape, generator=torch.Generator(device=device).manual_seed(8),
                      device=device)
    args = (masks.fluid, masks.face_u, masks.face_v, "multigrid", 1e-5, 1000)
    h = mg.cached_hierarchy(masks.fluid, masks.face_u, masks.face_v)

    def eager(b, x0):
        return cg.pcg_solve_info(functools.partial(mg.apply_a, h.levels[0]),
                                 lambda r: mg.v_cycle(h, r), b, 1e-5, 1000, x0)

    def rollout():
        with torch.inference_mode():
            return [pressure_cg_solve(rhs, x0, *args) for x0 in (torch.zeros_like(rhs), warm)]

    def training():
        b = rhs.clone().requires_grad_()
        x, iters = pressure_cg_solve(b, warm, *args)
        x.backward(cot)
        return x.detach(), iters, b.grad

    with profiling.recording() as rec:
        if first == "rollout":
            solves, (x, iters, grad) = rollout(), training()
        else:
            (x, iters, grad), solves = training(), rollout()
    counters = rec.read()["counters"]
    for (got, got_iters), x0 in zip(solves + [(x, iters)], (torch.zeros_like(rhs), warm, warm)):
        want, want_iters = eager(rhs, x0)
        assert torch.equal(got, want) and int(got_iters) == want_iters > 0
    want_grad, _ = eager(cot, torch.zeros_like(cot))
    assert torch.equal(grad, want_grad)
    assert len(counters["multigrid.vcycles"]) == 4
    assert counters["multigrid.graph_replays"] == counters["multigrid.vcycles"]
    assert sum(counters["multigrid.graph_captures"]) == 1 and list(h.graphs) == [
        ((6, 256, 128), torch.float32, device)]


def test_a_recorded_generator_rollout_replays_every_vcycle(device, monkeypatch):
    """Three steps of the hi-res generator's rollout (`karman-gen -r 128`:
    (6, 256, 128), gather advection, multigrid) count every V-cycle as a
    replay and one capture, and give the frames of the rollout with the
    graph turned off to the bit."""
    monkeypatch.setattr(mg, "_HIERARCHIES", {})
    dom = karman_domain(128)
    flow = KarmanFlow(dom, advection="gather", max_shift=4, device=device)
    re = torch.tensor([1.6e5 * 2 ** i for i in range(6)], device=device)
    d0, v0 = initial_state(dom, 6, device)
    assert pressure_route((6,) + dom.resolution, device) == "multigrid"
    with profiling.recording() as rec:
        graphed = karman_rollout(flow, d0, v0, re, 3)
    counters = rec.read()["counters"]
    assert sum(counters["multigrid.vcycles"]) > 3
    assert counters["multigrid.graph_replays"] == counters["multigrid.vcycles"]
    assert sum(counters["multigrid.graph_captures"]) == counters["multigrid.graph_captures"][0] == 1
    # the eager plain V-cycle: no graph, and the plain ops in the kernels' place
    monkeypatch.setattr(mg, "graphed_cycle", lambda h, b: (None, 0))
    monkeypatch.setattr(vcycle, "v_cycle", lambda h, b: mg._v_cycle(h, b, 0))
    eager = karman_rollout(flow, d0, v0, re, 3)
    for key in ("dens", "u", "v", "cg_iters"):
        assert torch.equal(graphed[key], eager[key]), key


def test_a_new_mask_set_after_eviction_captures_anew(device, monkeypatch):
    """Evicting a mask set's hierarchy frees its V-cycle graph; a solve on
    those masks afterwards builds the hierarchy again and captures anew."""
    monkeypatch.setattr(mg, "_HIERARCHIES", {})
    monkeypatch.setattr(mg, "_HIERARCHIES_KEPT", 1)
    (rhs, first), (_, second) = (_cg_problem(device, 6, karman_domain(128), seed=s)
                                 for s in (1, 2))

    def solve(masks):
        with profiling.recording() as rec:
            mg.mg_solve(rhs, torch.zeros_like(rhs), masks.fluid, masks.face_u, masks.face_v,
                        1e-5, 1000)
        return rec.read()["counters"]["multigrid.graph_captures"]

    assert solve(first) == [1] and solve(first) == [0]
    (old,) = mg._HIERARCHIES.values()
    graph = weakref.ref(next(iter(old.graphs.values())))
    del old
    assert solve(second) == [1]
    gc.collect()
    assert graph() is None
    assert solve(first) == [1]


# the V-cycle kernels' cases: the karman masks at the hi-res generator's
# (6, 256, 128), at (1, 384, 192) and (3, 128, 64); an OPEN box with ragged
# tiles and an odd 17x18 coarsest level; and one whose odd 171x171 coarsest
# level is swept in scratch beyond shared memory
VCYCLE_CASES = [(6, 128), (1, 192), (3, 64), (3, 68, 72), (1, 684, 684)]


def _vcycle_problem(device, case):
    if len(case) == 2:
        rhs, masks = _cg_problem(device, case[0], karman_domain(case[1]), seed=case[1])
    else:
        rhs, _, masks = _box_problem(device, case, seed=case[1])
    return mg.build_mg_hierarchy(masks, Domain(tuple(rhs.shape[1:]), (1.0, 1.0),
                                               Boundary.OPEN)), rhs


@pytest.mark.parametrize("case", VCYCLE_CASES)
def test_vcycle_kernels_are_bit_equal_to_the_plain_cycle(device, case):
    """The kernels give the plain `_v_cycle` to the bit, launched directly
    and replayed from the V-cycle's graph, on the right-hand side the graph
    was captured with and on two others, in 2 (levels - 1) + 1 launches an
    apply, whatever the level shapes."""
    h, rhs = _vcycle_problem(device, case)
    levels = len(h.levels)
    gen = torch.Generator(device=device).manual_seed(levels)
    others = [torch.randn(rhs.shape, generator=gen, device=device) * h.levels[0].masks.fluid
              for _ in range(2)]
    graph = mg.GraphedCycle(h, rhs)
    for b in [rhs] + others:
        want = mg._v_cycle(h, b, 0)
        before = vcycle.v_cycle.launches
        direct = vcycle.v_cycle(h, b)
        assert vcycle.v_cycle.launches - before == 2 * (levels - 1) + 1
        assert torch.equal(direct, want)
        assert torch.equal(graph(b), want)
        assert vcycle.v_cycle.launches - before == 2 * (levels - 1) + 1
    torch.cuda.synchronize()


def test_kernel_cycles_count_every_vcycle_of_a_solve(device, monkeypatch):
    """`multigrid.kernel_cycles` equals `multigrid.vcycles` in the multigrid
    route of `pressure_cg_solve`, forward and adjoint, and the plain V-cycle
    is not called."""
    monkeypatch.setattr(mg, "_HIERARCHIES", {})
    rhs, masks = _cg_problem(device, 6, karman_domain(128), seed=9)
    called = []
    monkeypatch.setattr(mg, "_v_cycle", lambda *a: called.append(a))
    b = rhs.clone().requires_grad_()
    with profiling.recording() as rec:
        x, _ = pressure_cg_solve(b, torch.zeros_like(rhs), masks.fluid, masks.face_u,
                                 masks.face_v, "multigrid", 1e-5, 1000)
        x.sum().backward()
    counters = rec.read()["counters"]
    assert len(counters["multigrid.vcycles"]) == 2 and min(counters["multigrid.vcycles"]) > 0
    assert counters["multigrid.kernel_cycles"] == counters["multigrid.vcycles"]
    assert counters["multigrid.graph_replays"] == counters["multigrid.vcycles"]
    assert called == [] and torch.isfinite(b.grad).all()


def test_vcycle_kernels_reject_what_they_do_not_take(device):
    h, rhs = _vcycle_problem(device, (1, 64))
    launches = vcycle.v_cycle.launches
    bad = [rhs.cpu(), rhs.double(), rhs.transpose(1, 2).contiguous().transpose(1, 2),
           rhs[:, :-4], torch.zeros((0,) + tuple(rhs.shape[1:]), device=device)]
    for b in bad:
        with pytest.raises(ValueError):
            vcycle.v_cycle(h, b)
    with pytest.raises(ValueError, match="sweep"):
        vcycle.v_cycle(dataclasses.replace(h, smooth_iters=3), rhs)
    assert vcycle.v_cycle.launches == launches


def test_train_step_without_preconditioner_matches_plain(device):
    launches = (cg_solve.launches, pcg_solve.launches)
    kernel = parity.parity_summary(parity.parity_step(device, precon="none"))
    # 32 forward solves and 31 adjoints (none for step 0, whose input is data)
    assert (cg_solve.launches, pcg_solve.launches) == (launches[0] + 63, launches[1])
    with parity.plain_path():
        plain = parity.parity_summary(parity.parity_step(device, precon="none"))
    errors = parity.parity_errors(kernel, plain)
    for key, tol in parity.TRAIN_PARITY_TOL.items():
        assert errors[key] <= tol, (key, errors)


@pytest.mark.parametrize("precon", ["fd", "none"])
def test_batch_above_a_cluster_takes_the_kernel(device, precon):
    """At (9, 64, 32) the batch is more than one cluster: the kernel that
    precon names runs it as a cooperative grid, forward and adjoint, with
    the CPU's solution and gradient."""
    rhs, masks = _cg_problem(device, 9, seed=9)
    kernel = {"fd": pcg_solve, "none": cg_solve}[precon]
    assert pressure_route(rhs.shape, device, precon=precon) == {"fd": "pcg", "none": "cg"}[precon]
    cot = torch.randn(rhs.shape, generator=torch.Generator(device=device).manual_seed(10),
                      device=device)
    launches = kernel.launches
    div = (-rhs).requires_grad_()
    p, iters = solve_pressure(div, masks, precon=precon)
    (grad,) = torch.autograd.grad(p, div, cot)
    assert kernel.launches == launches + 2
    cpu_masks = KarmanFlow(karman_domain(32), advection="shift").masks
    div_cpu = (-rhs).cpu().requires_grad_()
    p_cpu, iters_cpu = solve_pressure(div_cpu, cpu_masks, precon=precon)
    (grad_cpu,) = torch.autograd.grad(p_cpu, div_cpu, cot.cpu())
    assert abs(int(iters) - int(iters_cpu)) <= parity.PCG_ITER_TOL
    assert _rel(p.detach().cpu(), p_cpu.detach()) <= parity.PCG_REL_TOL
    assert _rel(grad.cpu(), grad_cpu) <= parity.TRAIN_PARITY_TOL["head_grad"]


@pytest.mark.parametrize("precon", ["fd", "none"])
def test_plain_fd_pcg_route_on_the_card_matches_cpu(device, precon):
    """A batch above MAX_BATCH runs the plain FD-PCG loop on either device,
    whichever precon names, forward and adjoint, with no kernel launch: the
    card's iterations, solution and gradient against the CPU's."""
    rhs, masks = _cg_problem(device, 129, seed=32)
    assert pressure_route(rhs.shape, device, precon=precon) == "pcg_plain"
    assert pressure_route(rhs.shape, "cpu", precon=precon) == "pcg_plain"
    cot = torch.randn(rhs.shape, generator=torch.Generator(device=device).manual_seed(11),
                      device=device)
    launches = (cg_solve.launches, pcg_solve.launches)
    div = (-rhs).requires_grad_()
    p, iters = solve_pressure(div, masks, precon=precon)
    (grad,) = torch.autograd.grad(p, div, cot)
    assert (cg_solve.launches, pcg_solve.launches) == launches
    cpu_masks = KarmanFlow(karman_domain(32), advection="shift").masks
    div_cpu = (-rhs).cpu().requires_grad_()
    p_cpu, iters_cpu = solve_pressure(div_cpu, cpu_masks, precon=precon)
    (grad_cpu,) = torch.autograd.grad(p_cpu, div_cpu, cot.cpu())
    assert 0 < int(iters) < 1000 and abs(int(iters) - int(iters_cpu)) <= parity.PCG_ITER_TOL
    assert _rel(p.detach().cpu(), p_cpu.detach()) <= parity.PCG_REL_TOL
    assert _rel(grad.cpu(), grad_cpu) <= parity.TRAIN_PARITY_TOL["head_grad"]


@pytest.mark.parametrize("batch,res,precon", [(1, 48, "fd"), (1, 65, "fd"), (1, 65, "none"),
                                              (2, 64, "fd")])
def test_general_layout_route_on_the_card_matches_cpu(device, batch, res, precon):
    """Off multigrid's sizes (-r 48, -r 65) and at 128x64, where the general
    layouts of the one-block kernels ran until the cluster layout replaced
    them, the kernel that precon names takes the element in the cluster
    layout (csrc/cg_cluster.cu), forward and adjoint, two launches: the
    card's solution and gradient against the CPU's with the same precon (at
    128x64 the CPU's multigrid), its iterations against the kernel's twin
    on the CPU in float32."""
    rhs, masks = _cg_problem(device, batch, karman_domain(res), seed=res)
    kernel, twin, tol = {"fd": (cg.pcg_cluster_solve, pcg_solve_plain, parity.PCG_ITER_TOL),
                         "none": (cg.cg_cluster_solve, cg_solve_plain, parity.CG_ITER_TOL)}[precon]
    assert pressure_route(rhs.shape, device, precon=precon) == {"fd": "pcg", "none": "cg"}[precon]
    cot = torch.randn(rhs.shape, generator=torch.Generator(device=device).manual_seed(12),
                      device=device)
    launches = kernel.launches
    div = (-rhs).requires_grad_()
    p, iters = solve_pressure(div, masks, precon=precon)
    (grad,) = torch.autograd.grad(p, div, cot)
    assert kernel.launches == launches + 2
    cpu_masks = KarmanFlow(karman_domain(res), advection="shift").masks
    div_cpu = (-rhs).cpu().requires_grad_()
    p_cpu, _ = solve_pressure(div_cpu, cpu_masks, precon=precon)
    (grad_cpu,) = torch.autograd.grad(p_cpu, div_cpu, cot.cpu())
    ops = [rhs.cpu(), torch.zeros_like(rhs.cpu()), cpu_masks.fluid, cpu_masks.face_u,
           cpu_masks.face_v] + (list(fd_factors(rhs.shape[1], rhs.shape[2], "cpu"))
                                if precon == "fd" else [])
    _, iters_cpu = twin(*ops, 1e-5, 1000)
    assert 0 < int(iters) < 1000 and abs(int(iters) - int(iters_cpu)) <= tol
    assert _rel(p.detach().cpu(), p_cpu.detach()) <= parity.PCG_REL_TOL
    assert _rel(grad.cpu(), grad_cpu) <= parity.TRAIN_PARITY_TOL["head_grad"]


# (batch, res, precon) of the cluster layout where the JAX package's gate
# takes its Pallas kernel and the card refused the shape or took multigrid
# before: -r 67, -r 79, 256x128 at its batches, -r 192, -r 267; -r 67
# without the preconditioner and -r 313 (the L2 variant without it)
CLUSTER_CASES = [(1, 67, "fd"), (1, 79, "none"), (1, 128, "fd"), (3, 128, "fd"),
                 (5, 128, "none"), (1, 192, "fd"), (1, 267, "fd"), (1, 67, "none"),
                 (1, 313, "none")]


@pytest.mark.parametrize("batch,res,precon", CLUSTER_CASES)
def test_cluster_shared_memory_matches_the_mirror(device, batch, res, precon):
    """csrc/cg_cluster.cu's own count of a block's shared memory against
    kernels/cg.py's mirror, in both variants, at the plan of each case (on
    chip at -r 67, -r 79 and 256x128; in L2 at -r 192 and -r 267 with the
    preconditioner and -r 313 without, where the on-chip count is above
    the limit)."""
    shape, pre = (batch, 2 * res, res), precon == "fd"
    _, band = cg.cluster_plan(shape, pre)
    for on_chip in (True, False):
        assert cg.cluster_smem_native(pre, on_chip, 2 * res, res, band) == cg.cluster_smem_bytes(
            band, 2 * res, res, pre, on_chip)
    assert cg.cluster_on_chip(shape, pre) == (res <= 128 or not pre and res < 267)


@pytest.mark.parametrize("batch,res,precon", CLUSTER_CASES)
def test_cluster_layout_matches_plain(device, batch, res, precon):
    """csrc/cg_cluster.cu, the route there, through its wrapper against the
    plain twin, cold and warm, one launch each: the solution within
    PCG_REL_TOL / CG_REL_TOL of the twin's on the card, the same bits from a
    second launch; and the adjoint, a cold solve by the same layout through
    the differentiable op, against the plain path's. The iteration count is
    not held here: on these random fields the float32 loop's count is
    rounding's, the twin's on the card and on the CPU parting by up to 2 at
    534x267 and the kernel's from both by 6 (220 against 212 and 214);
    chip_smoke.py's `pressure_route` cases hold it on karman fields."""
    from unittest import mock

    rhs, masks = _cg_problem(device, batch, karman_domain(res), seed=res + batch)
    pre = precon == "fd"
    route = "pcg" if pre else "cg"
    assert pressure_route(rhs.shape, device, precon=precon) == route
    kernel, twin = ((cg.pcg_cluster_solve, pcg_solve_plain) if pre
                    else (cg.cg_cluster_solve, cg_solve_plain))
    rel_tol = parity.PCG_REL_TOL if pre else parity.CG_REL_TOL
    ops = (masks.fluid, masks.face_u, masks.face_v,
           *(fd_factors(rhs.shape[1], rhs.shape[2], device) if pre else ()))
    for x0 in (torch.zeros_like(rhs), (0.1 * rhs).contiguous()):
        args = (rhs, x0, *ops, 1e-5, 4000)
        launches = kernel.launches
        x_k, it_k = kernel(*args)
        assert kernel.launches == launches + 1
        x_p, _ = twin(*args)
        assert 0 < int(it_k) < 4000 and _rel(x_k, x_p) <= rel_tol
        x_again, it_again = kernel(*args)  # fixed-order sums: the same bits
        assert torch.equal(x_k, x_again) and int(it_k) == int(it_again)
    cot = torch.randn(rhs.shape, generator=torch.Generator(device=device).manual_seed(13),
                      device=device)

    def grad():
        b = rhs.clone().requires_grad_()
        x, _ = pressure_cg_solve(b, torch.zeros_like(rhs), masks.fluid, masks.face_u,
                                 masks.face_v, route, 1e-5, 4000)
        return torch.autograd.grad(x, b, cot)[0]

    launches = kernel.launches
    with mock.patch.object(cg, "pcg_solve" if pre else "cg_solve", kernel):
        got = grad()
    assert kernel.launches == launches + 2  # forward and adjoint
    with parity.plain_path():
        want = grad()
    assert _rel(got, want) <= rel_tol


def test_periodic_solve_on_the_card_matches_cpu(device):
    """A periodic problem takes the plain CG loop on the card as on the CPU,
    the JAX package's route there, forward and a cold adjoint, no kernel
    launch: the card's solution and gradient against the CPU's. The right-
    hand side and the cotangent have zero mean on the fluid cells, whose
    constants are the periodic operator's null space."""
    h, w = 48, 40
    fluid = torch.ones(1, h, w)
    fluid[:, 18:26, 14:22] = 0.0
    dom = Domain((h, w), (float(h), float(w)), Boundary.PERIODIC)
    masks = masks_from_fluid_cells(fluid.to(device), dom)
    cpu_masks = masks_from_fluid_cells(fluid, dom)
    gen = torch.Generator().manual_seed(14)

    def zero_mean(a):
        a = a * fluid
        return (a - fluid * a.sum(dim=(1, 2), keepdim=True) / fluid.sum()).contiguous()

    div, cot = zero_mean(torch.randn(2, h, w, generator=gen)), zero_mean(
        torch.randn(2, h, w, generator=gen))
    assert pressure_route(div.shape, device, periodic=True) == "periodic_cg"
    kernels = (cg_solve, pcg_solve, cg.cg_cluster_solve, cg.pcg_cluster_solve)
    launches = [k.launches for k in kernels]
    results = []
    for where, ms in ((device, masks), ("cpu", cpu_masks)):
        d = div.to(where).requires_grad_()
        p, iters = solve_pressure(d, ms, periodic=True)
        (g,) = torch.autograd.grad(p, d, cot.to(where))
        results.append((p.detach().cpu(), g.cpu(), int(iters)))
    assert [k.launches for k in kernels] == launches
    (p_k, g_k, it_k), (p_c, g_c, it_c) = results
    assert 0 < it_k < 1000 and abs(it_k - it_c) <= parity.CG_ITER_TOL
    assert _rel(p_k, p_c) <= parity.PCG_REL_TOL
    assert _rel(g_k, g_c) <= parity.TRAIN_PARITY_TOL["head_grad"]


def _dp_case():
    """One SOL karman step at 16x8, msteps 2, batch 3 padded to 4 over two
    ranks, from a seeded MarsMoon, at CG tolerance 1e-7."""
    rng = np.random.RandomState(4)
    dom = karman_domain(8)
    d0, v0 = initial_state(dom, 1)
    data = {"dens": d0.values.numpy()[None] + 0.1 * rng.rand(3, 4, dom.ny, dom.nx),
            "u": v0.u.numpy()[None] + 0.2 * rng.randn(3, 4, dom.ny, dom.nx + 1),
            "v": v0.v.numpy()[None] + 0.2 * rng.randn(3, 4, dom.ny + 1, dom.nx),
            "re": 1.6e5 * 2.0 ** np.arange(3)}
    model = build_model("mars_moon", leaky_slope=0.3, generator=torch.Generator().manual_seed(2))
    return {"family": "karman", "res": 8, "max_shift": 2, "ptol": 1e-7, "pmaxiter": 1000,
            "in_channels": 3, "norm": ([0.3, 0.2, 1e5], [0.3, 0.2]), "msteps": 2, "lr": 1e-4,
            "params": params_to_jax(model, "mars_moon"), "pad_to": 4,
            "data": {k: np.asarray(a, np.float32) for k, a in data.items()},
            "idx": np.stack([np.arange(3), np.zeros(3, np.int64)], 1)}


def test_dp_step_on_two_ranks_of_the_card_matches_cpu(device):
    case = _dp_case()
    card = ranks.spawn(ranks.dp_train_step_rank, 2, case, "cuda")
    cpu = ranks.spawn(ranks.dp_train_step_rank, 2, case, "cpu")
    for r in card:
        assert r["launches"] == card[0]["launches"] and min(r["launches"].values()) > 0
        assert r["loss"] == card[0]["loss"]
    tol = parity.TRAIN_PARITY_TOL
    np.testing.assert_allclose(card[0]["loss"], cpu[0]["loss"], rtol=tol["loss"])
    np.testing.assert_allclose(card[0]["step_losses"], cpu[0]["step_losses"],
                               rtol=tol["step_losses"])
    for name, want in cpu[0]["grad"].items():
        assert np.abs(card[0]["grad"][name] - want).max() <= tol["grad_norms"] * np.abs(want).max()
        np.testing.assert_allclose(card[0]["update"][name], cpu[0]["update"][name], rtol=0,
                                   atol=1e-5, err_msg=name)


def test_sharded_shift_step_on_the_card_matches_its_twin(device):
    """The y-sharded step with `advection="shift"`: every rank runs the
    tap-sum kernel on its haloed blocks, three launches a step."""
    rng = np.random.RandomState(7)
    dom = karman_domain(16)
    d0, v0 = initial_state(dom, 1)
    fields = tuple(np.asarray(a + s * rng.randn(*a.shape), np.float32)
                   for a, s in ((d0.values.numpy(), 0.3), (v0.u.numpy(), 0.3),
                                (v0.v.numpy(), 0.3)))
    case = {"kind": "step", "advection": "shift", "ptol": 1e-6, "pmaxiter": 1000, "res": 16,
            "fields": fields}
    card = ranks.spawn(ranks.spatial_rank, 2, [case], "cuda")
    cpu = ranks.spawn(ranks.spatial_rank, 2, [case], "cpu")
    assert [r[0]["tap_sum_launches"] for r in card] == [(3, 0), (3, 0)]
    for name in ("dens", "u", "v"):
        want = cpu[0][0][name]
        assert np.abs(card[0][0][name] - want).max() <= 1e-5 * np.abs(want).max(), name


def test_spans_hang_from_the_backward_across_the_autograd_thread(device):
    """On the card the autograd engine runs the backward, and with it the
    remat's recomputes and the adjoint solves, on a thread of its own while
    the caller waits in `silt.train.backward`: each recompute span still
    hangs from it. A kernel library's first load in a process is a
    `silt.kernels.load` span."""
    from solver_in_the_loop_torch.kernels import build
    from solver_in_the_loop_torch.models.features import Normalization
    from solver_in_the_loop_torch.train import trainer
    from solver_in_the_loop_torch.utils import profiling

    msteps, rng, dom = 3, np.random.RandomState(3), karman_domain(32)
    d0, v0 = initial_state(dom, 1)
    data = {k: torch.from_numpy((a.numpy()[None] + s * rng.randn(2, msteps + 2, *a.shape[1:]))
                                .astype(np.float32)).to(device)
            for k, a, s in (("dens", d0.values, 0.1), ("u", v0.u, 0.2), ("v", v0.v, 0.2))}
    data["re"] = torch.tensor([1.6e5, 3.2e5], device=device)
    flow = KarmanFlow(dom, advection="shift", max_shift=2, device=device)
    model = build_model("mars_moon", init="reference").to(device)
    cfg = trainer.SolTrainConfig(msteps=msteps, clip_grad=True)
    step = trainer.make_karman_train_step(flow, model, trainer.make_optimizer(model, cfg), cfg)
    norm = Normalization.karman(0.3, 0.2, 1e5, device)
    idx = torch.tensor([[0, 0], [1, 1]], device=device)
    step(data, norm, idx)  # loads every library the step launches
    build._loaded.pop("advect")
    for key in [k for k in build._functions if k[0] == "advect"]:
        build._functions.pop(key)
    with profiling.recording() as rec:
        step(data, norm, idx)
    got = rec.read()
    spans = got["spans"]
    (backward,) = [i for i, s in enumerate(spans) if s[0] == "silt.train.backward"]
    recomputes = [s for s in spans if s[0] == "silt.train.recompute"]
    assert len(recomputes) == msteps
    assert all(s[3] == backward and s[4] != spans[backward][4] for s in recomputes)
    assert [s[0] for s in spans].count("silt.kernels.load") == 1
    assert len(got["counters"]["pressure.adjoint_iters"]) == msteps - 1
    assert min(got["counters"]["pressure.adjoint_iters"]) > 0


def test_remat_step_equals_the_step_without_remat_and_holds_no_more(device):
    """At SOL-32's shapes ((3, 64, 32), MarsMoon, msteps 4) the remat step
    under `pressure+conv` gives the step without remat's loss, step losses
    and gradients (bit for bit, or within 1e-6 of each leaf's largest value
    where cuDNN's algorithms part), and its peak of allocated memory is no
    higher than the step without remat's."""
    from solver_in_the_loop_torch.models.features import Normalization
    from solver_in_the_loop_torch.train import trainer

    msteps, rng, dom = 4, np.random.RandomState(4), karman_domain(32)
    d0, v0 = initial_state(dom, 1)
    data = {k: torch.from_numpy((a.numpy()[None] + s * rng.randn(3, msteps + 2, *a.shape[1:]))
                                .astype(np.float32)).to(device)
            for k, a, s in (("dens", d0.values, 0.1), ("u", v0.u, 0.2), ("v", v0.v, 0.2))}
    data["re"] = torch.tensor([1.6e5, 3.2e5, 6.4e5], device=device)
    flow = KarmanFlow(dom, advection="shift", max_shift=2, device=device)
    norm = Normalization.karman(0.3, 0.2, 1e5, device)
    idx = torch.tensor([[0, 0], [1, 1], [2, 0]], device=device)

    def run(remat):
        model = build_model("mars_moon", init="reference").to(device)
        cfg = trainer.SolTrainConfig(msteps=msteps, remat=remat, remat_policy="pressure+conv")
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        loss, step_losses, _ = trainer.karman_loss(flow, model, norm, data, idx, cfg)
        loss.backward()
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base
        return [loss.detach(), step_losses.detach()] + [p.grad for p in model.parameters()], peak

    run(True), run(False)  # cuDNN's and the kernels' first loads
    (want, plain_peak), (got, remat_peak) = run(False), run(True)
    for a, b in zip(got, want):
        assert torch.equal(a, b) or _rel(a, b) <= 1e-6, _rel(a, b)
    assert remat_peak <= plain_peak, (remat_peak, plain_peak)


def _pre_correction_case(device):
    """The karman_pre cell's geometry (karman_domain(32) against
    karman_domain(128), scale 4) and a pair like a developed wake's: a
    smooth hi-res velocity difference, and as the previous correction the
    constrained solution of a frame before, on the card."""
    from solver_in_the_loop_torch.pre import lsq

    geom = lsq.build_pre_geometry(karman_domain(32), karman_domain(128), 4, bnd=2)
    gen = torch.Generator().manual_seed(26)

    def smooth(shape, scale):
        coarse = torch.randn(1, 1, shape[1] // 16 + 2, shape[2] // 16 + 2, generator=gen)
        fine = torch.nn.functional.interpolate(coarse, size=shape[1:], mode="bilinear",
                                               align_corners=True)[0]
        return (scale * fine + 0.01 * scale * torch.randn(shape, generator=gen)).to(device)

    hu, hv = smooth(geom.hi_fu.shape, 0.1), smooth(geom.hi_fv.shape, 0.1)
    zu, zv = (torch.zeros(getattr(geom, n).shape, device=device) for n in ("lo_fu", "lo_fv"))
    with torch.no_grad():
        pu, pv, _ = lsq.solve_correction(geom, hu, hv, zu, zv, beta=1.0)
    return geom, (hu + smooth(geom.hi_fu.shape, 0.02), hv + smooth(geom.hi_fv.shape, 0.02), pu, pv)


def _correction_by_route(geom, args, beta, kernel: bool):
    """solve_correction with each projection's inner CG on the fused kernel
    or, the route taken away, on `tree_cg`: the correction, its counts,
    each projection's iterations and the recording."""
    from unittest import mock

    from solver_in_the_loop_torch.pre import lsq

    solver = "cg_solve" if kernel else "tree_cg"
    real, iters = getattr(lsq, solver), []

    def counted(*a, **k):
        x, n = real(*a, **k)
        iters.append(n)
        return x, n

    route = lsq.inner_on_kernel if kernel else (lambda rhs: False)
    with mock.patch.object(lsq, solver, counted), mock.patch.object(lsq, "inner_on_kernel", route), \
            profiling.recording() as rec, torch.no_grad():
        cu, cv, its = lsq.solve_correction(geom, *args, beta=beta)
    return cu, cv, its, [int(n) for n in iters], rec.read()


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_projections_on_the_cg_kernel_match_tree_cg(device, beta):
    """On the card each projection's inner CG is one `cg_solve` launch:
    the correction within CONSTRAINED_REL_TOL of its max of the same solve
    on `tree_cg`, each projection's iterations within one, every projection
    counted as the kernel's, and the host reading only the outer loop's
    stop flag (one an outer iteration, and the last). The outer loop ends
    at the float32 noise floor (`_ppcg`), where rounding may take one
    iteration, and so one projection, more or less (beta 0: 9 against 10)."""
    geom, args = _pre_correction_case(device)
    launches = cg_solve.launches
    ku, kv, k_its, k_iters, k_rec = _correction_by_route(geom, args, beta, kernel=True)
    k_projections = [s[0] for s in k_rec["spans"]].count("silt.pre.lsq.project")
    assert cg_solve.launches - launches == k_projections == len(k_iters) > 0
    assert sum(k_rec["counters"]["pre.lsq_kernel_projections"]) == k_projections
    assert sum(k_rec["counters"]["pre.lsq_host_reads"]) == int(k_its["outer"]) + 1
    assert sum(k_iters) == int(k_its["inner"])
    tu, tv, t_its, t_iters, t_rec = _correction_by_route(geom, args, beta, kernel=False)
    assert "pre.lsq_kernel_projections" not in t_rec["counters"]
    assert cg_solve.launches - launches == k_projections
    scale = max(float(tu.abs().max()), float(tv.abs().max()))
    gap = max(float((ku - tu).abs().max()), float((kv - tv).abs().max()))
    print(f"beta {beta}: outer {int(k_its['outer'])} / {int(t_its['outer'])}, projections' "
          f"iterations {k_iters} / {t_iters}, gap {gap / scale:.3g} of the max")
    assert 0 < scale and gap <= parity.CONSTRAINED_REL_TOL * scale, (gap, scale)
    assert abs(int(k_its["outer"]) - int(t_its["outer"])) <= 1
    assert len(k_iters) - len(t_iters) == int(k_its["outer"]) - int(t_its["outer"])
    assert max(abs(a - b) for a, b in zip(k_iters, t_iters)) <= 1, (k_iters, t_iters)


def test_a_constrained_solve_on_cpu_tensors_counts_no_kernel_projection(device):
    """With the card present, a solve on CPU tensors keeps `tree_cg`."""
    from solver_in_the_loop_torch.pre import lsq

    geom = lsq.build_pre_geometry(karman_domain(8), karman_domain(32), 4, bnd=2)
    rng = np.random.RandomState(3)
    args = [torch.from_numpy(rng.randn(*getattr(geom, n).shape).astype(np.float32))
            for n in ("hi_fu", "hi_fv", "lo_fu", "lo_fv")]
    launches = cg_solve.launches
    with profiling.recording() as rec, torch.no_grad():
        lsq.solve_correction(geom, *args, beta=1.0)
    got = rec.read()
    assert [s[0] for s in got["spans"]].count("silt.pre.lsq.project") > 0
    assert sum(got["counters"].get("pre.lsq_kernel_projections", [])) == 0
    assert cg_solve.launches == launches


def test_the_projection_route_on_the_card_depends_on_the_device_alone(device):
    """A field on the card takes the kernel route whatever its dtype: one
    the kernels cannot take raises in `cg_solve` rather than falling back
    to `tree_cg`."""
    from solver_in_the_loop_torch.pre import lsq

    geom = lsq.build_pre_geometry(karman_domain(32), karman_domain(128), 4, bnd=2)
    cells, fu, fv = (torch.from_numpy(getattr(geom, n)).to(device)
                     for n in ("lo_cells", "lo_fu", "lo_fv"))
    rhs = torch.ones(cells.shape, dtype=torch.float64, device=device) * cells
    assert lsq.inner_on_kernel(rhs) and lsq.inner_on_kernel(rhs.float())
    with pytest.raises(ValueError, match="cg_solve"):
        cg_solve(rhs, torch.zeros_like(rhs), cells, fu, fv, 1e-4, lsq.INNER_MAX_ITER)
