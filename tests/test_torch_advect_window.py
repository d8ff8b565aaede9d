"""The windowed loops of csrc/advect.cu, emulated on the CPU, against the
tap-sum's plain twins bit for bit.

The CUDA kernels cannot run here. Their numerics rest on one argument: each
sum adds the same non-zero terms as `tap_sum_fwd_plain` / `tap_sum_bwd_plain`
in the same order, and skips only terms that are exactly +-0, which leave a
float32 sum that starts at +0 unchanged. This file writes the kernels' loop
structure out in float32 PyTorch, one rounding per operation, and holds its
results to the twins' bits:

* forward: per cell the 2x2 window {fy, fy+1} x {fx, fx+1}, fy = floor(dy),
  clipped to the taps [-m, m+1];
* ddy, ddx: the 4x4 slope window [fy-1, fy+2] x [fx-1, fx+2], clipped alike;
* dV: per tap (sy outer, sx inner) the one destination that reads the cell
  through it, adding g * (wy * wx) only where the tap lies in its window,
  from the per-cell floors and two hat weights per axis that the kernel
  stages in shared memory; and, for the OPEN edge cells of a 4x32 tile whose
  staged destinations have a window tap of non-zero weight outside the field,
  every destination whose clamped index lands on the cell (columns outer,
  then rows, in index order). The solver's clamped offsets never take that
  second path;
* a block that finds a non-finite input among those its cells read (the
  forward's 4x32 tile with its window of V, the backward's staged 4x32 tile
  and halo) sums every tap as the twin does, zero weights included, with the
  twin's weights rebuilt from the staged window (NaN where the offset is
  NaN); elsewhere the windows above. The twin's zero-weight terms are NaN
  there (0 * inf), so these cases compare NaN where NaN and the bits
  elsewhere.

Cases: shapes (2,9,7), (1,8,8), (2,7,10); m = 1, 2, 3; OPEN and PERIODIC;
offsets "uniform" in +-(m+0.5) (beyond the taps' reach, so windows clip),
"integer" (every tap on a kink or a tie), "clamped" (as the solver clamps
them, ops/interp.py), "near-integer" (one float32 step off an integer, where
a slope one tap outside the 2-tap window rounds to non-zero), "outward"
(m to m+1 cells towards the nearest edge, so an OPEN edge cell sums many
non-zero terms through one tap and their order shows), "outward-x" and
"outward-y" (the same along one axis). The non-finite cases put an inf or a
NaN into V, g or an offset of a (1, 24, 40) field of clamped or uniform
offsets, which spans several tiles, so some blocks see it and some do not.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from solver_in_the_loop_torch.kernels.advect import (
    _hat_slope,
    tap_sum_bwd_plain,
    tap_sum_fwd_plain,
)

torch.set_num_threads(1)

SHAPES = [(2, 9, 7), (1, 8, 8), (2, 7, 10)]
TILE_H, TILE_W = 4, 32  # the backward kernel's tile of output cells
FWD_ROWS = 4  # the forward kernel's block: FWD_ROWS x TILE_W cells
OFFSETS = ("uniform", "integer", "clamped", "near-integer", "outward", "outward-x", "outward-y")
CASES = [(s, m, p, o) for s in SHAPES for m in (1, 2, 3) for p in (False, True) for o in OFFSETS]


def _offsets(shape, m, kind, periodic, rng):
    if kind in ("integer", "near-integer"):
        dy, dx = (rng.randint(-m - 1, m + 2, shape).astype(np.float32) for _ in range(2))
        if kind == "near-integer":  # one float32 step off: |d - s| rounds to exactly 1
            dy, dx = (np.nextafter(d, d + rng.choice([-1.0, 1.0], shape).astype(np.float32))
                      for d in (dy, dx))
    elif kind.startswith("outward"):  # m to m+1 cells towards the nearest edge
        dy, dx = (rng.uniform(m, m + 1, shape) for _ in range(2))
        dy = np.where(np.arange(shape[1])[None, :, None] < shape[1] / 2, -dy, dy)
        dx = np.where(np.arange(shape[2])[None, None, :] < shape[2] / 2, -dx, dx)
        if kind == "outward-x":
            dy = np.zeros(shape)
        if kind == "outward-y":
            dx = np.zeros(shape)
    else:
        dy, dx = (rng.uniform(-(m + 0.5), m + 0.5, shape) for _ in range(2))
    dy, dx = dy.astype(np.float32), dx.astype(np.float32)
    if kind == "clamped":  # ops/interp.py shifted_stencil_sample
        dy, dx = np.clip(dy, -m, m), np.clip(dx, -m, m)
        if not periodic:
            jj = np.arange(shape[1], dtype=np.float32)[None, :, None]
            ii = np.arange(shape[2], dtype=np.float32)[None, None, :]
            dy = np.clip(jj + dy, 0.0, shape[1] - 1.0) - jj
            dx = np.clip(ii + dx, 0.0, shape[2] - 1.0) - ii
    return torch.from_numpy(dy.astype(np.float32)), torch.from_numpy(dx.astype(np.float32))


def _hat(d, s):
    return torch.clamp_min(1.0 - torch.abs(d - s), 0.0)


def _floor(d, m):
    """window_floor: floor(d) held within [-m-2, m+2]."""
    return torch.clamp(torch.floor(d), -m - 2, m + 2).to(torch.int64)


def _edge(k, n, periodic):
    return k % n if periodic else torch.clamp(k, 0, n - 1)


def _grid(shape):
    b, h, w = shape
    return (torch.arange(b)[:, None, None], torch.arange(h)[None, :, None].expand(shape),
            torch.arange(w)[None, None, :].expand(shape))


def _in_taps(s, m):
    return (s >= -m) & (s <= m + 1)


def _per_block(bad, rows, halo, periodic):
    """Per cell, whether its block (`rows` x TILE_W cells) sees a True in
    `bad` (B, H, W) over its tile and `halo` = (before, after) cells around
    it, at the kernel's clamped or wrapped indices."""
    _, h, w = bad.shape
    out = torch.zeros_like(bad)
    for j0 in range(0, h, rows):
        for i0 in range(0, w, TILE_W):
            r = _edge(torch.arange(j0 - halo[0], j0 + rows + halo[1]), h, periodic)
            c = _edge(torch.arange(i0 - halo[0], i0 + TILE_W + halo[1]), w, periodic)
            out[:, j0:j0 + rows, i0:i0 + TILE_W] = bad[:, r][:, :, c].flatten(1).any(1)[:, None,
                                                                                        None]
    return out


def _odd(*ts):
    return torch.stack([~torch.isfinite(t) for t in ts]).any(0)


def fwd_windowed(v, dy, dx, m, periodic):
    _, h, w = v.shape
    bb, jj, ii = _grid(v.shape)
    fy, fx = _floor(dy, m), _floor(dx, m)
    acc = torch.zeros_like(v)
    for a in range(2):
        sy = fy + a
        wy = _hat(dy, sy)
        ry = _edge(jj + sy, h, periodic)
        for c in range(2):
            sx = fx + c
            ok = _in_taps(sy, m) & _in_taps(sx, m)
            val = v[bb, ry, _edge(ii + sx, w, periodic)]
            acc = torch.where(ok, acc + val * (wy * _hat(dx, sx)), acc)
    # a block with a non-finite V in its window or offset of its own: every tap
    full = torch.zeros_like(v)
    for sy in range(-m, m + 2):
        ry = _edge(jj + sy, h, periodic)
        for sx in range(-m, m + 2):
            val = v[bb, ry, _edge(ii + sx, w, periodic)]
            full = full + val * (_hat(dy, sy) * _hat(dx, sx))
    odd = _per_block(~torch.isfinite(v), FWD_ROWS, (m, m + 1), periodic)
    odd |= _per_block(_odd(dy, dx), FWD_ROWS, (0, 0), periodic)
    return torch.where(odd, full, acc)


def bwd_windowed(v, dy, dx, g, m, periodic):
    _, h, w = v.shape
    bb, jj, ii = _grid(v.shape)
    fy, fx = _floor(dy, m), _floor(dx, m)

    # ddy, ddx over the slope window of the own cell
    acc_y, acc_x = torch.zeros_like(v), torch.zeros_like(v)
    wxs = [_hat(dx, fx - 1 + c) for c in range(4)]
    dwxs = [_hat_slope(dx - (fx - 1 + c)) for c in range(4)]
    for a in range(4):
        sy = fy - 1 + a
        wy, dwy = _hat(dy, sy), _hat_slope(dy - sy)
        ry = _edge(jj + sy, h, periodic)
        for c in range(4):
            sx = fx - 1 + c
            ok = _in_taps(sy, m) & _in_taps(sx, m)
            gv = g * v[bb, ry, _edge(ii + sx, w, periodic)]
            acc_y = torch.where(ok, acc_y + gv * (dwy * wxs[c]), acc_y)
            acc_x = torch.where(ok, acc_x + gv * (wy * dwxs[c]), acc_x)

    # dV: what the kernel stages per cell, then the gather
    wy0, wy1, wx0, wx1 = _hat(dy, fy), _hat(dy, fy + 1), _hat(dx, fx), _hat(dx, fx + 1)

    def window_term(r, c, sy, sx):
        ky, kx = sy - fy[bb, r, c], sx - fx[bb, r, c]
        hit = (ky >= 0) & (ky <= 1) & (kx >= 0) & (kx <= 1)
        wgt = torch.where(ky == 1, wy1[bb, r, c], wy0[bb, r, c]) * torch.where(
            kx == 1, wx1[bb, r, c], wx0[bb, r, c])
        return hit, g[bb, r, c] * wgt

    # the fast path: per tap the one reader (j - sy, i - sx), wrapped if
    # PERIODIC, skipped if it lies outside an OPEN field
    fast = torch.zeros_like(v)
    for sy in range(-m, m + 2):
        for sx in range(-m, m + 2):
            r, c = jj - sy, ii - sx
            hit, term = window_term(r % h, c % w, sy, sx)
            if not periodic:
                hit = hit & (r >= 0) & (r < h) & (c >= 0) & (c < w)
            fast = torch.where(hit, fast + term, fast)
    # a block with a non-finite input among those it stages: every tap, the
    # zero-weight terms with the twin's weights rebuilt from the window
    odd = _per_block(_odd(v, g, dy, dx), TILE_H, (m + 1, m + 1), periodic)
    full_y, full_x = torch.zeros_like(v), torch.zeros_like(v)
    for sy in range(-m, m + 2):
        ry = _edge(jj + sy, h, periodic)
        for sx in range(-m, m + 2):
            gv = g * v[bb, ry, _edge(ii + sx, w, periodic)]
            full_y = full_y + gv * (_hat_slope(dy - sy) * _hat(dx, sx))
            full_x = full_x + gv * (_hat(dy, sy) * _hat_slope(dx - sx))
    acc_y, acc_x = torch.where(odd, full_y, acc_y), torch.where(odd, full_x, acc_x)

    def full_term(r, c, sy, sx):
        ky, kx = sy - fy[bb, r, c], sx - fx[bb, r, c]
        nan_y, nan_x = torch.isnan(wy0[bb, r, c]), torch.isnan(wx0[bb, r, c])
        wgt_y = torch.where(ky == 0, wy0[bb, r, c], torch.where(
            ky == 1, wy1[bb, r, c], torch.where(nan_y, wy0[bb, r, c], 0.0)))
        wgt_x = torch.where(kx == 0, wx0[bb, r, c], torch.where(
            kx == 1, wx1[bb, r, c], torch.where(nan_x, wx0[bb, r, c], 0.0)))
        return g[bb, r, c] * (wgt_y * wgt_x)

    full_v = _gather(jj, ii, h, w, m, periodic,
                     lambda r, c, sy, sx: (torch.ones_like(r, dtype=torch.bool),
                                           full_term(r, c, sy, sx)))
    if periodic:
        return torch.where(odd, full_v, fast), acc_y, acc_x, torch.zeros_like(odd)

    # OPEN edge cells of a block whose staged destinations have a window tap
    # of non-zero weight outside the field: every reader, columns outer
    general = _gather(jj, ii, h, w, m, periodic, window_term)

    def leaves(f, w0, w1, k, n):
        out = torch.zeros_like(f, dtype=torch.bool)
        for a, wgt in ((0, w0), (1, w1)):
            out |= _in_taps(f + a, m) & (wgt > 0) & ((k + f + a < 0) | (k + f + a > n - 1))
        return out

    leaving = leaves(fy, wy0, wy1, jj, h) | leaves(fx, wx0, wx1, ii, w)
    fold = torch.zeros_like(leaving)
    for j0 in range(0, h, TILE_H):  # the staged tile and halo of each block
        for i0 in range(0, w, TILE_W):
            rows = torch.arange(j0 - m - 1, j0 + TILE_H + m + 1).clamp(0, h - 1)
            cols = torch.arange(i0 - m - 1, i0 + TILE_W + m + 1).clamp(0, w - 1)
            any_leaving = leaving[:, rows][:, :, cols].flatten(1).any(1)
            fold[:, j0:j0 + TILE_H, i0:i0 + TILE_W] = any_leaving[:, None, None]
    edge = (jj == 0) | (jj == h - 1) | (ii == 0) | (ii == w - 1)
    dv = torch.where(odd, full_v, torch.where(fold & edge, general, fast))
    return dv, acc_y, acc_x, fold & ~odd


def _gather(jj, ii, h, w, m, periodic, term_of):
    """dv_gather: per tap (sy outer, sx inner) every destination whose
    clamped (OPEN) or wrapped (PERIODIC, one) index lands on the cell,
    columns outer, then rows, in index order, adding the terms `term_of`
    hits."""
    span = 1 if periodic else m + 2  # the most readers through one tap, per axis
    out = torch.zeros(jj.shape)
    for sy in range(-m, m + 2):
        if periodic:
            r0 = r1 = jj - sy
        else:
            r0 = torch.where(jj == 0, 0, jj - sy).clamp_min(0)
            r1 = torch.where(jj == h - 1, h - 1, jj - sy).clamp_max(h - 1)
        for sx in range(-m, m + 2):
            if periodic:
                c0 = c1 = ii - sx
            else:
                c0 = torch.where(ii == 0, 0, ii - sx).clamp_min(0)
                c1 = torch.where(ii == w - 1, w - 1, ii - sx).clamp_max(w - 1)
            tap = torch.zeros(jj.shape)
            for q in range(span):
                col_on = c0 + q <= c1
                c = _edge(c0 + q, w, periodic)
                col = torch.zeros(jj.shape)
                for p in range(span):
                    hit, term = term_of(_edge(r0 + p, h, periodic), c, sy, sx)
                    col = torch.where(col_on & (r0 + p <= r1) & hit, col + term, col)
                tap = torch.where(col_on, tap + col, tap)
            out = out + tap
    return out


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape,m,periodic,offsets", CASES)
def test_windowed_loops_equal_the_twins_bit_for_bit(shape, m, periodic, offsets):
    rng = np.random.RandomState(sum(shape) + 10 * m + 100 * periodic + len(offsets))
    v, g = (torch.from_numpy(rng.randn(*shape).astype(np.float32)) for _ in range(2))
    dy, dx = _offsets(shape, m, offsets, periodic, rng)
    fwd = fwd_windowed(v, dy, dx, m, periodic)
    assert torch.equal(_bits(fwd), _bits(tap_sum_fwd_plain(v, dy, dx, m, periodic)))
    *got, fold = bwd_windowed(v, dy, dx, g, m, periodic)
    want = tap_sum_bwd_plain(v, dy, dx, g, m, periodic)
    for name, a, b in zip(("dV", "ddy", "ddx"), got, want):
        assert torch.equal(_bits(a), _bits(b)), name
    if offsets == "clamped":  # the solver's offsets never leave the field
        assert not bool(fold.any())


def _same(a, b):
    """NaN where the other is NaN, and the same bits everywhere else."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(_bits(a)[~nan], _bits(b)[~nan])


POISONS = [("v", float("inf"), (0, 9, 21)), ("v", float("nan"), (0, 23, 39)),
           ("v", float("-inf"), (0, 0, 0)), ("g", float("inf"), (0, 12, 31)),
           ("g", float("nan"), (0, 4, 35)), ("dy", float("nan"), (0, 17, 8)),
           ("dx", float("inf"), (0, 8, 33))]


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("offsets", ["uniform", "clamped"])
@pytest.mark.parametrize("poison", POISONS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_non_finite_inputs_spread_as_in_the_twins(m, periodic, offsets, poison):
    """An inf or a NaN in V, g or an offset: the blocks that see it take the
    twin's full loops, so NaN and inf land where the twin's do (and with
    them the trainer's non-finite guard decides alike); the blocks that do
    not see it keep the windows and the twin's bits."""
    shape = (1, 24, 40)
    rng = np.random.RandomState(m + 2 * periodic)
    v, g = (torch.from_numpy(rng.randn(*shape).astype(np.float32)) for _ in range(2))
    dy, dx = _offsets(shape, m, offsets, periodic, rng)
    name, value, at = poison
    {"v": v, "g": g, "dy": dy, "dx": dx}[name][at] = value
    fwd = fwd_windowed(v, dy, dx, m, periodic)
    want = tap_sum_fwd_plain(v, dy, dx, m, periodic)
    assert _same(fwd, want)
    *got, _ = bwd_windowed(v, dy, dx, g, m, periodic)
    want_bwd = tap_sum_bwd_plain(v, dy, dx, g, m, periodic)
    for what, a, b in zip(("dV", "ddy", "ddx"), got, want_bwd):
        assert _same(a, b), what
    # the poison reaches some outputs (an infinite offset only zeroes its
    # weights), and the field has blocks it does not reach
    outs = (want,) + tuple(want_bwd)
    spreads = name in ("v", "g") or value != value
    assert any(not bool(torch.isfinite(t).all()) for t in outs) == spreads
    assert all(bool(torch.isfinite(t).any()) for t in outs)
