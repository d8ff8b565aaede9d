"""The bf16 forward kernel's partition, emulated on the CPU, against the
plain twin and the JAX package's forward.

csrc/conv_bf16.cu `conv_fwd_bf16` cannot run here. This test walks its
partition in float32 PyTorch, with the plan that kernels/conv.py
`fwd_bf16_plan` computes from the constants `FWD_BF16`, which it first holds
to the `constexpr` constants and the `FwdPlan` initializers of the source:

* the blocks: FWD_TH image rows x FWD_TW pixels and FWD_NT outputs;
* what a block stages, as the kernel stages it: where Cin >= 16 the patch
  (the tile and its K-1 halo, `cc` channels of a chunk) and the weight of
  every tap for the chunk and the block's outputs; where Cin < 16 the
  packed A rows (`taps` taps of all Cin channels in the 16 slots of a row,
  `groups` rows per pixel and tap row) and the weight in the same order;
  zeros outside the image, beyond Cin and Cout and beyond the K taps, and
  NaN in every slot the kernel never writes, which the products must never
  read;
* the products read through the kernel's own offsets (k-step column j at
  tap or tap group j >> sh, channel half j & sh): each warp takes two image
  rows and every other column over all tap rows, its partner the others,
  and where the columns are odd in number the last one's tap rows split
  between them; each k-step's 16x16 A tiles of both rows times its 16x16 B
  tile summed in fp32 into one of two banks by the tap row's parity, column
  after column, chunk after chunk;
* the epilogue: each half's two banks added, then half 0's sums plus half
  1's, + bias, + skip, the activation, one rounding to bf16, each output
  stored once.

The result is held to `conv_fwd_plain` within CONV_BF16_ULPS (parity
`bf16_errors`) at the card tests' shapes, forward and as the input
gradient, and to the JAX package's `_conv_rows` (the Pallas kernel in
interpret mode) at two small shapes, one of them a stem. The tensor cores'
order within one 16-term product is not emulated, so these are tolerances,
not bits.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.ops.pallas import conv_kernel as ck

from solver_in_the_loop_torch.kernels import conv as kconv
from solver_in_the_loop_torch.parity import CONV_BF16_ULPS, bf16_errors

torch.set_num_threads(1)

SOURCE = Path(kconv.__file__).resolve().parent.parent / "csrc" / "conv_bf16.cu"

# CONV_BF16_SHAPES of tests/test_torch_cuda.py, (B, H, W, Cin, Cout, K): the
# card's shapes, Cin = 20 (one chunk of 32 with 12 zero channels), Cin = 8
# and 5 (packed: 2 and 3 taps per row, 3 and 2 tap groups), K = 1, two
# chunks as the input gradient (16 -> 64), and Cin = 12 at K = 7 (7 groups)
SHAPES = [
    (5, 32, 32, 4, 32, 5), (5, 32, 32, 32, 32, 5), (5, 32, 32, 32, 2, 5), (1, 32, 32, 32, 32, 5),
    (3, 64, 32, 3, 32, 5), (1, 64, 32, 32, 2, 5), (5, 32, 32, 32, 32, 3),
    (2, 16, 16, 64, 64, 7), (1, 64, 32, 32, 64, 5), (1, 64, 32, 64, 2, 5),
    (2, 33, 17, 5, 3, 5), (8, 32, 32, 32, 32, 5),
    (1, 64, 32, 3, 32, 3), (1, 64, 32, 3, 32, 7), (3, 64, 32, 32, 32, 5), (3, 64, 32, 32, 2, 5),
    (1, 9, 24, 20, 17, 3), (2, 8, 8, 8, 16, 5), (1, 12, 20, 16, 9, 1), (2, 16, 16, 16, 64, 3),
    (1, 16, 24, 12, 20, 7),
]

# FwdPlan's member initializers in csrc/conv_bf16.cu, which fwd_bf16_plan mirrors
PLAN_INITIALIZERS = [
    "packed(cin < 16)",
    "taps(cin < 16 ? 16 / max(cin, 1) : 1)",
    "groups((k + taps - 1) / taps)",
    "cc(cin < 16 ? 16 : min(round_up(cin, 16), FWD_CC))",
    "cs(cin < 16 ? FWD_RS : cc + 8)",
    "ph(FWD_TH + k - 1)",
    "pw(cin < 16 ? groups * FWD_TW : FWD_TW + k - 1)",
    "nkx(cin < 16 ? groups : k)",
    "per_ky(cin < 16 ? groups : k * (cc / 16))",
    "patch(ph * pw * cs)",
    "weight(k * nkx * FWD_NT * cs)",
    "raw(cin < 16 ? 0 : max(FWD_NT * round_up(cc * k * k, 8), cc * round_up(FWD_NT * k * k, 8)))",
]


def test_plan_constants_match_the_source():
    text = SOURCE.read_text()
    constants = {m.group(1): int(m.group(2))
                 for m in re.finditer(r"constexpr int (FWD_[A-Z_]+) = (\d+);", text)}
    assert constants == kconv.FWD_BF16
    plan = text[text.index("struct FwdPlan {"):]
    plan = re.sub(r"\s+", " ", plan[:plan.index("{}")])
    for init in PLAN_INITIALIZERS:
        assert init in plan, init


def _weight_at(w, flip, ky, kx, c, o):
    """w[ky, kx, c, o] (flipped taps where `flip`), 0 where `valid` is
    False; the index tensors broadcast together."""
    k = w.shape[0]
    if flip:
        ky, kx = k - 1 - ky, k - 1 - kx
    valid = (kx >= 0) & (kx < k) & (c < w.shape[2]) & (o < w.shape[3])
    vals = w[ky.clamp(0, k - 1), kx.clamp(0, k - 1), c.clamp(max=w.shape[2] - 1),
             o.clamp(max=w.shape[3] - 1)]
    return torch.where(valid, vals, 0.0)


def _stage_wide(x, w, flip, plan, c0, tiles, n_co):
    """The patch (tiles, ph * pw * cs) and the weight (n_co, K*K*NT*cs) of
    chunk c0, flat as the kernel lays them out; NaN in the padding."""
    c = kconv.FWD_BF16
    b, h, wd, cin = x.shape
    k = w.shape[0]
    r = k // 2
    cs, cc, ph, pw, nt = plan["cs"], plan["cc"], plan["ph"], plan["pw"], c["FWD_NT"]
    bb, y0, x0 = tiles
    yy, xx, ch = torch.meshgrid(torch.arange(ph), torch.arange(pw), torch.arange(cs), indexing="ij")
    gy = y0[:, None, None, None] + yy - r
    gx = x0[:, None, None, None] + xx - r
    cg = c0 + ch
    inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < wd) & (cg < cin)
    vals = x[bb[:, None, None, None], gy.clamp(0, h - 1), gx.clamp(0, wd - 1), cg.clamp(max=cin - 1)]
    xs = torch.where(ch < cc, torch.where(inside, vals, 0.0), float("nan"))
    tap, o, ch = torch.meshgrid(torch.arange(k * k), torch.arange(nt), torch.arange(cs),
                                indexing="ij")
    co0 = torch.arange(n_co)[:, None, None, None] * nt
    wv = _weight_at(w, flip, tap // k, tap % k, c0 + ch, co0 + o)
    ws = torch.where(ch < cc, wv, float("nan"))
    return xs.reshape(len(bb), -1), ws.reshape(n_co, -1)


def _stage_packed(x, w, flip, plan, tiles, n_co):
    """The packed A rows (tiles, ph * pw * RS) and weight (n_co, K * groups
    * NT * RS), flat; NaN in the padding."""
    c = kconv.FWD_BF16
    b, h, wd, cin = x.shape
    k = w.shape[0]
    r = k // 2
    rs, taps, groups, nt, tw = c["FWD_RS"], plan["taps"], plan["groups"], c["FWD_NT"], c["FWD_TW"]
    bb, y0, x0 = tiles
    ry, q, px, d = torch.meshgrid(torch.arange(plan["ph"]), torch.arange(groups),
                                  torch.arange(tw), torch.arange(rs), indexing="ij")
    tap, ch = d // cin, d % cin
    kx = q * taps + tap
    gy = y0[:, None, None, None, None] + ry - r
    gx = x0[:, None, None, None, None] + px + kx - r
    ok = (d < 16) & (tap < taps) & (kx < k) & (gy >= 0) & (gy < h) & (gx >= 0) & (gx < wd)
    vals = x[bb[:, None, None, None, None], gy.clamp(0, h - 1), gx.clamp(0, wd - 1), ch]
    xs = torch.where(d < 16, torch.where(ok, vals, 0.0), float("nan"))
    ky, q, o, d = torch.meshgrid(torch.arange(k), torch.arange(groups), torch.arange(nt),
                                 torch.arange(rs), indexing="ij")
    tap, ch = d // cin, d % cin
    kx = torch.where(tap < taps, q * taps + tap, k)  # slots beyond taps * cin: zero
    co0 = torch.arange(n_co)[:, None, None, None, None] * nt
    wv = _weight_at(w, flip, ky, kx, ch, co0 + o)
    ws = torch.where(d < 16, wv, float("nan"))
    return xs.reshape(len(bb), -1), ws.reshape(n_co, -1)


def emulate_fwd_bf16(x, w, bias=None, skip=None, act="none", slope=0.3, flip=False):
    """y (B, H, W, Cout) as conv_fwd_bf16 partitions, stages, sums and stores
    it; x, w, bias and skip float32 tensors holding bf16 values, w any
    (K, K, Cin, Cout) view. Returned in bf16."""
    c = kconv.FWD_BF16
    b, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    plan = kconv.fwd_bf16_plan(b, h, wd, cin, cout, k)
    th, tw, nt = c["FWD_TH"], c["FWD_TW"], c["FWD_NT"]
    tiles_y, tiles_x = -(-h // th), -(-wd // tw)
    blk = torch.arange(plan["grid"][0])
    tiles = (blk // (tiles_x * tiles_y), (blk // tiles_x) % tiles_y * th, blk % tiles_x * tw)
    n_co = plan["grid"][1]
    cs, pw, nkx, per_ky = plan["cs"], plan["pw"], plan["nkx"], plan["per_ky"]
    sh = per_ky // nkx - 1
    a_kx = tw * cs if plan["packed"] else cs
    b_kx = nt * cs
    # the 16x16 tiles an ldmatrix.x4 reads: row i of A (pixel) and of B (output), slot j
    rows, cols = torch.meshgrid(torch.arange(16), torch.arange(16), indexing="ij")
    tile_off = rows * cs + cols
    # [tile, output tile, row pair rp, half, row 2 rp + r, bank, pixel, output]
    acc = torch.zeros((len(blk), n_co, th // 2, 2, 2, 2, 16, 16))
    # each half's units (column, tap rows [k0, k1)): every other column, and
    # where their number is odd the last one's tap rows split in two
    n_even = per_ky & ~1
    units = [[(j, 0, k) for j in range(half, n_even, 2)] for half in range(2)]
    if per_ky % 2:
        units[0].append((n_even, 0, (k + 1) // 2))
        units[1].append((n_even, (k + 1) // 2, k))
    for c0 in range(0, cin, plan["cc"]):
        if plan["packed"]:
            xs, ws = _stage_packed(x, w, flip, plan, tiles, n_co)
        else:
            xs, ws = _stage_wide(x, w, flip, plan, c0, tiles, n_co)
        for rp in range(th // 2):
            for half in range(2):
                for j, k0, k1 in units[half]:
                    for ky in range(k0, k1):
                        b_at = ky * nkx * b_kx + (j >> sh) * b_kx + (j & sh) * 16
                        bt = ws[:, b_at + tile_off]  # (n_co, 16 outputs, 16 slots)
                        for r in range(2):
                            a_at = ((2 * rp + r + ky) * pw * cs + (j >> sh) * a_kx
                                    + (j & sh) * 16)
                            a = xs[:, a_at + tile_off]  # (tiles, 16 pixels, 16 slots)
                            acc[:, :, rp, half, r, ky & 1] += torch.einsum("tpk,nok->tnpo", a, bt)
    part = acc[..., 0, :, :] + acc[..., 1, :, :]  # each half's bank sums
    v = part[:, :, :, 0] + part[:, :, :, 1]  # half 0's plus half 1's
    v = v.reshape(len(blk), n_co, th, 16, 16)  # rows 2 rp + r
    y = torch.full((b, h, wd, cout), float("nan"))
    written = torch.zeros((b, h, wd, cout), dtype=torch.int32)
    for t in range(len(blk)):
        bb, y0, x0 = (int(a[t]) for a in tiles)
        for co in range(n_co):
            o0, o1 = co * nt, min(cout, co * nt + nt)
            y1, x1 = min(h, y0 + th), min(wd, x0 + tw)
            z = v[t, co, :y1 - y0, :x1 - x0, :o1 - o0]
            if bias is not None:
                z = z + bias[o0:o1]
            if skip is not None:
                z = z + skip[bb, y0:y1, x0:x1, o0:o1]
            y[bb, y0:y1, x0:x1, o0:o1] = kconv._activate(z, act, slope)
            written[bb, y0:y1, x0:x1, o0:o1] += 1
    assert torch.equal(written, torch.ones_like(written)), "an output stored twice or never"
    return y.to(torch.bfloat16)


def _bf16_inputs(shape, seed=0):
    b, h, w, cin, cout, k = shape
    rng = np.random.RandomState(seed)

    def bf16(*s, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*s)).astype(np.float32)).to(torch.bfloat16)

    return (bf16(b, h, w, cin), bf16(cout, cin, k, k, scale=0.1), bf16(cout, scale=0.1),
            bf16(b, h, w, cout))


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_forward_matches_plain(shape):
    x, wt, bias, skip = _bf16_inputs(shape)
    w = wt.permute(2, 3, 1, 0)
    got = emulate_fwd_bf16(x.float(), w.float(), bias.float(), skip.float(), "leaky_relu", 0.3)
    want = kconv.conv_fwd_plain(x, w, bias, skip, "leaky_relu", 0.3)
    assert torch.isfinite(got.float()).all()
    assert bf16_errors(got, want) <= CONV_BF16_ULPS


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_input_gradient_matches_plain(shape):
    """dX: the same kernel on dz with the flipped, channel-transposed view
    of the weight, zero bias, no activation."""
    _, wt, _, dz = _bf16_inputs(shape, seed=1)
    w = wt.permute(2, 3, 1, 0).transpose(2, 3)
    got = emulate_fwd_bf16(dz.float(), w.float(), flip=True)
    want = kconv.conv_fwd_plain(dz, w, flip=True)
    assert torch.isfinite(got.float()).all()
    assert bf16_errors(got, want) <= CONV_BF16_ULPS


@pytest.mark.parametrize("shape,act,with_skip", [((2, 8, 8, 4, 32, 5), "leaky_relu", False),
                                                 ((2, 8, 8, 32, 16, 3), "relu", True)])
def test_emulated_forward_matches_jax(monkeypatch, shape, act, with_skip):
    monkeypatch.setattr(ck, "_INTERPRET", True)
    x, wt, bias, skip = _bf16_inputs(shape, seed=2)
    w = wt.permute(2, 3, 1, 0)
    skip = skip if with_skip else None

    def jarr(t):
        return None if t is None else jnp.asarray(t.float().numpy(), jnp.bfloat16)

    want = ck._conv_rows(jarr(x), jarr(w.contiguous()), jarr(bias), jarr(skip), act, 0.3)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(torch.bfloat16)
    got = emulate_fwd_bf16(x.float(), w.float(), bias.float(),
                           None if skip is None else skip.float(), act, 0.3)
    assert bf16_errors(got, want) <= CONV_BF16_ULPS
