"""The bf16 weight-gradient kernel's partition, emulated on the CPU, against
the plain twin and the JAX package's weight gradient.

csrc/conv_bf16.cu `conv_wgrad_bf16` cannot run here. This test walks its
partition in float32 PyTorch, with the plan that kernels/conv.py
`wgrad_bf16_plan` computes from the constants `WGRAD_BF16`, which it first
holds to the `constexpr` constants and the `WgPlan` initializers of the
source:

* the blocks: one tap row ky, one tile of 16 input channels (or, where
  Cin < 16, `taps` taps of all Cin channels packed into the 16 rows of an A
  tile), one tile of 16 outputs, and one rank of a cluster that owns a
  contiguous share of the units (`seg` pixels of one image row);
* the stages of `per_stage` units, each staged as the kernel stages it:
  `pw` input rows per unit with the halo and the packed taps, zeros outside
  the image and beyond the row, and NaN in every slot the kernel never
  writes (channels beyond Cin, outputs beyond Cout), which must reach only
  products that are not stored;
* the 16-pixel slices of a stage dealt to the warps in turn, each adding
  its tap groups' products (one 16x16 A tile times the slice's dz tile,
  summed in fp32) to the warp's sums;
* the warps' sums added in warp order, then the ranks' in rank order, and
  each sum stored once at (ky, kx, c, o).

The result is held to `conv_wgrad_plain` within CONV_WGRAD_BF16_REL_TOL of
its max at the card tests' shapes, and to the JAX package's `_conv_wgrad`
(the Pallas kernel in interpret mode) at two small shapes. The tensor
cores' order within one 16-term product is not emulated, so these are
tolerances, not bits.
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
from solver_in_the_loop_torch.parity import CONV_WGRAD_BF16_REL_TOL

torch.set_num_threads(1)

SOURCE = Path(kconv.__file__).resolve().parent.parent / "csrc" / "conv_bf16.cu"

# CONV_SHAPES of tests/test_torch_cuda.py, (B, H, W, Cin, Cout, K), and three
# more: two segments per image row with K = 1 and partial channel tiles; two
# packed taps of 8 channels with a partial output tile; a small stem
SHAPES = [
    (5, 32, 32, 4, 32, 5), (5, 32, 32, 32, 32, 5), (5, 32, 32, 32, 2, 5), (1, 32, 32, 32, 32, 5),
    (3, 64, 32, 3, 32, 5), (1, 64, 32, 32, 2, 5), (5, 32, 32, 32, 32, 3),
    (2, 16, 16, 64, 64, 7), (1, 64, 32, 32, 64, 5), (1, 64, 32, 64, 2, 5),
    (2, 33, 17, 5, 3, 5), (8, 32, 32, 32, 32, 5), (1, 64, 32, 3, 32, 3), (1, 64, 32, 3, 32, 7),
    (1, 4, 70, 20, 20, 1), (1, 9, 24, 8, 17, 3), (2, 8, 8, 4, 32, 5),
]

# WgPlan's member initializers in csrc/conv_bf16.cu, which wgrad_bf16_plan mirrors
PLAN_INITIALIZERS = [
    "seg(wd > 0 ? min(round_up(wd, 16), WG_SEG) : 16)",
    "segs((wd + seg - 1) / seg)",
    "units(batch * h * segs)",
    "per_stage(max(1, WG_PIXELS / seg))",
    "taps(cin < 16 ? 16 / cin : 1)",
    "groups((k + taps - 1) / taps)",
    "pw(seg + (groups - 1) * taps)",
    "raw(taps > 1 ? seg * cin : 0)",
    "stage_elems(per_stage * ((pw + seg) * WG_RS + raw))",
]


def test_plan_constants_match_the_source():
    text = SOURCE.read_text()
    constants = {m.group(1): int(m.group(2))
                 for m in re.finditer(r"constexpr int (WG_[A-Z_]+) = (\d+);", text)}
    assert constants == kconv.WGRAD_BF16
    plan = text[text.index("struct WgPlan {"):]
    plan = re.sub(r"\s+", " ", plan[:plan.index("{}")])
    for init in PLAN_INITIALIZERS:
        assert init in plan, init


def _stage_x(x, plan, k, ky, ci0):
    """The staged input rows of every unit for tap row ky and the channel
    tile at ci0: (units, pw, 16), NaN where the kernel writes nothing."""
    b, h, w, cin = x.shape
    r = k // 2
    u, s, e = torch.meshgrid(torch.arange(plan["units"]), torch.arange(plan["pw"]),
                             torch.arange(16), indexing="ij")
    q = u // plan["segs"]  # image row b * h + y
    taps = plan["taps"]
    tap = e // cin if taps > 1 else torch.zeros_like(e)
    c = e % cin if taps > 1 else ci0 + e
    staged = e < (taps * cin if taps > 1 else min(16, cin - ci0))
    gx = (u % plan["segs"]) * plan["seg"] + s + tap - r
    yy = q % h + ky - r
    inside = (yy >= 0) & (yy < h) & (gx >= 0) & (gx < w) & staged
    vals = x.reshape(-1)[torch.where(inside, ((q + ky - r) * w + gx) * cin + c, 0)]
    return torch.where(staged, torch.where(inside, vals, 0.0), float("nan"))


def _stage_dz(dz, plan, co0):
    """The staged dz rows of every unit for the output tile at co0: (units,
    seg, 16), zeros beyond the row, NaN where the kernel writes nothing."""
    _, _, w, cout = dz.shape
    u, s, e = torch.meshgrid(torch.arange(plan["units"]), torch.arange(plan["seg"]),
                             torch.arange(16), indexing="ij")
    q = u // plan["segs"]
    gx = (u % plan["segs"]) * plan["seg"] + s
    staged = e < min(16, cout - co0)
    inside = (gx < w) & staged
    vals = dz.reshape(-1)[torch.where(inside, (q * w + gx) * cout + co0 + e, 0)]
    return torch.where(staged, torch.where(inside, vals, 0.0), float("nan"))


def emulate_wgrad_bf16(x: torch.Tensor, dz: torch.Tensor, k: int) -> torch.Tensor:
    """dw (K, K, Cin, Cout) as conv_wgrad_bf16 partitions and sums it; x and
    dz float32 tensors holding bf16 values."""
    b, h, w, cin = x.shape
    cout = dz.shape[-1]
    plan = kconv.wgrad_bf16_plan(b, h, w, cin, cout, k)
    warps = kconv.WGRAD_BF16["WG_WARPS"]
    taps, groups, ranks = plan["taps"], plan["groups"], plan["ranks"]
    units, per_stage = plan["units"], plan["per_stage"]
    spu = plan["seg"] // 16
    # each tap group's 16 A rows of a slice: staged rows p0 + q * taps + [0, 16)
    rows_of = (torch.arange(groups)[:, None] * taps + torch.arange(16)[None, :])
    dw = torch.full((k, k, cin, cout), float("nan"))
    written = torch.zeros((k, k, cin, cout), dtype=torch.int32)
    for ky in range(k):
        for ci0 in range(0, cin, 16):
            xs = _stage_x(x, plan, k, ky, ci0)
            for co0 in range(0, cout, 16):
                ds = _stage_dz(dz, plan, co0)
                block_sums = []
                for rank in range(ranks):
                    u0, u1 = units * rank // ranks, units * (rank + 1) // ranks
                    acc = torch.zeros((warps, groups, 16, 16))
                    for ua in range(u0, u1, per_stage):
                        n = min(per_stage, u1 - ua)
                        for sl in range(n * spu):
                            j, p0 = sl // spu, (sl % spu) * 16
                            a = xs[ua + j][p0 + rows_of]  # (groups, 16 pixels, 16 rows)
                            bt = ds[ua + j, p0:p0 + 16]  # (16 pixels, 16 outputs)
                            acc[sl % warps] = acc[sl % warps] + a.transpose(1, 2) @ bt
                    total = acc[0]
                    for wp in range(1, warps):
                        total = total + acc[wp]
                    block_sums.append(total)
                total = block_sums[0]
                for rank in range(1, ranks):
                    total = total + block_sums[rank]
                for grp in range(groups):
                    for d in range(16):
                        tap = d // cin if taps > 1 else 0
                        kx = grp * taps + tap
                        c = d % cin if taps > 1 else ci0 + d
                        if tap >= taps or kx >= k or c >= cin:
                            continue
                        o1 = min(16, cout - co0)
                        dw[ky, kx, c, co0:co0 + o1] = total[grp, d, :o1]
                        written[ky, kx, c, co0:co0 + o1] += 1
    assert torch.equal(written, torch.ones_like(written)), "an element stored twice or never"
    return dw


def _bf16_inputs(shape, seed=0):
    b, h, w, cin, cout, _ = shape
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32)).to(torch.bfloat16)
    dz = torch.from_numpy(rng.randn(b, h, w, cout).astype(np.float32)).to(torch.bfloat16)
    return x, dz


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_partition_matches_plain(shape):
    x, dz = _bf16_inputs(shape)
    k = shape[5]
    got = emulate_wgrad_bf16(x.float(), dz.float(), k)
    want = kconv.conv_wgrad_plain(x, dz, k)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= CONV_WGRAD_BF16_REL_TOL * float(want.abs().max())


@pytest.mark.parametrize("shape", [(2, 8, 8, 4, 32, 5), (2, 8, 8, 8, 8, 3)])
def test_emulated_partition_matches_jax(monkeypatch, shape):
    monkeypatch.setattr(ck, "_INTERPRET", True)
    x, dz = _bf16_inputs(shape, seed=1)
    k = shape[5]
    want = np.asarray(ck._conv_wgrad(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(dz.float().numpy(), jnp.bfloat16), k))
    got = emulate_wgrad_bf16(x.float(), dz.float(), k).numpy()
    assert np.abs(got - want).max() <= CONV_WGRAD_BF16_REL_TOL * np.abs(want).max()
