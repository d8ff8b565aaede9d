"""Plain float32 reference of the correction net (MarsMoon), its features
and its correction, on a dict of parameters keyed as the program's modules
are (`stem.weight`, `blocks.0.conv1.weight`, ..., `head.bias`; OIHW).

MarsMoon (Um et al. 2020, the SOL nets): a 5x5 conv to `features`
channels and LeakyReLU, `blocks` residual blocks [5x5 conv, LeakyReLU,
5x5 conv, + skip, LeakyReLU], a 5x5 conv to the two outputs [dv, du].
Features are the lower-face samples [v, u] of each cell plus a constant
Re channel (karman) or the force's samples [fv, fu] (Burgers), divided
by the dataset's scales; the output, times [std_v, std_u], is put back
on the MAC faces with zero far edges.

`tf32=True` computes every convolution on TF32 operands, rounded here to
TF32's 10-bit mantissa in the forward and in both products of the
backward, the precision one step below float32 that the program's
float32 configuration forbids: the control of the correctness check.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 mantissa bits, ties away
    from zero), as a tensor core rounds an fp32 operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, pad: int):
        ctx.save_for_backward(x, w)
        ctx.pad = pad
        return F.conv2d(tf32_round(x), tf32_round(w), padding=pad)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = tf32_round(g)
        dx = torch.nn.grad.conv2d_input(x.shape, tf32_round(w), g, padding=ctx.pad)
        dw = torch.nn.grad.conv2d_weight(tf32_round(x), w.shape, g, padding=ctx.pad)
        return dx, dw, None


def conv(x, params, name, tf32: bool):
    w, b = params[f"{name}.weight"], params[f"{name}.bias"]
    pad = w.shape[-1] // 2
    y = _Tf32Conv.apply(x, w, pad) if tf32 else F.conv2d(x, w, padding=pad)
    return y + b[:, None, None]


def mars_moon(x, params, blocks: int, slope: float, tf32: bool = False):
    """(B, Y, X, C) features -> (B, Y, X, 2)."""
    h = F.leaky_relu(conv(x.permute(0, 3, 1, 2), params, "stem", tf32), slope)
    for k in range(blocks):
        y = F.leaky_relu(conv(h, params, f"blocks.{k}.conv1", tf32), slope)
        h = F.leaky_relu(conv(y, params, f"blocks.{k}.conv2", tf32) + h, slope)
    return conv(h, params, "head", tf32).permute(0, 2, 3, 1)


def collocated(u, v):
    """[v, u] at each cell's lower faces: (B, Y, X, 2)."""
    return torch.stack([v[:, :-1, :], u[:, :, :-1]], dim=-1)


def correction(out, out_scales):
    """Net output (B, Y, X, 2) -> (du (B, Y, X+1), dv (B, Y+1, X))."""
    out = out * out_scales
    return F.pad(out[..., 1], (0, 1)), F.pad(out[..., 0], (0, 0, 0, 1))
