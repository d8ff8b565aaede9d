"""Grid resampling (SMAC-aware): downsampling, used to start a rollout from
hi-res frames, and upsampling, used by the PRE generators.

Port of solver_in_the_loop_tpu/core/resample.py:

* centered 4x downsample = 2x2 mean applied twice;
* staggered downsample2x: per component, take every 2nd face along the normal
  axis and average the 2 faces along the tangential axis;
* centered upsample2x: linear interpolation (0.75/0.25 weights, replicate
  edges);
* staggered upsample2x: bilinear interpolation at the fine face positions;
* a generic bilinear regrid of a centered field onto another domain.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from solver_in_the_loop_torch.core.grids import CenteredGrid, Domain
from solver_in_the_loop_torch.ops.interp import bilinear_sample


def downsample2x_centered(values: torch.Tensor) -> torch.Tensor:
    """(B, Y, X) -> (B, Y/2, X/2) by 2x2 mean."""
    b, y, x = values.shape
    return values.reshape(b, y // 2, 2, x // 2, 2).mean(dim=(2, 4))


def downsample_centered(values: torch.Tensor, factor: int) -> torch.Tensor:
    while factor > 1:
        values = downsample2x_centered(values)
        factor //= 2
    return values


def upsample2x_centered(values: torch.Tensor) -> torch.Tensor:
    """(B, Y, X) -> (B, 2Y, 2X), linear (0.75/0.25 weights, replicate edges)."""
    def up_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
        n = a.shape[axis]
        pad = (0, 0, 1, 1) if axis == 1 else (1, 1, 0, 0)
        p = F.pad(a[:, None], pad, mode="replicate")[:, 0]
        lo, mid, hi = (p.narrow(axis, k, n) for k in range(3))
        even = 0.25 * lo + 0.75 * mid
        odd = 0.75 * mid + 0.25 * hi
        shape = list(a.shape)
        shape[axis] *= 2
        return torch.stack([even, odd], dim=axis + 1).reshape(shape)

    return up_axis(up_axis(values, 1), 2)


def upsample_centered(values: torch.Tensor, factor: int) -> torch.Tensor:
    while factor > 1:
        values = upsample2x_centered(values)
        factor //= 2
    return values


def downsample2x_staggered(u: torch.Tensor, v: torch.Tensor):
    """u (B, Y, X+1), v (B, Y+1, X) -> halved-resolution components:
    u_lo[j, i] = mean(u_hi[2j:2j+2, 2i]);  v_lo[j, i] = mean(v_hi[2j, 2i:2i+2])."""
    u_lo = 0.5 * (u[:, 0::2, ::2] + u[:, 1::2, ::2])
    v_lo = 0.5 * (v[:, ::2, 0::2] + v[:, ::2, 1::2])
    return u_lo, v_lo


def downsample_staggered(u: torch.Tensor, v: torch.Tensor, factor: int):
    while factor > 1:
        u, v = downsample2x_staggered(u, v)
        factor //= 2
    return u, v


def upsample2x_staggered(u: torch.Tensor, v: torch.Tensor):
    """Bilinear upsampling of MAC components at the fine face positions: fine
    u-face (jh, ih) samples the coarse u at index (jh/2 - 0.25, ih/2), fine
    v-face (jh, ih) the coarse v at (jh/2, ih/2 - 0.25), edges replicated."""
    b, yu, xu1 = u.shape
    y_hi, x_hi = 2 * yu, 2 * (xu1 - 1)
    kw = dict(dtype=u.dtype, device=u.device)

    jj = ((torch.arange(y_hi, **kw) + 0.5)[None, :, None] / 2.0 - 0.5).expand(b, y_hi, x_hi + 1)
    ii = (torch.arange(x_hi + 1, **kw)[None, None, :] / 2.0).expand(b, y_hi, x_hi + 1)
    u_hi = bilinear_sample(u, jj, ii)

    jjv = (torch.arange(y_hi + 1, **kw)[None, :, None] / 2.0).expand(b, y_hi + 1, x_hi)
    iiv = ((torch.arange(x_hi, **kw) + 0.5)[None, None, :] / 2.0 - 0.5).expand(b, y_hi + 1, x_hi)
    v_hi = bilinear_sample(v, jjv, iiv)
    return u_hi, v_hi


def upsample_staggered(u: torch.Tensor, v: torch.Tensor, factor: int):
    while factor > 1:
        u, v = upsample2x_staggered(u, v)
        factor //= 2
    return u, v


def resample_centered_grid(grid: CenteredGrid, dst: Domain) -> CenteredGrid:
    """Bilinear regrid of a centered field onto dst's cell centers."""
    src = grid.domain
    b = grid.values.shape[0]
    dy_s, dx_s = src.dx
    yy, xx = dst.cell_center_coords(grid.values.device)
    yi = (yy / dy_s - 0.5)[None].expand((b,) + yy.shape)
    xi = (xx / dx_s - 0.5)[None].expand((b,) + xx.shape)
    return CenteredGrid(bilinear_sample(grid.values, yi, xi, periodic=src.periodic), dst)
