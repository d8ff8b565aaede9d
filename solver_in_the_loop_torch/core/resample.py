"""Grid downsampling (SMAC-aware), used to start a rollout from hi-res frames.

Port of the downsampling half of solver_in_the_loop_tpu/core/resample.py:

* centered 4x downsample = 2x2 mean applied twice;
* staggered downsample2x: per component, take every 2nd face along the normal
  axis and average the 2 faces along the tangential axis.
"""

from __future__ import annotations

import torch


def downsample2x_centered(values: torch.Tensor) -> torch.Tensor:
    """(B, Y, X) -> (B, Y/2, X/2) by 2x2 mean."""
    b, y, x = values.shape
    return values.reshape(b, y // 2, 2, x // 2, 2).mean(dim=(2, 4))


def downsample_centered(values: torch.Tensor, factor: int) -> torch.Tensor:
    while factor > 1:
        values = downsample2x_centered(values)
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
