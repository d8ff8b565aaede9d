"""Bilinear interpolation on batched 2-D tensors.

Port of solver_in_the_loop_tpu/ops/interp.py:

* `bilinear_sample` — gather-based, arbitrary coordinates (`--advect gather`).
* `shifted_stencil_sample` — gather-free sampling for bounded offsets
  (|delta| <= max_shift cells, `--advect shift`), as a weighted sum of shifted
  copies of the field: the differentiable tap-sum of kernels/advect.py.

Both clip their coordinates with `clip`, which has `jnp.clip`'s gradient.
"""

from __future__ import annotations

import torch

from solver_in_the_loop_torch.kernels.advect import tap_sum


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)` with its gradient: 0.5 where x equals a bound
    (max and min share a tie), where `torch.clamp` passes the whole of it.
    Where no gradient is taken it is one `torch.clamp` (the same values, one
    launch instead of two). The bounds are 0-d CPU tensors, which broadcast
    like Python scalars and cost no device copy."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(x, lo, hi)
    lo_t = torch.tensor(lo, dtype=x.dtype)
    hi_t = torch.tensor(hi, dtype=x.dtype)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def _gather_2d(values: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """values (B, H, W); integer index tensors yi/xi (B, ...) -> (B, ...)."""
    b_idx = torch.arange(values.shape[0], device=values.device)
    b_idx = b_idx.reshape((-1,) + (1,) * (yi.dim() - 1))
    return values[b_idx, yi, xi]


def bilinear_sample(values: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                    periodic: bool = False) -> torch.Tensor:
    """Sample `values` (B, H, W) at fractional index coordinates (y, x) of shape (B, ...).

    Outside the array, OPEN domains clamp to the edge value; PERIODIC wraps.
    """
    h, w = values.shape[-2:]
    if periodic:
        y = torch.remainder(y, h)
        x = torch.remainder(x, w)
        y0 = torch.floor(y).long()
        x0 = torch.floor(x).long()
        fy = y - y0
        fx = x - x0
        y1 = torch.remainder(y0 + 1, h)
        x1 = torch.remainder(x0 + 1, w)
        y0 = torch.remainder(y0, h)
        x0 = torch.remainder(x0, w)
    else:
        y = clip(y, 0.0, h - 1.0)
        x = clip(x, 0.0, w - 1.0)
        y0 = torch.floor(y).long()
        x0 = torch.floor(x).long()
        y0 = torch.clamp_max(y0, h - 2) if h > 1 else y0
        x0 = torch.clamp_max(x0, w - 2) if w > 1 else x0
        fy = y - y0
        fx = x - x0
        y1 = torch.clamp_max(y0 + 1, h - 1)
        x1 = torch.clamp_max(x0 + 1, w - 1)

    v00 = _gather_2d(values, y0, x0)
    v01 = _gather_2d(values, y0, x1)
    v10 = _gather_2d(values, y1, x0)
    v11 = _gather_2d(values, y1, x1)
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def shifted_stencil_sample(values: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                           max_shift: int, periodic: bool = False) -> torch.Tensor:
    """Gather-free bilinear sampling at (j + dy, i + dx) for each element (j, i).

    values, dy, dx: (B, H, W). Offsets are clamped to [-max_shift, max_shift]
    and, for OPEN domains, so that the sample stays inside the field (the
    clamps of interp.py:97-106 in the JAX package, with their gradient). The
    tap-sum then runs in the CUDA kernels for CUDA tensors and in their plain
    PyTorch twins for CPU tensors, forward and backward.
    """
    h, w = values.shape[-2:]
    dy = clip(dy, -max_shift, max_shift)
    dx = clip(dx, -max_shift, max_shift)
    if not periodic:
        jj = torch.arange(h, dtype=values.dtype, device=values.device)[None, :, None]
        ii = torch.arange(w, dtype=values.dtype, device=values.device)[None, None, :]
        dy = clip(jj + dy, 0.0, h - 1.0) - jj
        dx = clip(ii + dx, 0.0, w - 1.0) - ii
    dy = dy.expand(values.shape).contiguous()
    dx = dx.expand(values.shape).contiguous()
    return tap_sum(values.contiguous(), dy, dx, max_shift, periodic)
