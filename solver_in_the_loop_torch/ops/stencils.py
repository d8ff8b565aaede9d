"""Finite-difference stencils on batched grids: laplacian, divergence, gradient.

Port of solver_in_the_loop_tpu/ops/stencils.py. All functions operate on raw
batched tensors (B, H, W) in index space (unit spacing); physical scaling is
applied by the callers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_hw(values: torch.Tensor, pad, periodic: bool) -> torch.Tensor:
    """Pad the last two axes of a (B, H, W) tensor; pad = (left, right, top, bottom)."""
    mode = "circular" if periodic else "replicate"
    return F.pad(values[:, None], pad, mode=mode)[:, 0]


def laplacian(values: torch.Tensor, periodic: bool = False) -> torch.Tensor:
    """5-point laplacian with unit spacing; replicate (OPEN) or wrap (PERIODIC) edges."""
    p = pad_hw(values, (1, 1, 1, 1), periodic)
    return (
        p[:, 1:-1, :-2] + p[:, 1:-1, 2:] + p[:, :-2, 1:-1] + p[:, 2:, 1:-1]
        - 4.0 * values
    )


def divergence(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Divergence of a MAC field in index space: (B,Y,X+1),(B,Y+1,X) -> (B,Y,X)."""
    return (u[:, :, 1:] - u[:, :, :-1]) + (v[:, 1:, :] - v[:, :-1, :])


def pressure_gradient(p: torch.Tensor, periodic: bool = False):
    """Gradient of a centered field onto MAC faces (index space).

    Returns (gu, gv) with gu (B, Y, X+1), gv (B, Y+1, X). OPEN domains use a
    Dirichlet-0 ghost pressure outside; PERIODIC neighbours wrap.
    """
    if periodic:
        pe = pad_hw(p, (1, 1, 0, 0), True)
        pn = pad_hw(p, (0, 0, 1, 1), True)
    else:
        pe = F.pad(p, (1, 1))
        pn = F.pad(p, (0, 0, 1, 1))
    gu = pe[:, :, 1:] - pe[:, :, :-1]
    gv = pn[:, 1:, :] - pn[:, :-1, :]
    return gu, gv


def masked_laplacian(
    p: torch.Tensor,
    mask_u: torch.Tensor,
    mask_v: torch.Tensor,
    periodic: bool = False,
) -> torch.Tensor:
    """Masked Poisson operator div(mask * grad(p)) with Dirichlet-0 ghosts (OPEN).

    mask_u (1, Y, X+1) and mask_v (1, Y+1, X) are face accessibility masks.
    """
    gu, gv = pressure_gradient(p, periodic=periodic)
    return divergence(gu * mask_u, gv * mask_v)
