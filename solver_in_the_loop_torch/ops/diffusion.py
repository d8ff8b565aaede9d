"""Explicit diffusion (viscosity) with substeps.

Port of solver_in_the_loop_tpu/ops/diffusion.py: `c += alpha * laplace(c)`
per substep in index space.
"""

from __future__ import annotations

import torch

from solver_in_the_loop_torch.ops.stencils import laplacian


def diffuse_explicit(
    values: torch.Tensor,
    amount,
    substeps: int = 1,
    periodic: bool = False,
) -> torch.Tensor:
    """values (B, H, W); amount: scalar or (B, 1, 1) index-space diffusion amount.

    Explicit Euler: values += (amount / substeps) * laplace(values), repeated.
    """
    step = amount / substeps
    for _ in range(substeps):
        values = values + step * laplacian(values, periodic=periodic)
    return values
