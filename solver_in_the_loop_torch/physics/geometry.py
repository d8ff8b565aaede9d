"""Geometry masks: sphere obstacles, box inflows (cell-center-inside sampling).

Port of solver_in_the_loop_tpu/physics/geometry.py.
"""

from __future__ import annotations

import torch

from solver_in_the_loop_torch.core.grids import Domain


def sphere_fluid_mask(domain: Domain, center_yx, radius: float, device=None) -> torch.Tensor:
    """(1, Y, X) float32 mask: 1 where the cell center lies OUTSIDE the sphere
    (strictly inside, `<`, counts as solid)."""
    yy, xx = domain.cell_center_coords(device)
    inside = (yy - center_yx[0]) ** 2 + (xx - center_yx[1]) ** 2 < radius**2
    return torch.where(inside, 0.0, 1.0)[None].to(torch.float32)


def box_mask(domain: Domain, y_range, x_range, device=None) -> torch.Tensor:
    """(1, Y, X) float32 mask: 1 where the cell center lies inside [y0,y1) x [x0,x1)."""
    yy, xx = domain.cell_center_coords(device)
    inside = (yy >= y_range[0]) & (yy < y_range[1]) & (xx >= x_range[0]) & (xx < x_range[1])
    return inside.to(torch.float32)[None]
