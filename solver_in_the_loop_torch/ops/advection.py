"""Semi-Lagrangian advection on centered and staggered (MAC) grids.

Port of solver_in_the_loop_tpu/ops/advection.py. Each sample point (cell
center or face center) is backtraced by the local velocity interpolated at
that point, then the advected quantity is bilinearly sampled there. OPEN
domains clamp samples to the edge; PERIODIC wraps.

Backends: "gather" (arbitrary CFL, gather-based bilinear sampling) and
"shift" (the tap-sum of kernels/advect.py, for bounded CFL).
"""

from __future__ import annotations

from typing import Union

import torch

from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
from solver_in_the_loop_torch.ops.interp import bilinear_sample, shifted_stencil_sample
from solver_in_the_loop_torch.ops.stencils import pad_hw


def velocity_at_u_faces(vel: StaggeredGrid):
    """(u, v) sampled at u-face centers; both (B, Y, X+1)."""
    vp = pad_hw(vel.v, (1, 1, 0, 0), vel.domain.periodic)  # (B, Y+1, X+2)
    v_at_u = 0.25 * (vp[:, :-1, :-1] + vp[:, :-1, 1:] + vp[:, 1:, :-1] + vp[:, 1:, 1:])
    return vel.u, v_at_u


def velocity_at_v_faces(vel: StaggeredGrid):
    """(u, v) sampled at v-face centers; both (B, Y+1, X)."""
    up = pad_hw(vel.u, (0, 0, 1, 1), vel.domain.periodic)  # (B, Y+2, X+1)
    u_at_v = 0.25 * (up[:, :-1, :-1] + up[:, :-1, 1:] + up[:, 1:, :-1] + up[:, 1:, 1:])
    return u_at_v, vel.v


def velocity_at_centers(vel: StaggeredGrid):
    """(u, v) sampled at cell centers; both (B, Y, X)."""
    u_c = 0.5 * (vel.u[:, :, :-1] + vel.u[:, :, 1:])
    v_c = 0.5 * (vel.v[:, :-1, :] + vel.v[:, 1:, :])
    return u_c, v_c


def _backtrace_sample(values, u_here, v_here, dt, dx, periodic, method, max_shift):
    """Sample `values` (same layout as the points of u_here/v_here) backtraced by dt."""
    dy_sp, dx_sp = dx
    off_y = -dt * v_here / dy_sp
    off_x = -dt * u_here / dx_sp
    if method == "shift":
        return shifted_stencil_sample(values, off_y, off_x, max_shift, periodic)
    if method != "gather":
        raise ValueError(f"unknown advection method '{method}' (use 'gather' or 'shift')")
    h, w = values.shape[-2:]
    jj = torch.arange(h, dtype=values.dtype, device=values.device)[None, :, None]
    ii = torch.arange(w, dtype=values.dtype, device=values.device)[None, None, :]
    return bilinear_sample(values, jj + off_y, ii + off_x, periodic)


def semi_lagrangian(field: Union[CenteredGrid, StaggeredGrid], velocity: StaggeredGrid,
                    dt: float, method: str = "gather", max_shift: int = 2):
    """Advect `field` through `velocity` for time dt (both on the same domain)."""
    dom = velocity.domain
    periodic = dom.periodic
    args = (dt, dom.dx, periodic, method, max_shift)
    if isinstance(field, CenteredGrid):
        u_c, v_c = velocity_at_centers(velocity)
        return CenteredGrid(_backtrace_sample(field.values, u_c, v_c, *args), dom)
    u_u, v_u = velocity_at_u_faces(velocity)
    u_v, v_v = velocity_at_v_faces(velocity)
    new_u = _backtrace_sample(field.u, u_u, v_u, *args)
    new_v = _backtrace_sample(field.v, u_v, v_v, *args)
    return StaggeredGrid(new_u, new_v, dom)
