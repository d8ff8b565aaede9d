"""Karman vortex street: incompressible wake flow behind a sphere obstacle.

Port of solver_in_the_loop_tpu/physics/karman.py. One solver step:

    1. explicit viscosity on each MAC component, alpha = dt * res^2 / Re
       (per-batch Re supported)
    2. freestream velocity BC blend on v: v = v*(1-mask) + bc
    3. semi-Lagrangian advection of density (+ inflow) and velocity
    4. pressure projection with sphere-obstacle masks (OPEN boundaries)
"""

from __future__ import annotations

import torch

from solver_in_the_loop_torch.core.grids import Boundary, CenteredGrid, Domain, StaggeredGrid
from solver_in_the_loop_torch.ops.advection import semi_lagrangian
from solver_in_the_loop_torch.ops.diffusion import diffuse_explicit
from solver_in_the_loop_torch.ops.poisson import (
    make_incompressible,
    masks_from_fluid_cells,
    pressure_route,
)
from solver_in_the_loop_torch.physics.geometry import box_mask, sphere_fluid_mask
from solver_in_the_loop_torch.utils import profiling

OBSTACLE_CENTER = (50.0, 50.0)
OBSTACLE_RADIUS = 10.0
INFLOW_Y = (5.0, 10.0)
INFLOW_X = (25.0, 75.0)


def karman_domain(res: int, length: float = 100.0) -> Domain:
    """Domain([2*res, res], box [0:2L, 0:L], OPEN)."""
    return Domain(resolution=(2 * res, res), size=(2 * length, length), boundary=Boundary.OPEN)


def freestream_bc(domain: Domain, device=None):
    """(bc_values, bc_mask), both (1, Y+1, X) on v-faces: v = 1 on the two
    inlet rows (j=0,1) and on the left/right columns."""
    m = torch.zeros((1, domain.ny + 1, domain.nx), dtype=torch.float32, device=device)
    m[:, 0:2, :] = 1.0
    m[:, :, 0] = 1.0
    m[:, :, -1] = 1.0
    return m, m  # pre-multiplied values == mask (all-ones BC)


class KarmanFlow:
    """Static per-domain setup (masks on `device`) and the solver step.

    pressure_precon ("fd" | "none") picks the pressure solver with the
    shape and device (ops/poisson.py `pressure_route`)."""

    def __init__(self, domain: Domain, advection: str = "gather", max_shift: int = 2,
                 pressure_tol: float = 1e-5, pressure_max_iter: int = 1000,
                 pressure_precon: str = "fd", device=None):
        self.domain = domain
        self.advection = advection
        self.max_shift = max_shift
        self.pressure_tol = pressure_tol
        self.pressure_max_iter = pressure_max_iter
        self.pressure_precon = pressure_precon
        fluid = sphere_fluid_mask(domain, OBSTACLE_CENTER, OBSTACLE_RADIUS, device)
        self.masks = masks_from_fluid_cells(fluid, domain)
        self.inflow = box_mask(domain, INFLOW_Y, INFLOW_X, device)
        self._bc_vals, self._bc_mask = freestream_bc(domain, device)

    def step(self, density: CenteredGrid, velocity: StaggeredGrid, re, dt: float = 1.0,
             p0=None):
        """One solver step, the `silt.solver` span. re: (B,) per-batch
        Reynolds numbers (tensor or sequence).

        p0 warm-starts the pressure CG. Returns (density, velocity, pressure,
        CG iterations as a 0-d int32 tensor)."""
        with profiling.span("silt.solver"):
            density, velocity = self.pre_projection(density, velocity, re, dt)
            velocity, pressure, iters = make_incompressible(
                velocity, self.masks, tol=self.pressure_tol, max_iter=self.pressure_max_iter,
                p0=p0, precon=self.pressure_precon)
            return density, velocity, pressure, iters

    def pressure_route(self, batch: int) -> str:
        """The pressure solver `step` runs at this batch size on the masks'
        device (ops/poisson.py `pressure_route`)."""
        return pressure_route((batch,) + self.domain.resolution, self.masks.fluid.device,
                              self.domain.periodic, self.pressure_precon)

    def pre_projection(self, density: CenteredGrid, velocity: StaggeredGrid, re,
                       dt: float = 1.0):
        """Steps 1-3 of `step` (diffuse -> BC blend -> advect)."""
        dom = self.domain
        res = dom.nx  # reference resolution is the size in x
        re_arr = torch.as_tensor(re, dtype=torch.float32,
                                 device=velocity.u.device).reshape(-1, 1, 1)
        alpha = dt * float(res) * float(res) / re_arr  # index-space diffusion amount

        u = diffuse_explicit(velocity.u, alpha, periodic=False)
        v = diffuse_explicit(velocity.v, alpha, periodic=False)
        v = v * (1.0 - self._bc_mask) + self._bc_vals
        velocity = StaggeredGrid(u, v, dom)

        adv = dict(method=self.advection, max_shift=self.max_shift)
        density = semi_lagrangian(density, velocity, dt, **adv)
        density = CenteredGrid(density.values + self.inflow * dt, dom)
        velocity = semi_lagrangian(velocity, velocity, dt, **adv)
        return density, velocity


def initial_state(domain: Domain, batch: int = 1, device=None):
    """Warm-start init: v=1 everywhere, u 'poke' block to trigger instability
    (u = 1 on rows [Y/2+10, Y/2+20) x cols [X/2-2, X/2+2))."""
    d0 = CenteredGrid(torch.zeros(domain.centered_shape(batch), device=device), domain)
    u = torch.zeros(domain.u_shape(batch), device=device)
    y_mid, x_mid = (domain.ny + 1) // 2, (domain.nx + 1) // 2
    u[:, y_mid + 10: y_mid + 20, x_mid - 2: x_mid + 2] = 1.0
    v = torch.ones(domain.v_shape(batch), device=device)
    return d0, StaggeredGrid(u, v, domain)
