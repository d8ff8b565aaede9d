"""2-D forced viscous Burgers on a periodic MAC grid.

Port of solver_in_the_loop_tpu/physics/burgers.py:

* `BurgersFlow.step`: semi-Lagrangian self-advection, then explicit
  diffusion with physical viscosity (default 0.1) and optional substeps;
* `step_with_f`: solver step, then `velocity += dt * force`;
* forces: sums of `SinPotentialForce` analytic fields, per component
  amplitude_c * sin(k . x + phase), sampled at that component's face
  positions; the phase evolves as phase += dt * omega;
* `random_forces`: the reference's force distribution, with the JAX
  package's numpy call order, so a seed gives the same forces.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from solver_in_the_loop_torch.core.grids import Boundary, Domain, StaggeredGrid
from solver_in_the_loop_torch.ops.advection import semi_lagrangian
from solver_in_the_loop_torch.ops.diffusion import diffuse_explicit
from solver_in_the_loop_torch.utils import profiling


def burgers_domain(res: int, length: float = 32.0) -> Domain:
    """Domain([res, res], box [0:len]^2, PERIODIC)."""
    return Domain(resolution=(res, res), size=(length, length), boundary=Boundary.PERIODIC)


@dataclasses.dataclass(frozen=True)
class BurgersFlow:
    """Burgers solver step on a staggered periodic grid."""

    domain: Domain
    viscosity: float = 0.1
    diffusion_substeps: int = 1
    advection: str = "gather"  # "gather" | "shift"
    max_shift: int = 2

    def step(self, velocity: StaggeredGrid, dt: float = 1.0) -> StaggeredGrid:
        """One solver step, the `silt.solver` span."""
        with profiling.span("silt.solver"):
            return self._step(velocity, dt)

    def step_with_f(self, velocity: StaggeredGrid, force: StaggeredGrid,
                    dt: float = 1.0) -> StaggeredGrid:
        """`step`, then velocity += dt * force, as one `silt.solver` span."""
        with profiling.span("silt.solver"):
            out = self._step(velocity, dt)
            return StaggeredGrid(out.u + dt * force.u, out.v + dt * force.v, self.domain)

    def _step(self, velocity: StaggeredGrid, dt: float) -> StaggeredGrid:
        dom = self.domain
        dy, dx = dom.dx
        if abs(dy - dx) >= 1e-9:
            raise ValueError(f"Burgers needs square cells, got {dom.dx}")
        velocity = semi_lagrangian(velocity, velocity, dt, self.advection, self.max_shift)
        amount = self.viscosity * dt / (dx * dx)
        u = diffuse_explicit(velocity.u, amount, self.diffusion_substeps, periodic=True)
        v = diffuse_explicit(velocity.v, amount, self.diffusion_substeps, periodic=True)
        return StaggeredGrid(u, v, dom)


@dataclasses.dataclass
class SinPotentialForce:
    """F_c(x) = amplitude[c] * sin(k . x + phase), c in {v, u}.

    k (B, 2) wave vector [ky, kx]; amplitude (B, 2) [amp_v, amp_u]; phase (B,)
    offset, evolved by omega (B,). All float32 tensors on one device."""

    k: torch.Tensor
    amplitude: torch.Tensor
    phase: torch.Tensor
    omega: torch.Tensor

    def advance(self, dt: float) -> "SinPotentialForce":
        """phase += dt * omega."""
        return SinPotentialForce(self.k, self.amplitude, self.phase + dt * self.omega, self.omega)

    def sample(self, domain: Domain, batch: int = 1) -> StaggeredGrid:
        dev = self.k.device
        ky = self.k[:, 0][:, None, None]
        kx = self.k[:, 1][:, None, None]
        ph = self.phase[:, None, None]
        uy, ux = domain.u_face_coords(dev)
        u = self.amplitude[:, 1][:, None, None] * torch.sin(ky * uy[None] + kx * ux[None] + ph)
        vy, vx = domain.v_face_coords(dev)
        v = self.amplitude[:, 0][:, None, None] * torch.sin(ky * vy[None] + kx * vx[None] + ph)
        return StaggeredGrid(u.expand(domain.u_shape(batch)), v.expand(domain.v_shape(batch)),
                             domain)


def sample_force_sum(forces: Sequence[SinPotentialForce], domain: Domain, batch: int = 1,
                     device=None) -> StaggeredGrid:
    """Sum of all force fields sampled on the staggered grid."""
    total = domain.staggered_grid(0.0, 0.0, batch, device=device)
    for f in forces:
        total = total + f.sample(domain, batch)
    return total


def random_forces(rng: np.random.RandomState, num_forces: int = 20, batch: int = 1,
                  device=None) -> List[SinPotentialForce]:
    """Draw the reference's force distribution in its np.random call order
    (burgers.py:100-114 of the reference):

      angle ~ U[0,1)*pi; dir = [sin, cos]; k = (U+1)*0.8*dir
      amplitude ~ (U[.,2]-0.5)*0.3; phase ~ U*2pi; omega ~ U*0.8-0.4
    """
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    forces = []
    for _ in range(num_forces):
        angle = rng.random_sample((batch, 1, 1, 1)) * np.pi
        unit = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)  # [y, x]
        k = (rng.random_sample((batch, 1, 1, 1)) + 1.0) * 0.8 * unit
        amplitude = (rng.random_sample((batch, 1, 1, 2)) - 0.5) * 0.3
        phase = rng.random_sample((batch,)) * 2.0 * np.pi
        omega = rng.random_sample((batch,)) * 0.8 - 0.4
        forces.append(SinPotentialForce(k=f32(k[:, 0, 0, :]), amplitude=f32(amplitude[:, 0, 0, :]),
                                        phase=f32(phase), omega=f32(omega)))
    return forces
