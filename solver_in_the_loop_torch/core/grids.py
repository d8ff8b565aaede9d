"""Grid types: Domain, CenteredGrid, StaggeredGrid (MAC layout).

Port of solver_in_the_loop_tpu/core/grids.py with the same conventions:

* All field tensors carry an explicit leading batch dimension.
* Centered fields:   values.shape == (B, Y, X)
* Staggered (MAC) velocity:
    u (x-component) at x-faces: u.shape == (B, Y, X + 1)
    v (y-component) at y-faces: v.shape == (B, Y + 1, X)
* Index (j, i) maps to physical position:
    cell center (j, i): ((j + .5) * dy, (i + .5) * dx)
    u-face (j, i):      ((j + .5) * dy,  i       * dx)
    v-face (j, i):      ( j      * dy, (i + .5) * dx)
* The collocated feature layout of the correction networks is channel-last
  (B, Y, X, C) with channel order [v, u, ...extras].
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


class Boundary(enum.Enum):
    """Domain boundary behaviour (OPEN for karman, PERIODIC for burgers)."""

    OPEN = "open"
    PERIODIC = "periodic"


@dataclasses.dataclass(frozen=True)
class Domain:
    """Static description of a rectangular 2-D simulation domain.

    resolution: (Y, X) cell counts; size: physical extent (ly, lx).
    """

    resolution: Tuple[int, int]
    size: Tuple[float, float]
    boundary: Boundary = Boundary.OPEN

    @property
    def ny(self) -> int:
        return self.resolution[0]

    @property
    def nx(self) -> int:
        return self.resolution[1]

    @property
    def dx(self) -> Tuple[float, float]:
        """Cell spacing (dy, dx)."""
        return (self.size[0] / self.resolution[0], self.size[1] / self.resolution[1])

    @property
    def periodic(self) -> bool:
        return self.boundary == Boundary.PERIODIC

    def centered_shape(self, batch: int = 1) -> Tuple[int, int, int]:
        return (batch, self.ny, self.nx)

    def u_shape(self, batch: int = 1) -> Tuple[int, int, int]:
        return (batch, self.ny, self.nx + 1)

    def v_shape(self, batch: int = 1) -> Tuple[int, int, int]:
        return (batch, self.ny + 1, self.nx)

    def cell_center_coords(self, device=None):
        """(yy, xx) float32 physical coordinates of cell centers, each (Y, X)."""
        dy, dxx = self.dx
        y = (torch.arange(self.ny, device=device, dtype=torch.float32) + 0.5) * dy
        x = (torch.arange(self.nx, device=device, dtype=torch.float32) + 0.5) * dxx
        return torch.meshgrid(y, x, indexing="ij")

    def u_face_coords(self, device=None):
        """(yy, xx) float32 physical coordinates of u-faces, each (Y, X+1)."""
        dy, dxx = self.dx
        y = (torch.arange(self.ny, device=device, dtype=torch.float32) + 0.5) * dy
        x = torch.arange(self.nx + 1, device=device, dtype=torch.float32) * dxx
        return torch.meshgrid(y, x, indexing="ij")

    def v_face_coords(self, device=None):
        """(yy, xx) float32 physical coordinates of v-faces, each (Y+1, X)."""
        dy, dxx = self.dx
        y = torch.arange(self.ny + 1, device=device, dtype=torch.float32) * dy
        x = (torch.arange(self.nx, device=device, dtype=torch.float32) + 0.5) * dxx
        return torch.meshgrid(y, x, indexing="ij")

    def staggered_grid(self, u=0.0, v=0.0, batch: int = 1, device=None) -> "StaggeredGrid":
        """A float32 MAC field from constants (filled) or arrays of the
        component shapes."""
        def component(val, shape):
            if np.ndim(val) == 0:
                return torch.full(shape, float(val), dtype=torch.float32, device=device)
            return torch.as_tensor(val, dtype=torch.float32, device=device)

        return StaggeredGrid(component(u, self.u_shape(batch)), component(v, self.v_shape(batch)),
                             self)


@dataclasses.dataclass
class CenteredGrid:
    """Scalar field sampled at cell centers; values shape (B, Y, X)."""

    values: torch.Tensor
    domain: Domain


@dataclasses.dataclass
class StaggeredGrid:
    """MAC velocity field: u at x-faces (B, Y, X+1), v at y-faces (B, Y+1, X)."""

    u: torch.Tensor
    v: torch.Tensor
    domain: Domain

    def __add__(self, other: "StaggeredGrid") -> "StaggeredGrid":
        return StaggeredGrid(self.u + other.u, self.v + other.v, self.domain)

    def to_collocated(self) -> torch.Tensor:
        """Lower-face samples per cell, channel-last (B, Y, X, 2) = [v, u]."""
        return torch.stack([self.v[:, :-1, :], self.u[:, :, :-1]], dim=-1)

    @classmethod
    def from_collocated(cls, vu: torch.Tensor, domain: Domain) -> "StaggeredGrid":
        """Inverse of to_collocated with zero far edges: channel 0 -> v (top
        row zero), channel 1 -> u (rightmost column zero)."""
        v = F.pad(vu[..., 0], (0, 0, 0, 1))
        u = F.pad(vu[..., 1], (0, 1))
        return cls(u, v, domain)
