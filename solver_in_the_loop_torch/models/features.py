"""Feature construction and the normalization contract of the correction nets.

Port of solver_in_the_loop_tpu/models/features.py (without the PRE means):

* features = collocated lower-face velocity samples [v, u] + a constant Re
  channel (karman) or the force's samples [fv, fu] (burgers, unless the
  force channels are dropped), divided channel-wise by the dataset's
  statistics;
* the model's 2-channel output is multiplied by [std_v, std_u] and
  zero-padded back onto the staggered grid.
"""

from __future__ import annotations

import dataclasses

import torch

from typing import Optional

from solver_in_the_loop_torch.core.grids import Domain, StaggeredGrid


@dataclasses.dataclass
class Normalization:
    """Channel scales: in_scales (C_in,) divide the features, out_scales (2,)
    multiply the model output [dv, du]."""

    in_scales: torch.Tensor
    out_scales: torch.Tensor

    @classmethod
    def karman(cls, std_v: float, std_u: float, std_re: float, device=None) -> "Normalization":
        return cls(
            torch.tensor([std_v, std_u, std_re], dtype=torch.float32, device=device),
            torch.tensor([std_v, std_u], dtype=torch.float32, device=device),
        )

    @classmethod
    def burgers(cls, std_v: float, std_u: float, std_fv: float, std_fu: float,
                device=None) -> "Normalization":
        return cls(
            torch.tensor([std_v, std_u, std_fv, std_fu], dtype=torch.float32, device=device),
            torch.tensor([std_v, std_u], dtype=torch.float32, device=device),
        )


def karman_features(velocity: StaggeredGrid, re, norm: Normalization) -> torch.Tensor:
    """(B, Y, X, 3): [v, u, Re] / in_scales."""
    vu = velocity.to_collocated()
    b, y, x, _ = vu.shape
    re_chan = torch.as_tensor(re, dtype=torch.float32, device=vu.device)
    re_chan = re_chan.reshape(-1, 1, 1, 1).expand(b, y, x, 1)
    return torch.cat([vu, re_chan], dim=-1) / norm.in_scales


def burgers_features(velocity: StaggeredGrid, force: Optional[StaggeredGrid],
                     norm: Normalization) -> torch.Tensor:
    """(B, Y, X, 4): [v, u, fv, fu] / in_scales ((B, Y, X, 2) without force)."""
    vu = velocity.to_collocated()
    if force is not None:
        vu = torch.cat([vu, force.to_collocated()], dim=-1)
    return vu / norm.in_scales


def correction_to_staggered(net_out: torch.Tensor, norm: Normalization,
                            domain: Domain) -> StaggeredGrid:
    """Model output (B, Y, X, 2) -> scaled staggered correction field."""
    return StaggeredGrid.from_collocated(net_out * norm.out_scales, domain)
