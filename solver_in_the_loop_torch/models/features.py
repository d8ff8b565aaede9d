"""Feature construction and the normalization contract of the correction nets.

Port of solver_in_the_loop_tpu/models/features.py:

* features = collocated lower-face velocity samples [v, u] + a constant Re
  channel (karman) or the force's samples [fv, fu] (burgers, unless the
  force channels are dropped), less the channel means where they are given
  (the PRE nets' `--nozerocen`), divided channel-wise by the dataset's
  statistics;
* the model's 2-channel output is multiplied by [std_v, std_u] (plus the
  output means where given) and zero-padded back onto the staggered grid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from solver_in_the_loop_torch.core.grids import Domain, StaggeredGrid


@dataclasses.dataclass
class Normalization:
    """Channel scales: in_scales (C_in,) divide the features, out_scales (2,)
    multiply the model output [dv, du]. in_means and out_means, where given,
    are the channel means a PRE net trained with `--nozerocen` subtracts
    from its features and adds to its output; None is the zero-centred
    standardisation."""

    in_scales: torch.Tensor
    out_scales: torch.Tensor
    in_means: Optional[torch.Tensor] = None
    out_means: Optional[torch.Tensor] = None

    @classmethod
    def pre(cls, stats: dict, device=None) -> "Normalization":
        """The contract of a PRE net's stats.json (karman and Burgers): its
        in.std and out.std, and its means under nozerocen."""
        def t(values):
            return torch.tensor(values, dtype=torch.float32, device=device)

        means = bool(stats.get("nozerocen"))
        return cls(t(stats["in.std"]), t(stats["out.std"][:2]),
                   t(stats["in.mean"]) if means else None,
                   t(stats["out.mean"][:2]) if means else None)

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
    feat = torch.cat([vu, re_chan], dim=-1)
    if norm.in_means is not None:
        feat = feat - norm.in_means
    return feat / norm.in_scales


def burgers_features(velocity: StaggeredGrid, force: Optional[StaggeredGrid],
                     norm: Normalization) -> torch.Tensor:
    """(B, Y, X, 4): [v, u, fv, fu] / in_scales ((B, Y, X, 2) without force)."""
    vu = velocity.to_collocated()
    if force is not None:
        vu = torch.cat([vu, force.to_collocated()], dim=-1)
    if norm.in_means is not None:
        vu = vu - norm.in_means
    return vu / norm.in_scales


def correction_to_staggered(net_out: torch.Tensor, norm: Normalization,
                            domain: Domain) -> StaggeredGrid:
    """Model output (B, Y, X, 2) -> scaled staggered correction field."""
    out = net_out * norm.out_scales
    if norm.out_means is not None:
        out = out + norm.out_means
    return StaggeredGrid.from_collocated(out, domain)
