"""Correction networks, fully convolutional, channel-last at the boundary.

Port of solver_in_the_loop_tpu/models/networks.py (the `--arch` choices of
karman-apply):

* Mercury  — conv5x5(32) ReLU -> conv5x5(64) ReLU -> conv5x5(2)
* MarsMoon — conv5x5(F)+LeakyReLU stem, `blocks` residual blocks
  [conv5x5(F) LeakyReLU conv5x5(F) + skip, LeakyReLU], conv5x5(2) head

Inputs are normalized collocated features (B, Y, X, C) and outputs
(B, Y, X, 2) = [dv, du], as in the JAX package; inside, the convolutions run
NCHW with `padding=2` (SAME for 5x5). The weights come from a JAX checkpoint
(train/checkpoint.py); the modules' own initialization is PyTorch's default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def disable_tf32() -> None:
    """The JAX apply builds its nets in float32; TF32 convolutions (cuDNN's
    default) or matmuls would move the rollout off that reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _conv5(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel_size=5, padding=2)


class Mercury(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 2):
        super().__init__()
        self.conv1 = _conv5(in_channels, 32)
        self.conv2 = _conv5(32, 64)
        self.head = _conv5(64, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        return self.head(x).permute(0, 2, 3, 1)


class ResBlock(nn.Module):
    """conv5x5 -> LeakyReLU -> conv5x5 -> skip-add -> LeakyReLU."""

    def __init__(self, features: int, leaky_slope: float):
        super().__init__()
        self.conv1 = _conv5(features, features)
        self.conv2 = _conv5(features, features)
        self.leaky_slope = leaky_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.conv1(x), self.leaky_slope)
        return F.leaky_relu(self.conv2(y) + x, self.leaky_slope)


class MarsMoon(nn.Module):
    """Default SOL/NON correction net (--arch mars_moon)."""

    def __init__(self, in_channels: int = 3, features: int = 32, blocks: int = 5,
                 out_channels: int = 2, leaky_slope: float = 0.3):
        super().__init__()
        self.stem = _conv5(in_channels, features)
        self.blocks = nn.ModuleList(ResBlock(features, leaky_slope) for _ in range(blocks))
        self.head = _conv5(features, out_channels)
        self.leaky_slope = leaky_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.stem(x.permute(0, 3, 1, 2)), self.leaky_slope)
        for block in self.blocks:
            x = block(x)
        return self.head(x).permute(0, 2, 3, 1)


MODELS = {"mercury": Mercury, "mars_moon": MarsMoon}


def build_model(name: str, in_channels: int = 3, leaky_slope: float = 0.3) -> nn.Module:
    """Registry lookup; also turns TF32 off (see disable_tf32)."""
    if name not in MODELS:
        raise KeyError(f"unknown model '{name}'; available: {sorted(MODELS)}")
    disable_tf32()
    if name == "mercury":
        return Mercury(in_channels)
    return MarsMoon(in_channels, leaky_slope=leaky_slope)
