"""Correction networks, fully convolutional, channel-last at the boundary.

Port of solver_in_the_loop_tpu/models/networks.py:

* Mercury  — conv5x5(32) ReLU -> conv5x5(64) ReLU -> conv5x5(2)
* MarsMoon — conv5x5(F)+LeakyReLU stem, `blocks` residual blocks
  [conv5x5(F) LeakyReLU conv5x5(F) + skip, LeakyReLU], conv5x5(2) head
* JupiterMoon — the Burgers PRE net: conv5x5(32)+ReLU stem, six blocks
  [conv5x5(F) ReLU conv3x3(F) + skip, LeakyReLU] at F = 32, 32, 64, 64, 32,
  32, the skip a 1x1 projection where F changes, conv5x5(2) head

Inputs are normalized collocated features (B, Y, X, C) and outputs
(B, Y, X, 2) = [dv, du], as in the JAX package. Each model runs its
convolutions one of two ways, chosen when it is built (`conv=`), the port's
form of the JAX package's `SILT_PALLAS_CONV` gate (networks.py `Conv`):

* "library" (the default, as the JAX package's dispatch stands without a
  `conv_ok` marker): `nn.Conv2d` (cuDNN on the card, TF32 off) in NCHW with
  `padding=2` (SAME for 5x5), the activations and skips as separate ops;
* "kernel": every conv stays NHWC and goes through `silt::conv`
  (kernels/conv.py, csrc/conv.cu on the card) with its bias, skip and
  activation fused, as `Conv.__call__` sends it to `conv_fused`.

The parameters are the same `nn.Conv2d` ones either way, so a checkpoint
loads unchanged under both. Every convolution, `aten.convolution` or
`silt::conv`, is a site a remat policy can tape (utils/remat.py); the
replayed `aten.convolution` takes its gradients from
`aten.convolution_backward`, as its autograd formula does.

`compute_dtype` (the trainers' --bf16; the JAX package's MarsMoon and
Mercury `compute_dtype`, networks.py:127-188) casts the input to bfloat16
and each conv's float32 kernel and bias to bfloat16 where the conv reads
them, and the output back to float32; the parameters and their gradients
stay float32. Under "library" each conv then rounds where flax's bf16
`nn.Conv` does: the conv's output in bf16, + bias, + skip and the
activation each in bf16 (LeakyReLU's slope taken as bf16(slope)); under
"kernel" `silt::conv` runs the bf16 kernels with the JAX Pallas conv's
fp32 epilogue. The weights come from a JAX checkpoint
(train/checkpoint.py) or from `init_weights`, the JAX package's init modes
(solver_in_the_loop_tpu/models/networks.py:112-124) drawn from an explicit
generator:

* "reference" — glorot_uniform on every conv kernel, the head included;
* "zero"      — flax's default lecun_normal (truncated normal) on the hidden
  kernels and a zero head kernel.

Biases start at zero in both, as flax's do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from solver_in_the_loop_torch.kernels import conv as _conv  # noqa: F401 (registers silt::conv)
from solver_in_the_loop_torch.utils import remat

_CONVOLUTION = torch.ops.aten.convolution.default
_SILT_CONV = torch.ops.silt.conv.default


def disable_tf32() -> None:
    """The JAX apply builds its nets in float32; TF32 convolutions (cuDNN's
    default) or matmuls would move the rollout off that reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _conv5(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel_size=5, padding=2)


def _convk(cin: int, cout: int, k: int) -> nn.Conv2d:
    """A KxK SAME conv (K odd)."""
    return nn.Conv2d(cin, cout, kernel_size=k, padding=k // 2)


CONV_IMPLS = ("library", "kernel")
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
            padding) -> torch.Tensor:
    """`F.conv2d(x, weight, bias, padding=padding)` as the `aten.convolution`
    it dispatches to, at a remat site."""
    return remat.site(_CONVOLUTION, x, weight, bias, (1, 1), padding, (1, 1), False, (0, 0), 1)


def _convolution_setup(ctx, inputs, output):
    x, weight, bias, stride, padding, dilation, transposed, output_padding, groups = inputs
    ctx.save_for_backward(x, weight)
    ctx.bias_sizes = None if bias is None else bias.shape
    ctx.geometry = (stride, padding, dilation, transposed, output_padding, groups)


def _convolution_backward(ctx, g):
    """The autograd formula of `aten.convolution`: `aten.convolution_backward`
    for the inputs that need a gradient."""
    x, weight = ctx.saved_tensors
    needs = ctx.needs_input_grad
    mask = [needs[0], needs[1], ctx.bias_sizes is not None and needs[2]]
    grads = torch.ops.aten.convolution_backward(g, x, weight, ctx.bias_sizes, *ctx.geometry,
                                                mask)
    return (*grads, None, None, None, None, None, None)


remat.register(_CONVOLUTION, _convolution_setup, _convolution_backward)


def _apply(conv: nn.Conv2d, x: torch.Tensor, nhwc: bool, act: str = "none",
           slope: float = 0.0, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(conv(x) + skip) in x's dtype: NHWC through the fused op when
    `nhwc` (the "kernel" implementation), else NCHW through the module and
    separate ops (in bf16 as flax's nn.Conv and activations round)."""
    dtype = x.dtype
    if nhwc:
        return remat.site(_SILT_CONV, x, conv.weight.to(dtype), conv.bias.to(dtype), skip, act,
                          slope)
    if dtype == torch.float32:
        y = _conv2d(x, conv.weight, conv.bias, conv.padding)
    else:
        y = _conv2d(x, conv.weight.to(dtype), None, conv.padding)
        y = y + conv.bias.to(dtype)[:, None, None]
    if skip is not None:
        y = y + skip
    if act == "relu":
        return F.relu(y)
    if act == "leaky_relu":
        if dtype == torch.float32:
            return F.leaky_relu(y, slope)
        # jnp.where(y >= 0, y, slope * y) with the slope cast to y's dtype
        return torch.where(y >= 0, y, float(torch.tensor(slope, dtype=dtype)) * y)
    return y


class _Net(nn.Module):
    """Runs `body` NHWC under the "kernel" conv implementation, NCHW under
    "library", with the features and the output NHWC either way, in
    `compute_dtype`; the output is float32."""

    conv_impl = "library"
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if self.conv_impl == "kernel":
            y = self.body(x.contiguous(), True)
        else:
            y = self.body(x.permute(0, 3, 1, 2), False).permute(0, 2, 3, 1)
        return y.to(torch.float32)


class Mercury(_Net):
    def __init__(self, in_channels: int = 3, out_channels: int = 2):
        super().__init__()
        self.conv1 = _conv5(in_channels, 32)
        self.conv2 = _conv5(32, 64)
        self.head = _conv5(64, out_channels)

    def body(self, x: torch.Tensor, nhwc: bool) -> torch.Tensor:
        x = _apply(self.conv1, x, nhwc, "relu")
        x = _apply(self.conv2, x, nhwc, "relu")
        return _apply(self.head, x, nhwc)


class ResBlock(nn.Module):
    """conv5x5 -> LeakyReLU -> conv5x5 -> skip-add -> LeakyReLU."""

    def __init__(self, features: int, leaky_slope: float):
        super().__init__()
        self.conv1 = _conv5(features, features)
        self.conv2 = _conv5(features, features)
        self.leaky_slope = leaky_slope

    def forward(self, x: torch.Tensor, nhwc: bool) -> torch.Tensor:
        y = _apply(self.conv1, x, nhwc, "leaky_relu", self.leaky_slope)
        return _apply(self.conv2, y, nhwc, "leaky_relu", self.leaky_slope, skip=x)


class MarsMoon(_Net):
    """Default SOL/NON correction net (--arch mars_moon)."""

    def __init__(self, in_channels: int = 3, features: int = 32, blocks: int = 5,
                 out_channels: int = 2, leaky_slope: float = 0.3):
        super().__init__()
        self.stem = _conv5(in_channels, features)
        self.blocks = nn.ModuleList(ResBlock(features, leaky_slope) for _ in range(blocks))
        self.head = _conv5(features, out_channels)
        self.leaky_slope = leaky_slope

    def body(self, x: torch.Tensor, nhwc: bool) -> torch.Tensor:
        x = _apply(self.stem, x, nhwc, "leaky_relu", self.leaky_slope)
        for block in self.blocks:
            x = block(x, nhwc)
        return _apply(self.head, x, nhwc)


class JupiterBlock(nn.Module):
    """conv5x5 with ReLU -> conv3x3 -> skip-add (a 1x1 projection where the
    width changes) -> LeakyReLU. The 1x1 projection is a plain matrix product
    over the channels, as in the JAX package (no kernel there either)."""

    def __init__(self, cin: int, features: int, leaky_slope: float):
        super().__init__()
        self.conv1 = _conv5(cin, features)
        self.conv2 = _convk(features, features, 3)
        self.proj = _convk(cin, features, 1) if cin != features else None
        self.leaky_slope = leaky_slope

    def forward(self, x: torch.Tensor, nhwc: bool) -> torch.Tensor:
        y = _apply(self.conv1, x, nhwc, "relu")
        skip = x if self.proj is None else _project(self.proj, x, nhwc)
        return _apply(self.conv2, y, nhwc, "leaky_relu", self.leaky_slope, skip=skip)


def _project(conv: nn.Conv2d, x: torch.Tensor, nhwc: bool) -> torch.Tensor:
    """A 1x1 conv with bias as one matrix product over the channels."""
    w = conv.weight.to(x.dtype)[:, :, 0, 0]
    if nhwc:
        return torch.matmul(x, w.t()) + conv.bias.to(x.dtype)
    return _conv2d(x, w[:, :, None, None], conv.bias.to(x.dtype), (0, 0))


class JupiterMoon(_Net):
    """The Burgers PRE net (--arch / --model jupiter_moon)."""

    STAGES = (32, 32, 64, 64, 32, 32)

    def __init__(self, in_channels: int = 4, out_channels: int = 2, leaky_slope: float = 0.3):
        super().__init__()
        self.stem = _conv5(in_channels, 32)
        widths = (32,) + self.STAGES
        self.blocks = nn.ModuleList(JupiterBlock(cin, f, leaky_slope)
                                    for cin, f in zip(widths, self.STAGES))
        self.head = _conv5(self.STAGES[-1], out_channels)
        self.leaky_slope = leaky_slope

    def body(self, x: torch.Tensor, nhwc: bool) -> torch.Tensor:
        x = _apply(self.stem, x, nhwc, "relu")
        for block in self.blocks:
            x = block(x, nhwc)
        return _apply(self.head, x, nhwc)


MODELS = {"mercury": Mercury, "mars_moon": MarsMoon, "jupiter_moon": JupiterMoon}
INIT_MODES = ("reference", "zero")

# jax.nn.initializers.variance_scaling's truncated normal: the stddev of a
# standard normal cut at +-2, by which the target stddev is divided
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(model: nn.Module, mode: str, generator: torch.Generator) -> nn.Module:
    """Draw every conv's kernel from `generator` in construction order and
    zero every bias. fan_in and fan_out are K*K*C_in and K*K*C_out, as flax
    counts them for HWIO kernels."""
    if mode not in INIT_MODES:
        raise KeyError(f"unknown init mode '{mode}' (use 'zero' or 'reference')")
    for name, conv in model.named_modules():
        if not isinstance(conv, nn.Conv2d):
            continue
        w = conv.weight
        receptive = w.shape[2] * w.shape[3]
        fan_in, fan_out = receptive * w.shape[1], receptive * w.shape[0]
        if mode == "reference":
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            w.copy_(torch.rand(w.shape, generator=generator) * (2.0 * limit) - limit)
        elif name == "head":
            w.zero_()
        else:
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), 0.0, std, -2.0 * std,
                                          2.0 * std, generator=generator))
        conv.bias.zero_()
    return model


def build_model(name: str, in_channels: int = 3, leaky_slope: float = 0.3,
                init: Optional[str] = None,
                generator: Optional[torch.Generator] = None,
                conv: str = "library", compute_dtype: torch.dtype = torch.float32) -> nn.Module:
    """Registry lookup; also turns TF32 off (see disable_tf32). With `init`,
    the weights are drawn by `init_weights` from `generator` (a fresh one
    seeded 0 if none is given); without, they are left for a checkpoint.
    `conv` picks the convolution implementation (CONV_IMPLS), `compute_dtype`
    the convolutions' dtype (COMPUTE_DTYPES; the parameters stay float32)."""
    if name not in MODELS:
        raise KeyError(f"unknown model '{name}'; available: {sorted(MODELS)}")
    if conv not in CONV_IMPLS:
        raise KeyError(f"unknown conv implementation '{conv}'; use one of {CONV_IMPLS}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise KeyError(f"unsupported compute dtype {compute_dtype}; use one of {COMPUTE_DTYPES}")
    disable_tf32()
    if name == "mercury":
        model = Mercury(in_channels)
    else:
        model = MODELS[name](in_channels, leaky_slope=leaky_slope)
    model.conv_impl = conv
    model.compute_dtype = compute_dtype
    if init is not None:
        init_weights(model, init, generator or torch.Generator().manual_seed(0))
    return model
