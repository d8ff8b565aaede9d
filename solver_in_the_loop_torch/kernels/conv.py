"""Fused KxK SAME stride-1 convolution (NHWC, float32 or bfloat16): CUDA
kernels, their plain twins, and the differentiable op that the correction
nets call.

`conv_fwd` replaces the TPU kernels
solver_in_the_loop_tpu/ops/pallas/conv_kernel.py `_fwd_kernel` and
`_fwd_kernel_taps` (through `_conv_rows`), and `conv_wgrad` replaces
`_wgrad_kernel` and `_wgrad_kernel_taps` (through `_conv_wgrad`). On a CUDA
tensor each launches its kernel in csrc/conv.cu; on a CPU tensor each runs
its plain twin (`conv_fwd_plain`, `conv_wgrad_plain`): the same per-tap sum
and the same epilogue, written out in PyTorch.

Weights are (K, K, Cin, Cout) tensors, the JAX package's HWIO layout, and
may be any strided view: the kernels read and write through the strides, so
the nets hand over `weight.permute(2, 3, 1, 0)` of their PyTorch
(Cout, Cin, K, K) parameter without a copy.

Both kernels multiply on the tensor cores in 3xTF32 (each operand split into
a TF32 part and a TF32 remainder, three products summed in fp32), which
keeps fp32's accuracy where one TF32 product would not. `conv_fwd` is an
implicit GEMM over tiles of 2x16 pixels and 16 output channels (64 blocks
for a 32->32 conv at 32x32 and batch 1), the whole input patch staged at
once and the weight one tap row at a time, double-buffered. `conv_wgrad`
splits the B*H*W rows over a cluster of up to 8 blocks, each owning one tap
row, 16 input and 16 output channels, and adds the blocks' partial sums in
rank order through distributed shared memory: one launch, no atomics, the
same bits on every launch. Each wrapper call is one CUDA launch. What bounds
them is in csrc/conv.cu.

On bfloat16 tensors (the nets under --bf16, as the JAX package casts x, the
kernel, the bias and the skip to bf16 before `conv_fused`) `conv_fwd` hands
over to `conv_fwd_bf16` and `conv_wgrad` to `conv_wgrad_bf16`, the kernels of
csrc/conv_bf16.cu: bf16 products summed in fp32 on the tensor cores
(`mma.sync` m16n8k16), the forward's epilogue in fp32 and one rounding to
bf16 at the store; the weight gradient in fp32. Their twins are the same
plain functions, which compute in fp32 from the bf16 values and round the
forward's output once.

`conv` (`torch.ops.silt.conv`) is the op the nets call: the convolution with
its epilogue fused (+bias, optional +skip, ReLU or LeakyReLU), as the JAX
package's `conv_fused`. Its backward takes the activation's derivative from
the saved output with JAX's conventions (`_act_grad`), then computes dX with
`conv_fwd` on the flipped, channel-transposed kernel (skipped where the input
needs no gradient), dW with `conv_wgrad`, and db and d(skip) in plain
PyTorch. In bf16 it rounds where the JAX VJP rounds (conv_kernel.py
`_fused`): the LeakyReLU slope of the backward is bf16(slope) (0.30078125
for 0.3) times a bf16 gradient, dX is bf16, dW is summed in fp32 and then
rounded to bf16, db is the fp32 sum of dz rounded to bf16. It is a
registered custom op whose call sites (models/networks.py) a remat policy
can tape, its formula registered with utils/remat.py, and it reaches each
kernel only through the module-level wrapper, so replacing a wrapper here
replaces the kernel everywhere.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from solver_in_the_loop_torch.kernels import build
from solver_in_the_loop_torch.utils import remat

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}
MAX_K = 7  # odd K up to 7, as the JAX gate admits (conv_kernel.py conv_available)


def _activate(z: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(z, 0.0)
    if act == "leaky_relu":
        return torch.where(z >= 0, z, slope * z)
    return z


def act_grad(act: str, slope: float, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d(activation)/dz times g, from the post-activation output y: both
    activations keep the sign, so sign(y) is sign(z). JAX's conventions at
    z == 0: relu' = 0, leaky_relu' = 1 (conv_kernel.py `_act_grad`), and its
    slope is cast to g's dtype before the product, as `jnp.asarray(slope,
    dy.dtype)` does: 0.30078125 for 0.3 in bf16."""
    if act == "relu":
        return torch.where(y > 0, g, 0.0)
    if act == "leaky_relu":
        return torch.where(y >= 0, g, float(torch.tensor(slope, dtype=g.dtype)) * g)
    return g


def conv_fwd_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   skip: Optional[torch.Tensor] = None, act: str = "none", slope: float = 0.3,
                   flip: bool = False) -> torch.Tensor:
    """act(sum_taps shift(x) @ w[tap] + bias + skip): x (B, H, W, Cin), w
    (K, K, Cin, Cout), zeros outside the image; `flip` reads w[K-1-ky, K-1-kx].
    Computed in fp32 (bf16 operands taken exactly), returned in x's dtype."""
    if flip:
        w = w.flip((0, 1))
    _, h, wd, _ = x.shape
    k = w.shape[0]
    r = k // 2
    xp = F.pad(x.float(), (0, 0, r, r, r, r))
    w = w.float()
    acc = torch.zeros(x.shape[:3] + (w.shape[3],), dtype=torch.float32, device=x.device)
    for ky in range(k):
        for kx in range(k):
            acc = acc + xp[:, ky:ky + h, kx:kx + wd, :] @ w[ky, kx]
    if bias is not None:
        acc = acc + bias.float()
    if skip is not None:
        acc = acc + skip.float()
    return _activate(acc, act, slope).to(x.dtype)


def _weight_grad_buffer(k: int, cin: int, cout: int, device) -> torch.Tensor:
    """A (K, K, Cin, Cout) view of a contiguous float32 (Cout, Cin, K, K) tensor."""
    return torch.empty((cout, cin, k, k), dtype=torch.float32, device=device).permute(2, 3, 1, 0)


def conv_wgrad_plain(x: torch.Tensor, dz: torch.Tensor, k: int) -> torch.Tensor:
    """dW[ky, kx] = shift(x)^T @ dz summed over all B*H*W rows, per tap, in
    fp32 (bf16 operands taken exactly). Returned as conv_wgrad returns it."""
    _, h, wd, cin = x.shape
    cout = dz.shape[-1]
    r = k // 2
    xp = F.pad(x.float(), (0, 0, r, r, r, r))
    rows = dz.float().reshape(-1, cout)
    dw = _weight_grad_buffer(k, cin, cout, x.device)
    for ky in range(k):
        for kx in range(k):
            dw[ky, kx] = xp[:, ky:ky + h, kx:kx + wd, :].reshape(-1, cin).T @ rows
    return dw


def _check(what: str, x: torch.Tensor, w: torch.Tensor, others: dict, dtype: torch.dtype,
           w_dtype: torch.dtype) -> None:
    """x, w and the `others` {name: (tensor or None, shape)} as the kernel
    takes them: x contiguous (B, H, W, C) of `dtype`, w (K, K, C, Cout) of
    `w_dtype` with odd K <= MAX_K, the others contiguous of `dtype`, all on
    x's device."""
    if x.dtype != dtype or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous {dtype} (B, H, W, C) tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    k = w.shape[0]
    if (w.dtype != w_dtype or w.dim() != 4 or w.shape[1] != k or k % 2 == 0 or k > MAX_K
            or w.shape[2] != x.shape[3] or w.device != x.device):
        raise ValueError(f"{what}: w must be a {w_dtype} (K, K, {x.shape[3]}, Cout) tensor "
                         f"with odd K <= {MAX_K} on {x.device}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    for name, (t, shape) in others.items():
        if t is not None and (t.dtype != dtype or tuple(t.shape) != shape
                              or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} {shape} tensor "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def conv_fwd(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
             skip: Optional[torch.Tensor] = None, act: str = "none", slope: float = 0.3,
             flip: bool = False) -> torch.Tensor:
    """KxK SAME stride-1 conv with the fused epilogue: x (B, H, W, Cin) ->
    (B, H, W, Cout); w (K, K, Cin, Cout), any strides; bias (Cout,) or None
    (zero); skip (B, H, W, Cout) or None; all float32, or all bfloat16
    (`conv_fwd_bf16`).

    CPU tensors take the plain twin; CUDA tensors launch the kernel; anything
    else raises."""
    if act not in ACTS:
        raise ValueError(f"conv_fwd: unknown activation '{act}'")
    if x.device.type == "cpu":
        return conv_fwd_plain(x, w, bias, skip, act, slope, flip)
    if x.device.type != "cuda":
        raise ValueError(f"conv_fwd: unsupported device {x.device}")
    if x.dtype == torch.bfloat16:
        return conv_fwd_bf16(x, w, bias, skip, act, slope, flip)
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    _check("conv_fwd", x, w, {"bias": (bias, (cout,)), "skip": (skip, (b, h, wd, cout))},
           torch.float32, torch.float32)
    fn = build.function("conv", "silt_conv_fwd",
                        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4 + [ctypes.c_int]
                        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                        + [ctypes.c_float, ctypes.c_void_p])
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), *w.stride(), int(flip),
                 None if bias is None else bias.data_ptr(),
                 None if skip is None else skip.data_ptr(), y.data_ptr(),
                 b, h, wd, cin, cout, w.shape[0], ACTS[act], float(slope), stream)
    build.check(err, "conv_fwd")
    conv_fwd.launches += 1
    return y


conv_fwd.launches = 0


def conv_fwd_bf16(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  skip: Optional[torch.Tensor] = None, act: str = "none", slope: float = 0.3,
                  flip: bool = False) -> torch.Tensor:
    """conv_fwd on bfloat16 tensors (x, w, bias, skip): the products summed
    in fp32, the epilogue in fp32 with the fp32 slope, the output rounded to
    bfloat16 once.

    CPU tensors take the plain twin; CUDA tensors launch the kernel of
    csrc/conv_bf16.cu; anything else raises."""
    if act not in ACTS:
        raise ValueError(f"conv_fwd_bf16: unknown activation '{act}'")
    if x.device.type == "cpu":
        return conv_fwd_plain(x, w, bias, skip, act, slope, flip)
    if x.device.type != "cuda":
        raise ValueError(f"conv_fwd_bf16: unsupported device {x.device}")
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    _check("conv_fwd_bf16", x, w, {"bias": (bias, (cout,)), "skip": (skip, (b, h, wd, cout))},
           torch.bfloat16, torch.bfloat16)
    fn = build.function("conv_bf16", "silt_conv_fwd_bf16",
                        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4 + [ctypes.c_int]
                        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                        + [ctypes.c_float, ctypes.c_void_p])
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), *w.stride(), int(flip),
                 None if bias is None else bias.data_ptr(),
                 None if skip is None else skip.data_ptr(), y.data_ptr(),
                 b, h, wd, cin, cout, w.shape[0], ACTS[act], float(slope), stream)
    build.check(err, "conv_fwd_bf16")
    conv_fwd_bf16.launches += 1
    return y


conv_fwd_bf16.launches = 0


# The tiling constants of csrc/conv_bf16.cu's forward, by their names there
# (tests/test_torch_conv_fwd_bf16_tiles.py holds the two to each other).
FWD_BF16 = {"FWD_TH": 8, "FWD_TW": 16, "FWD_NT": 16, "FWD_CC": 32, "FWD_RS": 24}


def fwd_bf16_plan(b: int, h: int, w: int, cin: int, cout: int, k: int) -> dict:
    """The partition `conv_fwd_bf16` launches for x (b, h, w, cin) and a KxK
    kernel to cout outputs, as csrc/conv_bf16.cu `FwdPlan` and `launch_fwd`
    compute it. A block owns FWD_TH image rows x FWD_TW pixels and FWD_NT
    outputs. Where cin >= 16 it stages the input in chunks of `cc` channels,
    a patch of ph x pw pixels at `cs` elements each, and the weight of every
    tap; where cin < 16 (`packed`) ph x pw A rows, each `taps` taps of all
    cin channels, `groups` per tap row. Every tap row has `per_ky` k-steps in
    `nkx` columns (taps or tap groups); each warp takes two image rows and
    every other column over all tap rows, its partner the others. `patch`,
    `weight` and `raw` are the elements of its shared memory (`raw`: the
    weight's runs as they lie in memory). Also the grid (tiles, output
    tiles), the block's threads and its shared memory in bytes: the tiles,
    at least the room where the two halves exchange their sums, and 16 for
    the mbarrier."""
    c = FWD_BF16
    packed = cin < 16
    taps = 16 // max(cin, 1) if packed else 1
    groups = -(-k // taps)
    cc = 16 if packed else min(-(-cin // 16) * 16, c["FWD_CC"])
    cs = c["FWD_RS"] if packed else cc + 8
    ph = c["FWD_TH"] + k - 1
    pw = groups * c["FWD_TW"] if packed else c["FWD_TW"] + k - 1
    nkx = groups if packed else k
    per_ky = groups if packed else k * (cc // 16)
    patch = ph * pw * cs
    weight = k * nkx * c["FWD_NT"] * cs
    raw = 0 if packed else max(c["FWD_NT"] * -(-cc * k * k // 8) * 8,
                               cc * -(-c["FWD_NT"] * k * k // 8) * 8)
    tiles = -(-h // c["FWD_TH"]) * -(-w // c["FWD_TW"])
    return {"packed": packed, "taps": taps, "groups": groups, "cc": cc, "cs": cs, "ph": ph,
            "pw": pw, "nkx": nkx, "per_ky": per_ky, "patch": patch, "weight": weight,
            "raw": raw, "grid": [b * tiles, -(-cout // c["FWD_NT"])], "block": 32 * c["FWD_TH"],
            "smem_bytes": max(2 * (patch + weight + raw), 4 * c["FWD_TH"] * 8 * 32) + 16}


def conv_wgrad(x: torch.Tensor, dz: torch.Tensor, k: int) -> torch.Tensor:
    """dW (K, K, Cin, Cout) of the SAME conv for the output cotangent dz
    (B, H, W, Cout), float32, laid out as a contiguous (Cout, Cin, K, K)
    tensor (the PyTorch conv weight's layout) seen through a permuted view.
    x and dz float32, or both bfloat16 (`conv_wgrad_bf16`).

    CPU tensors take the plain twin; CUDA tensors launch the kernel; anything
    else raises."""
    if x.device.type == "cpu":
        return conv_wgrad_plain(x, dz, k)
    if x.device.type != "cuda":
        raise ValueError(f"conv_wgrad: unsupported device {x.device}")
    if x.dtype == torch.bfloat16:
        return conv_wgrad_bf16(x, dz, k)
    b, h, wd, cin = x.shape
    cout = dz.shape[-1]
    dw = _weight_grad_buffer(k, cin, cout, x.device)
    _check("conv_wgrad", x, dw, {"dz": (dz, (b, h, wd, cout))}, torch.float32, torch.float32)
    fn = build.function("conv", "silt_conv_wgrad",
                        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dz.data_ptr(), dw.data_ptr(), *dw.stride(), b, h, wd, cin, cout,
                 k, stream)
    build.check(err, "conv_wgrad")
    conv_wgrad.launches += 1
    return dw


conv_wgrad.launches = 0


# The tiling constants of csrc/conv_bf16.cu's weight gradient, by their names
# there (tests/test_torch_conv_wgrad_bf16_tiles.py holds the two to each other).
WGRAD_BF16 = {"WG_RS": 24, "WG_SEG": 64, "WG_PIXELS": 512, "WG_STAGES": 2, "WG_WARPS": 8,
              "WG_CLUSTER": 8}


def wgrad_bf16_plan(b: int, h: int, w: int, cin: int, cout: int, k: int) -> dict:
    """The partition `conv_wgrad_bf16` launches for x (b, h, w, cin), dz (b,
    h, w, cout) and a KxK kernel, as csrc/conv_bf16.cu `WgPlan` and
    `launch_wgrad` compute it. Units of `seg` pixels of one image row are
    split over a cluster of `ranks` blocks in contiguous shares, `per_stage`
    units per stage. A block owns one tap row ky, one tile of input channels
    and one of 16 outputs; where cin < 16 the 16 rows of an A tile are `taps`
    taps of `cin` channels (else one tap of a 16-channel tile), `groups` such
    tiles per tap row; `pw` staged input rows per unit, `raw` elements of
    room per unit for an image row as it lies in memory (cin < 16). Also the
    grid (ranks, K x channel tiles x output tiles), the block's threads and
    its shared memory in bytes: the ring of stages, or the warps' sums if
    more, then the cluster's receiving room, `share` sums per rank."""
    c = WGRAD_BF16
    seg = min(-(-w // 16) * 16, c["WG_SEG"]) if w > 0 else 16
    segs = -(-w // seg)
    units = b * h * segs
    per_stage = max(1, c["WG_PIXELS"] // seg)
    taps = 16 // cin if cin < 16 else 1
    groups = -(-k // taps)
    pw = seg + (groups - 1) * taps
    raw = seg * cin if taps > 1 else 0
    stage_elems = per_stage * ((pw + seg) * c["WG_RS"] + raw)
    ranks = max(1, min(c["WG_CLUSTER"], -(-units // per_stage)))
    total = groups * 256
    share = -(-(-(-total // ranks)) // 4) * 4
    smem = max(2 * c["WG_STAGES"] * stage_elems, 4 * c["WG_WARPS"] * total) + 4 * ranks * share
    return {"seg": seg, "segs": segs, "units": units, "per_stage": per_stage, "taps": taps,
            "groups": groups, "pw": pw, "raw": raw, "ranks": ranks, "share": share,
            "grid": [ranks, k * -(-cin // 16) * -(-cout // 16)], "cluster": ranks,
            "block": 32 * c["WG_WARPS"], "smem_bytes": smem}


def conv_wgrad_bf16(x: torch.Tensor, dz: torch.Tensor, k: int) -> torch.Tensor:
    """conv_wgrad of bfloat16 x and dz: the products summed and returned in
    float32, as conv_wgrad returns its result (the VJP rounds it to bf16).

    CPU tensors take the plain twin; CUDA tensors launch the kernel of
    csrc/conv_bf16.cu; anything else raises."""
    if x.device.type == "cpu":
        return conv_wgrad_plain(x, dz, k)
    if x.device.type != "cuda":
        raise ValueError(f"conv_wgrad_bf16: unsupported device {x.device}")
    b, h, wd, cin = x.shape
    cout = dz.shape[-1]
    dw = _weight_grad_buffer(k, cin, cout, x.device)
    _check("conv_wgrad_bf16", x, dw, {"dz": (dz, (b, h, wd, cout))}, torch.bfloat16,
           torch.float32)
    fn = build.function("conv_bf16", "silt_conv_wgrad_bf16",
                        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dz.data_ptr(), dw.data_ptr(), *dw.stride(), b, h, wd, cin, cout,
                 k, stream)
    build.check(err, "conv_wgrad_bf16")
    conv_wgrad_bf16.launches += 1
    return dw


conv_wgrad_bf16.launches = 0


@torch.library.custom_op(
    "silt::conv", mutates_args=(),
    schema="(Tensor x, Tensor weight, Tensor bias, Tensor? skip, str act, float slope) -> Tensor")
def conv(x, weight, bias, skip, act, slope):
    """act(conv(x, weight) + bias + skip): x (B, H, W, Cin) contiguous,
    weight the PyTorch (Cout, Cin, K, K) parameter, K odd; all float32, or
    all bfloat16."""
    return conv_fwd(x, weight.permute(2, 3, 1, 0), bias, skip, act, slope)


def _conv_setup(ctx, inputs, output):
    x, weight, _, skip, act, slope = inputs
    ctx.save_for_backward(x, weight, output)
    ctx.act, ctx.slope, ctx.with_skip = act, slope, skip is not None


def _conv_backward(ctx, g):
    x, weight, y = ctx.saved_tensors
    dz = act_grad(ctx.act, ctx.slope, y, g).contiguous()
    w = weight.permute(2, 3, 1, 0)
    dx = None
    if ctx.needs_input_grad[0]:
        # the flipped, channel-transposed kernel, zero bias, no activation
        dx = conv_fwd(dz, w.transpose(2, 3), flip=True)
    # dW summed in fp32 and then rounded to the weight's dtype; db the fp32
    # sum of dz, rounded likewise (no-ops in float32)
    dw = conv_wgrad(x, dz, w.shape[0]).permute(3, 2, 0, 1).to(weight.dtype)
    db = dz.sum((0, 1, 2), dtype=torch.float32).to(weight.dtype)
    return dx, dw, db, (dz if ctx.with_skip else None), None, None


conv.register_autograd(_conv_backward, setup_context=_conv_setup)
remat.register(torch.ops.silt.conv.default, _conv_setup, _conv_backward)
