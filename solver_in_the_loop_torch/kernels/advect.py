"""Tap-sum of the shift advection, forward and backward: CUDA kernels and
their plain twins, and the differentiable op that the solver calls.

`tap_sum_fwd` replaces the TPU kernel
solver_in_the_loop_tpu/ops/pallas/advect_kernel.py `_fwd_kernel`, and
`tap_sum_bwd` replaces `_bwd_kernel` of the same file. On a CUDA tensor each
launches its kernel in csrc/advect.cu; on a CPU tensor each runs its plain
twin (`tap_sum_fwd_plain`, `tap_sum_bwd_plain`), which the kernel equals bit
for bit.

`tap_sum` is the op the solver calls (`torch.ops.silt.tap_sum`): forward
through `tap_sum_fwd`, backward through `tap_sum_bwd`. It is a registered
custom op so that a selective-checkpoint policy can name it
(train/trainer.py), and it reaches each kernel only through the module-level
wrapper, so replacing a wrapper here replaces the kernel everywhere.
"""

from __future__ import annotations

import ctypes

import torch

from solver_in_the_loop_torch.kernels import build


def _edge_index(idx: torch.Tensor, n: int, periodic: bool) -> torch.Tensor:
    return idx % n if periodic else torch.clamp(idx, 0, n - 1)


def tap_sum_fwd_plain(values: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                      max_shift: int, periodic: bool) -> torch.Tensor:
    """sum_{sy,sx in [-m, m+1]} max(0,1-|dy-sy|) * max(0,1-|dx-sx|) * V[j+sy, i+sx],
    with V's indices clamped to the edge (OPEN) or wrapped (PERIODIC)."""
    _, h, w = values.shape
    rows = torch.arange(h, device=values.device)
    cols = torch.arange(w, device=values.device)
    result = torch.zeros_like(values)
    for sy in range(-max_shift, max_shift + 2):
        wy = torch.clamp_min(1.0 - torch.abs(dy - sy), 0.0)
        vrow = values[:, _edge_index(rows + sy, h, periodic), :]
        for sx in range(-max_shift, max_shift + 2):
            wx = torch.clamp_min(1.0 - torch.abs(dx - sx), 0.0)
            result = result + vrow[:, :, _edge_index(cols + sx, w, periodic)] * (wy * wx)
    return result


def _hat_slope(t: torch.Tensor) -> torch.Tensor:
    """d/dt max(0, 1 - |t|) as JAX differentiates it: abs'(0) = +1, and at
    |t| == 1 the max ties and takes half of each branch."""
    sign = torch.where(t >= 0.0, 1.0, -1.0)
    a = torch.abs(t)
    return -sign * torch.where(a < 1.0, 1.0, torch.where(a == 1.0, 0.5, 0.0))


def tap_sum_bwd_plain(values: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                      g: torch.Tensor, max_shift: int, periodic: bool):
    """Cotangents (dV, ddy, ddx) of `tap_sum_fwd` for the output cotangent g.

    ddy = sum_taps g * V[j+sy, i+sx] * wy' * wx and ddx likewise with wx',
    with V read at the forward's clamped or wrapped indices (so OPEN tie taps,
    of weight 0 but slope -+0.5, read the edge value as JAX's replicate
    shifts do). dV scatters g * wy * wx of every destination back to the
    cell it read: per tap over rows, then over columns, in index order.
    Written out because PyTorch's autograd takes abs'(0) = 0 and gives the
    whole branch at a max tie, where JAX takes +1 and one half."""
    _, h, w = values.shape
    rows = torch.arange(h, device=values.device)
    cols = torch.arange(w, device=values.device)
    dv = torch.zeros_like(values)
    ddy = torch.zeros_like(values)
    ddx = torch.zeros_like(values)
    for sy in range(-max_shift, max_shift + 2):
        wy = torch.clamp_min(1.0 - torch.abs(dy - sy), 0.0)
        dwy = _hat_slope(dy - sy)
        iy = _edge_index(rows + sy, h, periodic)
        vrow = values[:, iy, :]
        for sx in range(-max_shift, max_shift + 2):
            wx = torch.clamp_min(1.0 - torch.abs(dx - sx), 0.0)
            dwx = _hat_slope(dx - sx)
            ix = _edge_index(cols + sx, w, periodic)
            gv = g * vrow[:, :, ix]
            ddy = ddy + gv * (dwy * wx)
            ddx = ddx + gv * (wy * dwx)
            contrib = g * (wy * wx)
            by_row = torch.zeros_like(values).index_add_(1, iy, contrib)
            dv = dv + torch.zeros_like(values).index_add_(2, ix, by_row)
    return dv, ddy, ddx


def _check(what: str, tensors: dict, max_shift: int) -> None:
    ref = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"(B, H, W) tensor, got {t.dtype} {tuple(t.shape)}")
        if t.shape != ref.shape or t.device != ref.device:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} on {t.device} does not "
                             f"match values {tuple(ref.shape)} on {ref.device}")
    if max_shift < 0:
        raise ValueError(f"{what}: max_shift must be >= 0, got {max_shift}")


def tap_sum_fwd(values: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                max_shift: int, periodic: bool) -> torch.Tensor:
    """Fused (2m+2)^2-tap weighted shift sum on pre-clamped offsets.

    CPU tensors take the plain twin; CUDA tensors launch the kernel; anything
    else raises."""
    if values.device.type == "cpu":
        return tap_sum_fwd_plain(values, dy, dx, max_shift, periodic)
    if values.device.type != "cuda":
        raise ValueError(f"tap_sum_fwd: unsupported device {values.device}")
    _check("tap_sum_fwd", {"values": values, "dy": dy, "dx": dx}, max_shift)
    fn = build.function("advect", "silt_tap_sum_fwd",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    b, h, w = values.shape
    out = torch.empty_like(values)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(values.data_ptr(), dy.data_ptr(), dx.data_ptr(), out.data_ptr(),
                 b, h, w, max_shift, int(periodic), stream)
    build.check(err, "tap_sum_fwd")
    tap_sum_fwd.launches += 1
    return out


tap_sum_fwd.launches = 0


def tap_sum_bwd(values: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, g: torch.Tensor,
                max_shift: int, periodic: bool):
    """(dV, ddy, ddx) of the tap-sum for the output cotangent g, in one pass.

    CPU tensors take the plain twin; CUDA tensors launch the kernel; anything
    else raises."""
    if values.device.type == "cpu":
        return tap_sum_bwd_plain(values, dy, dx, g, max_shift, periodic)
    if values.device.type != "cuda":
        raise ValueError(f"tap_sum_bwd: unsupported device {values.device}")
    _check("tap_sum_bwd", {"values": values, "dy": dy, "dx": dx, "g": g}, max_shift)
    fn = build.function("advect", "silt_tap_sum_bwd",
                        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    b, h, w = values.shape
    dv, ddy, ddx = (torch.empty_like(values) for _ in range(3))
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (values, dy, dx, g, dv, ddy, ddx)),
                 b, h, w, max_shift, int(periodic), stream)
    build.check(err, "tap_sum_bwd")
    tap_sum_bwd.launches += 1
    return dv, ddy, ddx


tap_sum_bwd.launches = 0


@torch.library.custom_op(
    "silt::tap_sum", mutates_args=(),
    schema="(Tensor values, Tensor dy, Tensor dx, int max_shift, bool periodic) -> Tensor")
def tap_sum(values, dy, dx, max_shift, periodic):
    """Differentiable tap-sum: `tap_sum_fwd` forward, `tap_sum_bwd` backward."""
    return tap_sum_fwd(values, dy, dx, max_shift, periodic)


def _tap_sum_setup(ctx, inputs, output):
    values, dy, dx, max_shift, periodic = inputs
    ctx.save_for_backward(values, dy, dx)
    ctx.max_shift, ctx.periodic = max_shift, periodic


def _tap_sum_backward(ctx, g):
    values, dy, dx = ctx.saved_tensors
    dv, ddy, ddx = tap_sum_bwd(values, dy, dx, g.contiguous(), ctx.max_shift, ctx.periodic)
    return dv, ddy, ddx, None, None


tap_sum.register_autograd(_tap_sum_backward, setup_context=_tap_sum_setup)
