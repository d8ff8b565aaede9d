"""Tap-sum forward of the shift advection: CUDA kernel and its plain twin.

`tap_sum_fwd` replaces the TPU kernel
solver_in_the_loop_tpu/ops/pallas/advect_kernel.py `_fwd_kernel`. On a CUDA
tensor it launches csrc/advect.cu; on a CPU tensor it runs
`tap_sum_fwd_plain`, the tap loop of solver_in_the_loop_tpu/ops/interp.py
(`shifted_stencil_sample`), which the kernel equals bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from solver_in_the_loop_torch.kernels import build


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
        iy = (rows + sy) % h if periodic else torch.clamp(rows + sy, 0, h - 1)
        vrow = values[:, iy, :]
        for sx in range(-max_shift, max_shift + 2):
            wx = torch.clamp_min(1.0 - torch.abs(dx - sx), 0.0)
            ix = (cols + sx) % w if periodic else torch.clamp(cols + sx, 0, w - 1)
            result = result + vrow[:, :, ix] * (wy * wx)
    return result


def _check(values, dy, dx, max_shift):
    for name, t in (("values", values), ("dy", dy), ("dx", dx)):
        if t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"tap_sum_fwd: {name} must be a contiguous float32 "
                             f"(B, H, W) tensor, got {t.dtype} {tuple(t.shape)}")
        if t.shape != values.shape or t.device != values.device:
            raise ValueError(f"tap_sum_fwd: {name} {tuple(t.shape)} on {t.device} does not "
                             f"match values {tuple(values.shape)} on {values.device}")
    if max_shift < 0:
        raise ValueError(f"tap_sum_fwd: max_shift must be >= 0, got {max_shift}")


def tap_sum_fwd(values: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                max_shift: int, periodic: bool) -> torch.Tensor:
    """Fused (2m+2)^2-tap weighted shift sum on pre-clamped offsets.

    CPU tensors take the plain twin; CUDA tensors launch the kernel; anything
    else raises."""
    if values.device.type == "cpu":
        return tap_sum_fwd_plain(values, dy, dx, max_shift, periodic)
    if values.device.type != "cuda":
        raise ValueError(f"tap_sum_fwd: unsupported device {values.device}")
    _check(values, dy, dx, max_shift)
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
