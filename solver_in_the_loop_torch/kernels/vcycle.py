"""The multigrid V-cycle as CUDA kernels (csrc/vcycle.cu): one launch per
level and direction.

`v_cycle(h, b)` is the top-level V-cycle of an ops/multigrid.py hierarchy,
the preconditioner apply M^-1 b, on a CUDA tensor: `mg_down` for each level
above the coarsest, `mg_coarse` for the coarsest, `mg_up` for each level from
the coarsest up, 2 (L - 1) + 1 launches for L levels. It replaces no TPU
kernel: the JAX package's V-cycle is XLA ops, and the port's plain twin is
ops/multigrid.py `_v_cycle`, which the kernels equal bit for bit on the card
and which the CPU runs. ops/multigrid.py `mg_pcg_solve` calls this wrapper on
CUDA (captured in its CUDA graph); the y-sharded V-cycle of
parallel/spatial.py keeps the plain ops.

`level_plan` is the launch plan, pure Python: the tiles of TILE_Y x TILE_X
cells that mirror csrc/vcycle.cu's, each level's grid, and where the
coarsest level's iterates live. `v_cycle.launches` counts the kernels
launched (a launch captured into a CUDA graph counts once, its replays not).
"""

from __future__ import annotations

import ctypes

import torch

from solver_in_the_loop_torch.kernels import build

# csrc/vcycle.cu's tile of level cells per block (even sides, so that every
# 2x2 parent lies in one tile), its smoothing sweeps each way (the halo it
# stages), and the most shared memory the coarsest level's two iterates
# may take
TILE_Y, TILE_X = 16, 32
SWEEPS = 2
COARSE_SMEM_MAX = 232448
# the grid's z extent: one batch element per z index
MAX_BATCH = 65535


def level_plan(shapes, batch: int) -> list:
    """The launches of one V-cycle over levels of (ny, nx) `shapes`, top
    first: per level above the coarsest its tiles' grid (ceil(nx / TILE_X),
    ceil(ny / TILE_Y), batch), shared by `mg_down` and `mg_up`; for the
    coarsest one block per batch element, its threads and whether its
    iterates need scratch beyond shared memory."""
    plan = []
    for i, (ny, nx) in enumerate(shapes):
        if i + 1 < len(shapes):
            if ny % 2 or nx % 2 or tuple(shapes[i + 1]) != (ny // 2, nx // 2):
                raise ValueError(f"v_cycle: level {i} of {ny}x{nx} is not halved to the next, "
                                 f"{tuple(shapes[i + 1])}")
            plan.append({"kind": "tiles", "shape": (ny, nx),
                         "grid": (-(-nx // TILE_X), -(-ny // TILE_Y), batch)})
        else:
            cells = ny * nx
            plan.append({"kind": "coarse", "shape": (ny, nx), "grid": (batch, 1, 1),
                         "threads": min(1024, -(-cells // 32) * 32),
                         "scratch": 2 * cells * 4 > COARSE_SMEM_MAX})
    return plan


def _check(h, b: torch.Tensor) -> None:
    if b.device.type != "cuda":
        raise ValueError(f"v_cycle: the kernels run on a CUDA device, got {b.device}")
    if b.dtype != torch.float32 or b.dim() != 3 or not b.is_contiguous():
        raise ValueError(f"v_cycle: b must be a contiguous float32 (B, H, W) tensor, got "
                         f"{b.dtype} {tuple(b.shape)}")
    if not 1 <= b.shape[0] <= MAX_BATCH:
        raise ValueError(f"v_cycle: batch {b.shape[0]} is outside 1..{MAX_BATCH}")
    if h.smooth_iters != SWEEPS:
        raise ValueError(f"v_cycle: the kernels sweep {SWEEPS} times each way, the hierarchy "
                         f"{h.smooth_iters}")
    if tuple(b.shape[1:]) != tuple(h.levels[0].masks.fluid.shape[1:]):
        raise ValueError(f"v_cycle: b {tuple(b.shape)} does not match the hierarchy's top "
                         f"level {tuple(h.levels[0].masks.fluid.shape[1:])}")
    for i, lv in enumerate(h.levels):
        ny, nx = lv.masks.fluid.shape[1:]
        want = {"fluid": (1, ny, nx), "face_u": (1, ny, nx + 1), "face_v": (1, ny + 1, nx),
                "diag": (1, ny, nx)}
        got = {"fluid": lv.masks.fluid, "face_u": lv.masks.face_u, "face_v": lv.masks.face_v,
               "diag": lv.diag}
        for name, t in got.items():
            if (t.dtype != torch.float32 or tuple(t.shape) != want[name]
                    or not t.is_contiguous() or t.device != b.device):
                raise ValueError(f"v_cycle: level {i}'s {name} must be a contiguous float32 "
                                 f"{want[name]} tensor on {b.device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")


def _level_ptrs(lv) -> list:
    return [t.data_ptr() for t in (lv.masks.fluid, lv.masks.face_u, lv.masks.face_v, lv.diag)]


def v_cycle(h, b: torch.Tensor) -> torch.Tensor:
    """One V-cycle of hierarchy h from zero on the CUDA tensor b (B, H, W) of
    its top level: M^-1 b, as ops/multigrid.py `_v_cycle(h, b, 0)` computes
    it. Raises on what the kernels do not take: another device or dtype, a
    non-contiguous or mismatched tensor, another number of sweeps."""
    _check(h, b)
    down = build.function("vcycle", "silt_mg_down", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                          + [ctypes.c_float, ctypes.c_void_p])
    up = build.function("vcycle", "silt_mg_up", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_void_p])
    coarse = build.function("vcycle", "silt_mg_coarse", [ctypes.c_void_p] * 7
                            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    levels = h.levels
    plan = level_plan([tuple(lv.masks.fluid.shape[1:]) for lv in levels], b.shape[0])
    omega = ctypes.c_float(h.omega)
    rhs, xs = [b], []
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, step in enumerate(plan[:-1]):
            (ny, nx), (gx, gy, bsz) = step["shape"], step["grid"]
            x = torch.empty_like(rhs[-1])
            bc = torch.empty((bsz, ny // 2, nx // 2), dtype=b.dtype, device=b.device)
            build.check(down(rhs[-1].data_ptr(), *_level_ptrs(levels[i]),
                             levels[i + 1].masks.fluid.data_ptr(), x.data_ptr(), bc.data_ptr(),
                             bsz, ny, nx, gx, gy, omega, stream), "v_cycle mg_down")
            xs.append(x)
            rhs.append(bc)
        last = plan[-1]
        (ny, nx), bsz = last["shape"], last["grid"][0]
        e = torch.empty_like(rhs[-1])
        scratch = (torch.empty((bsz, 2, ny, nx), dtype=b.dtype, device=b.device)
                   if last["scratch"] else None)
        build.check(coarse(rhs[-1].data_ptr(), *_level_ptrs(levels[-1]), e.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), bsz, ny, nx,
                           last["threads"], omega, stream), "v_cycle mg_coarse")
        for i in reversed(range(len(plan) - 1)):
            (ny, nx), (gx, gy, bsz) = plan[i]["shape"], plan[i]["grid"]
            out = torch.empty_like(xs[i])
            build.check(up(xs[i].data_ptr(), e.data_ptr(), rhs[i].data_ptr(),
                           *_level_ptrs(levels[i]), out.data_ptr(), bsz, ny, nx, gx, gy, omega,
                           stream), "v_cycle mg_up")
            e = out
    v_cycle.launches += len(plan) * 2 - 1
    return e


v_cycle.launches = 0
