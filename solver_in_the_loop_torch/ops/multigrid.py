"""Geometric multigrid preconditioner for the masked Poisson solve.

Port of solver_in_the_loop_tpu/ops/multigrid.py: the hi-res (256x128) karman
grids take hundreds of plain CG iterations per projection; CG preconditioned
with a V-cycle keeps the count nearly independent of the resolution. Damped
Jacobi smoothing on the masked operator at every level, 2x2 sum restriction
of residuals, repeat prolongation, a coarse cell fluid where any child is;
the V-cycle is symmetric (equal pre- and post-smoothing), so it is a valid
PCG preconditioner.

The V-cycle here is plain PyTorch ops (`_v_cycle`), as the JAX package runs
it as XLA ops (no Pallas kernel). The loop is kernels/cg.py `pcg_solve_info`
with the V-cycle as its preconditioner, and stops on a host read of the
residuals once per iteration; parallel/spatial.py runs the same V-cycle on
y-sharded rows.
`mg_solve` is the solver of the pressure projection's "multigrid" route
(ops/poisson.py `pressure_cg_solve`, forward and adjoint). Each
preconditioner apply is a `silt.pressure.vcycle` span, and a solve counts its
V-cycles as `multigrid.vcycles` (utils/profiling.py).

On a CUDA card `mg_pcg_solve` runs each V-cycle as the hand-written kernels
of kernels/vcycle.py (csrc/vcycle.cu: one launch per level and direction, 9
at 256x128, where the plain ops are some 600), which equal the plain
`_v_cycle` bit for bit. It captures them once per hierarchy and right-hand
side's shape, dtype and device as a CUDA graph (`GraphedCycle`, kept on the
hierarchy) and replays it for every apply; where the current stream is
capturing already it launches them directly. The CPU and the y-sharded
V-cycle of parallel/spatial.py run the plain ops. A solve counts the
V-cycles the kernels ran as `multigrid.kernel_cycles`, its replays as
`multigrid.graph_replays` and its captures as `multigrid.graph_captures`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import torch

from solver_in_the_loop_torch.core.grids import Boundary, Domain
from solver_in_the_loop_torch.kernels import vcycle
from solver_in_the_loop_torch.kernels.cg import pcg_solve_info
from solver_in_the_loop_torch.ops.poisson import ProjectionMasks, masks_from_fluid_cells
from solver_in_the_loop_torch.ops.stencils import masked_laplacian
from solver_in_the_loop_torch.utils import profiling


@dataclasses.dataclass(frozen=True, eq=False)
class MgLevel:
    masks: ProjectionMasks
    diag: torch.Tensor  # A's diagonal: sum of face masks per cell (1 on solids)


@dataclasses.dataclass(frozen=True, eq=False)
class MgHierarchy:
    levels: List[MgLevel]
    smooth_iters: int
    omega: float
    # the V-cycle's CUDA graphs, by the right-hand side's (shape, dtype, device)
    graphs: dict = dataclasses.field(default_factory=dict)


def _level_diag(masks: ProjectionMasks) -> torch.Tensor:
    """The smoother's diagonal: at least 1e-6 on fluid cells, 1 on solids
    (not the CG kernels' diag, which is the face sum as it is)."""
    d = (masks.face_u[:, :, 1:] + masks.face_u[:, :, :-1]
         + masks.face_v[:, 1:, :] + masks.face_v[:, :-1, :])
    return torch.where(masks.fluid > 0, torch.clamp_min(d, 1e-6), 1.0)


def build_mg_hierarchy(masks: ProjectionMasks, domain: Domain, min_size: int = 8,
                       smooth_iters: int = 2, omega: float = 0.8) -> MgHierarchy:
    """Levels halved while both sides are even and the smaller exceeds
    `min_size`; a coarse cell is fluid if any of its 2x2 children is (keeps
    narrow channels open)."""
    if domain.periodic:
        raise ValueError("the multigrid preconditioner supports OPEN domains only")
    levels = [MgLevel(masks, _level_diag(masks))]
    fluid = masks.fluid
    ny, nx = fluid.shape[1:]
    while ny % 2 == 0 and nx % 2 == 0 and min(ny, nx) > min_size:
        f = fluid.reshape(1, ny // 2, 2, nx // 2, 2).amax(dim=(2, 4))
        m = masks_from_fluid_cells(f, Domain((ny // 2, nx // 2), domain.size, Boundary.OPEN))
        levels.append(MgLevel(m, _level_diag(m)))
        fluid = f
        ny, nx = ny // 2, nx // 2
    return MgHierarchy(levels, smooth_iters, omega)


def apply_a(level: MgLevel, p: torch.Tensor) -> torch.Tensor:
    lp = masked_laplacian(p, level.masks.face_u, level.masks.face_v)
    return torch.where(level.masks.fluid > 0, -lp, p)


def smooth(level: MgLevel, x: torch.Tensor, b: torch.Tensor, iters: int,
           omega: float) -> torch.Tensor:
    """Damped Jacobi sweeps."""
    for _ in range(iters):
        r = b - apply_a(level, x)
        x = x + omega * r / level.diag
    return x


def restrict(r: torch.Tensor) -> torch.Tensor:
    """2x2 sum, in the order csrc/vcycle.cu adds: (r00 + r01) + (r10 + r11)."""
    return (r[:, 0::2, 0::2] + r[:, 0::2, 1::2]) + (r[:, 1::2, 0::2] + r[:, 1::2, 1::2])


def prolong(e: torch.Tensor) -> torch.Tensor:
    """Each coarse value to its 2x2 children."""
    return e.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def v_cycle(h: MgHierarchy, b: torch.Tensor, level: int = 0) -> torch.Tensor:
    """One V-cycle from zero: the preconditioner apply M^-1 b. From the top
    level it is a `silt.pressure.vcycle` span; from `level` > 0 (the rest
    of a cycle, as parallel/spatial.py runs it below its sharded levels)
    no span."""
    if level == 0:
        with profiling.span("silt.pressure.vcycle"):
            return _v_cycle(h, b, 0)
    return _v_cycle(h, b, level)


def _v_cycle(h: MgHierarchy, b: torch.Tensor, level: int) -> torch.Tensor:
    lvl = h.levels[level]
    x = smooth(lvl, torch.zeros_like(b), b, h.smooth_iters, h.omega)
    if level + 1 < len(h.levels):
        r = b - apply_a(lvl, x)
        rc = restrict(r) * torch.where(h.levels[level + 1].masks.fluid > 0, 1.0, 0.0)
        ec = _v_cycle(h, rc, level + 1)
        x = x + prolong(ec) * torch.where(lvl.masks.fluid > 0, 1.0, 0.0)
        x = smooth(lvl, x, b, h.smooth_iters, h.omega)
    else:
        x = smooth(lvl, x, b, 8, h.omega)  # extra smoothing as the coarse solve
    return x


class GraphedCycle:
    """The V-cycle's kernels (kernels/vcycle.py `v_cycle`) for right-hand
    sides of one shape, dtype and CUDA device, captured as a CUDA graph on
    static buffers.

    The capture runs outside inference mode and with autograd off, so that
    its buffers are plain tensors a rollout under `torch.inference_mode()`
    and a training backward can both copy into; it raises where an op of
    the cycle cannot be captured. A call copies r into the static input,
    replays the graph and returns a copy of the static output, which the
    next replay overwrites (the PCG loop keeps z as its next direction p):
    three launches in place of the cycle's 2 (L - 1) + 1 kernels."""

    def __init__(self, h: MgHierarchy, b: torch.Tensor):
        with torch.cuda.device(b.device), torch.inference_mode(False), torch.no_grad():
            self.input = torch.empty(b.shape, dtype=b.dtype, device=b.device)
            self.input.copy_(b)
            # the warm-up on a side stream that torch.cuda.graph asks for
            side = torch.cuda.Stream(b.device)
            side.wait_stream(torch.cuda.current_stream(b.device))
            with torch.cuda.stream(side):
                vcycle.v_cycle(h, self.input)
            torch.cuda.current_stream(b.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                self.output = vcycle.v_cycle(h, self.input)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        self.input.copy_(r)
        self.graph.replay()
        return self.output.clone()


def graphed_cycle(h: MgHierarchy, b: torch.Tensor):
    """(h's V-cycle graph for right-hand sides like b, 1 if this call
    captured it else 0); (None, 0) off CUDA or where the current stream is
    capturing already: the CPU runs the plain V-cycle, a capturing stream
    the kernels directly."""
    if not b.is_cuda or torch.cuda.is_current_stream_capturing():
        return None, 0
    key = (tuple(b.shape), b.dtype, b.device)
    if key in h.graphs:
        return h.graphs[key], 0
    h.graphs[key] = GraphedCycle(h, b)
    return h.graphs[key], 1


def mg_pcg_solve(h: MgHierarchy, b: torch.Tensor, tol: float = 1e-5, max_iter: int = 200,
                 x0=None):
    """CG preconditioned with the V-cycle; stops when every batch element's
    r.r is at most tol^2 max(b.b, 1e-30), the threshold from b also when
    warm-started at x0, or at max_iter. Returns (x, iterations).

    The JAX package's loop is `pcg_solve_info`'s line for line (the pap == 0
    and rz == 0 guards, the threshold from b), so it is that loop with the
    V-cycle as the preconditioner; parallel/spatial.py runs the same loop on
    y-sharded rows. On CUDA each apply runs the V-cycle's kernels
    (kernels/vcycle.py), replayed from its graph (`graphed_cycle`). The
    V-cycles it ran are counted as `multigrid.vcycles`, those the kernels ran
    as `multigrid.kernel_cycles`, those replayed as
    `multigrid.graph_replays`, and a capture as `multigrid.graph_captures`."""
    cycles = 0
    graph, captured = graphed_cycle(h, b)

    def minv(r):
        nonlocal cycles
        cycles += 1
        if not r.is_cuda:
            return v_cycle(h, r)
        with profiling.span("silt.pressure.vcycle"):
            return vcycle.v_cycle(h, r) if graph is None else graph(r)

    out = pcg_solve_info(functools.partial(apply_a, h.levels[0]), minv, b, tol, max_iter, x0)
    profiling.count("multigrid.vcycles", cycles)
    profiling.count("multigrid.kernel_cycles", cycles if b.is_cuda else 0)
    profiling.count("multigrid.graph_replays", 0 if graph is None else cycles)
    profiling.count("multigrid.graph_captures", captured)
    return out


def level_rows(level: MgLevel, lo: int, hi: int) -> MgLevel:
    """The level's operator on its cell rows [lo, hi): their masks, the faces
    around them and their smoother diagonal. Rows outside take the OPEN
    boundary's zero padding, so `apply_a` of it is the whole level's on every
    row but the cut's edges inside the field."""
    m = level.masks
    return MgLevel(ProjectionMasks(m.fluid[:, lo:hi], m.face_u[:, lo:hi], m.face_v[:, lo:hi + 1]),
                   level.diag[:, lo:hi])


# hierarchies of the latest mask sets, keyed by the masks' identity: a flow's
# masks are fixed and never written in place, so a rollout's solves and their
# adjoints build the hierarchy once. The entry holds the masks, so an id is
# not reused while it is cached; evicting it frees its V-cycle graphs.
_HIERARCHIES: dict = {}
_HIERARCHIES_KEPT = 4


def cached_hierarchy(fluid, face_u, face_v) -> MgHierarchy:
    """`build_mg_hierarchy` of an OPEN domain's masks, built once per mask set."""
    key = (id(fluid), id(face_u), id(face_v))
    if key not in _HIERARCHIES:
        if len(_HIERARCHIES) >= _HIERARCHIES_KEPT:
            del _HIERARCHIES[next(iter(_HIERARCHIES))]
        _, ny, nx = fluid.shape
        dom = Domain((ny, nx), (float(ny), float(nx)), Boundary.OPEN)
        _HIERARCHIES[key] = build_mg_hierarchy(ProjectionMasks(fluid, face_u, face_v), dom)
    return _HIERARCHIES[key]


def mg_solve(b, x0, fluid, face_u, face_v, tol: float, max_iter: int):
    """Multigrid-preconditioned CG of the masked system given by its masks,
    warm-started at x0, on b's device: (x, iterations as a 0-d int32 tensor)."""
    x, iters = mg_pcg_solve(cached_hierarchy(fluid, face_u, face_v), b, tol, max_iter, x0)
    return x, torch.tensor(iters, dtype=torch.int32, device=b.device)
