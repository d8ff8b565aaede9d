"""Spatial domain decomposition of the karman step: y-sharded fields, halo
exchanges and a distributed pressure solve over torch.distributed.

Counterpart of solver_in_the_loop_tpu/parallel/spatial.py. The JAX package
shards (B, Y, X) fields along Y with a NamedSharding and lets XLA's SPMD
partitioner insert the halo collectives of every stencil, advection gather
and CG iteration. PyTorch has no partitioner, so `YShardedKarman` runs the
stages of `KarmanFlow.step` (physics/karman.py) on each rank's rows and says
where rows move (parallel/mesh.py `move_rows`, differentiable):

* diffusion on a halo of one row;
* the freestream BC blend and the density inflow on the rank's own rows of
  the global masks;
* advection of density, u and v on a haloed block: `shift` takes
  max_shift + 1 rows each side (the tap-sum's reach), and runs the tap-sum
  kernel on the block; `gather` takes as many as the back-trace reaches,
  from the largest |v| dt / dy of the whole field (all-reduced), so a wide
  reach gathers rows from ranks beyond the neighbours;
* the projection: the divergence on one face row from below, the pressure
  solve on the rank's rows, and the pressure gradient on one row from above.

The pressure solve is `pcg_solve_info` on the rank's rows: a halo of one row
a matvec, the inner products all-reduced, so that every rank takes the
branch the unsharded loop takes and stops at its iteration. Its
preconditioner follows the route `sharded_pressure_route` names, which is the
JAX package's for a sharded field off its Pallas kernel (that kernel is
single-device in both packages, and its `solve_pressure` never looks at the
sharding): the multigrid V-cycle (ops/multigrid.py) where `_mg_applicable`
holds for the global shape, else the FD preconditioner, whose y-transform is
summed over the ranks.

The sharded V-cycle runs `multigrid.v_cycle`'s sweeps on each rank's window
of a level: its block of rows and smooth_iters rows each side, exchanged
once before the pre-smoothing and once before the post-smoothing. A sweep
spoils one row at each window edge inside the field, so smooth_iters sweeps
leave the block exact (the pre-smoothing starts from zero, which the window
holds exactly). A level is sharded while its parent's blocks have an
even number of rows (restriction and prolongation stay local) and its own
blocks hold at least MG_MIN_ROWS rows; below the last sharded level every
rank gathers that level's residual, restricts it and runs the rest of the
V-cycle replicated, then keeps its own rows of the prolonged correction. The
coarsest level is always replicated: a hierarchy of one level (an odd side,
66x33) gathers the right-hand side and runs the whole V-cycle on every rank,
each keeping its own rows.

A block's edge inside the field is a halo; the OPEN boundary's padding and
the advection's clamp act only at the field's first and last rows, which
the haloed block then holds.

Layouts: dens (B, ny, nx) and u (B, ny, nx+1) in blocks of ny / size rows;
v's ny+1 rows zero-padded to a multiple of the size and cut in equal blocks
(`shard_staggered_y`), which is JAX's `device_put(..., P(None, 'y', None))`
of the padded field shard by shard. Inside the step v is moved to the rows
the rank updates, the faces above its cells and, on the last rank, the
field's last face.
"""
from __future__ import annotations

import logging
import math

import torch
import torch.nn.functional as F

from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
from solver_in_the_loop_torch.kernels.cg import batch_dot, masked_matvec, pcg_solve_info
from solver_in_the_loop_torch.ops import multigrid as mg
from solver_in_the_loop_torch.ops.advection import semi_lagrangian
from solver_in_the_loop_torch.ops.diffusion import diffuse_explicit
from solver_in_the_loop_torch.ops.poisson import _mg_applicable, fd_factors
from solver_in_the_loop_torch.ops.stencils import divergence, pressure_gradient
from solver_in_the_loop_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    data_parallel_mesh,
    move_rows,
)
from solver_in_the_loop_torch.physics.karman import KarmanFlow

log = logging.getLogger(__name__)

# the group is the same whichever axis it shards: JAX names its one axis 'y'
spatial_mesh = data_parallel_mesh

# the JAX names of KarmanFlow's pressure_backend that a sharded field takes
SHARDED_BACKENDS = ("auto", "xla", "mg")
# the fewest rows a rank's block of a sharded multigrid level holds; a
# coarser level runs replicated. A sharded level costs two row exchanges a
# V-cycle, a replicated one none, and a level under 8 rows a rank is a few
# thousand cells on every rank, cheaper than two exchanges (each a host round
# trip over gloo); 8 rows also keep the 2-row halo inside the neighbours.
MG_MIN_ROWS = 8


def sharded_pressure_route(shape, backend: str = "auto") -> str:
    """The pressure solve of a y-sharded (B, ny, nx) karman field under the
    JAX name of the backend: "multigrid" (the V-cycle preconditioner) where
    `backend` is "mg", or "auto" and `_mg_applicable` holds for the global
    shape, as the JAX package's `solve_pressure` takes it off its Pallas
    kernel; else "pcg_plain" (the FD preconditioner), JAX's "xla"."""
    if backend not in SHARDED_BACKENDS:
        raise ValueError(f"a sharded field's pressure_backend is one of {SHARDED_BACKENDS}, got "
                         f"{backend!r} (the fused CG kernel is single-device)")
    if backend == "mg" or (backend == "auto" and _mg_applicable(shape)):
        return "multigrid"
    return "pcg_plain"


def y_blocks(mesh: Mesh, rows: int):
    """Every rank's rows [lo, hi) of an axis of `rows` rows that the group's
    size divides: contiguous blocks, rank order (JAX's P(None, 'y'))."""
    if rows % mesh.size != 0:
        raise ValueError(f"y-extent {rows} is not divisible by the group's {mesh.size} ranks")
    n = rows // mesh.size
    return [(q * n, (q + 1) * n) for q in range(mesh.size)]


def y_sharding(mesh: Mesh, rows: int) -> slice:
    """This rank's rows of axis 1 (`y_blocks`)."""
    return slice(*y_blocks(mesh, rows)[mesh.rank])


def pad_rows_to_mesh(a: torch.Tensor, mesh: Mesh):
    """Zero-pad axis 1 up to the next multiple of the group's size; returns
    (padded, number of rows added)."""
    extra = (-a.shape[1]) % mesh.size
    return (F.pad(a, (0, 0, 0, extra)) if extra else a), extra


def shard_staggered_y(mesh: Mesh, dens: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """This rank's blocks of a MAC triplet: dens (B, ny, nx) and u
    (B, ny, nx+1) must divide (ValueError), v's ny+1 rows are zero-padded to
    divisibility first. Returns (dens, u, v_padded) blocks, each contiguous;
    pair with `make_sharded_step_y`."""
    for name, a in (("dens", dens), ("u", u)):
        if a.shape[1] % mesh.size != 0:
            raise ValueError(f"shard_staggered_y: {name} y-extent {a.shape[1]} not divisible "
                             f"by mesh size {mesh.size}; choose a mesh-divisible ny")
    v_pad, _ = pad_rows_to_mesh(v, mesh)
    return tuple(a[:, y_sharding(mesh, a.shape[1])].contiguous() for a in (dens, u, v_pad))


def shard_fields_y(mesh: Mesh, *arrays, strict: bool = False):
    """This rank's block of each array's axis 1 where the group's size
    divides it. A y-extent it does not divide is REPLICATED (the whole array
    kept on every rank) with a warning, as the JAX package's fallback does,
    or raises ValueError with `strict`."""
    out = []
    for a in arrays:
        if a.shape[1] % mesh.size == 0:
            out.append(a[:, y_sharding(mesh, a.shape[1])].contiguous())
            continue
        msg = (f"shard_fields_y: y-extent {a.shape[1]} not divisible by mesh size {mesh.size}; "
               f"array shape {tuple(a.shape)} REPLICATED instead of sharded")
        if strict:
            raise ValueError(msg)
        log.warning(msg)
        out.append(a)
    return out if len(out) > 1 else out[0]


def gather_y(mesh: Mesh, block: torch.Tensor, rows: int) -> torch.Tensor:
    """The whole field on every rank from each rank's `block` of equal
    blocks along axis 1 (dens, u, or v padded), cut to its `rows` true rows;
    differentiable."""
    nb = block.shape[1]
    have = [(min(q * nb, rows), min((q + 1) * nb, rows)) for q in range(mesh.size)]
    return move_rows(block, have, [(0, rows)] * mesh.size, mesh)


class _ShardedSolve(torch.autograd.Function):
    """The distributed pressure solve (`YShardedKarman.solve`),
    differentiable in its right-hand side: the backward is a cold solve of
    the same symmetric system by the same solver, with the forward's
    tolerance and limit, as the unsharded `solve_pressure`'s is."""

    @staticmethod
    def forward(ctx, rhs, x0, shard):
        ctx.shard = shard
        x, iters = shard.solve(rhs, x0)
        iters = torch.tensor(iters, dtype=torch.int32, device=rhs.device)
        ctx.mark_non_differentiable(iters)
        return x, iters

    @staticmethod
    def backward(ctx, gx, _giters):
        gb, _ = ctx.shard.solve(gx.contiguous(), torch.zeros_like(gx))
        return gb, None, None


class _ShardedLevel:
    """A sharded level of the multigrid hierarchy on one rank: every rank's
    block of the level's cell rows, and this rank's window of them (its
    block and `halo` rows each side, cut at the field's edges) with the
    level's operator there."""

    def __init__(self, level: mg.MgLevel, blocks, mesh: Mesh, halo: int):
        rows = level.masks.fluid.shape[1]
        self.blocks, self.mesh, self.rows = blocks, mesh, rows
        self.windows = [(max(lo - halo, 0), min(hi + halo, rows)) for lo, hi in blocks]
        lo, hi = blocks[mesh.rank]
        c0, c1 = self.windows[mesh.rank]
        self.own = slice(lo - c0, hi - c0)
        self.op = mg.level_rows(level, c0, c1)
        self.fluid = level.masks.fluid[:, lo:hi]

    def window(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's window of a level field from every rank's block."""
        return move_rows(x, self.blocks, self.windows, self.mesh)


def _sharded_levels(h: mg.MgHierarchy, cells, mesh: Mesh):
    """The levels of `h` that run sharded on the ranks' `cells` of level 0
    (see the module doc): each finer than the coarsest, from level 0 on,
    while its parent's blocks are even and its own hold MG_MIN_ROWS rows;
    none where level 0 is the coarsest."""
    levels, blocks = [], cells
    while len(levels) < len(h.levels) - 1:
        levels.append(_ShardedLevel(h.levels[len(levels)], blocks, mesh, h.smooth_iters))
        if any((hi - lo) % 2 or (hi - lo) // 2 < MG_MIN_ROWS for lo, hi in blocks):
            break
        blocks = [(lo // 2, hi // 2) for lo, hi in blocks]
    return levels


class YShardedKarman:
    """`KarmanFlow.step` on y-blocks of its fields over `mesh`'s ranks (see
    the module doc); the flow's domain has ny rows that the size divides.
    `pressure_backend` is the JAX package's name ("auto", "xla", "mg";
    `sharded_pressure_route`), and `pressure_route` the solve it names."""

    def __init__(self, flow: KarmanFlow, mesh: Mesh, pressure_backend: str = "auto"):
        dom = flow.domain
        ny, size, r = dom.ny, mesh.size, mesh.rank
        self.flow, self.mesh, self.ny = flow, mesh, ny
        self.pressure_route = sharded_pressure_route((1, ny, dom.nx), pressure_backend)
        self.cells = y_blocks(mesh, ny)
        last = [int(q == size - 1) for q in range(size)]
        # the faces each rank updates, and v's padded blocks (their true rows)
        self.faces = [(lo, hi + e) for (lo, hi), e in zip(self.cells, last)]
        nv = -(-(ny + 1) // size)
        self.padded = [(min(q * nv, ny + 1), min((q + 1) * nv, ny + 1)) for q in range(size)]
        self.nv = nv
        lo, hi = self.cells[r]
        self.n, self.last = hi - lo, last[r]
        masks, dev = flow.masks, flow.masks.fluid.device
        self.face_u = masks.face_u[:, lo:hi]
        self.face_v = masks.face_v[:, lo:hi + self.last]
        self.bc_mask = flow._bc_mask[:, lo:hi + self.last]
        self.bc_vals = flow._bc_vals[:, lo:hi + self.last]
        self.inflow = flow.inflow[:, lo:hi]
        # the pressure solve's operator on the rows of a halo of one
        c0, c1 = self._cell_window(1)[r]
        self.matvec = masked_matvec(masks.fluid[:, c0:c1], masks.face_u[:, c0:c1],
                                    masks.face_v[:, c0:c1 + 1])
        self.fluid = masks.fluid[:, lo:hi]
        if self.pressure_route == "multigrid":
            # built on the global masks, which every rank holds
            self.mg = mg.cached_hierarchy(masks.fluid, masks.face_u, masks.face_v)
            self.mg_levels = _sharded_levels(self.mg, self.cells, mesh)
        else:
            vy, self.vx, self.invd = fd_factors(ny, dom.nx, dev)
            self.vy = vy[lo:hi]

    def _cell_window(self, k: int):
        return [(max(lo - k, 0), min(hi + k, self.ny)) for lo, hi in self.cells]

    def window(self, k: int, u=None, v=None, dens=None):
        """The sub-domain of cell rows [c0, c1) = this rank's block and up to
        k rows each side: (top, u rows [c0, c1), v faces [c0, c1], dens rows
        [c0, c1)) for the fields given, where top = rows above the block."""
        cw = self._cell_window(k)
        fw = [(a, b + 1) for a, b in cw]
        got = [move_rows(x, have, want, self.mesh)
               for x, have, want in ((u, self.cells, cw), (v, self.faces, fw),
                                     (dens, self.cells, cw)) if x is not None]
        return (self.cells[self.mesh.rank][0] - cw[self.mesh.rank][0], *got)

    def _own_cells(self, x, top):
        return x[:, top:top + self.n]

    def _own_faces(self, x, top):
        return x[:, top:top + self.n + self.last]

    def to_faces(self, v_pad: torch.Tensor) -> torch.Tensor:
        """v from its padded block to the faces this rank updates."""
        return move_rows(v_pad, self.padded, self.faces, self.mesh)

    def to_padded(self, v: torch.Tensor) -> torch.Tensor:
        """v from the faces this rank updates to its padded block, the
        padding rows zero."""
        v = move_rows(v, self.faces, self.padded, self.mesh)
        return F.pad(v, (0, 0, 0, self.nv - v.shape[1]))

    def advection_halo(self, v: torch.Tensor, dt: float) -> int:
        """Rows each side that advecting this rank's rows reads: the
        tap-sum's max_shift + 1, or the back-trace's reach from the largest
        |v| of the field (its samples' y-velocities are averages of v), plus
        a row for the bilinear pair and one for rounding."""
        if self.flow.advection == "shift":
            return self.flow.max_shift + 1
        vmax = v.detach().abs().amax().reshape(1).to(torch.float64)
        vmax = float(all_reduce_(vmax, self.mesh, torch.distributed.ReduceOp.MAX))
        if not math.isfinite(vmax):
            return self.ny
        return int(math.floor(vmax * dt / self.flow.domain.dx[0])) + 2

    def pre_projection(self, dens, u, v, re, dt: float = 1.0):
        """Diffusion, BC blend and advection (`KarmanFlow.pre_projection`) on
        this rank's rows; v on the faces this rank updates."""
        dom = self.flow.domain
        re = torch.as_tensor(re, dtype=torch.float32, device=u.device).reshape(-1, 1, 1)
        alpha = dt * float(dom.nx) * float(dom.nx) / re
        top, u_w, v_w = self.window(1, u, v)
        u = self._own_cells(diffuse_explicit(u_w, alpha, periodic=False), top)
        v = self._own_faces(diffuse_explicit(v_w, alpha, periodic=False), top)
        v = v * (1.0 - self.bc_mask) + self.bc_vals

        top, u_w, v_w, d_w = self.window(self.advection_halo(v, dt), u, v, dens)
        vel = StaggeredGrid(u_w, v_w, dom)
        adv = dict(method=self.flow.advection, max_shift=self.flow.max_shift)
        d_w = semi_lagrangian(CenteredGrid(d_w, dom), vel, dt, **adv).values
        vel = semi_lagrangian(vel, vel, dt, **adv)
        dens = self._own_cells(d_w, top) + self.inflow * dt
        return dens, self._own_cells(vel.u, top), self._own_faces(vel.v, top)

    def _dot(self, a, b):
        return all_reduce_(batch_dot(a, b), self.mesh)

    def _matvec(self, p):
        top, p_w = self.window(1, dens=p)
        return self._own_cells(self.matvec(p_w), top)

    def _minv(self, r):
        t = torch.einsum("jy,bjx->byx", self.vy, r)
        t = all_reduce_(t, self.mesh)
        t = torch.einsum("byj,jx->byx", t, self.vx) * self.invd
        t = torch.einsum("yj,bjx->byx", self.vy, t)
        return torch.einsum("byj,xj->byx", t, self.vx)

    def v_cycle(self, b: torch.Tensor, level: int = 0) -> torch.Tensor:
        """`multigrid.v_cycle` of this rank's block of a sharded level's
        right-hand side: the same sweeps on the rank's window, the
        restriction and prolongation on its rows, and below the last sharded
        level the rest gathered and replicated (see the module doc)."""
        h = self.mg
        if not self.mg_levels:  # one level, the coarsest: replicated whole
            whole = gather_y(self.mesh, b, self.ny)
            return mg.v_cycle(h, whole)[:, slice(*self.cells[self.mesh.rank])]
        lv = self.mg_levels[level]
        s, omega = h.smooth_iters, h.omega
        b_w = lv.window(b)
        x_w = mg.smooth(lv.op, torch.zeros_like(b_w), b_w, s, omega)
        r = (b_w - mg.apply_a(lv.op, x_w))[:, lv.own]
        coarse = level + 1
        if coarse < len(self.mg_levels):
            rc = mg.restrict(r) * torch.where(self.mg_levels[coarse].fluid > 0, 1.0, 0.0)
            e = mg.prolong(self.v_cycle(rc, coarse))
        else:
            rc = mg.restrict(gather_y(self.mesh, r, lv.rows))
            rc = rc * torch.where(h.levels[coarse].masks.fluid > 0, 1.0, 0.0)
            e = mg.prolong(mg.v_cycle(h, rc, coarse))[:, slice(*lv.blocks[self.mesh.rank])]
        x = x_w[:, lv.own] + e * torch.where(lv.fluid > 0, 1.0, 0.0)
        return mg.smooth(lv.op, lv.window(x), b_w, s, omega)[:, lv.own]

    def solve(self, b, x0):
        """The pressure solve on this rank's rows, by `pressure_route`:
        `pcg_solve_info` with the sharded V-cycle or the FD preconditioner.
        Returns (x, iterations)."""
        minv = self.v_cycle if self.pressure_route == "multigrid" else self._minv
        return pcg_solve_info(self._matvec, minv, b, self.flow.pressure_tol,
                              self.flow.pressure_max_iter, x0, dot=self._dot)

    def project_faces(self, u, v, p0=None):
        """`make_incompressible` on this rank's rows, v on the faces it
        updates: (u, v, pressure, iterations)."""
        u = u * self.face_u
        v = v * self.face_v
        _, v_w = self.window(0, v=v)  # and the face row below the block
        div = divergence(u, v_w)
        rhs = torch.where(self.fluid > 0, -div, 0.0).contiguous()
        x0 = (torch.zeros_like(rhs) if p0 is None
              else torch.where(self.fluid > 0, p0.detach(), 0.0))
        p, iters = _ShardedSolve.apply(rhs, x0, self)
        top, p_w = self.window(1, dens=p)
        gu, gv = pressure_gradient(p_w)
        u = u - self._own_cells(gu, top) * self.face_u
        v = v - self._own_faces(gv, top) * self.face_v
        return u, v, p, iters

    def project(self, u, v_pad, p0=None):
        """The projection of y-sharded u and padded v: (u, v_pad, pressure,
        iterations)."""
        u, v, p, iters = self.project_faces(u, self.to_faces(v_pad), p0)
        return u, self.to_padded(v), p, iters

    def step(self, dens, u, v_pad, re, dt: float = 1.0):
        """One karman solver step of y-sharded fields (`shard_staggered_y`'s
        layout in and out): (dens, u, v_pad), v's padding rows zero."""
        dens, u, v = self.pre_projection(dens, u, self.to_faces(v_pad), re, dt)
        u, v, _, _ = self.project_faces(u, v)
        return dens, u, self.to_padded(v)


def make_sharded_step_y(flow: KarmanFlow, mesh: Mesh, pressure_backend: str = "auto"):
    """(dens, u, v_pad, re, dt=1.0) -> (dens, u, v_pad): the karman step on
    `shard_staggered_y`'s layout, as JAX's wrapper of the same name returns
    it for its step function around a KarmanFlow of that pressure_backend.
    Every rank calls it together."""
    return YShardedKarman(flow, mesh, pressure_backend).step
