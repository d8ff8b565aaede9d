"""PRE correction solver: (constrained) least-squares fit of a lo-res
correction field to a hi-res velocity difference.

Port of solver_in_the_loop_tpu/pre/lsq.py. With W the hi-from-lo bilinear
face-interpolation operator, G the masked cell->face difference (gradient)
operator, M = W^T W + 2*beta*I and b = W^T v_hi + 2*beta*v_prev:

* Burgers (unconstrained):  solve M v = b by CG;
* karman (gradient-constrained): minimise 1/2 v^T M v - b^T v subject to
  G^T v = 0 by projected preconditioned CG, the projection
  P v = v - G (G^T G)^-1 G^T v an inner CG on the masked cell Laplacian.

G^T G on the valid cells is the pressure solve's masked operator with the
lo-res cell mask as its fluid and the face masks as its faces, so on the
card each projection's inner CG is one launch of the fused CG kernel
(csrc/cg.cu through `kernels.cg.cg_solve`, cold start, the same stop rule
and guards as `tree_cg`; it raises for a field its kernels cannot take);
on the CPU it is `tree_cg` on that operator (`inner_on_kernel` names the
route, by the device alone).

W is a function (masked, weight-renormalised `ops.interp.bilinear_sample`
at the hi face positions); its adjoint W^T is the VJP of that linear map
(`torch.func.vjp`, whose cotangent map is the transpose), G's adjoint is
written out (G^T = the face differences' negative divergence). Everything is
matrix-free and runs on the tensors' device.

The CG loops stop as the JAX package's `lax.while_loop`s do (`rs > thresh`,
PPCG's signed `rz > thresh` against the cold threshold), without a host read
per iteration: each iteration is computed under a device flag `active`
(the loop condition of that iterate) and its update kept only where the
flag holds, so an iterate past the stop is frozen; the host reads the flag
every `check_every` iterations and leaves the loop once it is down. The
result is the iterate the JAX loop stops at; the loops return their
iteration counts as 0-d int32 tensors.

PPCG also stops once r.z no longer falls: see `_ppcg`.

Spans and counters (utils/profiling.py): `silt.pre.lsq` brackets
`solve_correction`, `silt.pre.lsq.project` each projection's inner solve;
`pre.lsq_outer_iters` and `pre.lsq_inner_iters` take each solve's counts
(0-d tensors, no host read), `pre.lsq_host_reads` 1 for each read of a
loop's stop flag, `pre.lsq_kernel_projections` 1 for each projection the
fused kernel solved (none on the CPU).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from solver_in_the_loop_torch.core.grids import Domain
from solver_in_the_loop_torch.kernels.cg import cg_solve
from solver_in_the_loop_torch.ops.interp import bilinear_sample
from solver_in_the_loop_torch.utils import profiling

Vec = Dict[str, torch.Tensor]  # {"u": (1, Y, X+1), "v": (1, Y+1, X)}

# host reads of a CG's stop flag: one every CHECK_EVERY iterations; the
# projected CG reads its flag every iteration, since each of its iterations
# runs a whole inner solve
CHECK_EVERY = 8
# the projection's inner solve is capped at this many iterations
INNER_MAX_ITER = 300


def inner_on_kernel(rhs: torch.Tensor) -> bool:
    """Whether a projection's inner CG on the right-hand side `rhs` (1, Y, X)
    runs the fused kernel (`kernels.cg.cg_solve`) rather than `tree_cg`: on
    the card, always."""
    return rhs.is_cuda


def _cell_mask(ny: int, nx: int, bnd: int) -> np.ndarray:
    m = np.zeros((1, ny, nx), np.float32)
    m[:, bnd: ny - bnd, bnd: nx - bnd] = 1.0
    return m


def _face_masks(cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """u faces (1, Y, X+1), v faces (1, Y+1, X) from a cell mask: face (j, i)
    is valid if cell (j, i) or its west (south) neighbour is, within a
    one-cell margin; the far edge column (row) stays invalid."""
    _, ny, nx = cells.shape
    fu = np.zeros((1, ny, nx + 1), np.float32)
    fv = np.zeros((1, ny + 1, nx), np.float32)
    c = cells[0] > 0
    fu[0, 1:ny - 1, 1:nx - 1] = c[1:-1, 1:-1] | c[1:-1, :-2]
    fv[0, 1:ny - 1, 1:nx - 1] = c[1:-1, 1:-1] | c[:-2, 1:-1]
    return fu, fv


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: ndarray fields
class PreGeometry:
    """Static masks and scale of one (lo, hi) domain pair (numpy)."""

    lo: Domain
    hi: Domain
    scale: int
    lo_cells: np.ndarray
    lo_fu: np.ndarray
    lo_fv: np.ndarray
    hi_fu: np.ndarray
    hi_fv: np.ndarray


def build_pre_geometry(lo: Domain, hi: Domain, scale: int, bnd: int = 2) -> PreGeometry:
    lo_cells = _cell_mask(lo.ny, lo.nx, bnd)
    lo_fu, lo_fv = _face_masks(lo_cells)
    hi_fu, hi_fv = _face_masks(_cell_mask(hi.ny, hi.nx, bnd * scale))
    return PreGeometry(lo, hi, scale, lo_cells, lo_fu, lo_fv, hi_fu, hi_fv)


def _masks(geom: PreGeometry, device) -> Dict[str, torch.Tensor]:
    names = ("lo_cells", "lo_fu", "lo_fv", "hi_fu", "hi_fv")
    return {n: torch.as_tensor(getattr(geom, n), device=device) for n in names}


def make_apply_w(geom: PreGeometry, device=None) -> Callable[[Vec], Vec]:
    """W: lo faces -> hi faces, masked and renormalised bilinear sampling."""
    s = float(geom.scale)
    hy, hx = geom.hi.ny, geom.hi.nx
    m = _masks(geom, device)

    def coords(rows, cols):
        shape = (1, len(rows), len(cols))
        r = torch.as_tensor(rows, dtype=torch.float32, device=device)[None, :, None]
        c = torch.as_tensor(cols, dtype=torch.float32, device=device)[None, None, :]
        return r.expand(shape), c.expand(shape)

    # hi u-face (jj, ii) samples lo u at row (jj+.5)/s-.5, col ii/s; hi
    # v-face (jj, ii) lo v at row jj/s, col (ii+.5)/s-.5
    rows_u, cols_u = coords((np.arange(hy) + 0.5) / s - 0.5, np.arange(hx + 1) / s)
    rows_v, cols_v = coords(np.arange(hy + 1) / s, (np.arange(hx) + 0.5) / s - 0.5)
    den_u = bilinear_sample(m["lo_fu"], rows_u, cols_u)
    den_v = bilinear_sample(m["lo_fv"], rows_v, cols_v)

    def masked_interp(vals, mask, rows, cols, den):
        num = bilinear_sample(vals * mask, rows, cols)
        return torch.where(den > 1e-6, num / torch.clamp_min(den, 1e-6), 0.0)

    def apply_w(vec: Vec) -> Vec:
        return {"u": masked_interp(vec["u"], m["lo_fu"], rows_u, cols_u, den_u) * m["hi_fu"],
                "v": masked_interp(vec["v"], m["lo_fv"], rows_v, cols_v, den_v) * m["hi_fv"]}

    return apply_w


def make_apply_g(geom: PreGeometry, device=None) -> Callable[[torch.Tensor], Vec]:
    """G: cell scalars (1, Y, X) -> face vectors, face (j, i) = X[j, i] -
    X[west or south neighbour] over valid cells."""
    m = _masks(geom, device)
    cm, fu, fv = m["lo_cells"], m["lo_fu"], m["lo_fv"]

    def apply_g(x: torch.Tensor) -> Vec:
        xm = x * cm
        return {"u": (F.pad(xm, (0, 1)) - F.pad(xm, (1, 0))) * fu,
                "v": (F.pad(xm, (0, 0, 0, 1)) - F.pad(xm, (0, 0, 1, 0))) * fv}

    return apply_g


def make_apply_gt(geom: PreGeometry, device=None) -> Callable[[Vec], torch.Tensor]:
    """G^T, the adjoint of make_apply_g: face vectors -> cell scalars."""
    m = _masks(geom, device)
    cm, fu, fv = m["lo_cells"], m["lo_fu"], m["lo_fv"]

    def apply_gt(vec: Vec) -> torch.Tensor:
        gu = vec["u"] * fu
        gv = vec["v"] * fv
        return ((gu[..., :-1] - gu[..., 1:]) + (gv[:, :-1] - gv[:, 1:])) * cm

    return apply_gt


def linear_transpose(fn: Callable, example):
    """The transpose of the linear map `fn` at inputs shaped like `example`:
    its VJP, which for a linear map does not depend on the point."""
    _, vjp = torch.func.vjp(fn, example)
    return lambda ct: vjp(ct)[0]


# --------------------------------------------------------------------------
# pytree conjugate gradients
# --------------------------------------------------------------------------

def _tdot(a: Vec, b: Vec) -> torch.Tensor:
    return sum(torch.sum(a[k] * b[k]) for k in sorted(a))


def _axpy(alpha, x: Vec, y: Vec) -> Vec:
    """y + alpha * x, leaf by leaf."""
    return {k: y[k] + alpha * x[k] for k in y}


def _keep(active: torch.Tensor, new: Vec, old: Vec) -> Vec:
    return {k: torch.where(active, new[k], old[k]) for k in new}


def _as_vec(t):
    return t if isinstance(t, dict) else {"x": t}


def _from_vec(v, like):
    return v if isinstance(like, dict) else v["x"]


def _divide(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, 0 where den is 0 (the JAX loops' guarded step length)."""
    zero = den == 0
    return torch.where(zero, 0.0, num / torch.where(zero, 1.0, den))


def _loop(body, state, active, max_iter: int, check_every: int):
    """Run `body(state) -> (state, still_active)` while the device flag
    `active` holds, at most max_iter times, keeping each update only under
    the flag; reads the flag on the host every `check_every` iterations.
    Returns (state, iterations as a 0-d int32 tensor)."""
    iters = torch.zeros((), dtype=torch.int32, device=active.device)
    for i in range(max_iter):
        if i % check_every == 0:
            profiling.count("pre.lsq_host_reads", 1)
            if not bool(active):
                break
        new, still = body(state)
        state = {k: torch.where(active, new[k], state[k]) if torch.is_tensor(new[k])
                 else _keep(active, new[k], state[k]) for k in new}
        iters = iters + active.to(torch.int32)
        active = active & still
    return state, iters


def tree_cg(matvec, b, tol: float = 1e-6, max_iter: int = 2000, x0=None,
            check_every: int = CHECK_EVERY):
    """Matrix-free CG on a tensor or a dict of tensors (SPD matvec). x0
    warm-starts the iteration; the stop threshold stays relative to ||b||.
    Returns (x, iterations)."""
    mv = lambda v: _as_vec(matvec(_from_vec(v, b)))  # noqa: E731
    bv = _as_vec(b)
    bb = _tdot(bv, bv)
    thresh = (tol * tol) * torch.clamp_min(bb, 1e-30)
    if x0 is None:
        x, r, rs = {k: torch.zeros_like(t) for k, t in bv.items()}, bv, bb
    else:
        x = _as_vec(x0)
        r = _axpy(-1.0, mv(x), bv)
        rs = _tdot(r, r)

    def body(st):
        ap = mv(st["p"])
        alpha = _divide(st["rs"], _tdot(st["p"], ap))
        x = _axpy(alpha, st["p"], st["x"])
        r = _axpy(-alpha, ap, st["r"])
        rs_new = _tdot(r, r)
        beta = rs_new / torch.where(st["rs"] == 0, 1.0, st["rs"])
        p = _axpy(beta, st["p"], r)
        return {"x": x, "r": r, "p": p, "rs": rs_new}, rs_new > thresh

    st, iters = _loop(body, {"x": x, "r": r, "p": r, "rs": rs}, rs > thresh, max_iter,
                      check_every)
    return _from_vec(st["x"], b), iters


def _ppcg(apply_m, project, b: Vec, tol: float, max_iter: int, x0=None):
    """Projected preconditioned CG for min 1/2 x^T M x - b^T x s.t. G^T x = 0:
    the projection is the preconditioner (z = P r), iterates stay feasible.
    x0 is projected first; the threshold stays pinned to the cold energy
    <b, P b>. Returns (x, iterations).

    The loop runs while the signed r.z exceeds the threshold (the JAX rule:
    r.z drops below 0 at the float32 noise floor) and r.z still falls. On
    these systems r.z falls about 10x an iteration until that floor; there
    rounding decides its sign, and where it stays positive, iterating on
    amplifies the noise (on an 8x8 box with random data at tol 1e-8, r.z
    then grows 4x an iteration and G^T x reaches 1.5x the field's max). A
    rise of r.z is that floor's other sign, so the loop stops there too."""
    z_b = project(b)
    thresh = (tol * tol) * torch.clamp_min(_tdot(b, z_b), 1e-30)
    if x0 is None:
        x, r, z = {k: torch.zeros_like(t) for k, t in b.items()}, b, z_b
    else:
        x = project(x0)
        r = _axpy(-1.0, apply_m(x), b)
        z = project(r)
    rz = _tdot(r, z)

    def body(st):
        mp = apply_m(st["p"])
        alpha = _divide(st["rz"], _tdot(st["p"], mp))
        x = _axpy(alpha, st["p"], st["x"])
        r = _axpy(-alpha, mp, st["r"])
        z = project(r)
        rz_new = _tdot(r, z)
        beta = rz_new / torch.where(st["rz"] == 0, 1.0, st["rz"])
        still = (rz_new > thresh) & (rz_new < st["rz"])
        return {"x": x, "r": r, "p": _axpy(beta, st["p"], z), "rz": rz_new}, still

    st, iters = _loop(body, {"x": x, "r": r, "p": z, "rz": rz}, rz > thresh, max_iter, 1)
    return st["x"], iters


# --------------------------------------------------------------------------
# solvers
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _operators(geom: PreGeometry, device: torch.device):
    """W, W^T, G, G^T and the masks of `geom` on `device`."""
    m = _masks(geom, device)
    apply_w = make_apply_w(geom, device)
    example = {"u": torch.zeros_like(m["lo_fu"]), "v": torch.zeros_like(m["lo_fv"])}
    return m, apply_w, linear_transpose(apply_w, example), make_apply_g(geom, device), \
        make_apply_gt(geom, device)


def solve_correction(geom: PreGeometry, vdiff_hi_u: torch.Tensor, vdiff_hi_v: torch.Tensor,
                     prev_u: torch.Tensor, prev_v: torch.Tensor, beta: float,
                     constrained: bool = True, tol: float = 1e-4, max_iter: int = 600):
    """The lo-grid correction (corr_u, corr_v), zero outside the valid faces,
    and its iteration counts {"outer": ..., "inner": ...} (0-d int32
    tensors; "inner" sums the projections' CG iterations, 0 unconstrained),
    in the `silt.pre.lsq` span.

    The defaults keep the tol^2-relative stop above the float32 noise floor
    (tol 1e-4: a 1e-8 relative residual)."""
    with profiling.span("silt.pre.lsq"):
        corr_u, corr_v, its = _solve_correction(geom, vdiff_hi_u, vdiff_hi_v, prev_u, prev_v,
                                                beta, constrained, tol, max_iter)
    profiling.count("pre.lsq_outer_iters", its["outer"])
    profiling.count("pre.lsq_inner_iters", its["inner"])
    return corr_u, corr_v, its


def _solve_correction(geom, vdiff_hi_u, vdiff_hi_v, prev_u, prev_v, beta, constrained, tol,
                      max_iter):
    device = prev_u.device
    m, apply_w, wt, apply_g, apply_gt = _operators(geom, device)
    lo = {"u": m["lo_fu"], "v": m["lo_fv"]}
    vh = {"u": vdiff_hi_u * m["hi_fu"], "v": vdiff_hi_v * m["hi_fv"]}
    prev = {"u": prev_u * lo["u"], "v": prev_v * lo["v"]}

    two_beta = 2.0 * beta
    ridge = two_beta if beta > 0 else 1e-6  # a tiny ridge keeps beta=0 (PRE-SR) SPD

    def apply_m(x: Vec) -> Vec:
        x = {k: x[k] * lo[k] for k in lo}
        wtw = wt(apply_w(x))
        return {k: (wtw[k] + ridge * x[k]) * lo[k] for k in lo}

    wt_vh = wt(vh)
    b = {k: (wt_vh[k] + two_beta * prev[k]) * lo[k] for k in lo}
    inner = torch.zeros((), dtype=torch.int32, device=device)

    if not constrained:
        # warm start from the previous frame's correction, also the
        # temporal regulariser's target
        vl, outer = tree_cg(apply_m, b, tol=tol, max_iter=max_iter, x0=prev)
    else:
        cm = m["lo_cells"]
        inner_max = min(max_iter, INNER_MAX_ITER)

        def gtg(x: torch.Tensor) -> torch.Tensor:
            return torch.where(cm > 0, apply_gt(apply_g(x * cm)), x)

        def project(v: Vec) -> Vec:
            nonlocal inner
            with profiling.span("silt.pre.lsq.project"):
                rhs = apply_gt(v) * cm
                if inner_on_kernel(rhs):
                    # r, p and x stay 0 off the cells from the cold start,
                    # where gtg's masking of the neighbours has no effect
                    p, n = cg_solve(rhs, torch.zeros_like(rhs), cm, m["lo_fu"], m["lo_fv"], tol,
                                    inner_max)
                    profiling.count("pre.lsq_kernel_projections", 1)
                else:
                    p, n = tree_cg(gtg, rhs, tol=tol, max_iter=inner_max)
            inner = inner + n
            return _axpy(-1.0, apply_g(p), v)

        # prev is the previous frame's constrained solution: a valid warm start
        vl, outer = _ppcg(apply_m, project, b, tol=tol, max_iter=max_iter, x0=prev)

    return vl["u"] * lo["u"], vl["v"] * lo["v"], {"outer": outer, "inner": inner}
