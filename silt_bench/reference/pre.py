"""Plain reference of the PRE set generator's frame (`karman-pre-gen`, the
Makefile's `karman-fdt-pre-set`): a hi-res and a corrected lo-res karman
wake in lockstep, the difference of the hi-res velocity and the 4x
upsampled lo-res one made divergence-free, and the lo-res correction that
fits it best under the lo-res divergence constraint (Um et al. 2020, PRE).

Written for the benchmark in plain PyTorch; it imports nothing of the
program. The steps are reference/gen.py's `KarmanGen` at both
resolutions (float32, the FD-preconditioned CG stopped at 1e-7), the
projection fluid.py's `project` on the hi-res masks. The correction is
a direct float64 solve:

* W, the hi-from-lo face interpolation: each hi-res face samples its
  component of the lo-res faces bilinearly (coordinates clamped to the
  field), each tap weighted by its lo-res face's validity and the weights
  renormalised to sum to 1 (0 where they sum to at most 1e-6); rows of
  hi-res faces outside their valid region are 0.
* G, the lo-res cell -> face difference on the valid region: face (j, i)
  holds x[j, i] - x[j, i - 1] (u) or x[j, i] - x[j - 1, i] (v), a cell
  outside the region counting 0.
* The valid region: the cells `BND` (lo-res) or `BND * scale` (hi-res)
  cells in from the edge; a face is valid where a cell on either side is.
* The correction c minimises 1/2 c^T M c - b^T c subject to G^T c = 0, with
  M = W^T W + r I, b = W^T vdiff + 2 beta c_prev and r = 2 beta (the
  program's 1e-6 where beta is 0, PRE-SR, which keeps M definite). Its KKT
  system [M G; G^T 0] is solved through the Cholesky factor of M and the
  eigendecomposition of the Schur complement S = G^T M^-1 G, whose
  pseudo-inverse takes any dependent constraint rows: the solution map
  K = M^-1 - M^-1 G S^+ G^T M^-1 is built once per geometry and beta, and
  c = K b.

`tf32=True` rounds each operator's output to TF32's 10-bit mantissa (the
steps' fields as reference/gen.py does, the upsample, the difference, the
projection, the correction and the corrected velocity): the control of
the correctness check, one precision below the configuration's float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from silt_bench.reference.fluid import project
from silt_bench.reference.gen import KarmanGen, clamped_sample
from silt_bench.reference.net import tf32_round

BND = 2  # the lo-res valid region's margin in cells
RIDGE_BETA0 = 1e-6


# ------------------------------------------------------------------ upsample

def upsample2x_staggered(u: torch.Tensor, v: torch.Tensor):
    """MAC components at twice the resolution, each fine face sampled
    bilinearly at its position in the coarse face grid (edge values
    outside): fine u-face (jh, ih) lies at coarse u index (jh / 2 - 1/4,
    ih / 2), fine v-face (jh, ih) at coarse v index (jh / 2, ih / 2 - 1/4)."""
    b, ny, nx1 = u.shape
    fy, fx = 2 * ny, 2 * (nx1 - 1)
    kw = dict(dtype=u.dtype, device=u.device)

    def at(rows, cols):
        shape = (b, len(rows), len(cols))
        return rows[None, :, None].expand(shape), cols[None, None, :].expand(shape)

    ju, iu = at(torch.arange(fy, **kw) / 2 - 0.25, torch.arange(fx + 1, **kw) / 2)
    jv, iv = at(torch.arange(fy + 1, **kw) / 2, torch.arange(fx, **kw) / 2 - 0.25)
    return clamped_sample(u, ju, iu), clamped_sample(v, jv, iv)


def upsample_staggered(u: torch.Tensor, v: torch.Tensor, scale: int):
    """`upsample2x_staggered` log2(scale) times, as the PRE generator
    upsamples its lo-res velocity."""
    while scale > 1:
        u, v = upsample2x_staggered(u, v)
        scale //= 2
    return u, v


# -------------------------------------------------------------- the geometry

def face_masks(ny: int, nx: int, bnd: int):
    """Valid u faces (ny, nx + 1) and v faces (ny + 1, nx) of the region
    `bnd` cells in from the edge, and its cells (ny, nx): float64 numpy."""
    cells = np.zeros((ny, nx))
    cells[bnd:ny - bnd, bnd:nx - bnd] = 1.0
    fu, fv = np.zeros((ny, nx + 1)), np.zeros((ny + 1, nx))
    fu[:, :-1] = cells  # the face west of a valid cell
    fu[:, 1:] = np.maximum(fu[:, 1:], cells)  # and the face east of it
    fv[:-1, :] = cells
    fv[1:, :] = np.maximum(fv[1:, :], cells)
    return fu, fv, cells


def _taps(lo_mask: np.ndarray, hi_mask: np.ndarray, rows: np.ndarray, cols: np.ndarray):
    """W's rows for one component: the hi faces at lo index coordinates
    (rows, cols) as the flat lo indices (4, N) of their four taps and the
    taps' weights (4, N), renormalised over the valid lo faces (N the hi
    faces, row-major)."""
    h, w = lo_mask.shape
    r = np.broadcast_to(np.clip(rows, 0.0, h - 1.0)[:, None], (rows.size, cols.size))
    c = np.broadcast_to(np.clip(cols, 0.0, w - 1.0)[None, :], (rows.size, cols.size))
    r0 = np.minimum(np.floor(r), h - 2).astype(np.int64)
    c0 = np.minimum(np.floor(c), w - 2).astype(np.int64)
    fr, fc = r - r0, c - c0
    taps = [(r0, c0, (1 - fr) * (1 - fc)), (r0, c0 + 1, (1 - fr) * fc),
            (r0 + 1, c0, fr * (1 - fc)), (r0 + 1, c0 + 1, fr * fc)]
    weights = np.stack([wt * lo_mask[rr, cc] for rr, cc, wt in taps])
    total = weights.sum(0)
    weights = weights * (np.where(total > 1e-6, 1.0 / np.where(total > 1e-6, total, 1.0), 0.0)
                         * hi_mask)
    index = np.stack([rr * w + cc for rr, cc, _ in taps])
    return index.reshape(4, -1), weights.reshape(4, -1)


class Correction:
    """The constrained least-squares correction of one lo-res / hi-res
    geometry and beta, solved directly in float64 (see the module's
    docstring)."""

    def __init__(self, res: int, scale: int, beta: float, device):
        ly, lx, hy, hx = 2 * res, res, 2 * res * scale, res * scale
        lo_fu, lo_fv, lo_cells = face_masks(ly, lx, BND)
        hi_fu, hi_fv, _ = face_masks(hy, hx, BND * scale)
        s = float(scale)
        # hi u-face (jj, ii) at lo u index ((jj + 1/2) / s - 1/2, ii / s); v alike
        iu, wu = _taps(lo_fu, hi_fu, (np.arange(hy) + 0.5) / s - 0.5, np.arange(hx + 1) / s)
        iv, wv = _taps(lo_fv, hi_fv, np.arange(hy + 1) / s, (np.arange(hx) + 0.5) / s - 0.5)
        lo_face = np.concatenate([lo_fu.ravel(), lo_fv.ravel()])
        lo_valid = lo_face > 0
        unknown = np.cumsum(lo_valid) - 1  # a valid lo face's column of W
        # every hi face's taps as columns of W (a tap on an invalid face has weight 0)
        index = np.concatenate([iu, lo_fu.size + iv], 1)
        weight = np.concatenate([wu, wv], 1)
        column = np.where(lo_valid[index], unknown[index], 0)
        n = int(lo_valid.sum())
        wtw = np.zeros((n, n))
        for a in range(4):
            for b in range(4):
                np.add.at(wtw, (column[a], column[b]), weight[a] * weight[b])

        # G: a valid cell's value enters its west and south faces with +1,
        # its east and north faces with -1
        g = np.zeros((lo_face.size, int(lo_cells.sum())))
        for k, cell in enumerate(np.flatnonzero(lo_cells.ravel() > 0)):
            j, i = divmod(int(cell), lx)
            g[j * (lx + 1) + i, k] += 1.0
            g[j * (lx + 1) + i + 1, k] -= 1.0
            g[lo_fu.size + j * lx + i, k] += 1.0
            g[lo_fu.size + (j + 1) * lx + i, k] -= 1.0
        g = g[lo_valid]

        ridge = 2.0 * beta if beta > 0 else RIDGE_BETA0
        dev = dict(dtype=torch.float64, device=device)
        g_t = torch.as_tensor(g, **dev)
        m = torch.as_tensor(wtw, **dev) + ridge * torch.eye(n, **dev)
        m_inv = torch.cholesky_inverse(torch.linalg.cholesky(m))
        m_inv_g = m_inv @ g_t
        lam, vec = torch.linalg.eigh(g_t.T @ m_inv_g)
        kept = lam > 1e-12 * lam.abs().max()
        s_pinv = (vec[:, kept] / lam[kept]) @ vec[:, kept].T
        self.k = m_inv - m_inv_g @ s_pinv @ m_inv_g.T
        self.w_rows = torch.as_tensor(np.tile(np.arange(index.shape[1]), 4), device=device)
        self.w_cols = torch.as_tensor(column.ravel(), device=device)
        self.w_vals = torch.as_tensor(weight.ravel(), **dev)
        self.beta, self.n = beta, n
        self.lo_valid = torch.as_tensor(lo_valid, device=device)
        self.lo_shapes = (lo_fu.shape, lo_fv.shape)

    def apply_wt(self, vh: torch.Tensor) -> torch.Tensor:
        """W^T of hi face values (B, all hi faces): (B, valid lo faces)."""
        out = torch.zeros((vh.shape[0], self.n), dtype=torch.float64, device=vh.device)
        return out.index_add_(1, self.w_cols, vh[:, self.w_rows] * self.w_vals)

    def solve(self, vd_u, vd_v, prev_u, prev_v):
        """The corrections (B, ...) of the velocity differences vd (B, hi
        faces) given the previous corrections prev (B, lo faces), float32."""
        b = vd_u.shape[0]
        vh = torch.cat([vd_u.reshape(b, -1), vd_v.reshape(b, -1)], 1).double()
        prev = torch.cat([prev_u.reshape(b, -1), prev_v.reshape(b, -1)], 1).double()
        rhs = self.apply_wt(vh) + 2.0 * self.beta * prev[:, self.lo_valid]
        c = torch.zeros_like(prev)
        c[:, self.lo_valid] = rhs @ self.k  # K is symmetric
        n_u = int(np.prod(self.lo_shapes[0]))
        return (c[:, :n_u].reshape((b,) + self.lo_shapes[0]).float(),
                c[:, n_u:].reshape((b,) + self.lo_shapes[1]).float())


@functools.lru_cache(maxsize=4)
def correction(res: int, scale: int, beta: float, device) -> Correction:
    return Correction(res, scale, beta, device)


# ----------------------------------------------------------------- the frame

class KarmanPre:
    """The PRE generator's frame at lo-res (2 res, res) and hi-res (2 res
    scale, res scale): both steps, the projected difference, the
    correction and the corrected lo-res velocity."""

    def __init__(self, res: int, length: float, scale: int, beta: float, max_iter: int, device,
                 tf32: bool = False):
        self.hi = KarmanGen(res * scale, length, max_iter, device, tf32)
        self.lo = KarmanGen(res, length, max_iter, device, tf32)
        self.lsq = correction(res, scale, beta, torch.device(device))
        self.scale = scale
        self.round = tf32_round if tf32 else (lambda t: t)

    @torch.no_grad()
    def frame(self, s: dict, re: torch.Tensor) -> dict:
        """One frame from the state s (dens_hi, u_hi, v_hi, dens, u, v,
        corr_u, corr_v; (B, ...) each) at Reynolds numbers re (B,): the
        state one frame on."""
        rnd = self.round
        d_hi, u_hi, v_hi, _, _ = self.hi.step(s["dens_hi"], s["u_hi"], s["v_hi"], re)
        d_lo, u_lo, v_lo, _, _ = self.lo.step(s["dens"], s["u"], s["v"], re)
        up_u, up_v = upsample_staggered(u_lo, v_lo, self.scale)
        du, dv = rnd(u_hi - rnd(up_u)), rnd(v_hi - rnd(up_v))
        du, dv, _, _ = project(du, dv, self.hi.pressure, None)
        cu, cv = self.lsq.solve(rnd(du), rnd(dv), s["corr_u"], s["corr_v"])
        cu, cv = rnd(cu), rnd(cv)
        return {"dens_hi": d_hi, "u_hi": u_hi, "v_hi": v_hi, "dens": d_lo,
                "u": rnd(u_lo + cu), "v": rnd(v_lo + cv), "corr_u": cu, "corr_v": cv}

    def rollout(self, start: dict, re: torch.Tensor, steps: int) -> dict:
        """Frames 1..steps from `start`: each field (T, B, ...)."""
        out, s = [], start
        for _ in range(steps):
            s = self.frame(s, re)
            out.append(s)
        return {k: torch.stack([f[k] for f in out]) for k in out[0]}
