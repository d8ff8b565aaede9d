"""The V-cycle kernels' launch plan and tiled passes, emulated on the CPU.

csrc/vcycle.cu cannot run here. These tests hold kernels/vcycle.py's mirror
of its constants to the source, walk `level_plan` over the hierarchies of
256x128, 384x192, 128x64 and 64x64 (every level above the coarsest cut into
even-aligned tiles that cover each cell once and hold each 2x2 parent
whole), and emulate the kernels' passes tile by tile in PyTorch: the tile
and its halo staged with zeros outside the field, the first sweep from zero
on the whole staged region, each further sweep on one cell less, the
residual's 2x2 sums on the tile, x + prolong(e) staged for the way up. The
emulation gives ops/multigrid.py `_v_cycle` bit for bit, which is what the
card tests (tests/test_torch_cuda.py) ask of the kernels. The module imports
without nvcc and without JAX.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from solver_in_the_loop_torch.core.grids import Boundary, Domain
from solver_in_the_loop_torch.kernels import build, vcycle
from solver_in_the_loop_torch.ops import multigrid as mg
from solver_in_the_loop_torch.ops.poisson import masks_from_fluid_cells
from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain

torch.set_num_threads(1)

SOURCE = Path(vcycle.__file__).resolve().parent.parent / "csrc" / "vcycle.cu"
H = vcycle.SWEEPS


def _box_hierarchy(ny, nx, seed=0):
    """A hierarchy of an OPEN (ny, nx) field with random solid blocks."""
    g = torch.Generator().manual_seed(seed)
    fluid = torch.ones(1, ny, nx)
    for _ in range(4):
        y, x = (int(torch.randint(0, n - 6, (1,), generator=g)) for n in (ny, nx))
        fluid[:, y:y + 5, x:x + 3] = 0.0
    dom = Domain((ny, nx), (float(ny), float(nx)), Boundary.OPEN)
    return mg.build_mg_hierarchy(masks_from_fluid_cells(fluid, dom), dom)


def _shapes(h):
    return [tuple(lv.masks.fluid.shape[1:]) for lv in h.levels]


def test_the_mirror_holds_the_sources_constants():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("TILE_Y"), const("TILE_X")) == (vcycle.TILE_Y, vcycle.TILE_X)
    assert const("SWEEPS") == vcycle.SWEEPS == 2
    assert const("COARSE_SMEM_MAX") == vcycle.COARSE_SMEM_MAX
    assert const("COARSE_SWEEPS") == 8 and "HALO = SWEEPS" in src
    assert vcycle.TILE_Y % 2 == 0 and vcycle.TILE_X % 2 == 0
    assert "--fmad=false" in build.SOURCES["vcycle"]


@pytest.mark.parametrize("ny,nx,levels", [(256, 128, 5), (384, 192, 6), (128, 64, 4),
                                          (64, 64, 4)])
@pytest.mark.parametrize("batch", [1, 6, 128])
def test_the_plan_tiles_every_level(ny, nx, levels, batch):
    h = _box_hierarchy(ny, nx)
    shapes = _shapes(h)
    assert len(shapes) == levels
    plan = vcycle.level_plan(shapes, batch)
    assert [p["kind"] for p in plan] == ["tiles"] * (levels - 1) + ["coarse"]
    assert len(plan) * 2 - 1 == 2 * (levels - 1) + 1
    for step, (ly, lx) in zip(plan[:-1], shapes[:-1]):
        gx, gy, bsz = step["grid"]
        assert bsz == batch and step["shape"] == (ly, lx)
        owner = torch.full((ly, lx), -1, dtype=torch.long)
        for by in range(gy):
            for bx in range(gx):
                y0, x0 = by * vcycle.TILE_Y, bx * vcycle.TILE_X
                assert y0 % 2 == 0 and x0 % 2 == 0 and y0 < ly and x0 < lx
                tile = owner[y0:y0 + vcycle.TILE_Y, x0:x0 + vcycle.TILE_X]
                assert (tile == -1).all()
                tile[:] = by * gx + bx
        assert (owner >= 0).all()
        # every 2x2 parent's children lie in one tile
        kids = owner.reshape(ly // 2, 2, lx // 2, 2)
        assert (kids == kids[:, :1, :, :1]).all()
    cny, cnx = shapes[-1]
    coarse = plan[-1]
    assert coarse["grid"] == (batch, 1, 1) and not coarse["scratch"]
    assert coarse["threads"] % 32 == 0 and min(cny * cnx, 1024) <= coarse["threads"] <= 1024


def test_a_coarsest_level_beyond_shared_memory_takes_scratch():
    # 684 = 4 x 171: two halvings leave an odd 171x171 coarsest level, whose
    # two iterates are 233,928 bytes
    plan = vcycle.level_plan([(684, 684), (342, 342), (171, 171)], 1)
    assert plan[-1]["scratch"] and plan[-1]["threads"] == 1024
    assert not vcycle.level_plan([(128, 64), (64, 32)], 2)[-1]["scratch"]
    with pytest.raises(ValueError):
        vcycle.level_plan([(128, 64), (32, 16)], 1)


# --- the kernels' passes, tile by tile ---------------------------------------

def _pad(t, value, extra_y, extra_x):
    """A (.., ny, nx) tensor with H cells of `value` above and left and H +
    extra below and right."""
    return torch.nn.functional.pad(t, (H, H + extra_x, H, H + extra_y), value=value)


def _staged(lv, b, y0, x0):
    """b, diag, fluid, west/east/north/south face masks and the in-field
    mask of the region of the tile at (y0, x0), as csrc/vcycle.cu `stage`
    fills it: 0 outside the field (diag 1)."""
    ny, nx = b.shape[1:]
    ey, ex = vcycle.TILE_Y, vcycle.TILE_X
    ry, rx = ey + 2 * H, ex + 2 * H
    sl = (slice(None), slice(y0, y0 + ry), slice(x0, x0 + rx))
    m = lv.masks
    u = _pad(m.face_u, 0.0, ey, ex)[:, y0:y0 + ry, x0:x0 + rx + 1]
    v = _pad(m.face_v, 0.0, ey, ex)[:, y0:y0 + ry + 1, x0:x0 + rx]
    return {"b": _pad(b, 0.0, ey, ex)[sl], "diag": _pad(lv.diag, 1.0, ey, ex)[sl],
            "fluid": _pad(m.fluid, 0.0, ey, ex)[sl], "uw": u[:, :, :-1], "ue": u[:, :, 1:],
            "vn": v[:, :-1], "vs": v[:, 1:],
            "in": _pad(torch.ones(1, ny, nx, dtype=torch.bool), False, ey, ex)[sl]}


def _a(s, xc, xw, xe, xn, xs, a):
    """A x on the region's cells a cells in from its edge, in the plain ops'
    order."""
    c = (slice(None), slice(a, s["b"].shape[1] - a), slice(a, s["b"].shape[2] - a))
    du = (xe - xc) * s["ue"][c] - (xc - xw) * s["uw"][c]
    dv = (xs - xc) * s["vs"][c] - (xc - xn) * s["vn"][c]
    return torch.where(s["fluid"][c] > 0, -(du + dv), xc), c


def _sweep(s, x, reach, omega):
    """One sweep on the cells at most `reach` from the tile (x None: from
    zero, on the whole region); 0 outside the field and beyond the reach."""
    a = H - reach
    ry, rx = s["b"].shape[1:]
    if x is None:
        z = torch.zeros_like(s["b"])
        ax, c = _a(s, z, z, z, z, z, 0)
        xc = z
    else:
        xc = x[:, a:ry - a, a:rx - a]
        ax, c = _a(s, xc, x[:, a:ry - a, a - 1:rx - a - 1], x[:, a:ry - a, a + 1:rx - a + 1],
                   x[:, a - 1:ry - a - 1, a:rx - a], x[:, a + 1:ry - a + 1, a:rx - a], a)
    new = xc + omega * (s["b"][c] - ax) / s["diag"][c]
    out = torch.zeros_like(s["b"])
    out[c] = torch.where(s["in"][c], new, 0.0)
    return out


def _tiles(shape):
    ny, nx = shape
    for y0 in range(0, ny, vcycle.TILE_Y):
        for x0 in range(0, nx, vcycle.TILE_X):
            yield y0, x0


def _down(lv, fluid_c, b, omega):
    """mg_down: x_l and b_{l+1}, tile by tile."""
    ny, nx = b.shape[1:]
    x = torch.full_like(b, float("nan"))
    bc = torch.full((b.shape[0], ny // 2, nx // 2), float("nan"))
    ty, tx = vcycle.TILE_Y, vcycle.TILE_X
    for y0, x0 in _tiles((ny, nx)):
        s = _staged(lv, b, y0, x0)
        xk = _sweep(s, None, H, omega)
        for k in range(2, H + 1):
            xk = _sweep(s, xk, H + 1 - k, omega)
        t = (slice(None), slice(H, H + ty), slice(H, H + tx))
        ax, _ = _a(s, xk[t], xk[:, H:H + ty, H - 1:H + tx - 1], xk[:, H:H + ty, H + 1:H + tx + 1],
                   xk[:, H - 1:H + ty - 1, H:H + tx], xk[:, H + 1:H + ty + 1, H:H + tx], H)
        r = s["b"][t] - ax
        hy, hx = min(ty, ny - y0), min(tx, nx - x0)
        x[:, y0:y0 + hy, x0:x0 + hx] = xk[t][:, :hy, :hx]
        r = r[:, :hy, :hx]
        rc = (r[:, 0::2, 0::2] + r[:, 0::2, 1::2]) + (r[:, 1::2, 0::2] + r[:, 1::2, 1::2])
        fc = fluid_c[:, y0 // 2:(y0 + hy) // 2, x0 // 2:(x0 + hx) // 2]
        bc[:, y0 // 2:(y0 + hy) // 2, x0 // 2:(x0 + hx) // 2] = rc * torch.where(fc > 0, 1.0, 0.0)
    return x, bc


def _up(lv, xl, e, b, omega):
    """mg_up: x_l + prolong(e) under the fluid mask, then the sweeps."""
    ny, nx = b.shape[1:]
    out = torch.full_like(b, float("nan"))
    ty, tx = vcycle.TILE_Y, vcycle.TILE_X
    start = xl + mg.prolong(e) * torch.where(lv.masks.fluid > 0, 1.0, 0.0)
    for y0, x0 in _tiles((ny, nx)):
        s = _staged(lv, b, y0, x0)
        xk = _pad(start, 0.0, ty, tx)[:, y0:y0 + ty + 2 * H, x0:x0 + tx + 2 * H]
        for k in range(1, H + 1):
            xk = _sweep(s, xk, H - k, omega)
        hy, hx = min(ty, ny - y0), min(tx, nx - x0)
        out[:, y0:y0 + hy, x0:x0 + hx] = xk[:, H:H + hy, H:H + hx]
    return out


def _coarse(lv, b, omega, sweeps):
    x = torch.zeros_like(b)
    for _ in range(sweeps):
        x = mg.smooth(lv, x, b, 1, omega)
    return x


def _tiled_v_cycle(h, b):
    xs, rhs = [], [b]
    for i in range(len(h.levels) - 1):
        x, bc = _down(h.levels[i], h.levels[i + 1].masks.fluid, rhs[-1], h.omega)
        xs.append(x)
        rhs.append(bc)
    e = _coarse(h.levels[-1], rhs[-1], h.omega, vcycle.SWEEPS + 8)
    for i in reversed(range(len(h.levels) - 1)):
        e = _up(h.levels[i], xs[i], e, rhs[i], h.omega)
    return e


@pytest.mark.parametrize("case", ["karman_64", "box_68x72", "box_64x96"])
def test_the_tiled_passes_give_the_plain_cycle_to_the_bit(case):
    if case == "karman_64":
        masks = KarmanFlow(karman_domain(64)).masks
        h = mg.cached_hierarchy(masks.fluid, masks.face_u, masks.face_v)
        batch = 2
    else:
        ny, nx = (int(n) for n in case.split("_")[1].split("x"))
        h = _box_hierarchy(ny, nx, seed=ny)
        batch = 3
    ny, nx = h.levels[0].masks.fluid.shape[1:]
    g = torch.Generator().manual_seed(ny * nx)
    b = torch.randn(batch, ny, nx, generator=g) * h.levels[0].masks.fluid
    got = _tiled_v_cycle(h, b)
    assert torch.isfinite(got).all()
    assert torch.equal(got, mg._v_cycle(h, b, 0))


def test_the_plain_restrict_is_the_reshaped_sum():
    """`restrict` adds in the kernel's order, which is the 2x2 reshaped sum
    of PyTorch's CPU reduction to the bit."""
    r = torch.randn(3, 64, 32, generator=torch.Generator().manual_seed(3)) * 1e3
    assert torch.equal(mg.restrict(r), r.reshape(3, 32, 2, 16, 2).sum(dim=(2, 4)))


def test_the_wrapper_imports_without_nvcc_and_without_jax(tmp_path):
    code = ("import sys; sys.modules['jax'] = None\n"
            "from solver_in_the_loop_torch.kernels import build, vcycle\n"
            "from solver_in_the_loop_torch.ops import multigrid\n"
            "assert build._loaded == {} and vcycle.v_cycle.launches == 0\n"
            "assert 'jax' not in {m.split('.')[0] for m, v in sys.modules.items() if v}\n")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)
    env["PYTHONPATH"] = str(SOURCE.parents[2])
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=tmp_path)


def test_the_wrapper_raises_off_cuda():
    masks = KarmanFlow(karman_domain(64)).masks
    h = mg.cached_hierarchy(masks.fluid, masks.face_u, masks.face_v)
    with pytest.raises(ValueError, match="CUDA"):
        vcycle.v_cycle(h, torch.zeros(1, 128, 64))
    assert vcycle.v_cycle.launches == 0
