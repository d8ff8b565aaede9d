"""The PRE generator's frame unit (apps/karman_pre_gen.py `PreFrame`) on the
CPU at -r 8 (lo-res 16x8, hi-res 64x32): bit-equal to the frame loop the
CLI ran inline before it, and its spans and counters as a recording sees
them."""

from __future__ import annotations

import pytest
import torch

from solver_in_the_loop_torch.apps import karman_pre_gen as kpg
from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
from solver_in_the_loop_torch.core.resample import (
    downsample_centered,
    downsample_staggered,
    upsample_staggered,
)
from solver_in_the_loop_torch.ops.poisson import make_incompressible
from solver_in_the_loop_torch.physics.karman import KarmanFlow, initial_state, karman_domain
from solver_in_the_loop_torch.pre import lsq
from solver_in_the_loop_torch.pre.lsq import build_pre_geometry, solve_correction
from solver_in_the_loop_torch.utils import profiling

torch.set_num_threads(2)

RES, SCALE, RE, BETA = 8, 4, 160000.0, 1.0
CPU = torch.device("cpu")


def _start(seed: int):
    """A seeded perturbation of the CLI's start: the hi-res `initial_state`,
    the lo-res its 4x downsample, a zero correction."""
    g = torch.Generator().manual_seed(seed)
    d, v = initial_state(karman_domain(RES * SCALE), 1)
    d_hi = d.values + 0.1 * torch.rand(d.values.shape, generator=g)
    u_hi = v.u + 0.2 * torch.randn(v.u.shape, generator=g)
    v_hi = v.v + 0.2 * torch.randn(v.v.shape, generator=g)
    lo_u, lo_v = downsample_staggered(u_hi, v_hi, SCALE)
    return d_hi, u_hi, v_hi, downsample_centered(d_hi, SCALE), lo_u, lo_v


def _inline_loop(start, frames: int):
    """The frame loop of `karman-pre-gen` as the CLI ran it inline before
    the frame unit (stage clock and log left out): the corrected lo-res
    velocity, the hi-res velocity and the correction of every frame, and the
    correction solve's counts."""
    d_hi0, u_hi0, v_hi0, d_lo0, u_lo0, v_lo0 = start
    dom_lo, dom_hi = karman_domain(RES), karman_domain(RES * SCALE)
    flow_kw = dict(advection="gather", max_shift=4, pressure_precon="fd", device=CPU)
    flow_lo, flow_hi = KarmanFlow(dom_lo, **flow_kw), KarmanFlow(dom_hi, **flow_kw)
    geom = build_pre_geometry(dom_lo, dom_hi, SCALE, bnd=2)
    d_hi, v_hi = CenteredGrid(d_hi0, dom_hi), StaggeredGrid(u_hi0, v_hi0, dom_hi)
    d_co, v_co = CenteredGrid(d_lo0, dom_lo), StaggeredGrid(u_lo0, v_lo0, dom_lo)
    corr_u, corr_v = torch.zeros(dom_lo.u_shape(1)), torch.zeros(dom_lo.v_shape(1))
    hist = [(torch.zeros_like(d_hi.values),) * 3, (torch.zeros_like(d_co.values),) * 3,
            (torch.zeros_like(d_hi.values),) * 3]
    out = []
    with torch.no_grad():
        for i in range(1, frames + 1):
            x_hi, x_lo, x_vd = (kpg.warm_start(i, h) for h in hist)
            d_hi, v_hi, p_hi, _ = flow_hi.step(d_hi, v_hi, RE, dt=1.0, p0=x_hi)
            d_co, v_co_base, p_lo, _ = flow_lo.step(d_co, v_co, RE, dt=1.0, p0=x_lo)
            up_u, up_v = upsample_staggered(v_co_base.u, v_co_base.v, SCALE)
            vdiff, p_vd, _ = make_incompressible(
                StaggeredGrid(v_hi.u - up_u, v_hi.v - up_v, dom_hi), flow_hi.masks, p0=x_vd,
                precon=flow_hi.pressure_precon)
            corr_u, corr_v, its = solve_correction(geom, vdiff.u, vdiff.v, corr_u, corr_v,
                                                   beta=BETA, constrained=True)
            v_co = StaggeredGrid(v_co_base.u + corr_u, v_co_base.v + corr_v, dom_lo)
            hist = [(p, h[0], h[1]) for p, h in zip((p_hi, p_lo, p_vd), hist)]
            out.append({"d_hi": d_hi.values, "u_hi": v_hi.u, "v_hi": v_hi.v, "d_co": d_co.values,
                        "u_co": v_co.u, "v_co": v_co.v, "velo_u": v_co_base.u,
                        "corr_u": corr_u, "corr_v": corr_v, "outer": its["outer"],
                        "inner": its["inner"]})
    return out


def _unit(start, frames: int, mark=None):
    d_hi0, u_hi0, v_hi0, d_lo0, u_lo0, v_lo0 = start
    pre = kpg.PreFrame(RES, 100.0, SCALE, BETA, "gather", 4, "fd", CPU)
    state = pre.start(CenteredGrid(d_hi0, pre.dom_hi), StaggeredGrid(u_hi0, v_hi0, pre.dom_hi),
                      CenteredGrid(d_lo0, pre.dom_lo), StaggeredGrid(u_lo0, v_lo0, pre.dom_lo),
                      torch.zeros(pre.dom_lo.u_shape(1)), torch.zeros(pre.dom_lo.v_shape(1)), RE)
    out = []
    with torch.no_grad():
        for _ in range(frames):
            state, velo, its = pre(state, mark=mark)
            out.append({"d_hi": state.d_hi.values, "u_hi": state.v_hi.u, "v_hi": state.v_hi.v,
                        "d_co": state.d_co.values, "u_co": state.v_co.u, "v_co": state.v_co.v,
                        "velo_u": velo.u, "corr_u": state.corr_u, "corr_v": state.corr_v,
                        "outer": its["outer"], "inner": its["inner"]})
    return out, state


@pytest.mark.parametrize("seed", [0, 1])
def test_the_frame_unit_is_bit_equal_to_the_inline_loop(seed):
    """Five frames, so that every warm start (p1, linear, quadratic) runs."""
    start = _start(seed)
    want = _inline_loop(start, 5)
    marks = []
    got, state = _unit(start, 5, mark=marks.append)
    assert state.frame == 5 and marks == list(kpg.STAGES) * 5
    for k, (g, w) in enumerate(zip(got, want)):
        for name in w:
            assert torch.equal(g[name], w[name]), (k, name)
    assert all(int(f["outer"]) > 0 and int(f["inner"]) > 0 for f in got)


def test_a_recorded_frame_holds_its_spans_and_counters():
    start = _start(2)
    _unit(start, 1)  # the operators' first build stays out of the recording
    with profiling.recording() as rec:
        out, _ = _unit(start, 1)
    got = rec.read()
    names = [s[0] for s in got["spans"]]
    assert names.count("silt.pre.frame") == 1 and names.count("silt.pre.lsq") == 1
    frame = names.index("silt.pre.frame")
    lsq_span = names.index("silt.pre.lsq")
    assert got["spans"][lsq_span][3] == frame  # the correction solve inside the frame
    projects = [s for s in got["spans"] if s[0] == "silt.pre.lsq.project"]
    assert projects and all(s[3] == lsq_span for s in projects)
    # one projection a PPCG iteration, and three before them: of b, of the warm
    # start and of its residual
    counted = got["counters"]
    assert counted["pre.lsq_outer_iters"] == [int(out[0]["outer"])]
    assert counted["pre.lsq_inner_iters"] == [int(out[0]["inner"])]
    assert len(projects) == int(out[0]["outer"]) + 3
    assert names.count("silt.solver") == 2 and names.count("silt.pressure") == 3


def test_host_reads_count_every_read_of_a_stop_flag(monkeypatch):
    """`pre.lsq_host_reads` against the reads of a loop's flag counted by
    wrapping the tensors' `__bool__`, over one correction solve (the only
    tensor truth tests inside it are the loops' stop flags)."""
    dom_lo, dom_hi = karman_domain(RES), karman_domain(RES * SCALE)
    geom = build_pre_geometry(dom_lo, dom_hi, SCALE, bnd=2)
    g = torch.Generator().manual_seed(4)
    hu = torch.randn(geom.hi_fu.shape, generator=g)
    hv = torch.randn(geom.hi_fv.shape, generator=g)
    pu = 0.3 * torch.randn(geom.lo_fu.shape, generator=g)
    pv = 0.3 * torch.randn(geom.lo_fv.shape, generator=g)
    with torch.no_grad():
        solve_correction(geom, hu, hv, pu, pv, beta=BETA)  # the operators' first build
    reads = []
    as_bool = torch.Tensor.__bool__

    def counted(t):
        reads.append(t.shape)
        return as_bool(t)

    monkeypatch.setattr(torch.Tensor, "__bool__", counted)
    with torch.no_grad(), profiling.recording() as rec:
        _, _, its = solve_correction(geom, hu, hv, pu, pv, beta=BETA)
    monkeypatch.undo()
    counted_reads = rec.read()["counters"]["pre.lsq_host_reads"]
    assert reads and all(shape == () for shape in reads)
    assert sum(counted_reads) == len(reads)
    # the projected CG reads its flag every iteration, the inner CGs every CHECK_EVERY
    assert len(reads) > int(its["outer"]) + int(its["inner"]) // lsq.CHECK_EVERY

