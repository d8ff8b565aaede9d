"""Karman PRE data generation: a hi-res and a corrected lo-res sim in
lockstep.

Port of solver_in_the_loop_tpu/apps/karman_pre_gen.py with the same flags
plus `--pressure-precon {fd,none}` (as karman-apply's) and `--device
{cuda,cpu}` (default cuda). The Makefile's PRE set (`karman-fdt-pre-set`;
`karman-fdt-presr-set` is the same with `--beta 0`) is six of

    python -m solver_in_the_loop_torch karman-pre-gen -o karman-fdt-pre-set \
        -r 32 -l 100 --re 160000 --seed 0 --beta 1.0

Each frame i = 1 .. simsteps-1 is one call of `PreFrame`:

  1. a hi-res step and a lo-res step on the previously corrected state,
     each warm-started from the quadratic extrapolation of its previous
     pressures. At -r 32 on the card the hi-res solve (256x128, batch 1)
     takes the fused FD-PCG kernel in its cluster layout
     (csrc/cg_cluster.cu), the lo-res one (64x32) the fused kernel of
     csrc/pcg.cu; on the CPU the hi-res solve takes multigrid
     (ops/multigrid.py) and the lo-res one the kernel's plain twin. The CLI
     logs the routes (`pressure solves:`);
  2. vdiff = v_hi - upsample4x(v_lo), made divergence-free on the hi-res
     domain with its obstacle (the hi-res step's route, likewise
     warm-started);
  3. the gradient-constrained least-squares correction (pre/lsq.py) with
     the temporal regulariser beta / dt; lo state += correction.

Frames skipsteps+1 .. simsteps-1 are kept (densH veloH densC veloC, the
model inputs dens velo and the label corr) and written at the end on the
frame writer's thread pool (io/npz_pool.py); `--thumb` writes densH, velUC,
velVC, corUC and corVC (x 10000) to <output>/thumb/sim_%06d/. The run
returns each stage's seconds and the correction solve's iteration counts.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from solver_in_the_loop_torch.apps.karman_apply import add_pressure_precon, resolve_device
from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
from solver_in_the_loop_torch.core.resample import (
    downsample_centered,
    downsample_staggered,
    upsample_staggered,
)
from solver_in_the_loop_torch.io import scene as scene_io
from solver_in_the_loop_torch.io import thumbs
from solver_in_the_loop_torch.io.scene import Scene
from solver_in_the_loop_torch.ops.poisson import make_incompressible
from solver_in_the_loop_torch.physics.karman import KarmanFlow, initial_state, karman_domain
from solver_in_the_loop_torch.pre.lsq import build_pre_geometry, solve_correction
from solver_in_the_loop_torch.utils import profiling

log = logging.getLogger(__name__)

STAGES = ("hires_step", "lores_step", "projection", "lsq")


def build_parser(parser=None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("karman-pre-gen")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--thumb", action="store_true")
    p.add_argument("-t", "--simsteps", type=int, default=1500)
    p.add_argument("-s", "--skipsteps", type=int, default=999)
    p.add_argument("-r", "--res", type=int, default=32)
    p.add_argument("-l", "--len", type=float, default=100.0)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--re", type=float, default=1e6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--advect", choices=["gather", "shift"], default="gather")
    p.add_argument("--max-shift", type=int, default=4)
    add_pressure_precon(p)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the CUDA card)")
    return p


def warm_start(i: int, hist):
    """The warm start of frame i from the previous pressures hist = (p1, p2,
    p3): quadratic 3p1-3p2+p3 from frame 4, linear at 3, else p1."""
    p1, p2, p3 = hist
    if i >= 4:
        return 3 * p1 - 3 * p2 + p3
    if i == 3:
        return 2 * p1 - p2
    return p1


class StageClock:
    """Wall seconds per stage, synchronised with the device at each mark."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds = dict.fromkeys(STAGES, 0.0)
        self.t = None

    def sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self) -> None:
        self.t = self.sync()

    def mark(self, stage: str) -> None:
        t = self.sync()
        self.seconds[stage] += t - self.t
        self.t = t


@dataclasses.dataclass(frozen=True, eq=False)
class PreState:
    """The lockstep state between two frames: the hi-res sim, the corrected
    lo-res sim, the last correction, the previous pressures (p1, p2, p3) of
    the three solves (hi step, lo step, vdiff projection) and the sims'
    Reynolds number. `frame` counts the frames since the pressures started
    cold."""

    d_hi: CenteredGrid
    v_hi: StaggeredGrid
    d_co: CenteredGrid
    v_co: StaggeredGrid
    corr_u: torch.Tensor
    corr_v: torch.Tensor
    hist: Tuple[tuple, tuple, tuple]
    re: float
    frame: int = 0


class PreFrame:
    """One PRE frame of `karman-pre-gen`: the hi-res and lo-res flows, the
    correction's geometry, and `__call__`, which advances a `PreState` one
    frame (the `silt.pre.frame` span).

    A frame reads nothing on the host beyond the solves' own stop tests;
    `mark`, where given, is called with each stage's name as it ends (the
    CLI's `StageClock.mark`, which synchronises)."""

    def __init__(self, res: int, length: float, scale: int, beta: float, advection: str,
                 max_shift: int, pressure_precon: str, device):
        self.dom_lo = karman_domain(res, length)
        self.dom_hi = karman_domain(res * scale, length)
        flow_kw = dict(advection=advection, max_shift=max_shift,
                       pressure_precon=pressure_precon, device=device)
        self.flow_lo = KarmanFlow(self.dom_lo, **flow_kw)
        self.flow_hi = KarmanFlow(self.dom_hi, **flow_kw)
        self.geom = build_pre_geometry(self.dom_lo, self.dom_hi, scale, bnd=2)
        self.scale, self.beta = scale, beta

    def start(self, d_hi: CenteredGrid, v_hi: StaggeredGrid, d_co: CenteredGrid,
              v_co: StaggeredGrid, corr_u: torch.Tensor, corr_v: torch.Tensor,
              re: float) -> PreState:
        """A state at Reynolds number `re` whose pressure histories start
        cold (zero)."""
        hist = ((torch.zeros_like(d_hi.values),) * 3, (torch.zeros_like(d_co.values),) * 3,
                (torch.zeros_like(d_hi.values),) * 3)
        return PreState(d_hi, v_hi, d_co, v_co, corr_u, corr_v, hist, re)

    def __call__(self, state: PreState, mark: Optional[Callable[[str], None]] = None):
        """(the state one frame on, the lo-res step's uncorrected velocity,
        the correction solve's iterations {"outer", "inner"} as 0-d int32
        tensors)."""
        mark = mark or (lambda stage: None)
        i = state.frame + 1
        re, dt = state.re, 1.0
        with profiling.span("silt.pre.frame"):
            x_hi, x_lo, x_vd = (warm_start(i, h) for h in state.hist)
            d_hi, v_hi, p_hi, _ = self.flow_hi.step(state.d_hi, state.v_hi, re, dt=dt, p0=x_hi)
            mark("hires_step")
            d_co, v_co_base, p_lo, _ = self.flow_lo.step(state.d_co, state.v_co, re, dt=dt,
                                                         p0=x_lo)
            mark("lores_step")
            up_u, up_v = upsample_staggered(v_co_base.u, v_co_base.v, self.scale)
            vdiff, p_vd, _ = make_incompressible(
                StaggeredGrid(v_hi.u - up_u, v_hi.v - up_v, self.dom_hi), self.flow_hi.masks,
                p0=x_vd, precon=self.flow_hi.pressure_precon)
            mark("projection")
            corr_u, corr_v, its = solve_correction(self.geom, vdiff.u, vdiff.v, state.corr_u,
                                                   state.corr_v, beta=self.beta / dt,
                                                   constrained=True)
            mark("lsq")
            v_co = StaggeredGrid(v_co_base.u + corr_u, v_co_base.v + corr_v, self.dom_lo)
            hist = tuple((p, h[0], h[1]) for p, h in zip((p_hi, p_lo, p_vd), state.hist))
        return PreState(d_hi, v_hi, d_co, v_co, corr_u, corr_v, hist, re, i), v_co_base, its


def run(args):
    """Generate the scene. Returns a dict: "scene" (its path), "seconds"
    (per stage, and "rollout" and "write"), "lsq_outer" and "lsq_inner"
    (the correction solve's iterations per frame, (T,) int), "frames" (the
    frame ids written)."""
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    pre = PreFrame(args.res, args.len, args.scale, args.beta, args.advect, args.max_shift,
                   args.pressure_precon, device)
    dom_lo = pre.dom_lo
    log.info("pressure solves: hi-res %s, lo-res %s", pre.flow_hi.pressure_route(1),
             pre.flow_lo.pressure_route(1))

    d_hi, v_hi = initial_state(pre.dom_hi, 1, device)
    d_co = CenteredGrid(downsample_centered(d_hi.values, args.scale), dom_lo)
    v_co = StaggeredGrid(*downsample_staggered(v_hi.u, v_hi.v, args.scale), dom_lo)
    state = pre.start(d_hi, v_hi, d_co, v_co, torch.zeros(dom_lo.u_shape(1), device=device),
                      torch.zeros(dom_lo.v_shape(1), device=device), args.re)

    sc = Scene.create(args.output)
    sc.write_params(vars(args).copy())
    kept = {k: [] for k in ("densH", "veloH", "densC", "veloC", "dens", "velo", "corr")}
    outer, inner, frame_ids = [], [], []
    clock = StageClock(device)
    with scene_io.scene_run_log(sc.path), torch.no_grad():
        log.info("params: %s", vars(args))
        log.info("writing %s", sc.path)
        t_roll = clock.sync()
        for i in range(1, args.simsteps):
            clock.start()
            state, v_co_base, its = pre(state, mark=clock.mark)
            outer.append(its["outer"])
            inner.append(its["inner"])

            if i % 25 == 0 or i == 1:
                log.info("step %06d |corr|max=%.4f lsq iterations %d outer, %d inner", i,
                         float(state.corr_u.abs().max()), int(its["outer"]), int(its["inner"]))
            if args.skipsteps < i:
                frame_ids.append(i)
                for name, t in (("densH", state.d_hi.values), ("densC", state.d_co.values),
                                ("dens", state.d_co.values)):
                    kept[name].append(t[0].cpu().numpy())
                for name, g in (("veloH", state.v_hi), ("veloC", state.v_co),
                                ("velo", v_co_base),
                                ("corr", StaggeredGrid(state.corr_u, state.corr_v, dom_lo))):
                    kept[name].append((g.u[0].cpu().numpy(), g.v[0].cpu().numpy()))
        t_write = clock.sync()
        seconds = dict(clock.seconds, rollout=t_write - t_roll)
        for name, frames in kept.items():
            if name.startswith("dens"):
                sc.write_centered_batch(name, frame_ids, np.stack(frames))
            else:
                sc.write_staggered_batch(name, frame_ids, np.stack([f[0] for f in frames]),
                                         np.stack([f[1] for f in frames]))
        if args.thumb:
            td = thumbs.thumb_dir_for(sc.path)
            items = []
            for k, i in enumerate(frame_ids):
                fields = (("densH", kept["densH"][k]), ("velUC", kept["veloC"][k][0]),
                          ("velVC", kept["veloC"][k][1]), ("corUC", kept["corr"][k][0]),
                          ("corVC", kept["corr"][k][1]))
                items += [(f, 10000.0, os.path.join(td, f"{n}_{i:06d}.png")) for n, f in fields]
            thumbs.save_thumbs(items)
        seconds["write"] = time.perf_counter() - t_write
        steps = max(args.simsteps - 1, 1)
        outer_n = torch.stack(outer).cpu().numpy() if outer else np.zeros(0, int)
        inner_n = torch.stack(inner).cpu().numpy() if inner else np.zeros(0, int)
        log.info("%d frames in %.3f s (%.4f s/frame: %s); lsq iterations per frame: outer "
                 "mean %.1f max %d, inner mean %.1f max %d; wrote %d frames in %.3f s", steps,
                 seconds["rollout"], seconds["rollout"] / steps,
                 ", ".join(f"{k} {seconds[k] / steps:.4f}" for k in STAGES),
                 outer_n.mean() if len(outer_n) else 0, outer_n.max(initial=0),
                 inner_n.mean() if len(inner_n) else 0, inner_n.max(initial=0),
                 len(frame_ids), seconds["write"])
    return {"scene": sc.path, "seconds": seconds, "lsq_outer": outer_n, "lsq_inner": inner_n,
            "frames": frame_ids}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
