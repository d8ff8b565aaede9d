"""Burgers PRE data generation: a hi-res and a corrected lo-res sim in
lockstep, the forces replayed from a recorded hi-res sim.

Port of solver_in_the_loop_tpu/apps/burgers_pre_gen.py with the same flags
plus `--device {cuda,cpu}` (default cuda). The Makefile's PRE set
(`burgers-fdt-pre-set`) is, for each sim of the hi-res training set,

    python -m solver_in_the_loop_torch burgers-pre-gen -o burgers-fdt-pre-set \
        -r 32 -l 32 --dt 0.1 -t 200 --beta 1.0 \
        --initvH burgers-fdt-hires-set/sim_000000/velo_000000.npz \
        --loadfH "burgers-fdt-hires-set/sim_000000/forc_0*.npz"

Each frame i = 1 .. simsteps-1: a forced hi-res step and a forced lo-res
step (force i-1, 4x downsampled for the lo-res), then the unconstrained
regularised least-squares correction of v_hi - upsample4x(v_lo)
(pre/lsq.py, beta / dt); lo state += correction. Every frame's veloH,
veloC, velo (the model input), corr (the label), forcH and forc (force i)
are written at the end on the frame writer's thread pool (io/npz_pool.py);
`--thumb` writes velUC, velVC, corUC and corVC (x 100000).
"""

from __future__ import annotations

import argparse
import glob as _glob
import logging
import os
import time

import numpy as np
import torch

from solver_in_the_loop_torch.apps.burgers_gen import read_downsampled
from solver_in_the_loop_torch.apps.karman_apply import resolve_device
from solver_in_the_loop_torch.core.grids import StaggeredGrid
from solver_in_the_loop_torch.core.random_fields import randfreq_staggered
from solver_in_the_loop_torch.core.resample import downsample_staggered, upsample_staggered
from solver_in_the_loop_torch.io import npz_pool, thumbs
from solver_in_the_loop_torch.io import scene as scene_io
from solver_in_the_loop_torch.io.scene import Scene
from solver_in_the_loop_torch.physics.burgers import BurgersFlow, burgers_domain
from solver_in_the_loop_torch.pre.lsq import build_pre_geometry, solve_correction

log = logging.getLogger(__name__)


def build_parser(parser=None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("burgers-pre-gen")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--thumb", action="store_true")
    p.add_argument("-t", "--simsteps", type=int, default=200)
    p.add_argument("-r", "--res", type=int, default=32)
    p.add_argument("-l", "--len", type=float, default=32.0)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--initvH", default=None, help="hires velocity npz init")
    p.add_argument("--loadfH", required=True, help="glob of hires force npz files")
    p.add_argument("--advect", choices=["gather", "shift"], default="gather")
    p.add_argument("--max-shift", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the CUDA card)")
    return p


def run(args):
    """Generate the scene. Returns a dict: "scene", "seconds" ("rollout",
    "write"), "lsq_outer" (the correction solve's iterations per frame)."""
    device = resolve_device(args.device)
    rng = np.random.RandomState(args.seed)
    dom_lo = burgers_domain(args.res, args.len)
    dom_hi = burgers_domain(args.res * args.scale, args.len)
    flow_lo = BurgersFlow(dom_lo, advection=args.advect, max_shift=args.max_shift)
    flow_hi = BurgersFlow(dom_hi, advection=args.advect, max_shift=args.max_shift)
    geom = build_pre_geometry(dom_lo, dom_hi, args.scale, bnd=2)

    fc_files = sorted(_glob.glob(args.loadfH))
    if len(fc_files) < args.simsteps:
        raise ValueError(f"{args.loadfH!r} matches {len(fc_files)} force frames; -t "
                         f"{args.simsteps} needs {args.simsteps}")
    if args.initvH:
        v_hi = StaggeredGrid(*read_downsampled(args.initvH, 1, device), dom_hi)
    else:
        v_hi = randfreq_staggered(rng, dom_hi, 1, device=device)
    v_co = StaggeredGrid(*downsample_staggered(v_hi.u, v_hi.v, args.scale), dom_lo)

    # every hi-res force frame (1, Y, X+1), (1, Y+1, X), and its downsampling
    forces = [scene_io.legacy_to_staggered(a[None] if a.ndim < 4 else a)
              for a in npz_pool.read_npz_batch(fc_files[:args.simsteps])]
    f_hi = [StaggeredGrid(torch.from_numpy(u).to(device), torch.from_numpy(v).to(device), dom_hi)
            for u, v in forces]
    f_co = [StaggeredGrid(*downsample_staggered(f.u, f.v, args.scale), dom_lo) for f in f_hi]

    sc = Scene.create(args.output)
    sc.write_params(vars(args).copy())
    corr_u = torch.zeros(dom_lo.u_shape(1), device=device)
    corr_v = torch.zeros(dom_lo.v_shape(1), device=device)
    names = ("veloH", "veloC", "velo", "corr", "forcH", "forc")
    kept = {k: [] for k in names}
    outer = []
    with scene_io.scene_run_log(sc.path), torch.no_grad():
        log.info("params: %s", vars(args))
        log.info("writing %s", sc.path)
        t0 = time.perf_counter()
        for i in range(1, args.simsteps):
            v_hi = flow_hi.step_with_f(v_hi, f_hi[i - 1], dt=args.dt)
            v_co_base = flow_lo.step_with_f(v_co, f_co[i - 1], dt=args.dt)
            up_u, up_v = upsample_staggered(v_co_base.u, v_co_base.v, args.scale)
            corr_u, corr_v, its = solve_correction(geom, v_hi.u - up_u, v_hi.v - up_v, corr_u,
                                                   corr_v, beta=args.beta / args.dt,
                                                   constrained=False)
            v_co = StaggeredGrid(v_co_base.u + corr_u, v_co_base.v + corr_v, dom_lo)
            outer.append(its["outer"])
            if i % 25 == 0 or i == 1:
                log.info("step %06d |corr|max=%.5f lsq iterations %d", i,
                         float(corr_u.abs().max()), int(its["outer"]))
            for name, g in zip(names, (v_hi, v_co, v_co_base,
                                       StaggeredGrid(corr_u, corr_v, dom_lo), f_hi[i], f_co[i])):
                kept[name].append((g.u[0].cpu().numpy(), g.v[0].cpu().numpy()))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        frame_ids = list(range(1, args.simsteps))
        for name, frames in kept.items():
            if frames:
                sc.write_staggered_batch(name, frame_ids, np.stack([f[0] for f in frames]),
                                         np.stack([f[1] for f in frames]))
        if args.thumb:
            td = thumbs.thumb_dir_for(sc.path)
            thumbs.save_thumbs(
                (field, 100000.0, os.path.join(td, f"{n}_{i:06d}.png"))
                for i, (vc, cr) in zip(frame_ids, zip(kept["veloC"], kept["corr"]))
                for n, field in zip(("velUC", "velVC", "corUC", "corVC"), vc + cr))
        seconds = {"rollout": t1 - t0, "write": time.perf_counter() - t1}
        outer_n = torch.stack(outer).cpu().numpy() if outer else np.zeros(0, int)
        log.info("%d frames in %.3f s (%.4f s/frame); lsq iterations per frame mean %.1f max "
                 "%d", len(frame_ids), seconds["rollout"],
                 seconds["rollout"] / max(len(frame_ids), 1),
                 outer_n.mean() if len(outer_n) else 0, outer_n.max(initial=0))
    return {"scene": sc.path, "seconds": seconds, "lsq_outer": outer_n}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
