"""Burgers data generation: forced viscous sims with random sine forces.

Port of solver_in_the_loop_tpu/apps/burgers_gen.py with the same flags plus
`--device {cuda,cpu}` (default cuda). The Makefile's hi-res training set
(`burgers-fdt-hires-set`) is ten of

    python -m solver_in_the_loop_torch burgers-gen -o burgers-fdt-hires-set \
        -r 128 -l 32 --dt 0.1 -s 30 -t 200 --seed i

The forces advance in closed form (phase(t) = phase0 + t*dt*omega), or are
replayed from hi-res force frames (`--loadfH`); loop step i (1-based) writes
frame i - skipsteps once i >= skipsteps, on the frame writer's thread pool
(io/npz_pool.py). `--thumb` writes a PNG of every written frame's velU, velV,
frcU and frcV (x 100000) to <output>/thumb/sim_%06d/ (io/thumbs.py).
"""

from __future__ import annotations

import argparse
import glob as _glob
import logging
import os

import numpy as np
import torch

from solver_in_the_loop_torch.apps.karman_apply import resolve_device
from solver_in_the_loop_torch.core.grids import StaggeredGrid
from solver_in_the_loop_torch.core.random_fields import randfreq_staggered
from solver_in_the_loop_torch.core.resample import downsample_staggered
from solver_in_the_loop_torch.io import scene as scene_io
from solver_in_the_loop_torch.io import thumbs
from solver_in_the_loop_torch.io.scene import Scene
from solver_in_the_loop_torch.physics.burgers import (
    BurgersFlow,
    burgers_domain,
    random_forces,
    sample_force_sum,
)
from solver_in_the_loop_torch.train.rollout import burgers_rollout

log = logging.getLogger(__name__)


def build_parser(parser=None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("burgers-gen")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--thumb", action="store_true")
    p.add_argument("--noforce", action="store_true")
    p.add_argument("-s", "--skipsteps", type=int, default=0)
    p.add_argument("-t", "--simsteps", type=int, default=200)
    p.add_argument("-r", "--res", type=int, default=32)
    p.add_argument("-l", "--len", type=float, default=32.0)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--initvH", default=None)
    p.add_argument("--loadfH", default=None, help="glob of hires force npz files to replay")
    p.add_argument("-d", "--scale", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-forces", type=int, default=20)
    p.add_argument("--advect", choices=["gather", "shift"], default="gather")
    p.add_argument("--max-shift", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the CUDA card)")
    return p


def read_downsampled(path: str, scale: int, device):
    """A legacy hi-res staggered frame, downsampled by `scale`, as (u, v)
    float32 tensors on `device` (batch 1)."""
    u_hi, v_hi = scene_io.legacy_to_staggered(scene_io.read_array(path))
    u_lo, v_lo = downsample_staggered(torch.from_numpy(u_hi).float(),
                                      torch.from_numpy(v_hi).float(), scale)
    return u_lo.to(device), v_lo.to(device)


def read_forces(pattern: str, count: int, scale: int, device):
    """The first `count` force frames matching `pattern` (sorted),
    downsampled: fu (T, 1, Y, X+1), fv (T, 1, Y+1, X)."""
    files = sorted(_glob.glob(pattern))[:count]
    if not files:
        raise ValueError(f"no force frames match {pattern!r}")
    fus, fvs = zip(*(read_downsampled(fp, scale, device) for fp in files))
    return torch.stack(fus), torch.stack(fvs)


def run(args):
    """Generate one scene; returns it."""
    device = resolve_device(args.device)
    rng = np.random.RandomState(args.seed)
    dom = burgers_domain(args.res, args.len)
    flow = BurgersFlow(dom, advection=args.advect, max_shift=args.max_shift)

    # the reference's call order: forces first, then the initial field
    forces = [] if args.noforce else random_forces(rng, args.num_forces, device=device)
    v0 = randfreq_staggered(rng, dom, batch=1, device=device)
    if args.initvH:
        v0 = StaggeredGrid(*read_downsampled(args.initvH, args.scale, device), dom)

    total_steps = args.simsteps + args.skipsteps - 1
    rollout_analytic, rollout_replay = burgers_rollout(flow, steps=total_steps, dt=args.dt)
    if args.loadfH and _glob.glob(args.loadfH):
        fu, fv = read_forces(args.loadfH, total_steps, args.scale, device)
        frames = {**rollout_replay(v0, fu, fv), "fu": fu, "fv": fv}
        f0 = StaggeredGrid(fu[0], fv[0], dom)
    elif args.noforce:
        fu = torch.zeros((total_steps,) + dom.u_shape(1), device=device)
        fv = torch.zeros((total_steps,) + dom.v_shape(1), device=device)
        frames = {**rollout_replay(v0, fu, fv), "fu": fu, "fv": fv}
        f0 = dom.staggered_grid(0.0, 0.0, device=device)
    else:
        frames = rollout_analytic(v0, forces)
        f0 = sample_force_sum(forces, dom, device=device)

    uu, vv, fu, fv = (frames[k].cpu().numpy() for k in ("u", "v", "fu", "fv"))
    start = [t[0].cpu().numpy() for t in (v0.u, v0.v, f0.u, f0.v)]  # frame 0's u, v, fu, fv
    sc = Scene.create(args.output)
    sc.write_params(vars(args).copy())
    with scene_io.scene_run_log(sc.path):
        log.info("params: %s", vars(args))
        log.info("writing %s", sc.path)
        if args.skipsteps == 0:
            sc.write_staggered("velo", 0, start[0][None], start[1][None])
            sc.write_staggered("forc", 0, start[2][None], start[3][None])
        keep = [t for t in range(uu.shape[0]) if t + 1 >= max(args.skipsteps, 1)]
        frame_ids = [t + 1 - args.skipsteps for t in keep]
        sc.write_staggered_batch("velo", frame_ids, uu[keep, 0], vv[keep, 0])
        sc.write_staggered_batch("forc", frame_ids, fu[keep, 0], fv[keep, 0])
        if args.thumb:
            kept = [(0, *start)] if args.skipsteps == 0 else []
            kept += [(f, uu[t, 0], vv[t, 0], fu[t, 0], fv[t, 0]) for t, f in zip(keep, frame_ids)]
            td = thumbs.thumb_dir_for(sc.path)
            thumbs.save_thumbs((field, 100000.0, os.path.join(td, f"{name}_{f:06d}.png"))
                               for f, *fields in kept
                               for name, field in zip(("velU", "velV", "frcU", "frcV"), fields))
    return sc


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
