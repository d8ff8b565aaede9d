"""Karman data generation: hi-res reference sims and lo-res source sims.

Port of solver_in_the_loop_tpu/apps/karman_gen.py with the same flags plus
`--pressure-precon {fd,none}` (as karman-apply's) and `--device {cuda,cpu}`
(default cuda). The Makefile's hi-res training set (`karman-fdt-hires-set`) is

    python -m solver_in_the_loop_torch karman-gen -o karman-fdt-hires-set \
        -r 128 -l 100 --seed 0 --re 160000 320000 640000 1280000 2560000 5120000

`--re` takes several values, which run batched in one rollout. The first
`--skipsteps` steps run and are not kept; frames skipsteps+1 .. simsteps-1 are
written, and frame 0 too with `-s 0`, on the frame writer's thread pool
(io/npz_pool.py). At 256x128 the pressure solve takes multigrid
(ops/multigrid.py), at 64x32 the fused CG kernel. `--seed` is accepted for
the Makefile's commands: nothing here is random. `--thumb` writes a PNG of
every written frame's dens, velU and velV (x 10000) to
<output>/thumb/sim_%06d/ (io/thumbs.py).
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from solver_in_the_loop_torch.apps.karman_apply import (
    add_pressure_precon,
    load_initial,
    resolve_device,
)
from solver_in_the_loop_torch.io import scene as scene_io
from solver_in_the_loop_torch.io import thumbs
from solver_in_the_loop_torch.io.scene import Scene
from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
from solver_in_the_loop_torch.train.rollout import karman_rollout

log = logging.getLogger(__name__)


def build_parser(parser=None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("karman-gen")
    p.add_argument("-o", "--output", required=True, help="output parent directory")
    p.add_argument("--thumb", action="store_true", help="save thumbnail images")
    p.add_argument("-t", "--simsteps", type=int, default=1500)
    p.add_argument("-s", "--skipsteps", type=int, default=999)
    p.add_argument("-r", "--res", type=int, default=32)
    p.add_argument("--re", type=float, nargs="+", default=[1e6],
                   help="Reynolds number(s); multiple values run batched")
    p.add_argument("--initdH", default=None, help="hires density npz to downsample as init")
    p.add_argument("--initvH", default=None, help="hires velocity npz to downsample as init")
    p.add_argument("-d", "--scale", type=int, default=4)
    p.add_argument("-l", "--len", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--advect", choices=["gather", "shift"], default="gather")
    p.add_argument("--max-shift", type=int, default=4)
    add_pressure_precon(p)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the CUDA card)")
    return p


def run(args):
    """Generate one scene per Re. Returns the rollout's frames (see
    train.rollout.karman_rollout) plus "route", the pressure solver it ran
    (ops/poisson.py `pressure_route`), "rollout_seconds", the wall time of
    the rollout alone, synchronized with the device, "write_seconds", the
    frames' and thumbnails' writes, and "thumbs", the PNGs written."""
    if bool(args.initdH) != bool(args.initvH):
        raise ValueError("provide both --initdH and --initvH")
    if args.skipsteps >= args.simsteps - 1:
        raise ValueError(f"-s {args.skipsteps} leaves no frame of -t {args.simsteps} to write")
    alpha = args.res * args.res / min(args.re)  # dt = 1
    if alpha > 0.25:
        raise ValueError(f"explicit diffusion unstable: alpha={alpha:.4f} > 0.25 for "
                         f"res={args.res}, min Re={min(args.re)}")
    device = resolve_device(args.device)
    dom = karman_domain(args.res, args.len)
    flow = KarmanFlow(dom, advection=args.advect, max_shift=args.max_shift,
                      pressure_precon=args.pressure_precon, device=device)
    batch = len(args.re)
    d0, v0 = load_initial(args, dom, batch, device)
    re = torch.tensor(args.re, dtype=torch.float32, device=device)
    route = flow.pressure_route(batch)

    steps = args.simsteps - 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    frames = karman_rollout(flow, d0, v0, re, steps=steps, collect_from=args.skipsteps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    iters = frames["cg_iters"].cpu().numpy()
    log.info("rollout done: %d steps x %d sims in %.3f s (%.5f s/step); pressure solve %s, "
             "iterations p50 %d, max %d over the %d kept steps", steps, batch, seconds,
             seconds / steps, route, int(np.median(iters)), int(iters.max()), len(iters))

    t0 = time.perf_counter()
    dens, uu, vv = (frames[k].cpu().numpy() for k in ("dens", "u", "v"))
    d0_np, u0_np, v0_np = (t.cpu().numpy() for t in (d0.values, v0.u, v0.v))
    frame_ids = [args.skipsteps + 1 + t for t in range(dens.shape[0])]
    thumb_items = []
    for b in range(batch):
        sc = Scene.create(args.output)
        params = vars(args).copy()
        params["re"] = float(args.re[b])
        sc.write_params(params)
        with scene_io.scene_run_log(sc.path):
            log.info("params: %s", params)
            log.info("writing %s (re=%.0f)", sc.path, params["re"])
            if args.skipsteps == 0:
                sc.write_centered("dens", 0, d0_np[b:b + 1])
                sc.write_staggered("velo", 0, u0_np[b:b + 1], v0_np[b:b + 1])
            sc.write_centered_batch("dens", frame_ids, dens[:, b])
            sc.write_staggered_batch("velo", frame_ids, uu[:, b], vv[:, b])
            if args.thumb:
                td = thumbs.thumb_dir_for(sc.path)
                kept = [(0, d0_np[b], u0_np[b], v0_np[b])] if args.skipsteps == 0 else []
                kept += [(f, dens[t, b], uu[t, b], vv[t, b]) for t, f in enumerate(frame_ids)]
                thumb_items += [(field, 10000.0, os.path.join(td, f"{name}_{f:06d}.png"))
                                for f, *fields in kept
                                for name, field in zip(("dens", "velU", "velV"), fields)]
            log.info("done %s", sc.path)
    n_thumbs = thumbs.save_thumbs(thumb_items)
    write_seconds = time.perf_counter() - t0
    log.info("wrote %d scenes of %d frames and %d thumbnails in %.3f s", batch,
             len(frame_ids) + (args.skipsteps == 0), n_thumbs, write_seconds)
    frames.update(route=route, rollout_seconds=seconds, write_seconds=write_seconds,
                  thumbs=n_thumbs)
    return frames


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
