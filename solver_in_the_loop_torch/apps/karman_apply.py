"""Karman test rollout CLI: recurrent steps with a per-step net correction.

Port of solver_in_the_loop_tpu/apps/karman_apply.py with the same flags plus
`--conv {library,kernel}` (how the net's convolutions run, default library),
`--pressure-precon {fd,none}` (the pressure solve with the FD preconditioner,
default, or plain CG: the port's form of the JAX package's
SILT_PALLAS_FDPCG=0) and `--device {cuda,cpu}` (default cuda). It runs on the
card unless the CPU is asked for, and raises if CUDA is missing instead of
running on the CPU.

    python -m solver_in_the_loop_torch karman-apply -o OUT \
        --model artifacts/a3_k_sol32/model.msgpack \
        --stats artifacts/a3_k_sol32/dataStats.json -r 32 -l 100 -t 500 --re 240000
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
from solver_in_the_loop_torch.core.resample import downsample_centered, downsample_staggered
from solver_in_the_loop_torch.io import scene as scene_io
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import CONV_IMPLS, build_model
from solver_in_the_loop_torch.ops.poisson import PRECONS
from solver_in_the_loop_torch.physics.karman import KarmanFlow, initial_state, karman_domain
from solver_in_the_loop_torch.train import checkpoint as ckpt
from solver_in_the_loop_torch.train.rollout import karman_rollout

log = logging.getLogger(__name__)


def build_parser(parser=None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("karman-apply")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--model", required=True, help="trained checkpoint (flax msgpack)")
    p.add_argument("--stats", required=True, help="dataStats.json from training")
    p.add_argument("--leaky-alpha", type=float, default=None,
                   help="override the LeakyReLU slope (default: the value "
                        "recorded in the stats json; 0.01 if absent)")
    p.add_argument("--arch", default="mars_moon", choices=["mars_moon", "mercury"])
    p.add_argument("-t", "--simsteps", type=int, default=500)
    p.add_argument("-r", "--res", type=int, default=32)
    p.add_argument("--re", type=float, nargs="+", default=[1e6])
    p.add_argument("--initdH", default=None)
    p.add_argument("--initvH", default=None)
    p.add_argument("-d", "-s", "--scale", type=int, default=4, dest="scale")
    p.add_argument("-l", "--len", type=float, default=100.0)
    p.add_argument("--advect", choices=["gather", "shift"], default="shift")
    p.add_argument("--max-shift", type=int, default=2)
    p.add_argument("--no-model", action="store_true", help="pure-solver rollout (source run)")
    p.add_argument("--ptol", type=float, default=1e-5, help="pressure CG tolerance")
    p.add_argument("--pmaxiter", type=int, default=1000, help="pressure CG max iterations")
    p.add_argument("--conv", choices=CONV_IMPLS, default="library",
                   help="the net's convolutions: cuDNN ('library') or the port's "
                        "CUDA kernels ('kernel')")
    add_pressure_precon(p)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the CUDA card)")
    return p


def add_pressure_precon(p: argparse.ArgumentParser) -> None:
    """--pressure-precon, shared by the karman CLIs."""
    p.add_argument("--pressure-precon", choices=list(PRECONS), default="fd",
                   help="the pressure CG's preconditioner: fast diagonalization ('fd', "
                        "default) or none (plain CG, the JAX package's SILT_PALLAS_FDPCG=0); "
                        "a batch above 128 takes 'fd' either way, as the JAX package does")


def resolve_device(name: str) -> torch.device:
    """The requested device; CUDA must be present when it is requested."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    return torch.device(name)


def load_initial(args, dom, batch, device):
    """Initial state: downsampled hi-res frames (--initdH/--initvH), else the
    built-in initial_state."""
    if args.initdH or args.initvH:
        d_hi = scene_io.legacy_to_centered(scene_io.read_array(args.initdH))
        u_hi, v_hi = scene_io.legacy_to_staggered(scene_io.read_array(args.initvH))
        d_lo = downsample_centered(torch.from_numpy(d_hi).float(), args.scale)
        u_lo, v_lo = downsample_staggered(torch.from_numpy(u_hi).float(),
                                          torch.from_numpy(v_hi).float(), args.scale)
        d0 = CenteredGrid(d_lo.expand(dom.centered_shape(batch)).contiguous().to(device), dom)
        v0 = StaggeredGrid(u_lo.expand(dom.u_shape(batch)).contiguous().to(device),
                           v_lo.expand(dom.v_shape(batch)).contiguous().to(device), dom)
        return d0, v0
    return initial_state(dom, batch, device)


def leaky_slope(args, stats) -> float:
    """Explicit --leaky-alpha wins, else the slope recorded at train time
    ("leaky_alpha" in the stats json); absent means 0.01."""
    if args.leaky_alpha is not None:
        return args.leaky_alpha
    return float(stats.get("leaky_alpha", 0.01))


def sol_normalization(stats: dict, device) -> Normalization:
    """The SOL/NON nets' contract: dataStats.json's std.v, std.u, ext.std."""
    return Normalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"], device)


def prepare(args, normalization=sol_normalization):
    """What the rollout takes, on the requested device: (flow, d0, v0, re,
    model or None, norm); `normalization(stats, device)` reads the stats
    json's contract."""
    device = resolve_device(args.device)
    dom = karman_domain(args.res, args.len)
    flow = KarmanFlow(dom, advection=args.advect, max_shift=args.max_shift,
                      pressure_tol=args.ptol, pressure_max_iter=args.pmaxiter,
                      pressure_precon=args.pressure_precon, device=device)
    d0, v0 = load_initial(args, dom, len(args.re), device)

    with open(args.stats) as f:
        stats = json.load(f)
    norm = normalization(stats, device)

    model = None
    if not args.no_model:
        model = build_model(args.arch, leaky_slope=leaky_slope(args, stats), conv=args.conv)
        ckpt.load_model_weights(model, args.model, args.arch)
        model = model.to(device).eval()
        log.info("loaded model %s (%d params)", args.model, ckpt.param_count(model))

    re = torch.tensor(args.re, dtype=torch.float32, device=device)
    return flow, d0, v0, re, model, norm


def run(args, normalization=sol_normalization):
    """Run the rollout and write one scene per Re. Returns the frames (see
    train.rollout.karman_rollout) plus "rollout_seconds", the wall time of the
    rollout alone, synchronized with the device."""
    flow, d0, v0, re, model, norm = prepare(args, normalization)
    device, batch = re.device, len(args.re)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    frames = karman_rollout(flow, d0, v0, re, steps=args.simsteps - 1, model=model, norm=norm)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0

    host = {k: v.cpu().numpy() for k, v in frames.items()}
    d0_np, u0_np, v0_np = (t.cpu().numpy() for t in (d0.values, v0.u, v0.v))
    frame_ids = list(range(1, host["dens"].shape[0] + 1))
    for b in range(batch):
        sc = scene_io.Scene.create(args.output)
        params_out = vars(args).copy()
        params_out["re"] = float(args.re[b])
        sc.write_params(params_out)
        log.info("writing %s (re=%.0f)", sc.path, params_out["re"])
        sc.write_centered("denTf", 0, d0_np[b:b + 1])
        sc.write_staggered("velTf", 0, u0_np[b:b + 1], v0_np[b:b + 1])
        sc.write_staggered("corTf", 0, np.zeros_like(u0_np[b:b + 1]), np.zeros_like(v0_np[b:b + 1]))
        sc.write_centered_batch("denTf", frame_ids, host["dens"][:, b])
        sc.write_staggered_batch("velTf", frame_ids, host["u"][:, b], host["v"][:, b])
        if "corr_u" in host:  # a pure-solver rollout (--no-model) corrects nothing
            cu, cv = host["corr_u"][:, b], host["corr_v"][:, b]
        else:
            cu, cv = np.zeros_like(host["u"][:, b]), np.zeros_like(host["v"][:, b])
        sc.write_staggered_batch("corTf", frame_ids, cu, cv)
    frames["rollout_seconds"] = seconds
    return frames


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
