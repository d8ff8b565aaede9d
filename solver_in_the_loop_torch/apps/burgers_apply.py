"""Burgers test rollout CLI: recurrent steps driven by downsampled hi-res
test forces, with a per-step net correction.

Port of solver_in_the_loop_tpu/apps/burgers_apply.py with the same flags plus
`--conv {library,kernel}` (how the net's convolutions run, default library)
and `--device {cuda,cpu}` (default cuda). The Makefile's
`burgers-fdt-sol04/run_test` for one test sim:

    python -m solver_in_the_loop_torch burgers-apply -o OUT \
        --model artifacts/a3_b_sol04/model.msgpack \
        --stats artifacts/a3_b_sol04/dataStats.json \
        --initvH burgers-fdt-hires-testset/sim_000000/velo_000000.npz \
        --loadfH "burgers-fdt-hires-testset/sim_000000/forc_0*.npz" \
        -d 4 -r 32 -l 32 --dt 0.1 -t 200
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import torch

from solver_in_the_loop_torch.apps.burgers_gen import read_downsampled, read_forces
from solver_in_the_loop_torch.apps.karman_apply import leaky_slope, resolve_device
from solver_in_the_loop_torch.core.grids import StaggeredGrid
from solver_in_the_loop_torch.io.scene import Scene
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import CONV_IMPLS, build_model
from solver_in_the_loop_torch.physics.burgers import BurgersFlow, burgers_domain
from solver_in_the_loop_torch.train import checkpoint as ckpt
from solver_in_the_loop_torch.train.rollout import burgers_rollout

log = logging.getLogger(__name__)


def build_parser(parser=None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("burgers-apply")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--model", required=True, help="trained checkpoint (flax msgpack)")
    p.add_argument("--stats", required=True, help="dataStats.json from training")
    p.add_argument("--leaky-alpha", type=float, default=None,
                   help="override the LeakyReLU slope (default: the value "
                        "recorded in the stats json; 0.01 if absent)")
    p.add_argument("--arch", default="mars_moon", choices=["mars_moon", "mercury"])
    p.add_argument("--noforce", action="store_true")
    p.add_argument("-t", "--simsteps", type=int, default=200)
    p.add_argument("-r", "--res", type=int, default=32)
    p.add_argument("-l", "--len", type=float, default=32.0)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--initvH", required=True, help="hires velocity npz init")
    p.add_argument("--loadfH", default=None, help="glob of hires force npz to replay")
    p.add_argument("-d", "--scale", type=int, default=4)
    p.add_argument("--advect", choices=["gather", "shift"], default="shift")
    p.add_argument("--max-shift", type=int, default=2)
    p.add_argument("--no-model", action="store_true")
    p.add_argument("--conv", choices=CONV_IMPLS, default="library",
                   help="the net's convolutions: cuDNN ('library') or the port's "
                        "CUDA kernels ('kernel')")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the CUDA card)")
    return p


def sol_normalization(stats: dict, device, use_force: bool) -> Normalization:
    """The SOL/NON nets' contract: dataStats.json's std.v, std.u (and with
    the force channels std.fv, std.fu)."""
    if use_force:
        return Normalization.burgers(stats["std.v"], stats["std.u"], stats["std.fv"],
                                     stats["std.fu"], device)
    std = torch.tensor([stats["std.v"], stats["std.u"]], dtype=torch.float32, device=device)
    return Normalization(std, std)


def prepare(args, normalization=sol_normalization):
    """What the rollout takes, on the requested device: (rollout_replay, v0,
    fu, fv); `normalization(stats, device, use_force)` reads the stats
    json's contract."""
    device = resolve_device(args.device)
    dom = burgers_domain(args.res, args.len)
    flow = BurgersFlow(dom, advection=args.advect, max_shift=args.max_shift)
    v0 = StaggeredGrid(*read_downsampled(args.initvH, args.scale, device), dom)

    steps = args.simsteps - 1
    use_force = not args.noforce
    if use_force:
        fu, fv = read_forces(args.loadfH, steps, args.scale, device)
        if fu.shape[0] < steps:
            raise ValueError(f"need {steps} force frames, got {fu.shape[0]}")
    else:
        fu = torch.zeros((steps,) + dom.u_shape(1), device=device)
        fv = torch.zeros((steps,) + dom.v_shape(1), device=device)

    with open(args.stats) as f:
        stats = json.load(f)
    norm = normalization(stats, device, use_force)

    model = None
    if not args.no_model:
        model = build_model(args.arch, in_channels=4 if use_force else 2,
                            leaky_slope=leaky_slope(args, stats), conv=args.conv)
        ckpt.load_model_weights(model, args.model, args.arch)
        model = model.to(device).eval()
        log.info("loaded model %s (%d params, conv %s)", args.model, ckpt.param_count(model),
                 args.conv)
    _, rollout_replay = burgers_rollout(flow, steps=steps, model=model, norm=norm, dt=args.dt,
                                        use_force_features=use_force)
    return rollout_replay, v0, fu, fv


def run(args, normalization=sol_normalization):
    """Run the rollout and write its scene. Returns the frames ((T, 1, ...)
    "u", "v") plus "rollout_seconds", the wall time of the rollout alone,
    synchronized with the device."""
    rollout_replay, v0, fu, fv = prepare(args, normalization)
    device = v0.u.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    frames = rollout_replay(v0, fu, fv)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0

    sc = Scene.create(args.output)
    sc.write_params(vars(args).copy())
    log.info("writing %s", sc.path)
    sc.write_staggered("velTf", 0, v0.u.cpu().numpy(), v0.v.cpu().numpy())
    uu, vv = frames["u"].cpu().numpy(), frames["v"].cpu().numpy()
    sc.write_staggered_batch("velTf", range(1, uu.shape[0] + 1), uu[:, 0], vv[:, 0])
    frames["rollout_seconds"] = seconds
    return frames


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
