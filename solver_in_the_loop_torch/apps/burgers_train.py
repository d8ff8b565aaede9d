"""Burgers SOL/NON training CLI.

Port of solver_in_the_loop_tpu/apps/burgers_train.py with the same flags plus
`--conv {library,kernel}` (how the net's convolutions run, default library)
and `--device {cuda,cpu}` (default cuda). The SOL-04 run of the repo's
Makefile (`burgers-fdt-sol04`; `burgers-fdt-non` is the same with -m 1):

    python -m solver_in_the_loop_torch burgers-train --train burgers-fdt-hires-set \
        --tf OUT/tf --log OUT/tf/run.log --epochs 100 --lr 0.0001 \
        --dt 0.1 -t 200 -s 4 -m 4 -n 10 -b 5 --seed 0

It writes OUT/tf/dataStats.json at the start, model_epoch%04d.msgpack (the
parameters and the optimizer state) after the first epoch and every 10
epochs, and model.msgpack at the end, in the JAX package's format. The
flags --resume, --inittf, --pretf, --bf16, --profile and --debug-nans work
as karman-train's (a --pretf net's in.std and out.std become the features'
and output's scales, their first two channels without the force), and so
does `--dp`: the batch sharded over the ranks of a process group, started
by `python -m torch.distributed.run --nproc-per-node N -m
solver_in_the_loop_torch burgers-train --dp ...`.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from solver_in_the_loop_torch.apps.karman_train import (
    is_main,
    load_on_ranks,
    prepare,
    run_context,
    train,
)
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import CONV_IMPLS
from solver_in_the_loop_torch.physics.burgers import BurgersFlow, burgers_domain
from solver_in_the_loop_torch.train import checkpoint as ckpt
from solver_in_the_loop_torch.train.dataset import load_burgers_dataset
from solver_in_the_loop_torch.train.trainer import SolTrainConfig, make_burgers_train_step
from solver_in_the_loop_torch.utils.metrics import setup_logging

log = logging.getLogger(__name__)


def build_parser(parser=None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("burgers-train")
    p.add_argument("--train", required=True, help="hires training scene set")
    p.add_argument("--skip-ds", action="store_true",
                   help="read the downsampled ds_ frames already beside the hi-res ones")
    p.add_argument("--only-ds", action="store_true", help="downsample, then stop")
    p.add_argument("--log", default=None)
    p.add_argument("--noforce", action="store_true")
    p.add_argument("-s", "--scale", type=int, default=4)
    p.add_argument("-n", "--nsims", type=int, default=1)
    p.add_argument("-b", "--sbatch", type=int, default=1)
    p.add_argument("-t", "--simsteps", type=int, default=200, help="frames per sim")
    p.add_argument("-m", "--msteps", type=int, default=2)
    p.add_argument("-e", "--epochs", type=int, default=10)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-l", "--len", type=float, default=32.0)
    p.add_argument("--model", default="mars_moon", choices=["mars_moon", "mercury"])
    p.add_argument("--init", choices=["zero", "reference"], default="reference",
                   help="'reference': glorot_uniform on every conv (needs --clip-grad, "
                        "on by default); 'zero': lecun_normal hidden convs, zero head")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--adplr", action="store_true")
    p.add_argument("--clip-grad", action=argparse.BooleanOptionalAction, default=True,
                   help="per-tensor grad-norm clip at 0.001 (reference karman_train.py:453)")
    p.add_argument("--warmup-epochs", type=int, default=0,
                   help="run the first N epochs at lr/10 (0, the default, disables)")
    p.add_argument("--resume", type=int, default=-1,
                   help="resume from model_epoch%%04d.msgpack of --tf at this epoch")
    p.add_argument("--inittf", default=None, help="warm-start checkpoint (msgpack)")
    p.add_argument("--pretf", default=None, help="supervised pre-trained checkpoint")
    p.add_argument("--tf", default=os.path.join(tempfile.gettempdir(), "silt", "tf"),
                   help="output dir (models, logs)")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--remat-policy", choices=["pressure", "pressure+conv", "pressure+advect", "none"],
                   default="pressure+conv",
                   help="what the per-step checkpoint saves (Burgers has no pressure "
                        "solve; 'none' runs as 'pressure')")
    p.add_argument("--advect", choices=["gather", "shift"], default="shift")
    p.add_argument("--max-shift", type=int, default=2)
    p.add_argument("--leaky-alpha", type=float, default=0.3,
                   help="LeakyReLU negative slope (Keras default 0.3)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 network compute")
    p.add_argument("--dp", action="store_true",
                   help="shard the batch over the ranks of the process group "
                        "(python -m torch.distributed.run starts them)")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace of one step to this dir")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the first NaN")
    p.add_argument("--conv", choices=CONV_IMPLS, default="library",
                   help="the net's convolutions: cuDNN ('library') or the port's "
                        "CUDA kernels ('kernel')")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the CUDA card)")
    return p


def run(args):
    """Train and write the checkpoints; returns the TrainResult (None with
    --only-ds)."""
    with run_context(args) as (device, mesh):
        return _run(args, device, mesh)


def _run(args, device, mesh):
    setup_logging(args.log if is_main(mesh) else None, args.resume)
    if args.nsims % args.sbatch != 0:
        args.nsims = (args.nsims // args.sbatch) * args.sbatch
        log.info("nsims adjusted to %d (batch size divisibility)", args.nsims)
    log.info("params: %s", vars(args))

    data_np = load_on_ranks(mesh, lambda skip: load_burgers_dataset(
        args.train, num_frames=args.simsteps, num_sims=args.nsims, scale=args.scale,
        skip_preprocessing=skip), args.skip_ds)
    if args.only_ds:
        return None

    stats = dict(data_np.stats)
    if args.resume > 0:
        stats = ckpt.load_stats(args.tf)
        # resume with the slope the run was started with (absent: the old 0.01)
        args.leaky_alpha = stats.get("leaky_alpha", 0.01)
    if args.pretf is not None:
        ckpt.adopt_pretf_stats(stats, args, log)
    use_force = not args.noforce
    if "in.std" in stats:
        # the supervised-init contract: the PRE net's scales
        def t(values):
            return torch.tensor(values, dtype=torch.float32, device=device)

        norm = Normalization(t(stats["in.std"][:4 if use_force else 2]), t(stats["out.std"][:2]))
    elif use_force:
        norm = Normalization.burgers(stats["std.v"], stats["std.u"], stats["std.fv"],
                                     stats["std.fu"], device)
    else:
        std = torch.tensor([stats["std.v"], stats["std.u"]], dtype=torch.float32, device=device)
        norm = Normalization(std, std)
    res_y, res_x = data_np.resolution
    if res_y != res_x:
        raise ValueError(f"Burgers frames must be square, got {(res_y, res_x)}")
    flow = BurgersFlow(burgers_domain(res_x, args.len), advection=args.advect,
                       max_shift=args.max_shift)
    if args.remat_policy == "none":
        log.info("--remat-policy none: running as 'pressure'")
        args.remat_policy = "pressure"
    cfg = SolTrainConfig(
        msteps=args.msteps, lr=args.lr, epochs=args.epochs, adplr=args.adplr,
        clip_grad=args.clip_grad, remat=not args.no_remat, remat_policy=args.remat_policy,
        warmup_epochs=args.warmup_epochs, debug_nans=args.debug_nans)
    stats["leaky_alpha"] = args.leaky_alpha  # the apply CLIs rebuild the net with it
    model, optimizer = prepare(args, stats, device, 4 if use_force else 2, cfg, mesh)
    train_step = make_burgers_train_step(flow, model, optimizer, cfg, dt=args.dt,
                                         use_force=use_force)
    # Burgers also keeps epoch 1
    return train(args, train_step, optimizer, model, data_np.to_device(device), norm, cfg,
                 lambda epoch: epoch == 0 or epoch % 10 == 9, mesh)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
