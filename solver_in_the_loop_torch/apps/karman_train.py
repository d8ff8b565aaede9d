"""Karman SOL/NON training CLI.

Port of solver_in_the_loop_tpu/apps/karman_train.py with the same flags plus
`--device {cuda,cpu}` (default cuda): it runs on the card unless the CPU is
asked for, and raises if CUDA is missing instead of running on the CPU. The
SOL-32 run of the repo's Makefile (`karman-fdt-sol32`):

    python -m solver_in_the_loop_torch karman-train --train karman-fdt-hires-set \
        --tf OUT/tf --log OUT/tf/run.log --epochs 100 --lr 0.0001 \
        -l 100 -t 500 -s 4 -m 32 -n 6 -b 3 --seed 0

It writes OUT/tf/dataStats.json at the start, model_epoch%04d.msgpack every
10 epochs and model.msgpack at the end, in the JAX package's format. Flags
of the JAX CLI that this port does not implement yet raise
NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from solver_in_the_loop_torch.apps.karman_apply import resolve_device
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
from solver_in_the_loop_torch.train import checkpoint as ckpt
from solver_in_the_loop_torch.train.dataset import EpochSchedule, load_karman_dataset
from solver_in_the_loop_torch.train.trainer import (
    SolTrainConfig,
    make_karman_train_step,
    make_optimizer,
    run_training,
)
from solver_in_the_loop_torch.utils.metrics import MetricsWriter, setup_logging

log = logging.getLogger(__name__)

# flags of the JAX CLI left out of this port, with the ROADMAP.md item that
# ports them; each raises NotImplementedError when given
NOT_PORTED = {
    "resume": "A1 (resume with the optimizer state)",
    "inittf": "A1 (--inittf warm start)",
    "pretf": "A5 (PRE: --pretf supervised init)",
    "dp": "A6 (data parallelism)",
    "bf16": "A1 (--bf16 network compute)",
    "profile": "A1 (--profile trace)",
    "debug_nans": "A1 (--debug-nans)",
    "reg_loss": "A1 (--reg-loss)",
}


def build_parser(parser=None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("karman-train")
    p.add_argument("--train", required=True, help="hires training scene set")
    p.add_argument("--skip-ds", action="store_true",
                   help="read the downsampled ds_ frames already beside the hi-res ones")
    p.add_argument("--only-ds", action="store_true", help="downsample, then stop")
    p.add_argument("--log", default=None)
    p.add_argument("-s", "--scale", type=int, default=4)
    p.add_argument("-n", "--nsims", type=int, default=1)
    p.add_argument("-b", "--sbatch", type=int, default=1)
    p.add_argument("-t", "--simsteps", type=int, default=1500, help="frames per sim")
    p.add_argument("-m", "--msteps", type=int, default=2)
    p.add_argument("-e", "--epochs", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-l", "--len", type=float, default=100.0)
    p.add_argument("--model", default="mars_moon", choices=["mars_moon", "mercury"])
    p.add_argument("--init", choices=["zero", "reference"], default="reference",
                   help="'reference': glorot_uniform on every conv (needs --clip-grad, "
                        "on by default); 'zero': lecun_normal hidden convs, zero head")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--reg-loss", action="store_true")
    p.add_argument("--adplr", action="store_true")
    p.add_argument("--clip-grad", action=argparse.BooleanOptionalAction, default=True,
                   help="per-tensor grad-norm clip at 0.001 (reference karman_train.py:453)")
    p.add_argument("--warmup-epochs", type=int, default=1,
                   help="run the first N epochs at lr/10 (0 disables)")
    p.add_argument("--resume", type=int, default=-1)
    p.add_argument("--inittf", default=None)
    p.add_argument("--pretf", default=None)
    p.add_argument("--tf", default=os.path.join(tempfile.gettempdir(), "silt", "tf"),
                   help="output dir (models, logs)")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--remat-policy", choices=["pressure", "pressure+conv", "pressure+advect", "none"],
                   default="pressure+conv",
                   help="what the per-step checkpoint saves; 'none' saves the solve like "
                        "'pressure' (the JAX package's 'none' recomputes it)")
    p.add_argument("--advect", choices=["gather", "shift"], default="shift")
    p.add_argument("--max-shift", type=int, default=2)
    p.add_argument("--leaky-alpha", type=float, default=0.3,
                   help="LeakyReLU negative slope (Keras default 0.3)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--dp", action="store_true")
    p.add_argument("--ptol", type=float, default=1e-5, help="pressure CG tolerance")
    p.add_argument("--pmaxiter", type=int, default=1000, help="pressure CG max iterations")
    p.add_argument("--profile", default=None)
    p.add_argument("--debug-nans", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the CUDA card)")
    return p


def _refuse_not_ported(args) -> None:
    for flag, item in NOT_PORTED.items():
        value = getattr(args, flag)
        if (value > 0) if flag == "resume" else value:  # --resume N resumes for N > 0
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported to the PyTorch trainer yet "
                f"(ROADMAP.md {item})")


def run(args):
    """Train and write the checkpoints; returns the TrainResult (None with
    --only-ds)."""
    _refuse_not_ported(args)
    device = resolve_device(args.device)
    setup_logging(args.log, args.resume)
    if args.nsims % args.sbatch != 0:
        args.nsims = (args.nsims // args.sbatch) * args.sbatch
        log.info("nsims adjusted to %d (batch size divisibility)", args.nsims)
    log.info("params: %s", vars(args))

    data_np = load_karman_dataset(args.train, num_frames=args.simsteps, num_sims=args.nsims,
                                  scale=args.scale, skip_preprocessing=args.skip_ds)
    if args.only_ds:
        return None

    stats = dict(data_np.stats)
    norm = Normalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"], device)
    res_y, res_x = data_np.resolution
    dom = karman_domain(res_x, args.len)
    if dom.resolution != (res_y, res_x):
        raise ValueError(f"frames of {(res_y, res_x)} are not a karman domain "
                         f"({dom.resolution} for x resolution {res_x})")
    flow = KarmanFlow(dom, advection=args.advect, max_shift=args.max_shift,
                      pressure_tol=args.ptol, pressure_max_iter=args.pmaxiter, device=device)
    if args.remat_policy == "none":
        log.info("--remat-policy none: saving the pressure solve as 'pressure' does; the "
                 "port never re-runs a solve in the backward pass")
        args.remat_policy = "pressure"
    cfg = SolTrainConfig(
        msteps=args.msteps, lr=args.lr, epochs=args.epochs, adplr=args.adplr,
        clip_grad=args.clip_grad, remat=not args.no_remat, remat_policy=args.remat_policy,
        warmup_epochs=args.warmup_epochs)
    stats["leaky_alpha"] = args.leaky_alpha  # the apply CLIs rebuild the net with it
    model = build_model(args.model, leaky_slope=args.leaky_alpha, init=args.init,
                        generator=torch.Generator().manual_seed(args.seed)).to(device)
    log.info("model %s: %d params", args.model, ckpt.param_count(model))
    optimizer = make_optimizer(model, cfg)
    ckpt.save_stats(args.tf, stats)

    train_step = make_karman_train_step(flow, model, optimizer, cfg)
    schedule = EpochSchedule(args.nsims, args.simsteps, args.sbatch, seed=args.seed)
    writer = MetricsWriter(args.tf)

    def on_epoch_end(epoch):
        if epoch % 10 == 9:
            ckpt.save_checkpoint(args.tf, model, args.model, epoch=epoch + 1)

    try:
        result = run_training(train_step, optimizer, data_np.to_device(device), norm, schedule,
                              cfg, on_epoch_end=on_epoch_end, metrics_writer=writer)
    finally:
        writer.close()
    ckpt.save_checkpoint(args.tf, model, args.model)
    log.info("final loss %.6f; %.4f sec/iter (best epoch), %.4f (median epoch); "
             "%d non-finite update(s) skipped", result.losses[-1], result.sec_per_iter,
             result.sec_per_iter_median, result.notfinite)
    return result


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
