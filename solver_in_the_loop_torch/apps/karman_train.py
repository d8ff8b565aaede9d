"""Karman SOL/NON training CLI.

Port of solver_in_the_loop_tpu/apps/karman_train.py with the same flags plus
`--conv {library,kernel}` (how the net's convolutions run, default library),
`--pressure-precon {fd,none}` (as karman-apply's) and `--device {cuda,cpu}`
(default cuda): it runs on the card unless the CPU
is asked for, and raises if CUDA is missing instead of running on the CPU. The
SOL-32 run of the repo's Makefile (`karman-fdt-sol32`):

    python -m solver_in_the_loop_torch karman-train --train karman-fdt-hires-set \
        --tf OUT/tf --log OUT/tf/run.log --epochs 100 --lr 0.0001 \
        -l 100 -t 500 -s 4 -m 32 -n 6 -b 3 --seed 0

It writes OUT/tf/dataStats.json at the start, model_epoch%04d.msgpack (the
parameters and the optimizer state) every 10 epochs and model.msgpack at the
end, in the JAX package's format, so either package resumes the other's run.
As in the JAX CLI: `--resume N` reloads dataStats.json (and its LeakyReLU
slope) and epoch N's parameters and optimizer state and skips N epochs of
the schedule; `--inittf PATH` starts from a checkpoint's parameters;
`--bf16` runs the net's convolutions in bfloat16 on float32 parameters;
`--profile DIR` traces one step on the index pairs (0, 0) before training,
without drawing from the schedule, and keeps its update; `--debug-nans`
raises FloatingPointError at the first NaN (train/trainer.py); `--reg-loss`
is accepted and changes nothing (the reference's regularization list is
empty); `--pretf PATH` starts from a PRE net's parameters (karman-pre-train's
model.msgpack) and adopts its stats.json's in.std and out.std and LeakyReLU
slope (train/checkpoint.py adopt_pretf_stats). Flags of the JAX CLI that
this port does not implement yet (NOT_PORTED) raise NotImplementedError
naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from solver_in_the_loop_torch.apps.karman_apply import add_pressure_precon, resolve_device
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import CONV_IMPLS, build_model
from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
from solver_in_the_loop_torch.train import checkpoint as ckpt
from solver_in_the_loop_torch.train.dataset import EpochSchedule, load_karman_dataset
from solver_in_the_loop_torch.train.trainer import (
    SolTrainConfig,
    make_karman_train_step,
    make_optimizer,
    run_training,
)
from solver_in_the_loop_torch.utils import profiling
from solver_in_the_loop_torch.utils.metrics import MetricsWriter, setup_logging

log = logging.getLogger(__name__)

# flags of the JAX CLI left out of this port, with the ROADMAP.md item that
# ports them; each raises NotImplementedError when given
NOT_PORTED = {
    "dp": "A3 (parallelism)",
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
    p.add_argument("--reg-loss", action="store_true",
                   help="accepted for the reference's CLI; a no-op (its model.losses is empty)")
    p.add_argument("--adplr", action="store_true")
    p.add_argument("--clip-grad", action=argparse.BooleanOptionalAction, default=True,
                   help="per-tensor grad-norm clip at 0.001 (reference karman_train.py:453)")
    p.add_argument("--warmup-epochs", type=int, default=1,
                   help="run the first N epochs at lr/10 (0 disables)")
    p.add_argument("--resume", type=int, default=-1,
                   help="resume from model_epoch%%04d.msgpack of --tf at this epoch")
    p.add_argument("--inittf", default=None, help="warm-start checkpoint (msgpack)")
    p.add_argument("--pretf", default=None, help="supervised pre-trained checkpoint")
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
    p.add_argument("--bf16", action="store_true", help="bfloat16 network compute")
    p.add_argument("--dp", action="store_true")
    p.add_argument("--ptol", type=float, default=1e-5, help="pressure CG tolerance")
    p.add_argument("--pmaxiter", type=int, default=1000, help="pressure CG max iterations")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace of one step to this dir")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the first NaN")
    p.add_argument("--conv", choices=CONV_IMPLS, default="library",
                   help="the net's convolutions: cuDNN ('library') or the port's "
                        "CUDA kernels ('kernel')")
    add_pressure_precon(p)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the CUDA card)")
    return p


def refuse_not_ported(args) -> None:
    """Raise NotImplementedError for a NOT_PORTED flag that is given (a
    parser without the flag gives none)."""
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag, None):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported to the PyTorch trainer yet "
                f"(ROADMAP.md {item})")


def prepare(args, stats: dict, device, in_channels: int, cfg: SolTrainConfig):
    """What both trainers do between the data and the epoch loop, as the JAX
    CLIs do it: the net (bf16 compute with --bf16) and its optimizer, the
    parameters from --pretf, then from --inittf, the parameters and optimizer state of epoch
    --resume (else dataStats.json written); returns (model, optimizer)."""
    model = build_model(args.model, in_channels=in_channels, leaky_slope=args.leaky_alpha,
                        init=args.init, generator=torch.Generator().manual_seed(args.seed),
                        conv=args.conv,
                        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32).to(device)
    log.info("model %s: %d params, conv %s, compute %s", args.model, ckpt.param_count(model),
             args.conv, "bfloat16" if args.bf16 else "float32")
    optimizer = make_optimizer(model, cfg)
    if getattr(args, "reg_loss", False):
        log.info("--reg-loss: no regularization terms (the reference's list is empty)")
    if args.pretf:
        ckpt.load_model_weights(model, args.pretf, args.model)
        log.info("loaded pre-trained model %s", args.pretf)
    if args.inittf:
        ckpt.load_model_weights(model, args.inittf, args.model)
        log.info("warm start from %s", args.inittf)
    if args.resume > 0:
        if not ckpt.load_epoch_checkpoint(args.tf, args.resume, model, args.model, optimizer):
            log.warning("epoch %d's checkpoint holds no optimizer state; Adam starts afresh",
                        args.resume)
        log.info("resumed from epoch %d", args.resume)
    else:
        ckpt.save_stats(args.tf, stats)
    return model, optimizer


def train(args, train_step, optimizer, model, data, norm, cfg, keep_epoch):
    """--profile's traced step, the epoch loop with an epoch checkpoint after
    every epoch `keep_epoch` names, and the final model.msgpack; returns the
    TrainResult."""
    if args.profile:
        # one step on the pairs (0, 0), which draws nothing from the
        # schedule; its update is kept, as the JAX CLIs keep it
        idx0 = torch.zeros((args.sbatch, 2), dtype=torch.int64, device=data["u"].device)
        with profiling.trace(args.profile):
            train_step(data, norm, idx0)
        log.info("profiler trace written to %s", args.profile)
    schedule = EpochSchedule(args.nsims, args.simsteps, args.sbatch, seed=args.seed)
    writer = MetricsWriter(args.tf)

    def on_epoch_end(epoch):
        if keep_epoch(epoch):
            ckpt.save_checkpoint(args.tf, model, args.model, optimizer, epoch=epoch + 1)

    try:
        result = run_training(train_step, optimizer, data, norm, schedule, cfg,
                              start_epoch=max(args.resume, 0), on_epoch_end=on_epoch_end,
                              metrics_writer=writer)
    finally:
        writer.close()
    ckpt.save_checkpoint(args.tf, model, args.model)
    if result.losses:
        log.info("final loss %.6f; %.4f sec/iter (best epoch), %.4f (median epoch); "
                 "%d non-finite update(s) skipped", result.losses[-1], result.sec_per_iter,
                 result.sec_per_iter_median, result.notfinite)
    return result


def run(args):
    """Train and write the checkpoints; returns the TrainResult (None with
    --only-ds)."""
    refuse_not_ported(args)
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
    if args.resume > 0:
        stats = ckpt.load_stats(args.tf)
        # resume with the slope the run was started with (absent: the old 0.01)
        args.leaky_alpha = stats.get("leaky_alpha", 0.01)
    if args.pretf is not None:
        ckpt.adopt_pretf_stats(stats, args, log)
    if "in.std" in stats:
        # the supervised-init contract: the PRE net's velocity scales, the
        # data's Re scale
        norm = Normalization(
            torch.tensor([stats["in.std"][0], stats["in.std"][1], stats["ext.std"]],
                         dtype=torch.float32, device=device),
            torch.tensor(stats["out.std"][:2], dtype=torch.float32, device=device))
    else:
        norm = Normalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"], device)
    res_y, res_x = data_np.resolution
    dom = karman_domain(res_x, args.len)
    if dom.resolution != (res_y, res_x):
        raise ValueError(f"frames of {(res_y, res_x)} are not a karman domain "
                         f"({dom.resolution} for x resolution {res_x})")
    flow = KarmanFlow(dom, advection=args.advect, max_shift=args.max_shift,
                      pressure_tol=args.ptol, pressure_max_iter=args.pmaxiter,
                      pressure_precon=args.pressure_precon, device=device)
    if args.remat_policy == "none":
        log.info("--remat-policy none: saving the pressure solve as 'pressure' does; the "
                 "port never re-runs a solve in the backward pass")
        args.remat_policy = "pressure"
    cfg = SolTrainConfig(
        msteps=args.msteps, lr=args.lr, epochs=args.epochs, adplr=args.adplr,
        clip_grad=args.clip_grad, remat=not args.no_remat, remat_policy=args.remat_policy,
        warmup_epochs=args.warmup_epochs, debug_nans=args.debug_nans)
    stats["leaky_alpha"] = args.leaky_alpha  # the apply CLIs rebuild the net with it
    model, optimizer = prepare(args, stats, device, 3, cfg)
    train_step = make_karman_train_step(flow, model, optimizer, cfg)
    return train(args, train_step, optimizer, model, data_np.to_device(device), norm, cfg,
                 lambda epoch: epoch % 10 == 9)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
