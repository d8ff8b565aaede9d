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
slope (train/checkpoint.py adopt_pretf_stats).

`--dp` trains data-parallel, as the JAX CLI does over its devices, over the
ranks of a process group (parallel/mesh.py): under
`python -m torch.distributed.run --nproc-per-node N -m solver_in_the_loop_torch
karman-train --dp ...` each of N ranks runs its rows of every batch, a batch
the ranks do not divide padded with zero-weighted rows, and the gradients
are summed over the ranks before the clip, the guard and Adam; without the
launcher the process is a group of one. Every rank starts from rank 0's
parameters and optimizer state, and only rank 0 writes dataStats.json, the
checkpoints, the metrics, the log file and the --profile trace.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import tempfile

import numpy as np
import torch

from solver_in_the_loop_torch.apps.karman_apply import add_pressure_precon, resolve_device
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import CONV_IMPLS, build_model
from solver_in_the_loop_torch.parallel import mesh as pmesh
from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
from solver_in_the_loop_torch.train import checkpoint as ckpt
from solver_in_the_loop_torch.train.dataset import EpochSchedule, load_karman_dataset
from solver_in_the_loop_torch.train.trainer import (
    SolTrainConfig,
    local_batch,
    make_karman_train_step,
    make_optimizer,
    run_training,
)
from solver_in_the_loop_torch.utils import profiling
from solver_in_the_loop_torch.utils.metrics import MetricsWriter, setup_logging

log = logging.getLogger(__name__)

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
    p.add_argument("--dp", action="store_true",
                   help="shard the batch over the ranks of the process group "
                        "(python -m torch.distributed.run starts them)")
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


@contextlib.contextmanager
def run_context(args):
    """The device both trainers run on and, with --dp, this rank's place in
    the data-parallel group (parallel/mesh.py `data_parallel_mesh`), which
    is closed when the run ends; yields (device, mesh or None)."""
    device = resolve_device(args.device)
    mesh = pmesh.data_parallel_mesh(args.device) if args.dp else None
    try:
        yield (device if mesh is None else mesh.device), mesh
    finally:
        if mesh is not None:
            mesh.close()


def is_main(mesh) -> bool:
    """Whether this process writes files: rank 0, or the only process."""
    return mesh is None or mesh.is_main


def load_on_ranks(mesh, load, skip_ds: bool):
    """`load(skip_preprocessing)`; data-parallel, rank 0 first, which writes
    the downsampled ds_ cache that the other ranks then read."""
    if mesh is None:
        return load(skip_ds)
    data = load(skip_ds) if mesh.is_main else None
    mesh.barrier()
    return data if mesh.is_main else load(True)


def dp_padding(mesh, sbatch: int):
    """The JAX CLI's `pad_batch_to` for a batch the ranks do not divide
    (None when they do, or without --dp), with its log line."""
    if mesh is None:
        return None
    if sbatch % mesh.size == 0:
        log.info("data-parallel over %d devices", mesh.size)
        return None
    pad = -(-sbatch // mesh.size) * mesh.size
    log.info("data-parallel over %d devices: batch %d padded to %d with zero-weighted rows "
             "(gradients exact, %d rows of compute wasted); for full efficiency pick a batch "
             "size divisible by %d", mesh.size, sbatch, pad, pad - sbatch, mesh.size)
    return pad


def prepare(args, stats: dict, device, in_channels: int, cfg: SolTrainConfig, mesh=None):
    """What both trainers do between the data and the epoch loop, as the JAX
    CLIs do it: the net (bf16 compute with --bf16) and its optimizer, the
    parameters from --pretf, then from --inittf, the parameters and optimizer state of epoch
    --resume (else dataStats.json written by the main rank); data-parallel,
    rank 0's parameters and Adam moments broadcast to every rank (JAX's
    `replicate`); returns (model, optimizer)."""
    model = build_model(args.model, in_channels=in_channels, leaky_slope=args.leaky_alpha,
                        init=args.init, generator=torch.Generator().manual_seed(args.seed),
                        conv=args.conv,
                        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32).to(device)
    log.info("model %s: %d params, conv %s, compute %s", args.model, ckpt.param_count(model),
             args.conv, "bfloat16" if args.bf16 else "float32")
    optimizer = make_optimizer(model, cfg, mesh)
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
    elif is_main(mesh):
        ckpt.save_stats(args.tf, stats)
    if mesh is not None:
        moments = [t for p in optimizer.params
                   for k, t in sorted(optimizer.adam.state.get(p, {}).items()) if k != "step"]
        pmesh.replicate([*model.parameters(), *model.buffers(), *moments], mesh)
    return model, optimizer


def train(args, train_step, optimizer, model, data, norm, cfg, keep_epoch, mesh=None):
    """--profile's traced step, the epoch loop with an epoch checkpoint after
    every epoch `keep_epoch` names, and the final model.msgpack (data-parallel:
    every rank trains, the main rank traces and writes); returns the
    TrainResult."""
    main = is_main(mesh)
    pad_batch_to = dp_padding(mesh, args.sbatch)
    if args.profile:
        # one step on the pairs (0, 0), which draws nothing from the
        # schedule; its update is kept, as the JAX CLIs keep it
        idx0, wgt0 = local_batch(np.zeros((args.sbatch, 2), np.int64), mesh, pad_batch_to,
                                 data["u"].device)
        with profiling.trace(args.profile) if main else contextlib.nullcontext():
            train_step(data, norm, idx0, wgt0)
        if main:
            log.info("profiler trace written to %s", args.profile)
    schedule = EpochSchedule(args.nsims, args.simsteps, args.sbatch, seed=args.seed)
    writer = MetricsWriter(args.tf) if main else None

    def on_epoch_end(epoch):
        if main and keep_epoch(epoch):
            ckpt.save_checkpoint(args.tf, model, args.model, optimizer, epoch=epoch + 1)

    try:
        result = run_training(train_step, optimizer, data, norm, schedule, cfg,
                              start_epoch=max(args.resume, 0), on_epoch_end=on_epoch_end,
                              metrics_writer=writer, mesh=mesh, pad_batch_to=pad_batch_to)
    finally:
        if writer is not None:
            writer.close()
    if main:
        ckpt.save_checkpoint(args.tf, model, args.model)
    if result.losses:
        secs = np.asarray(result.iter_seconds)
        log.info("final loss %.6f; %.4f sec/iter (mean), %.4f (95th percentile); "
                 "%d non-finite update(s) skipped", result.losses[-1], secs.mean(),
                 np.percentile(secs, 95), result.notfinite)
    return result


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

    data_np = load_on_ranks(mesh, lambda skip: load_karman_dataset(
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
    model, optimizer = prepare(args, stats, device, 3, cfg, mesh)
    train_step = make_karman_train_step(flow, model, optimizer, cfg)
    return train(args, train_step, optimizer, model, data_np.to_device(device), norm, cfg,
                 lambda epoch: epoch % 10 == 9, mesh)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
