"""PRE supervised training CLI (karman and Burgers).

Port of solver_in_the_loop_tpu/apps/pre_train.py with the same flags plus
`--conv {library,kernel}` (the net's convolutions in cuDNN or in the port's
CUDA kernels, default library) and `--device {cuda,cpu}` (default cuda).
The Makefile's PRE nets (`karman-fdt-pre`; `karman-fdt-presr` on the
PRE-SR set; `burgers-fdt-pre` with `burgers-pre-train`):

    python -m solver_in_the_loop_torch karman-pre-train -o karman-fdt-pre/tf \
        --seed 0 --val 0.05 --epochs 400 --augment karman-fdt-pre-set/sim_0*/

* features [v, u, Re] (karman) or [v, u, fv, fu] (Burgers) from the stored
  pre-correction state `velo` (Re from each scene's parameters), labels the
  correction `corr` [corr_v, corr_u];
* a shuffled validation split (`--val`; `--novdata` validates on the
  training set), drawn with np.random as the JAX CLI draws it;
* nonzero-masked per-channel std (times `--nsigma`) and zero-centred
  standardisation, or with `--nozerocen` less the nonzero-masked means;
  stats.json with the JAX CLI's keys;
* random flips in x (`--augment`) with per-channel sign vectors
  ([1, -1, 1, 1, -1] karman: u and corr_u negate; all +1 Burgers);
* MSE, plain Adam (the port's float32 betas, no clip, no guard), batch 32,
  the learning rate x0.1 at epochs 81, 121 and 161 and x0.5 at 181; the
  batches and flips drawn from RandomState(seed) in the JAX CLI's order;
* model_epoch%04d.msgpack (parameters and Adam state) after every epoch,
  the previous one removed unless its epoch is a multiple of 50, and
  model.msgpack at the end; `--resume N` reloads epoch N, replays the
  skipped epochs' draws and schedule and keeps the LeakyReLU slope the run
  was started with.

Unless `--nostats`, a histogram of every channel of the inputs, labels and
normalised training inputs and labels goes to stats-png/{name}_{c}.png (100
bins, log counts, written with io/thumbs.py's PNG writer); the JAX CLI also
writes them into stats.pdf with matplotlib, which the port does not.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import logging
import os
import time

import numpy as np
import torch

from solver_in_the_loop_torch.apps.karman_apply import resolve_device
from solver_in_the_loop_torch.io import npz_pool, thumbs
from solver_in_the_loop_torch.io import scene as scene_io
from solver_in_the_loop_torch.models.networks import CONV_IMPLS, MODELS, build_model
from solver_in_the_loop_torch.train import checkpoint as ckpt
from solver_in_the_loop_torch.train.trainer import ADAM_BETAS, ADAM_EPS
from solver_in_the_loop_torch.utils.metrics import MetricsWriter
from solver_in_the_loop_torch.utils.stats import nonzero_channel_mean, nonzero_channel_std

log = logging.getLogger(__name__)

HIST_BINS = 100
HIST_BAR_W = 4  # pixels per bin
HIST_H = 200


def build_parser(parser=None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("pre-train")
    p.add_argument("-o", "--opath", required=True, help="output dir (model, stats)")
    p.add_argument("--val", type=float, default=0.2)
    p.add_argument("--bsize", dest="batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", dest="steps_per_epoch", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--model", default="mars_moon", choices=sorted(MODELS))
    p.add_argument("--augment", action="store_true")
    p.add_argument("--nsigma", type=float, default=1.0)
    p.add_argument("--novdata", action="store_true",
                   help="no held-out split: train and validate on the full set")
    p.add_argument("--nozerocen", action="store_true",
                   help="standardise less the nonzero-masked channel means instead of "
                        "zero-centred")
    p.add_argument("--nostats", action="store_true", help="skip the histogram PNGs")
    p.add_argument("--leaky-alpha", type=float, default=0.3,
                   help="LeakyReLU negative slope (Keras default 0.3)")
    p.add_argument("--resume", type=int, default=-1,
                   help="resume from model_epochNNNN.msgpack, replaying the data/lr schedule "
                        "of the skipped epochs")
    p.add_argument("--conv", choices=CONV_IMPLS, default="library",
                   help="the net's convolutions: cuDNN ('library') or the port's CUDA kernels "
                        "('kernel')")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the CUDA card)")
    p.add_argument("tdata", nargs="+", help="PRE scene dirs (sim_*)")
    return p


def hist_pixels(values: np.ndarray) -> np.ndarray:
    """A HIST_H x (HIST_BINS * HIST_BAR_W) grayscale bar chart of the
    histogram of `values` over HIST_BINS bins, each bar's height log(1 +
    count) / log(1 + max count) of the image, black on white."""
    counts, _ = np.histogram(np.asarray(values, np.float64).reshape(-1), bins=HIST_BINS)
    heights = np.round(HIST_H * np.log1p(counts) / max(np.log1p(counts.max()), 1e-30))
    rows = np.arange(HIST_H)[::-1, None]  # distance from the bottom
    bars = np.repeat(rows < heights[None, :], HIST_BAR_W, axis=1)
    return np.where(bars, 0, 65535).astype(">u2")


def write_histogram_stats(opath: str, named_arrays) -> int:
    """stats-png/{name}_{c}.png for every channel c of every array; returns
    how many were written."""
    png_dir = os.path.join(opath, "stats-png")
    os.makedirs(png_dir, exist_ok=True)
    n = 0
    for name, arr in named_arrays:
        for c in range(arr.shape[-1]):
            dd = np.asarray(arr[..., c]).reshape(-1)
            log.info("histogram of %s[%d]  mean=%.4g std=%.4g", name, c, dd.mean(), dd.std())
            with open(os.path.join(png_dir, f"{name}_{c}.png"), "wb") as f:
                f.write(thumbs.png_bytes(hist_pixels(dd)))
            n += 1
    return n


def _epoch_path_keep(opath: str, cur_epoch: int):
    """Path of the now-superseded previous per-epoch checkpoint, or None if it
    should be kept (every 50th epoch stays as a snapshot)."""
    prev_ep = cur_epoch - 1
    if prev_ep <= 0 or prev_ep % 50 == 0:
        return None
    p = ckpt.epoch_path(opath, prev_ep)
    return p if os.path.exists(p) else None


def pre_lr_schedule(epoch: int, current_lr: float) -> float:
    if epoch == 181:
        return current_lr * 0.5
    if epoch in (81, 121, 161):
        return current_lr * 0.1
    return current_lr


def _collocated(arrays) -> np.ndarray:
    """Legacy staggered frames -> (N, Y, X, 2) collocated [v, u]."""
    out = []
    for a in arrays:
        u, v = scene_io.legacy_to_staggered(a[None] if a.ndim < 4 else a)
        out.append(np.stack([v[:, :-1, :], u[:, :, :-1]], axis=-1))
    return np.concatenate(out, 0)


def load_pre_data(tdata, scenario: str):
    """(inputs (N, Y, X, C), labels (N, Y, X, 2)) from the PRE scenes
    matching the patterns `tdata`, in sorted order."""
    dirs = sorted(d for pat in tdata for d in _glob.glob(pat))
    vel_files, corr_files, frc_files, re_vals = [], [], [], []
    for d in dirs:
        vels = sorted(_glob.glob(os.path.join(d, "velo_0*.npz")))
        corrs = sorted(_glob.glob(os.path.join(d, "corr_0*.npz")))
        if len(vels) != len(corrs):
            raise ValueError(f"{d}: {len(vels)} velo frames but {len(corrs)} corr frames")
        vel_files += vels
        corr_files += corrs
        if scenario == "karman":
            re_vals += [float(scene_io.Scene(d).read_params()["re"])] * len(vels)
        else:
            frcs = sorted(_glob.glob(os.path.join(d, "forc_0*.npz")))
            if len(frcs) != len(vels):
                raise ValueError(f"{d}: {len(vels)} velo frames but {len(frcs)} forc frames")
            frc_files += frcs
    if not vel_files:
        raise ValueError(f"no PRE frames under {tdata}")
    vu = _collocated(npz_pool.read_npz_batch(vel_files))
    labels = _collocated(npz_pool.read_npz_batch(corr_files))
    if scenario == "karman":
        re_chan = np.broadcast_to(np.asarray(re_vals, np.float32)[:, None, None, None],
                                  vu.shape[:-1] + (1,))
        inputs = np.concatenate([vu, re_chan], axis=-1)
    else:
        inputs = np.concatenate([vu, _collocated(npz_pool.read_npz_batch(frc_files))], axis=-1)
    return inputs, labels


def _replay_batches(rng, n: int, batch: int, steps: int):
    """Yield the (selection, flip draws) the JAX CLI draws for one epoch:
    contiguous batches of a fresh permutation, reshuffled where a batch
    would overrun it; the caller draws the flips."""
    perm = rng.permutation(n)
    pos = 0
    for _ in range(steps):
        if pos + batch > n:
            perm = rng.permutation(n)
            pos = 0
        yield perm[pos:pos + batch]
        pos += batch


def run(args, scenario: str = "karman"):
    """Train; returns a dict: "model", "stats", "losses" and "val_losses"
    (per epoch run), "seconds_per_epoch" (synchronised with the device) and
    "histograms" (PNGs written)."""
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    inputs, labels = load_pre_data(args.tdata, scenario)
    log.info("%s PRE data: %s -> %s", scenario, inputs.shape, labels.shape)

    perm = np.random.permutation(inputs.shape[0])
    if args.novdata:
        tr_in, tr_lb = inputs[perm], labels[perm]
        va_in, va_lb = tr_in, tr_lb
    else:
        val_size = max(1, int(args.val * inputs.shape[0]))
        tr_in, tr_lb = inputs[perm][:-val_size], labels[perm][:-val_size]
        va_in, va_lb = inputs[perm][-val_size:], labels[perm][-val_size:]

    in_std = nonzero_channel_std(tr_in) * args.nsigma
    out_std = nonzero_channel_std(tr_lb) * args.nsigma
    in_mean = nonzero_channel_mean(tr_in) if args.nozerocen else np.zeros_like(in_std)
    out_mean = nonzero_channel_mean(tr_lb) if args.nozerocen else np.zeros_like(out_std)
    if args.resume > 0:
        # rebuild the net at the slope the run was started with (absent: 0.01)
        path = os.path.join(args.opath, "stats.json")
        if os.path.exists(path):
            with open(path) as f:
                old_alpha = json.load(f).get("leaky_alpha", 0.01)
            if old_alpha != args.leaky_alpha:
                log.info("resume: restoring leaky_alpha=%s from stats.json (CLI said %s)",
                         old_alpha, args.leaky_alpha)
                args.leaky_alpha = old_alpha

    stats = {
        "in.std": in_std.tolist(),
        "out.std": out_std.tolist(),
        "in.mean": in_mean.tolist(),
        "out.mean": out_mean.tolist(),
        "nozerocen": bool(args.nozerocen),
        "ext.std": float(in_std[2]) if scenario == "karman" else 0.0,
        "scenario": scenario,
        "nsigma": args.nsigma,
        "leaky_alpha": args.leaky_alpha,
    }
    os.makedirs(args.opath, exist_ok=True)
    with open(os.path.join(args.opath, "stats.json"), "w") as f:
        json.dump(stats, f, indent=1)

    tr_in = (tr_in - in_mean) / in_std
    tr_lb = (tr_lb - out_mean) / out_std
    va_in = (va_in - in_mean) / in_std
    va_lb = (va_lb - out_mean) / out_std
    n_hist = 0
    if not args.nostats:
        n_hist = write_histogram_stats(
            args.opath, [("inputs", inputs), ("labels", labels),
                         ("input_train_norm", tr_in), ("label_train_norm", tr_lb)])

    channels = tr_in.shape[-1]
    signs = [1.0, -1.0, 1.0, 1.0, -1.0] if scenario == "karman" else [1.0] * (channels + 2)
    flip_signs = torch.tensor(signs, dtype=torch.float32, device=device)
    model = build_model(args.model, in_channels=channels, leaky_slope=args.leaky_alpha,
                        init="zero", generator=torch.Generator().manual_seed(args.seed),
                        conv=args.conv).to(device)
    log.info("model %s: %d params, conv %s", args.model, ckpt.param_count(model), args.conv)
    adam = torch.optim.Adam(model.parameters(), lr=args.lr, betas=ADAM_BETAS, eps=ADAM_EPS)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    tr_in_d, tr_lb_d, va_in_d, va_lb_d = (to_dev(a) for a in (tr_in, tr_lb, va_in, va_lb))

    def train_step(sel: np.ndarray, flip: np.ndarray) -> torch.Tensor:
        idx = torch.from_numpy(sel).to(device)
        x, y = tr_in_d[idx], tr_lb_d[idx]
        if args.augment:
            both = torch.cat([x, y], dim=-1)
            flipped = both.flip(2) * flip_signs
            both = torch.where(torch.from_numpy(flip).to(device)[:, None, None, None],
                               flipped, both)
            x, y = both[..., :-2], both[..., -2:]
        adam.zero_grad(set_to_none=True)
        loss = torch.mean((model(x) - y) ** 2)
        loss.backward()
        adam.step()
        return loss.detach()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    writer = MetricsWriter(args.opath)
    n = tr_in.shape[0]
    steps = args.steps_per_epoch or max(1, n // args.batch_size)
    current_lr = args.lr
    rng = np.random.RandomState(args.seed)
    gstep = 0
    start_epoch = max(args.resume, 0)
    if start_epoch > 0:
        # weights and Adam state of epoch N; the skipped epochs' draws and
        # schedule replayed, so the run goes on as an uninterrupted one
        ckpt.load_epoch_checkpoint(args.opath, start_epoch, model, args.model, adam)
        log.info("resumed from epoch %d", start_epoch)
        for epoch in range(start_epoch):
            current_lr = pre_lr_schedule(epoch, current_lr)
            for sel in _replay_batches(rng, n, args.batch_size, steps):
                if args.augment:
                    rng.rand(len(sel))
                gstep += 1
    losses, val_losses, seconds = [], [], []
    try:
        for epoch in range(start_epoch, args.epochs):
            t0 = sync()
            current_lr = pre_lr_schedule(epoch, current_lr)
            for group in adam.param_groups:
                group["lr"] = current_lr
            ep_losses = []
            for sel in _replay_batches(rng, n, args.batch_size, steps):
                flip = rng.rand(len(sel)) > 0.5 if args.augment else np.zeros(len(sel), bool)
                ep_losses.append(train_step(sel, flip))
                gstep += 1
            with torch.no_grad():
                val = float(torch.mean((model(va_in_d) - va_lb_d) ** 2))
            ep_loss = float(torch.stack(ep_losses).mean())
            seconds.append(sync() - t0)
            losses.append(ep_loss)
            val_losses.append(val)
            writer.scalar("loss", ep_loss, gstep)
            writer.scalar("val_loss", val, gstep)
            writer.scalar("lr", current_lr, gstep)
            if epoch % 10 == 0 or epoch == args.epochs - 1:
                log.info("epoch %03d loss=%.6f val=%.6f lr=%.1e (%.3f s)", epoch + 1, ep_loss,
                         val, current_lr, seconds[-1])
            ckpt.save_checkpoint(args.opath, model, args.model, adam, epoch=epoch + 1)
            prev = _epoch_path_keep(args.opath, epoch + 1)
            if prev:
                os.remove(prev)
    finally:
        writer.close()
    ckpt.save_checkpoint(args.opath, model, args.model)
    return {"model": model, "stats": stats, "losses": losses, "val_losses": val_losses,
            "seconds_per_epoch": seconds, "histograms": n_hist}


def main(argv=None, scenario: str = "karman"):
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv), scenario)


if __name__ == "__main__":
    main()
