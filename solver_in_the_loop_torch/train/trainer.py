"""Unrolled "solver-in-the-loop" training of the karman correction net.

Port of the karman half of solver_in_the_loop_tpu/train/trainer.py. Per
iteration: gather a window of msteps+1 frames per batch row, unroll msteps of
[solver step -> features -> net -> staggered correction] with an L2 loss
against the ground truth after every step, backpropagate through the whole
unroll, then clip each gradient tensor and take an Adam step, unless a
gradient is not finite.

What differs from the JAX package, and why:

* The unroll is a Python loop over eagerly executed steps (JAX: a jitted
  `lax.scan`), each wrapped in `torch.utils.checkpoint` with a selective
  policy in place of `jax.checkpoint` with a names policy. The policy sees
  the pressure solve and the tap-sum as the custom ops `silt::pcg_solve` and
  `silt::tap_sum`, and the convolutions as `aten.convolution`.
* The optimizer is `torch.optim.Adam` (optax's b1, b2, eps) behind
  `GuardedAdam`, which reproduces the chain `clip_by_leaf_norm -> adam`
  under `optax.apply_if_finite`; the learning rate is set per epoch as
  `set_learning_rate` does.
* The non-finite test reads one flag from the device per iteration, which
  is also where the loop synchronizes to time the iteration.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
from solver_in_the_loop_torch.models.features import (
    Normalization,
    correction_to_staggered,
    karman_features,
)
from solver_in_the_loop_torch.physics.karman import KarmanFlow
from solver_in_the_loop_torch.train.dataset import EpochSchedule

log = logging.getLogger(__name__)

CLIP_NORM = 0.001  # per-variable tf.clip_by_norm of the reference, karman_train.py:453
MAX_CONSECUTIVE_ERRORS = 100  # optax.apply_if_finite's limit in make_optimizer
# epochs [0, warmup_epochs) run at lr * WARMUP_LR_SCALE: at the reference's
# defaults a fresh glorot net can overflow the 32-step unroll within ~20
# iterations without it (solver_in_the_loop_tpu/train/trainer.py:100-108)
WARMUP_LR_SCALE = 0.1
LOG_EVERY = 50  # iterations between loss log lines and per-step loss records


def lr_schedule_step(epoch: int, current_lr: float) -> float:
    """Adaptive schedule (--adplr): x0.1 at epochs 11/16/21, x0.5 at 23
    (reference karman_train.py:146-163; `epoch` is 0-based)."""
    if epoch == 23:
        return current_lr * 0.5
    if epoch in (11, 16, 21):
        return current_lr * 0.1
    return current_lr


def clip_by_leaf_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """tf.clip_by_norm per tensor, as the JAX package writes it:
    g * min(1, max_norm / max(||g||, 1e-20)). (torch.nn.utils.clip_grad_norm_
    clips the global norm and adds 1e-6 to it.)"""
    out = []
    for g in grads:
        n = torch.sqrt(torch.sum(g * g))
        out.append(g * torch.clamp_max(max_norm / torch.clamp_min(n, 1e-20), 1.0))
    return out


def l2_loss_rows(diff: torch.Tensor) -> torch.Tensor:
    """Per-batch-row tf.nn.l2_loss: (B, Y, X) -> (B,), 0.5 * sum(x^2)."""
    return 0.5 * torch.sum(diff * diff, dim=(1, 2))


@dataclasses.dataclass
class SolTrainConfig:
    msteps: int = 32
    lr: float = 1e-4
    epochs: int = 100
    adplr: bool = False
    clip_grad: bool = False
    remat: bool = True
    remat_policy: str = "pressure+conv"  # pressure | pressure+conv | pressure+advect
    warmup_epochs: int = 0  # at lr * WARMUP_LR_SCALE; the karman CLI defaults it to 1


class GuardedAdam:
    """`optax.apply_if_finite(chain(clip_by_leaf_norm(0.001), adam), 100)` on
    torch.optim.Adam (b1 0.9, b2 0.999, eps 1e-8, as optax's defaults).

    `step` applies the update unless a raw gradient is not finite. A skipped
    update leaves the parameters and Adam's moments untouched; after more than
    `MAX_CONSECUTIVE_ERRORS` non-finite gradients in a row it applies anyway.
    `total_notfinite` counts every non-finite gradient, applied or not."""

    def __init__(self, params, cfg: SolTrainConfig):
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        self.clip = CLIP_NORM if cfg.clip_grad else None
        self.notfinite_count = 0
        self.total_notfinite = 0

    def set_learning_rate(self, lr: float) -> None:
        for group in self.adam.param_groups:
            group["lr"] = lr

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """Update from the parameters' .grad; returns whether it applied."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.total_notfinite += 0 if finite else 1
        if not finite and self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
            return False
        if self.clip is not None:
            grads = clip_by_leaf_norm(grads, self.clip)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()
        return True


def make_optimizer(model: nn.Module, cfg: SolTrainConfig) -> GuardedAdam:
    return GuardedAdam(model.parameters(), cfg)


REMAT_SAVES = {
    "pressure": ("pcg",),
    "pressure+conv": ("pcg", "conv"),
    "pressure+advect": ("pcg", "advect"),
}


def remat_policy_ops(policy: str) -> list:
    """The ops whose outputs a remat policy saves; everything else in an
    unrolled step is recomputed in the backward pass. Every policy saves the
    pressure solve, so no policy re-runs a CG solve (JAX's fourth policy,
    "none", a plain jax.checkpoint, would; the CLI maps it to "pressure")."""
    if policy not in REMAT_SAVES:
        raise KeyError(f"unknown remat policy '{policy}'; use one of {sorted(REMAT_SAVES)}")
    ops = {"pcg": torch.ops.silt.pcg_solve.default,
           "conv": torch.ops.aten.convolution.default,
           "advect": torch.ops.silt.tap_sum.default}
    return [ops[k] for k in REMAT_SAVES[policy]]


def karman_loss(flow: KarmanFlow, model: nn.Module, norm: Normalization,
                data: Dict[str, torch.Tensor], idx: torch.Tensor, cfg: SolTrainConfig,
                wgt: Optional[torch.Tensor] = None):
    """The unrolled loss of one batch (the `loss_fn` of make_karman_train_step).

    data: {dens (S,F,Y,X), u, v, re (S,)} on the device; idx (B, 2) int64
    (sim, frame0) pairs. Returns (loss, step_losses (msteps,), forward CG
    iterations (msteps,) int32), all on the device; loss is differentiable
    in the model's parameters."""
    dom = flow.domain
    msteps = cfg.msteps
    sim, frame0 = idx[:, 0], idx[:, 1]
    dens, u, v = data["dens"][sim, frame0], data["u"][sim, frame0], data["v"][sim, frame0]
    re = data["re"][sim]
    frames = frame0[None, :] + torch.arange(1, msteps + 1, device=idx.device)[:, None]
    gt_u = data["u"][sim[None, :], frames]  # (msteps, B, Y, X+1)
    gt_v = data["v"][sim[None, :], frames]
    w = torch.ones(idx.shape[0], device=u.device) if wgt is None else wgt
    std_v, std_u = norm.out_scales[0], norm.out_scales[1]

    def step(dens, u, v, x0):
        d, vel, p, iters = flow.step(CenteredGrid(dens, dom), StaggeredGrid(u, v, dom), re,
                                     p0=x0)
        vel = vel + correction_to_staggered(model(karman_features(vel, re, norm)), norm, dom)
        return d.values, vel.u, vel.v, p, iters

    if cfg.remat:
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       remat_policy_ops(cfg.remat_policy))
        run_step = functools.partial(checkpoint, step, use_reentrant=False,
                                     preserve_rng_state=False, context_fn=context_fn)
    else:
        run_step = step

    p1 = p2 = p3 = torch.zeros_like(dens)
    step_losses, cg_iters = [], []
    for k in range(msteps):
        # quadratic extrapolated warm start, falling back to linear, previous
        # and cold on the first steps; the p's are detached, as JAX's
        # stop_gradient of x0 makes them
        if k >= 3:
            x0 = 3.0 * p1 - 3.0 * p2 + p3
        elif k >= 2:
            x0 = 2.0 * p1 - p2
        else:
            x0 = p1
        dens, u, v, p, iters = run_step(dens, u, v, x0)
        step_losses.append(torch.sum(w * (l2_loss_rows((gt_v[k] - v) / std_v)
                                          + l2_loss_rows((gt_u[k] - u) / std_u))))
        p1, p2, p3 = p.detach(), p1, p2
        cg_iters.append(iters)
    step_losses = torch.stack(step_losses)
    return torch.sum(step_losses) / msteps, step_losses, torch.stack(cg_iters)


def make_karman_train_step(flow: KarmanFlow, model: nn.Module, optimizer: GuardedAdam,
                           cfg: SolTrainConfig) -> Callable:
    """(data, norm, idx) -> (loss, step_losses, forward CG iterations, applied):
    one forward-backward through the unroll and one guarded optimizer step."""

    def train_step(data, norm, idx, wgt=None):
        optimizer.zero_grad()
        loss, step_losses, cg_iters = karman_loss(flow, model, norm, data, idx, cfg, wgt)
        loss.backward()
        applied = optimizer.step()
        return loss.detach(), step_losses.detach(), cg_iters, applied

    return train_step


@dataclasses.dataclass
class TrainResult:
    losses: list
    sec_per_iter: float                # best epoch average
    sec_per_iter_median: float = 0.0   # median of per-epoch averages after the first
    iter_seconds: list = dataclasses.field(default_factory=list)  # every iteration, in order
    notfinite: int = 0                 # gradients the guard found not finite
    cg_iters: list = dataclasses.field(default_factory=list)  # forward CG iterations per step


def run_training(train_step, optimizer: GuardedAdam, data: Dict[str, torch.Tensor],
                 norm: Normalization, schedule: EpochSchedule, cfg: SolTrainConfig,
                 on_epoch_end: Optional[Callable] = None, metrics_writer=None) -> TrainResult:
    """Epoch loop of solver_in_the_loop_tpu/train/trainer.py `run_training`
    (reference karman_train.py:483-514): the epoch's learning rate (the
    --adplr schedule, times WARMUP_LR_SCALE in warm-up epochs), one train step
    per index row, the loss logged every LOG_EVERY iterations and written
    to the metrics writer. Timing: each iteration ends when its loss has been
    read from the device, after the guard has read its gradients' flag."""
    device = data["u"].device
    current_lr = cfg.lr
    losses, iter_seconds, epoch_means, cg_iters = [], [], [], []
    global_step = 0
    for epoch in range(cfg.epochs):
        idx_epoch = torch.from_numpy(schedule.epoch_indices(cfg.msteps).astype(np.int64))
        current_lr = lr_schedule_step(epoch, current_lr) if cfg.adplr else cfg.lr
        eff_lr = current_lr * (WARMUP_LR_SCALE if epoch < cfg.warmup_epochs else 1.0)
        optimizer.set_learning_rate(eff_lr)
        t_epoch = t_prev = time.perf_counter()
        for it in range(idx_epoch.shape[0]):
            idx = idx_epoch[it].to(device, non_blocking=True)
            loss, step_losses, iters, _ = train_step(data, norm, idx)
            loss_f = float(loss)
            now = time.perf_counter()
            iter_seconds.append(now - t_prev)
            t_prev = now
            losses.append(loss_f)
            cg_iters.append(iters)
            if it % LOG_EVERY == 0:
                log.info("epoch %03d/%03d it %04d/%04d loss=%.6f lr=%.2e",
                         epoch + 1, cfg.epochs, it + 1, idx_epoch.shape[0], loss_f, eff_lr)
            if metrics_writer is not None:
                metrics_writer.scalar("loss", loss_f, global_step)
                metrics_writer.scalar("lr", eff_lr, global_step)
                if it % LOG_EVERY == 0:
                    # per-unrolled-step losses (reference karman_train.py:437-438)
                    for s, sl in enumerate(step_losses.tolist()):
                        metrics_writer.scalar(f"loss_step_{s:02d}", sl, global_step)
            global_step += 1
        epoch_means.append((time.perf_counter() - t_epoch) / idx_epoch.shape[0])
        if optimizer.total_notfinite:
            log.warning("epoch %03d: %d non-finite update(s) skipped so far "
                        "(apply_if_finite guard)", epoch + 1, optimizer.total_notfinite)
        if on_epoch_end is not None:
            on_epoch_end(epoch)
    best = float(min(epoch_means)) if epoch_means else 0.0
    steady = epoch_means[1:] or epoch_means
    median = float(np.median(steady)) if steady else 0.0
    log.info("sec/iter best-epoch %.4f, median-epoch %.4f", best, median)
    iters_np = torch.stack(cg_iters).cpu().numpy().tolist() if cg_iters else []
    return TrainResult(losses, best, median, iter_seconds, optimizer.total_notfinite, iters_np)
