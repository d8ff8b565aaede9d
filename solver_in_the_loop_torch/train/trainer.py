"""Unrolled "solver-in-the-loop" training of the karman and Burgers
correction nets.

Port of solver_in_the_loop_tpu/train/trainer.py. Per iteration: gather a
window of msteps+1 frames per batch row (and, for Burgers, the msteps forces
applied during the steps), unroll msteps of [solver step -> features -> net
-> staggered correction] with an L2 loss against the ground truth after every
step, backpropagate through the whole unroll, then clip each gradient tensor
and take an Adam step, unless a gradient is not finite.

What differs from the JAX package, and why:

* The unroll is a Python loop over eagerly executed steps (JAX: a jitted
  `lax.scan`), each one node of utils/remat.py `checkpoint` in place of
  `jax.checkpoint` with a names policy: as there, the saved ops decide at
  their call sites (`remat_policy_ops`), and nothing else of the step is
  kept. The policy (`REMAT_SAVES`) names the pressure solve by its one
  custom op, `silt::pressure_cg_solve` on every route, the tap-sum as
  `silt::tap_sum`, and the convolutions as `aten.convolution` (the
  "library" nets) or `silt::conv` (the "kernel" nets).
* The optimizer is `torch.optim.Adam` (optax's b1, b2, eps) behind
  `GuardedAdam`, which reproduces the chain `clip_by_leaf_norm -> adam`
  under `optax.apply_if_finite`; the learning rate is set per epoch as
  `set_learning_rate` does.
* The non-finite test reads one flag from the device per iteration, which
  is also where the loop synchronizes to time the iteration.
* Data parallelism (`mesh`, the CLIs' --dp) is explicit where XLA's
  partitioner inserts it: each rank runs the unroll on its rows of the
  (padded) batch, and `GuardedAdam.step` sums the gradients over the ranks
  in one all-reduce before the clip and the guard, so that every rank
  clips, guards and updates alike with the gradient of the global loss
  (JAX's loss is a sum over the global batch, and the psum adds the shards:
  a sum, not DistributedDataParallel's mean). The logged losses are
  summed too.
* `debug_nans` (the CLIs' --debug-nans, the JAX package's jax_debug_nans)
  raises FloatingPointError at the first NaN: each unrolled step's state
  and loss are checked as they are made, and the backward pass runs under
  autograd's anomaly mode, whose NaN check on every backward function's
  output is turned into that error. An inf alone passes, as it does under
  jax_debug_nans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
from solver_in_the_loop_torch.kernels import conv as _conv  # noqa: F401 (registers silt::conv)
from solver_in_the_loop_torch.models.features import (
    Normalization,
    burgers_features,
    correction_to_staggered,
    karman_features,
)
from solver_in_the_loop_torch.parallel import mesh as pmesh
from solver_in_the_loop_torch.physics.burgers import BurgersFlow
from solver_in_the_loop_torch.physics.karman import KarmanFlow
from solver_in_the_loop_torch.train.dataset import EpochSchedule
from solver_in_the_loop_torch.utils import profiling, remat

log = logging.getLogger(__name__)

CLIP_NORM = 0.001  # per-variable tf.clip_by_norm of the reference, karman_train.py:453
MAX_CONSECUTIVE_ERRORS = 100  # optax.apply_if_finite's limit in make_optimizer
# epochs [0, warmup_epochs) run at lr * WARMUP_LR_SCALE: at the reference's
# defaults a fresh glorot net can overflow the 32-step unroll within ~20
# iterations without it (solver_in_the_loop_tpu/train/trainer.py:100-108)
WARMUP_LR_SCALE = 0.1
LOG_EVERY = 50  # iterations between loss log lines and per-step loss records
# optax's defaults. inject_hyperparams holds b1, b2 and eps as float32
# arrays, so the JAX trainer's Adam blends with 1 - float32(0.999) =
# 0.00099998713, not 0.001: torch's Adam is given the same float32 values
ADAM_BETAS = (float(np.float32(0.9)), float(np.float32(0.999)))
ADAM_EPS = float(np.float32(1e-8))


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
    debug_nans: bool = False  # raise FloatingPointError at the first NaN (see the module doc)


class GuardedAdam:
    """`optax.apply_if_finite(chain(clip_by_leaf_norm(0.001), adam), 100)` on
    torch.optim.Adam (ADAM_BETAS, ADAM_EPS: optax's defaults in float32).

    `step` applies the update unless a raw gradient is not finite. A skipped
    update leaves the parameters and Adam's moments untouched; after more than
    `MAX_CONSECUTIVE_ERRORS` non-finite gradients in a row it applies anyway.
    `notfinite_count` counts the non-finite gradients in a row,
    `last_finite` says whether the last one was finite and `total_notfinite`
    counts every non-finite gradient, applied or not: optax's three counters,
    which an epoch checkpoint keeps (train/checkpoint.py).

    With a `mesh` of the data-parallel group, `step` first sums the
    gradients over its ranks (parallel/mesh.py `all_reduce_sum`), so the
    clip and the guard act on the reduced gradient and agree on every rank."""

    def __init__(self, params, cfg: SolTrainConfig, mesh: Optional[pmesh.Mesh] = None):
        self.params = list(params)
        self.mesh = mesh
        self.adam = torch.optim.Adam(self.params, lr=cfg.lr, betas=ADAM_BETAS, eps=ADAM_EPS)
        self.clip = CLIP_NORM if cfg.clip_grad else None
        self.notfinite_count = 0
        self.last_finite = True
        self.total_notfinite = 0

    def set_learning_rate(self, lr: float) -> None:
        for group in self.adam.param_groups:
            group["lr"] = lr

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """Update from the parameters' .grad; returns whether it applied."""
        with profiling.span("silt.train.optimizer"):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
            if self.mesh is not None:
                grads = pmesh.all_reduce_sum(grads, self.mesh)
            with profiling.span("silt.train.guard"):
                finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.last_finite = finite
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


def make_optimizer(model: nn.Module, cfg: SolTrainConfig,
                   mesh: Optional[pmesh.Mesh] = None) -> GuardedAdam:
    return GuardedAdam(model.parameters(), cfg, mesh)


# policy -> the ops whose outputs it saves. Every policy saves the pressure
# solve, whichever route runs it, so no policy re-runs a CG solve (JAX's
# fourth policy, "none", a plain jax.checkpoint, would; the CLI maps it to
# "pressure"); "conv" names both conv implementations, cuDNN's and the fused
# silt::conv.
REMAT_SAVES = {
    "pressure": (torch.ops.silt.pressure_cg_solve.default,),
    "pressure+conv": (torch.ops.silt.pressure_cg_solve.default,
                      torch.ops.aten.convolution.default, torch.ops.silt.conv.default),
    "pressure+advect": (torch.ops.silt.pressure_cg_solve.default,
                        torch.ops.silt.tap_sum.default),
}


def remat_policy_ops(policy: str) -> list:
    """The ops whose outputs a remat policy saves, which their call sites
    consult (utils/remat.py `site`); everything else in an unrolled step is
    recomputed in the backward pass."""
    if policy not in REMAT_SAVES:
        raise KeyError(f"unknown remat policy '{policy}'; use one of {sorted(REMAT_SAVES)}")
    return list(REMAT_SAVES[policy])


def _checkpointed(step: Callable, cfg: SolTrainConfig, model: nn.Module) -> Callable:
    """`step`, which reads `model`'s parameters, as one remat node that keeps
    the outputs of cfg's remat policy (or as it is without remat)."""
    if not cfg.remat:
        return step
    saves = frozenset(remat_policy_ops(cfg.remat_policy))
    return functools.partial(remat.checkpoint, step, saves, tuple(model.parameters()))


def _check_nan(cfg: SolTrainConfig, step: int, **tensors: torch.Tensor) -> None:
    """Under cfg.debug_nans, raise FloatingPointError if a tensor holds a NaN."""
    if not cfg.debug_nans:
        return
    for name, t in tensors.items():
        if bool(torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in {name} of unrolled step {step} (--debug-nans)")


def _backward(loss: torch.Tensor, cfg: SolTrainConfig) -> None:
    """loss.backward() as the `silt.train.backward` span; under
    cfg.debug_nans in anomaly mode, its NaN check raised as
    FloatingPointError."""
    with profiling.span("silt.train.backward"):
        if not cfg.debug_nans:
            loss.backward()
            return
        try:
            with torch.autograd.detect_anomaly(check_nan=True):
                loss.backward()
        except RuntimeError as err:
            if "nan" not in str(err).lower():
                raise
            raise FloatingPointError(f"NaN in the backward pass (--debug-nans): {err}") from err


def _forward_context(cfg: SolTrainConfig):
    """Anomaly mode over the forward pass under cfg.debug_nans, so that a NaN
    found in the backward is reported with the forward op that made it."""
    return torch.autograd.detect_anomaly(check_nan=True) if cfg.debug_nans \
        else contextlib.nullcontext()


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
        with profiling.span("silt.net"):
            vel = vel + correction_to_staggered(model(karman_features(vel, re, norm)), norm, dom)
        return d.values, vel.u, vel.v, p, iters

    run_step = _checkpointed(step, cfg, model)

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
        _check_nan(cfg, k, density=dens, u=u, v=v, pressure=p, loss=step_losses[-1])
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
        with _forward_context(cfg), profiling.span("silt.train.forward"):
            loss, step_losses, cg_iters = karman_loss(flow, model, norm, data, idx, cfg, wgt)
        _backward(loss, cfg)
        applied = optimizer.step()
        return loss.detach(), step_losses.detach(), cg_iters, applied

    return train_step


def burgers_loss(flow: BurgersFlow, model: nn.Module, norm: Normalization,
                 data: Dict[str, torch.Tensor], idx: torch.Tensor, cfg: SolTrainConfig,
                 dt: float = 0.1, use_force: bool = True, wgt: Optional[torch.Tensor] = None):
    """The unrolled loss of one Burgers batch (the `loss_fn` of
    make_burgers_train_step).

    data: {u (S,F,Y,X+1), v, fu, fv} on the device; idx (B, 2) int64 (sim,
    frame0) pairs. Step k applies the force stored with frame frame0+k;
    without `use_force` the solver runs unforced and the features drop the
    force channels. Returns (loss, step_losses (msteps,)); loss is
    differentiable in the model's parameters."""
    dom = flow.domain
    msteps = cfg.msteps
    sim, frame0 = idx[:, 0], idx[:, 1]
    u, v = data["u"][sim, frame0], data["v"][sim, frame0]
    steps = torch.arange(msteps, device=idx.device)[:, None]
    gt_u = data["u"][sim[None, :], frame0[None, :] + 1 + steps]  # (msteps, B, Y, X+1)
    gt_v = data["v"][sim[None, :], frame0[None, :] + 1 + steps]
    f_u = data["fu"][sim[None, :], frame0[None, :] + steps]
    f_v = data["fv"][sim[None, :], frame0[None, :] + steps]
    w = torch.ones(idx.shape[0], device=u.device) if wgt is None else wgt
    std_v, std_u = norm.out_scales[0], norm.out_scales[1]

    def step(u, v, fu, fv):
        vel = StaggeredGrid(u, v, dom)
        force = StaggeredGrid(fu, fv, dom)
        if use_force:
            vel = flow.step_with_f(vel, force, dt=dt)
        else:
            vel = flow.step(vel, dt=dt)
        with profiling.span("silt.net"):
            feat = burgers_features(vel, force if use_force else None, norm)
            vel = vel + correction_to_staggered(model(feat), norm, dom)
        return vel.u, vel.v

    run_step = _checkpointed(step, cfg, model)
    step_losses = []
    for k in range(msteps):
        u, v = run_step(u, v, f_u[k], f_v[k])
        step_losses.append(torch.sum(w * (l2_loss_rows((gt_v[k] - v) / std_v)
                                          + l2_loss_rows((gt_u[k] - u) / std_u))))
        _check_nan(cfg, k, u=u, v=v, loss=step_losses[-1])
    step_losses = torch.stack(step_losses)
    return torch.sum(step_losses) / msteps, step_losses


def make_burgers_train_step(flow: BurgersFlow, model: nn.Module, optimizer: GuardedAdam,
                            cfg: SolTrainConfig, dt: float = 0.1,
                            use_force: bool = True) -> Callable:
    """(data, norm, idx) -> (loss, step_losses, None, applied): one
    forward-backward through the Burgers unroll and one guarded optimizer
    step (None where the karman step returns its CG iterations)."""

    def train_step(data, norm, idx, wgt=None):
        optimizer.zero_grad()
        with _forward_context(cfg), profiling.span("silt.train.forward"):
            loss, step_losses = burgers_loss(flow, model, norm, data, idx, cfg, dt, use_force,
                                             wgt)
        _backward(loss, cfg)
        applied = optimizer.step()
        return loss.detach(), step_losses.detach(), None, applied

    return train_step


@dataclasses.dataclass
class TrainResult:
    losses: list
    iter_seconds: list = dataclasses.field(default_factory=list)  # every iteration, in order
    notfinite: int = 0                 # gradients the guard found not finite
    cg_iters: list = dataclasses.field(default_factory=list)  # forward CG iterations per step (karman)


def local_batch(idx: np.ndarray, mesh: Optional[pmesh.Mesh], pad_batch_to: Optional[int],
                device):
    """An iteration's (B, 2) index rows as this rank runs them: padded to
    `pad_batch_to` with zero-weighted copies of row 0 (parallel/mesh.py
    `padded_batch`), then its rows of them (`batch_rows`); without a mesh
    all of them. Returns (idx, weights or None) on `device`."""
    idx, wgt = pmesh.padded_batch(idx, pad_batch_to)
    if mesh is not None:
        rows = pmesh.batch_rows(mesh, idx.shape[0])
        idx, wgt = idx[rows], (None if wgt is None else wgt[rows])
    idx = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(device, non_blocking=True)
    return idx, (None if wgt is None else torch.from_numpy(wgt).to(device))


def run_training(train_step, optimizer: GuardedAdam, data: Dict[str, torch.Tensor],
                 norm: Normalization, schedule: EpochSchedule, cfg: SolTrainConfig,
                 start_epoch: int = 0, on_epoch_end: Optional[Callable] = None,
                 metrics_writer=None, mesh: Optional[pmesh.Mesh] = None,
                 pad_batch_to: Optional[int] = None) -> TrainResult:
    """Epoch loop of solver_in_the_loop_tpu/train/trainer.py `run_training`
    (reference karman_train.py:483-514): the epoch's learning rate (the
    --adplr schedule, times WARMUP_LR_SCALE in warm-up epochs), one train step
    per index row, the loss logged every LOG_EVERY iterations and written
    to the metrics writer. Timing: each iteration ends when its loss has been
    read from the device, after the guard has read its gradients' flag.

    A resumed run (`start_epoch` N > 0) skips epochs 0..N-1 as the JAX loop
    does: each still draws its shuffle, so the data order stays that of an
    uninterrupted run, and advances the metrics' step; the --adplr schedule
    is not stepped for them (the reference's own behaviour, kept).

    Data-parallel (`mesh`): every rank draws the same schedule and runs its
    rows of each iteration's batch, padded to `pad_batch_to` as the JAX loop
    pads it (`local_batch`); the loss and the per-step losses are summed over
    the ranks, so every rank logs and returns the global loss. The forward
    CG iterations are this rank's. Only a rank given a metrics writer
    writes."""
    device = data["u"].device
    current_lr = cfg.lr
    losses, iter_seconds, cg_iters = [], [], []
    global_step = 0
    for epoch in range(cfg.epochs):
        idx_epoch = schedule.epoch_indices(cfg.msteps)
        if epoch < start_epoch:
            global_step += idx_epoch.shape[0]
            continue
        current_lr = lr_schedule_step(epoch, current_lr) if cfg.adplr else cfg.lr
        eff_lr = current_lr * (WARMUP_LR_SCALE if epoch < cfg.warmup_epochs else 1.0)
        optimizer.set_learning_rate(eff_lr)
        t_prev = time.perf_counter()
        for it in range(idx_epoch.shape[0]):
            idx, wgt = local_batch(idx_epoch[it], mesh, pad_batch_to, device)
            batch = (idx,) if wgt is None else (idx, wgt)
            loss, step_losses, iters, _ = train_step(data, norm, *batch)
            if mesh is not None:
                loss, step_losses = pmesh.all_reduce_sum([loss, step_losses], mesh)
            loss_f = float(loss)
            now = time.perf_counter()
            iter_seconds.append(now - t_prev)
            t_prev = now
            losses.append(loss_f)
            if iters is not None:
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
        if optimizer.total_notfinite:
            log.warning("epoch %03d: %d non-finite update(s) skipped so far "
                        "(apply_if_finite guard)", epoch + 1, optimizer.total_notfinite)
        if on_epoch_end is not None:
            on_epoch_end(epoch)
    iters_np = torch.stack(cg_iters).cpu().numpy().tolist() if cg_iters else []
    return TrainResult(losses, iter_seconds, optimizer.total_notfinite, iters_np)
