"""What the port is held to against its plain path and the JAX package: the
kernels' tolerances, the swap to the plain twins, and the SOL-32 train step
and training set that chip_smoke.py and the tests share.

Imports nothing of JAX. The inputs are made with numpy or read from the
repository (artifacts/a3_k_sol32, tests/data/torch_port), so the JAX package
computes its side from the same arrays (tests/test_torch_train_golden.py).
"""

from __future__ import annotations

import contextlib
import json
import os
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "a3_k_sol32")
DATA = os.path.join(REPO, "tests", "data", "torch_port")
TRAIN_GOLDEN = os.path.join(DATA, "karman_train_step_sol32.npz")
# the first 40 frames (1000..1039) of the Makefile's karman-fdt-hires-set,
# 4x downsampled to 64x32, as the JAX package writes and reads them
TRAIN_SET = os.path.join(DATA, "karman_hires_set_head_ds.npz")
# chip_smoke's `train` phase trains with --seed TRAIN_SEED. Whether a fresh
# glorot net's 32-step unroll stays bounded depends on the draw: on
# TRAIN_SET the first losses of seeds 0..7 lie between 1.8e7 and 4.8e17
# (karman_train_fixture_first_batch.json). Seed 1 starts at 1.8e7, near the
# JAX package's own seed-0 draw (9.6e6 there; 1.35e7 in its real run,
# artifacts/a3_k_sol32/run.log); the port's seed 0 starts at 3.0e12.
TRAIN_SEED = 1

# train_parity: one SOL-32 step (MarsMoon 32x5, batch 3, msteps 32, 64x32)
PARITY_RE = [160000.0, 320000.0, 640000.0]
PARITY_MSTEPS = 32
PARITY_SEED = 0
PARITY_NOISE = 0.05

# Tolerances. The tap-sum kernel rounds every multiply and add on its own
# in the twin's order, so it must match bit for bit. The PCG kernel sums its
# dot products and matrix products in another order than the twin (cuBLAS
# einsums, torch.sum), so the iterates differ in the last bits: the iteration
# counts may differ by one and the solutions by 1e-4 of their max, the order
# of the CG tolerance 1e-5 amplified by the operator's condition. The rollout
# feeds such differences back through 20 steps of a chaotic flow, hence 1e-3.
TAP_SUM_TOL = 0.0
# The backward kernel's ddy and ddx follow the twin's order exactly (0.0). Its
# dV gathers what the twin scatters with index_add_, which on the card adds
# with atomics in no fixed order: where an OPEN edge cell is read by several
# destinations with nonzero weights (offsets that leave the field, which the
# solver's clamps never pass), those few terms may be summed in another order,
# a few float32 ulps of the sum. Offsets clamped as the solver clamps them give
# those terms exact zero weights, and dV must then match bit for bit too.
TAP_SUM_BWD_DV_REL_TOL = 1e-6
PCG_REL_TOL = 1e-4
PCG_ITER_TOL = 1
ROLLOUT_REL_TOL = 1e-3
# One SOL-32 train step against another: the forward and the adjoint of each
# of the 32 steps are CG solves to tol 1e-5, whose iterates differ in the last
# bits between the kernel, the plain twin and XLA (other summation orders) and
# may stop an iteration apart. The losses move by about that tolerance; the
# gradients, a sum over 32 steps of such solves, by more. On the CPU the
# port's plain path is within 3e-7 (step losses) and 3.2e-5 (gradient norms)
# of the JAX golden (tests/test_torch_train_golden.py); the bounds leave room
# for the kernel's own order.
TRAIN_PARITY_TOL = {"loss": 1e-4, "step_losses": 1e-4, "grad_norms": 1e-3, "head_grad": 1e-3}


@contextlib.contextmanager
def plain_path():
    """Swap every kernel's wrapper for its plain PyTorch twin at its one
    dispatch point (the module-level wrapper that the differentiable ops
    call, forward and backward), so the same code runs without a kernel."""
    from solver_in_the_loop_torch.kernels import advect, cg

    with mock.patch.object(advect, "tap_sum_fwd", advect.tap_sum_fwd_plain), \
            mock.patch.object(advect, "tap_sum_bwd", advect.tap_sum_bwd_plain), \
            mock.patch.object(cg, "pcg_solve", cg.pcg_solve_plain):
        yield


def train_set():
    """TRAIN_SET as numpy {dens (6, 40, 64, 32), u, v (staggered), re (6,)}."""
    with np.load(TRAIN_SET) as f:
        return {k: f[k] for k in ("dens", "u", "v", "re")}


def train_parity_inputs():
    """The inputs of the train-parity step: three batch rows (Re 160000 *
    2^i) that start from the built-in initial state, with ground-truth frames
    1..32 that are that state plus noise from numpy's RandomState(PARITY_SEED),
    and the trained SOL-32 checkpoint's statistics. Returns (data of numpy
    arrays, idx (3, 2), stats)."""
    from solver_in_the_loop_torch.physics.karman import initial_state, karman_domain

    dom = karman_domain(32)
    d0, v0 = initial_state(dom, 1)
    rng = np.random.RandomState(PARITY_SEED)
    rows, frames = len(PARITY_RE), PARITY_MSTEPS + 1

    def window(field):
        x = np.broadcast_to(field.numpy()[None], (rows, frames) + tuple(field.shape[1:]))
        noise = PARITY_NOISE * rng.randn(*x.shape)
        noise[:, 0] = 0.0
        return (x + noise).astype(np.float32)

    data = {"dens": window(d0.values), "u": window(v0.u), "v": window(v0.v),
            "re": np.asarray(PARITY_RE, np.float32)}
    idx = np.stack([np.arange(rows), np.zeros(rows, np.int64)], axis=1)
    with open(os.path.join(CKPT, "dataStats.json")) as f:
        stats = json.load(f)
    return data, idx, stats


def parity_model(device):
    """The trained SOL-32 MarsMoon (artifacts/a3_k_sol32) on `device`."""
    from solver_in_the_loop_torch.models.networks import build_model
    from solver_in_the_loop_torch.train import checkpoint as ckpt

    with open(os.path.join(CKPT, "dataStats.json")) as f:
        slope = json.load(f)["leaky_alpha"]
    model = build_model("mars_moon", leaky_slope=slope)
    ckpt.load_model_weights(model, os.path.join(CKPT, "model.msgpack"), "mars_moon")
    return model.to(device)


def parity_step(device):
    """One SOL-32 train step's loss and gradients on `device` (no update):
    (loss, step_losses (32,), forward CG iterations, {param name: grad})."""
    from solver_in_the_loop_torch.models.features import Normalization
    from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
    from solver_in_the_loop_torch.train.trainer import SolTrainConfig, karman_loss

    data, idx, stats = train_parity_inputs()
    model = parity_model(device)
    flow = KarmanFlow(karman_domain(32), advection="shift", max_shift=2, device=device)
    norm = Normalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"], device)
    cfg = SolTrainConfig(msteps=PARITY_MSTEPS, clip_grad=True)
    tdata = {k: torch.from_numpy(a).to(device) for k, a in data.items()}
    loss, step_losses, iters = karman_loss(flow, model, norm, tdata,
                                           torch.from_numpy(idx).to(device), cfg)
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return loss.item(), step_losses.detach().cpu(), iters.cpu(), grads


def parity_summary(step):
    """What is compared of a step (as parity_step returns it): (loss, step
    losses, {param name: gradient norm}, head conv gradient). The JAX golden
    file holds the same four."""
    loss, steps, _, grads = step
    return (loss, steps.numpy(), {n: float(g.norm()) for n, g in grads.items()},
            grads["head.weight"].numpy())


def train_golden_summary():
    """The JAX package's parity step (TRAIN_GOLDEN), laid out as
    parity_summary lays out the port's."""
    with np.load(TRAIN_GOLDEN) as g:
        return (float(g["loss"]), g["step_losses"],
                dict(zip(g["grad_names"].tolist(), g["grad_norms"].tolist())),
                g["head_weight_grad"])


def parity_errors(got, want):
    """Relative errors of one parity summary against another: the loss, the
    worst step loss, the worst per-parameter gradient norm, and the head
    conv's whole gradient as a share of its max."""
    loss, steps, norms, head = got
    w_loss, w_steps, w_norms, w_head = want
    return {"loss": abs(loss - w_loss) / abs(w_loss),
            "step_losses": float(np.max(np.abs(steps - w_steps) / np.abs(w_steps))),
            "grad_norms": max(abs(norms[n] - w) / w for n, w in w_norms.items()),
            "head_grad": float(np.abs(head - w_head).max() / np.abs(w_head).max())}
