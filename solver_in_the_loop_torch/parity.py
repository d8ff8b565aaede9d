"""What the port is held to against its plain path and the JAX package: the
kernels' tolerances, the swap to the plain twins, the karman SOL-32 train
step and training set, the karman-gen hi-res command and golden, and the
Burgers SOL-04 apply and train-step inputs that chip_smoke.py and the tests
share.

Imports nothing of JAX. The inputs are made with numpy or read from the
repository (artifacts/a3_k_sol32, artifacts/a3_b_sol04, tests/data/torch_port),
so the JAX package computes its side from the same arrays
(tests/test_torch_train_golden.py, tests/test_torch_burgers_golden.py).
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
# The unpreconditioned CG kernel against its twin: it has no matrix products,
# so its iterates part from the twin's only through the order of the dot
# products' sums; it is held to one iteration and 5e-6 of the solution's max.
CG_REL_TOL = 5e-6
CG_ITER_TOL = 1
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
# The conv kernels against their twins, relative to the output's max: the
# kernel sums each output on the tensor cores in 3xTF32 (fp32's accuracy,
# in another order), the twin per tap as a matmul, so the two differ in the
# last bits of sums of K*K*Cin products (forward, 1e-5) and of M = B*H*W
# products (weight gradient, 1e-4). One TF32 product per term would not
# meet either (tests/test_torch_conv.py).
CONV_FWD_REL_TOL = 1e-5
CONV_WGRAD_REL_TOL = 1e-4
# The bf16 conv kernels against their twins (and the twins against the JAX
# Pallas conv on bf16 inputs). Both sum exact bf16 products in fp32, in
# another order (the kernel on the tensor cores, whose fp32 sums truncate),
# and round the forward's output (and the VJP's dX, dW and db) to bf16 once.
# The two fp32 sums differ by a few fp32 roundings of the partial sums, at
# most CONV_FWD_REL_TOL of the output's max as for the fp32 kernels; where
# they straddle a rounding boundary the bf16 values land one ulp apart. So
# each bf16 output element is held to CONV_BF16_ULPS bf16 ulp (2^-7 of its
# binade) of its magnitude plus CONV_FWD_REL_TOL of the output's max
# (`bf16_errors`): the second term matters only for elements that cancel to
# near 0, whose bf16 ulp is below the fp32 sums' own rounding. The weight
# gradient's fp32 sum, before its rounding, is held to
# CONV_WGRAD_BF16_REL_TOL of its max: M = B*H*W exact products summed in
# fp32 in another order.
CONV_BF16_ULPS = 1
CONV_WGRAD_BF16_REL_TOL = 1e-5
# One SOL-04 train step with --bf16 against the JAX package's --bf16 step.
# bf16 keeps 8 bits, so a value rounds to 2^-9 of itself; wherever the two
# sides' fp32 sums land on either side of a rounding boundary, a conv's
# output, and then everything downstream in the 4-step unroll, moves by
# such a step. Measured on the CPU (the kernel's twin against the JAX Pallas
# conv in interpret mode, tests/test_torch_burgers_golden.py): loss 2.2e-5,
# step losses 4.2e-5, gradient norms 5.6e-3 (a bias: db is a sum of 5,120
# bf16 values), head gradient 2.2e-3; the bounds leave about 4x for the
# card's summation order.
TRAIN_PARITY_TOL_BF16 = {"loss": 2e-4, "step_losses": 2e-4, "grad_norms": 2e-2, "head_grad": 2e-2}
# Under --conv library the biases' gradients are left out of that
# comparison: XLA on the CPU sums the broadcast bias's cotangent in bf16 (on
# a (5, 32, 32, 32) cotangent 22 % of the sum's max off the exact sum, where
# jnp.sum, which accumulates in fp32, is within 0.24 %), torch in fp32
# (tests/test_torch_bf16.py `test_xla_cpu_sums_a_bias_cotangent_in_bf16`).
# The weights' gradient norms agree within 1.9e-3 there.

# Burgers: the trained SOL-04 MarsMoon (32x5, 4 input channels) and the JAX
# golden of its apply (frames of the Makefile's test sim seed 100) and of one
# full-width train step (tests/test_torch_burgers_golden.py)
BURGERS_CKPT = os.path.join(REPO, "artifacts", "a3_b_sol04")
BURGERS_APPLY_GOLDEN = os.path.join(DATA, "burgers_apply_sol04_r32.npz")
BURGERS_TRAIN_GOLDEN = os.path.join(DATA, "burgers_train_step_sol04.npz")
# the same step with --bf16 and the JAX Pallas conv (interpret mode)
BURGERS_TRAIN_GOLDEN_BF16 = os.path.join(DATA, "burgers_train_step_sol04_bf16.npz")
# the Makefile's test-set command (burgers-fdt-hires-testset) for seed 100
BURGERS_GEN_ARGV = ["-r", "128", "-l", "32", "--dt", "0.1", "-s", "30", "--seed", "100"]
BURGERS_GOLDEN_STEPS = 20  # frames of the apply golden, and forces it replays
# a Burgers hi-res frame against the JAX package's: 229 steps of the same
# float32 formulas, whose sin and sums differ in the last bits
BURGERS_GEN_REL_TOL = 1e-4
# train parity: one SOL-04 step (batch 5, msteps 4, 32x32) from numpy inputs
BURGERS_PARITY_ROWS = 5
BURGERS_PARITY_MSTEPS = 4
BURGERS_DT = 0.1

# karman-gen: the Makefile's hi-res training-set command (karman-fdt-hires-set,
# without --thumb), 6 Re batched at 256x128, solved with multigrid; the JAX
# golden holds its frames KARMAN_GEN_STEPS of sims KARMAN_GEN_SIMS
# (tests/test_torch_karman_gen_golden.py), held within ROLLOUT_REL_TOL
KARMAN_GEN_GOLDEN = os.path.join(DATA, "karman_gen_hires_r128.npz")
KARMAN_HIRES_RE = [160000.0, 320000.0, 640000.0, 1280000.0, 2560000.0, 5120000.0]
KARMAN_HIRES_ARGV = ["-r", "128", "-l", "100", "--seed", "0",
                     "--re", *[str(int(r)) for r in KARMAN_HIRES_RE]]
KARMAN_GEN_STEPS = (1, 5, 20)
KARMAN_GEN_SIMS = (0, 5)


@contextlib.contextmanager
def plain_path():
    """Swap every kernel's wrapper for its plain PyTorch twin at its one
    dispatch point (the module-level wrapper that the differentiable ops
    call, forward and backward), so the same code runs without a kernel."""
    from solver_in_the_loop_torch.kernels import advect, cg, conv

    with mock.patch.object(advect, "tap_sum_fwd", advect.tap_sum_fwd_plain), \
            mock.patch.object(advect, "tap_sum_bwd", advect.tap_sum_bwd_plain), \
            mock.patch.object(cg, "pcg_solve", cg.pcg_solve_plain), \
            mock.patch.object(cg, "cg_solve", cg.cg_solve_plain), \
            mock.patch.object(conv, "conv_fwd", conv.conv_fwd_plain), \
            mock.patch.object(conv, "conv_wgrad", conv.conv_wgrad_plain), \
            mock.patch.object(conv, "conv_fwd_bf16", conv.conv_fwd_plain), \
            mock.patch.object(conv, "conv_wgrad_bf16", conv.conv_wgrad_plain):
        yield


def tap_sum_offsets(shape, kind: str, m: int, periodic: bool, gen: torch.Generator, device):
    """Tap-sum offsets for the kernel checks: "uniform" in +-(m+0.5) (beyond
    the taps' reach), "integer" (the same rounded: every tap on a kink or a
    tie of the hat weights), or "clamped" (uniform, then clamped as the
    solver clamps them, ops/interp.py: to +-m and, OPEN, into the field)."""
    dy, dx = ((torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * (m + 0.5)
              for _ in range(2))
    if kind == "integer":
        return dy.round(), dx.round()
    if kind == "clamped":
        dy, dx = dy.clamp(-m, m), dx.clamp(-m, m)
        if not periodic:
            jj = torch.arange(shape[1], device=device, dtype=dy.dtype)[None, :, None]
            ii = torch.arange(shape[2], device=device, dtype=dy.dtype)[None, None, :]
            dy = torch.clamp(jj + dy, 0.0, shape[1] - 1.0) - jj
            dx = torch.clamp(ii + dx, 0.0, shape[2] - 1.0) - ii
    return dy.contiguous(), dx.contiguous()


def train_set():
    """TRAIN_SET as numpy {dens (6, 40, 64, 32), u, v (staggered), re (6,)}."""
    with np.load(TRAIN_SET) as f:
        return {k: f[k] for k in ("dens", "u", "v", "re")}


def train_parity_inputs(rows: int = len(PARITY_RE)):
    """The inputs of the train-parity step: three batch rows (Re 160000 *
    2^i, PARITY_RE; `rows` of them cycle through it) that start from the
    built-in initial state, with ground-truth frames 1..32 that are that
    state plus noise from numpy's RandomState(PARITY_SEED), and the trained
    SOL-32 checkpoint's statistics. Returns (data of numpy arrays, idx
    (rows, 2), stats)."""
    from solver_in_the_loop_torch.physics.karman import initial_state, karman_domain

    dom = karman_domain(32)
    d0, v0 = initial_state(dom, 1)
    rng = np.random.RandomState(PARITY_SEED)
    frames = PARITY_MSTEPS + 1

    def window(field):
        x = np.broadcast_to(field.numpy()[None], (rows, frames) + tuple(field.shape[1:]))
        noise = PARITY_NOISE * rng.randn(*x.shape)
        noise[:, 0] = 0.0
        return (x + noise).astype(np.float32)

    data = {"dens": window(d0.values), "u": window(v0.u), "v": window(v0.v),
            "re": np.asarray([PARITY_RE[i % len(PARITY_RE)] for i in range(rows)], np.float32)}
    idx = np.stack([np.arange(rows), np.zeros(rows, np.int64)], axis=1)
    with open(os.path.join(CKPT, "dataStats.json")) as f:
        stats = json.load(f)
    return data, idx, stats


def parity_model(device, conv: str = "library", ckpt_dir: str = CKPT, in_channels: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
    """A trained MarsMoon (default the SOL-32 karman one, artifacts/a3_k_sol32)
    on `device`, its convolutions run as `conv` says in `compute_dtype`."""
    from solver_in_the_loop_torch.models.networks import build_model
    from solver_in_the_loop_torch.train import checkpoint as ckpt

    with open(os.path.join(ckpt_dir, "dataStats.json")) as f:
        slope = json.load(f)["leaky_alpha"]
    model = build_model("mars_moon", in_channels=in_channels, leaky_slope=slope, conv=conv,
                        compute_dtype=compute_dtype)
    ckpt.load_model_weights(model, os.path.join(ckpt_dir, "model.msgpack"), "mars_moon")
    return model.to(device)


def _loss_and_grads(model, loss_fn):
    loss, step_losses, *rest = loss_fn()
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return (loss.item(), step_losses.detach().cpu(), *(r.cpu() for r in rest), grads)


def pretf_model(device, pretf_dir: str, conv: str = "library"):
    """The PRE net of `pretf_dir` (model.msgpack, stats.json) as
    `karman-train --pretf` starts from it: (model, its stats)."""
    from solver_in_the_loop_torch.models.networks import build_model
    from solver_in_the_loop_torch.train import checkpoint as ckpt

    with open(os.path.join(pretf_dir, "stats.json")) as f:
        pre = json.load(f)
    model = build_model("mars_moon", leaky_slope=pre.get("leaky_alpha", 0.01), conv=conv)
    ckpt.load_model_weights(model, os.path.join(pretf_dir, "model.msgpack"), "mars_moon")
    return model.to(device), pre


def parity_step(device, conv: str = "library", precon: str = "fd",
                compute_dtype: torch.dtype = torch.float32, pretf: str = None,
                rows: int = len(PARITY_RE)):
    """One SOL-32 train step's loss and gradients on `device` (no update),
    its pressure solves preconditioned as `precon` says, the net computing
    in `compute_dtype`, at a batch of `rows` (`train_parity_inputs`): (loss,
    step_losses (32,), forward CG iterations, {param name: grad}). With
    `pretf` (a PRE net's directory) the net and the velocity scales are
    those `karman-train --pretf` adopts."""
    from solver_in_the_loop_torch.models.features import Normalization
    from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
    from solver_in_the_loop_torch.train.trainer import SolTrainConfig, karman_loss

    data, idx, stats = train_parity_inputs(rows)
    flow = KarmanFlow(karman_domain(32), advection="shift", max_shift=2, pressure_precon=precon,
                      device=device)
    if pretf is None:
        model = parity_model(device, conv, compute_dtype=compute_dtype)
        norm = Normalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"], device)
    else:
        model, pre = pretf_model(device, pretf, conv)
        norm = Normalization(
            torch.tensor([pre["in.std"][0], pre["in.std"][1], stats["ext.std"]],
                         dtype=torch.float32, device=device),
            torch.tensor(pre["out.std"][:2], dtype=torch.float32, device=device))
    cfg = SolTrainConfig(msteps=PARITY_MSTEPS, clip_grad=True)
    tdata = {k: torch.from_numpy(a).to(device) for k, a in data.items()}
    return _loss_and_grads(model, lambda: karman_loss(flow, model, norm, tdata,
                                                      torch.from_numpy(idx).to(device), cfg))


def burgers_train_parity_inputs():
    """The inputs of the Burgers train-parity step: BURGERS_PARITY_ROWS rows
    that start from numpy's randfreq initial velocity (RandomState(
    PARITY_SEED), the generator's scale), with ground-truth frames 1..4 that
    are that velocity plus noise, and per-frame forces of 20 random sine
    forces advanced by BURGERS_DT per frame; and the trained SOL-04
    checkpoint's statistics. Made on the CPU, so every device gets the same
    arrays. Returns (data {u, v, fu, fv} of numpy arrays (rows, msteps+1,
    ...), idx (rows, 2), stats)."""
    from solver_in_the_loop_torch.core.random_fields import randfreq_staggered
    from solver_in_the_loop_torch.physics.burgers import (
        burgers_domain,
        random_forces,
        sample_force_sum,
    )

    dom = burgers_domain(32)
    rows, frames = BURGERS_PARITY_ROWS, BURGERS_PARITY_MSTEPS + 1
    rng = np.random.RandomState(PARITY_SEED)
    forces = random_forces(rng, batch=rows)
    v0 = randfreq_staggered(rng, dom, batch=rows)
    data = {}
    for key, field in (("u", v0.u), ("v", v0.v)):
        x = np.repeat(field.numpy()[:, None], frames, axis=1)
        noise = PARITY_NOISE * rng.randn(*x.shape)
        noise[:, 0] = 0.0
        data[key] = (x + noise).astype(np.float32)
    sampled = [sample_force_sum([f.advance(BURGERS_DT * t) for f in forces], dom, rows)
               for t in range(frames)]
    data["fu"] = np.stack([s.u.numpy() for s in sampled], axis=1)
    data["fv"] = np.stack([s.v.numpy() for s in sampled], axis=1)
    idx = np.stack([np.arange(rows), np.zeros(rows, np.int64)], axis=1)
    with open(os.path.join(BURGERS_CKPT, "dataStats.json")) as f:
        stats = json.load(f)
    return data, idx, stats


def burgers_parity_step(device, conv: str = "library", remat_policy: str = "pressure+conv",
                        compute_dtype: torch.dtype = torch.float32):
    """One SOL-04 train step's loss and gradients on `device` (no update), from
    the trained artifacts/a3_b_sol04 net computing in `compute_dtype`:
    (loss, step_losses (4,), {param name: grad})."""
    from solver_in_the_loop_torch.models.features import Normalization
    from solver_in_the_loop_torch.physics.burgers import BurgersFlow, burgers_domain
    from solver_in_the_loop_torch.train.trainer import SolTrainConfig, burgers_loss

    data, idx, stats = burgers_train_parity_inputs()
    model = parity_model(device, conv, BURGERS_CKPT, in_channels=4, compute_dtype=compute_dtype)
    flow = BurgersFlow(burgers_domain(32), advection="shift", max_shift=2)
    norm = Normalization.burgers(stats["std.v"], stats["std.u"], stats["std.fv"],
                                 stats["std.fu"], device)
    cfg = SolTrainConfig(msteps=BURGERS_PARITY_MSTEPS, clip_grad=True, remat_policy=remat_policy)
    tdata = {k: torch.from_numpy(a).to(device) for k, a in data.items()}
    return _loss_and_grads(model, lambda: burgers_loss(flow, model, norm, tdata,
                                                       torch.from_numpy(idx).to(device), cfg,
                                                       BURGERS_DT))


def burgers_apply_inputs(dirpath: str) -> dict:
    """The Burgers apply golden's inputs written as a scene the CLI reads at
    `-d 1 -r 32`: the test sim's hi-res frame 0, downsampled 4x on the CPU,
    as velo_000000.npz, and its first BURGERS_GOLDEN_STEPS downsampled forces
    as forc_%06d.npz. Returns the CLI's --initvH and --loadfH arguments."""
    from solver_in_the_loop_torch.core.resample import downsample_staggered
    from solver_in_the_loop_torch.io import scene as scene_io

    with np.load(BURGERS_APPLY_GOLDEN) as g:
        u_hi, v_hi = scene_io.legacy_to_staggered(g["velo_hi"])
        forces = g["forc_ds"]
    u, v = downsample_staggered(torch.from_numpy(u_hi), torch.from_numpy(v_hi), 4)
    sc = scene_io.Scene(dirpath)
    sc.write_staggered("velo", 0, u.numpy(), v.numpy())
    for t, legacy in enumerate(forces):
        scene_io.write_array(sc.frame_path("forc", t), legacy)
    return {"initvH": sc.frame_path("velo", 0), "loadfH": os.path.join(dirpath, "forc_0*.npz")}


def burgers_apply_argv(out: str, inputs: dict, conv: str = "library") -> list:
    """burgers-apply's arguments for BURGERS_GOLDEN_STEPS steps of the SOL-04
    rollout from burgers_apply_inputs (already at 32x32, so -d 1)."""
    return ["-o", out, "--model", os.path.join(BURGERS_CKPT, "model.msgpack"),
            "--stats", os.path.join(BURGERS_CKPT, "dataStats.json"),
            "--initvH", inputs["initvH"], "--loadfH", inputs["loadfH"], "-d", "1", "-r", "32",
            "-l", "32", "--dt", str(BURGERS_DT), "-t", str(BURGERS_GOLDEN_STEPS + 1),
            "--conv", conv]


def parity_summary(step):
    """What is compared of a step (as parity_step returns it): (loss, step
    losses, {param name: gradient norm}, head conv gradient). The JAX golden
    file holds the same four."""
    loss, steps, grads = step[0], step[1], step[-1]
    return (loss, steps.numpy(), {n: float(g.norm()) for n, g in grads.items()},
            grads["head.weight"].numpy())


def train_golden_summary(path: str = TRAIN_GOLDEN, prefix: str = ""):
    """A JAX package's parity step (default the karman TRAIN_GOLDEN; its keys
    with `prefix`), laid out as parity_summary lays out the port's."""
    with np.load(path) as g:
        return (float(g[f"{prefix}loss"]), g[f"{prefix}step_losses"],
                dict(zip(g[f"{prefix}grad_names"].tolist(), g[f"{prefix}grad_norms"].tolist())),
                g[f"{prefix}head_weight_grad"])


def parity_errors(got, want, params=None):
    """Relative errors of one parity summary against another: the loss, the
    worst step loss, the worst per-parameter gradient norm (of the
    parameters named by `params`, default all), and the head conv's whole
    gradient as a share of its max."""
    loss, steps, norms, head = got
    w_loss, w_steps, w_norms, w_head = want
    names = w_norms if params is None else params
    return {"loss": abs(loss - w_loss) / abs(w_loss),
            "step_losses": float(np.max(np.abs(steps - w_steps) / np.abs(w_steps))),
            "grad_norms": max(abs(norms[n] - w_norms[n]) / w_norms[n] for n in names),
            "head_grad": float(np.abs(head - w_head).max() / np.abs(w_head).max())}


def bf16_errors(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| of two bf16 tensors over its allowance: one
    bf16 ulp of the element's magnitude (max(|got|, |want|)) plus
    CONV_FWD_REL_TOL of want's max. Held to CONV_BF16_ULPS."""
    got, want = got.float(), want.float()
    sums = CONV_FWD_REL_TOL * float(want.abs().max())
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / (ulp + sums)).max())


# PRE (tests/test_torch_pre_golden.py makes the JAX goldens). karman-pre-gen
# at the Makefile's width (-r 32: 64x32 lo-res, 256x128 hi-res, Re 160000),
# cut from 1500 frames to KARMAN_PRE_FRAMES with PRE_SKIP skipped, with
# --beta 1 (PRE) and --beta 0 (PRE-SR); the golden holds the lo-res frames
# PRE_GOLDEN_FRAMES of both and the hi-res ones of the last
KARMAN_PRE_GEN_GOLDEN = os.path.join(DATA, "karman_pre_gen_r32.npz")
KARMAN_PRE_FRAMES = 30
PRE_SKIP = 20
KARMAN_PRE_GEN_ARGV = ["-r", "32", "-l", "100", "--re", "160000", "--seed", "0",
                       "-t", str(KARMAN_PRE_FRAMES), "-s", str(PRE_SKIP)]
PRE_BETAS = ("1.0", "0")
PRE_GOLDEN_FRAMES = (21, 25, 29)
PRE_LO_NAMES = ("densC", "veloC", "dens", "velo", "corr")
# a karman correction's constraint: G^T corr on the valid cells within this
# share of max |corr_u| (the JAX package's bound, tests/test_pre_lsq.py; the
# golden frames sit at 1e-5 to 2e-5)
PRE_DIV_TOL = 5e-3
# the constrained correction of two float32 implementations (the JAX
# package's and the port's, or the port's inner solve on the fused CG kernel
# and on `tree_cg`): within this share of the correction's max, the order of
# the inner solve's 1e-4 stop (tests/test_torch_pre_lsq.py measures it)
CONSTRAINED_REL_TOL = 1e-3
PRE_HI_NAMES = ("densH", "veloH")
# burgers-pre-gen of the Makefile's test sim seed 100 (BURGERS_GEN_ARGV)
# at its width (-r 32: 32x32 lo-res from the 128x128 frames), cut from 200
# frames to BURGERS_PRE_FRAMES
BURGERS_PRE_GEN_GOLDEN = os.path.join(DATA, "burgers_pre_gen_r32.npz")
BURGERS_PRE_FRAMES = 20
BURGERS_PRE_GOLDEN_FRAMES = (1, 5, 19)
BURGERS_PRE_NAMES = ("veloC", "velo", "corr", "forc")
# the PRE rollouts: karman-pre-apply of artifacts/k_pre_train from the
# built-in initial state at -r 32, Re 240000 (the first test Re), and
# burgers-pre-apply on the Burgers apply golden's inputs with
# artifacts/b_pre_train (MarsMoon) and a JupiterMoon of seeded weights
PRE_APPLY_GOLDEN = os.path.join(DATA, "pre_apply_r32.npz")
PRE_APPLY_STEPS = 20
PRE_APPLY_GOLDEN_STEPS = (1, 5, 20)  # the steps the golden keeps
KARMAN_PRE_CKPT = os.path.join(REPO, "artifacts", "k_pre_train")
KARMAN_PRESR_CKPT = os.path.join(REPO, "artifacts", "k_presr_train")
BURGERS_PRE_CKPT = os.path.join(REPO, "artifacts", "b_pre_train")
PRE_APPLY_RE = 240000.0
JUPITER_SEED = 3
# pre-train: two epochs (--resume 1 --epochs 3) from a start checkpoint of
# seeded weights on the PRE golden frames, both scenarios, against the JAX
# CLI's run from the same start (PRE_TRAIN_GOLDEN)
PRE_TRAIN_GOLDEN = os.path.join(DATA, "pre_train_r32.npz")
PRE_TRAIN_ARGV = ["--seed", "0", "--val", "0.2", "--augment", "--bsize", "4", "--steps", "3",
                  "--resume", "1", "--epochs", "3", "--nostats"]
PRE_TRAIN_SEED = 5
# Two epochs (6 Adam steps) from the same start on the same batches and
# flips. Adam moves a weight by about lr * m / sqrt(v), about lr * sign(g) in
# its first steps, so an element whose gradient is near 0 may step the
# other way on the other side: after one step the weights agree within
# 4.5e-5, after three hundreds of elements a leaf sit 2 lr (2e-3) apart
# (JupiterMoon on random data, on the CPU), and the function moves with
# them. So each leaf is held in norm (||port - JAX|| / ||JAX||) and the
# epochs' mean losses in relative terms. Measured: on the CPU at most 7e-6
# (karman MarsMoon), 9e-5 (Burgers JupiterMoon on the golden frames) and
# 2.3e-3 (JupiterMoon on random frames), losses within 1e-4; on the card
# with the conv kernels 5.3e-4 (karman) and 1.7e-3 (Burgers JupiterMoon),
# losses within 8.6e-4 (measured on one NVIDIA H100 80GB HBM3 at 700.00 W
# by chip_smoke.py's pre_train phase)
PRE_TRAIN_REL_TOL = 1e-2
PRE_LOSS_REL_TOL = 2e-3
# stats.json on another machine: numpy's float32 sums in another order
PRE_STATS_REL_TOL = 1e-6


def seeded_weights(model, seed: int):
    """Set every conv's kernel to numpy glorot-uniform draws from
    RandomState(seed) in construction order, and its bias to 0.01 times
    normal draws: weights that every device and both packages rebuild from
    the seed alone. Returns the model."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for conv in (m for m in model.modules() if isinstance(m, torch.nn.Conv2d)):
            w = conv.weight
            receptive = w.shape[2] * w.shape[3]
            limit = np.sqrt(6.0 / (receptive * (w.shape[0] + w.shape[1])))
            w.copy_(torch.from_numpy(rng.uniform(-limit, limit, tuple(w.shape))
                                     .astype(np.float32)))
            conv.bias.copy_(torch.from_numpy(0.01 * rng.randn(*conv.bias.shape)
                                             .astype(np.float32)))
    return model


def jupiter_checkpoint(out_dir: str, leaky: float = 0.3) -> dict:
    """A JupiterMoon (4 input channels) of seeded weights (JUPITER_SEED),
    written as out_dir/model.msgpack with the Burgers PRE net's stats.json
    (BURGERS_PRE_CKPT's, at slope `leaky`). Returns the apply CLIs'
    --model and --stats arguments."""
    from solver_in_the_loop_torch.models.networks import build_model
    from solver_in_the_loop_torch.train import checkpoint as ckpt

    model = seeded_weights(build_model("jupiter_moon", in_channels=4), JUPITER_SEED)
    ckpt.save_checkpoint(out_dir, model, "jupiter_moon")
    with open(os.path.join(BURGERS_PRE_CKPT, "stats.json")) as f:
        stats = json.load(f)
    stats["leaky_alpha"] = leaky
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    return {"model": os.path.join(out_dir, "model.msgpack"),
            "stats": os.path.join(out_dir, "stats.json")}


def karman_pre_apply_argv(out: str, ckpt_dir: str = KARMAN_PRE_CKPT,
                          steps: int = PRE_APPLY_STEPS) -> list:
    """karman-pre-apply's arguments for `steps` steps of a PRE net's rollout
    at -r 32 from the built-in initial state, Re PRE_APPLY_RE."""
    return ["-o", out, "--model", os.path.join(ckpt_dir, "model.msgpack"),
            "--stats", os.path.join(ckpt_dir, "stats.json"), "-r", "32", "-l", "100",
            "--re", str(int(PRE_APPLY_RE)), "-t", str(steps + 1)]


def burgers_pre_apply_argv(out: str, inputs: dict, model: str, stats: str, arch: str,
                           steps: int = PRE_APPLY_STEPS) -> list:
    """burgers-pre-apply's arguments for `steps` steps from
    burgers_apply_inputs (already at 32x32, so -d 1)."""
    return ["-o", out, "--model", model, "--stats", stats, "--arch", arch,
            "--initvH", inputs["initvH"], "--loadfH", inputs["loadfH"], "-d", "1", "-r", "32",
            "-l", "32", "--dt", str(BURGERS_DT), "-t", str(steps + 1)]


def write_pre_set(out: str, scenario: str) -> list:
    """The PRE training set of the pre-train parity: the PRE golden frames
    (karman: both betas' PRE_GOLDEN_FRAMES, one scene each, Re 160000;
    Burgers: BURGERS_PRE_GOLDEN_FRAMES) written as PRE scenes under `out`.
    Returns the trainer's scene patterns."""
    from solver_in_the_loop_torch.io import scene as scene_io

    golden = KARMAN_PRE_GEN_GOLDEN if scenario == "karman" else BURGERS_PRE_GEN_GOLDEN
    with np.load(golden) as g:
        groups = ([(f"b{b}_", PRE_GOLDEN_FRAMES) for b in PRE_BETAS] if scenario == "karman"
                  else [("", BURGERS_PRE_GOLDEN_FRAMES)])
        names = ("velo", "corr") if scenario == "karman" else ("velo", "corr", "forc")
        for prefix, frames in groups:
            sc = scene_io.Scene.create(out)
            sc.write_params({"re": 160000.0} if scenario == "karman" else {})
            for name in names:
                for f in frames:
                    scene_io.write_array(sc.frame_path(name, f), g[f"{prefix}{name}_{f}"])
    return [os.path.join(out, "sim_0*")]


def write_pre_start(opath: str, scenario: str, arch: str, leaky: float = 0.3) -> None:
    """The start of the pre-train parity: opath/model_epoch0001.msgpack with
    seeded weights (PRE_TRAIN_SEED) and a fresh Adam state, which both
    packages' `--resume 1` load."""
    from solver_in_the_loop_torch.models.networks import build_model
    from solver_in_the_loop_torch.train import checkpoint as ckpt

    model = seeded_weights(build_model(arch, in_channels=3 if scenario == "karman" else 4,
                                       leaky_slope=leaky), PRE_TRAIN_SEED)
    adam = torch.optim.Adam(model.parameters(), lr=1e-3)
    ckpt.save_checkpoint(opath, model, arch, adam, epoch=1)


def stats_errors(got: dict, want: dict) -> float:
    """The largest relative difference of two stats.json dicts' numbers
    (inf where a key or a non-number differs)."""
    if set(got) != set(want):
        return float("inf")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (list, float)) and not isinstance(w, bool):
            g, w = (np.atleast_1d(np.asarray(a, np.float64)) for a in (g, w))
            if g.shape != w.shape:
                return float("inf")
            worst = max(worst, float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30))))
        elif g != w:
            return float("inf")
    return worst


def pre_train_golden(scenario: str) -> dict:
    """The pre-train golden of `scenario`: "losses", "leaves" ({port name:
    array}) and "stats"."""
    prefix = f"{scenario}_leaf_"
    with np.load(PRE_TRAIN_GOLDEN) as g:
        return {"losses": g[f"{scenario}_losses"],
                "leaves": {k[len(prefix):]: g[k] for k in g.files if k.startswith(prefix)},
                "stats": json.loads(str(g[f"{scenario}_stats"]))}


def leaf_errors(got: dict, want: dict) -> dict:
    """{name: ||got - want|| / ||want||} of two {name: array} parameter sets."""
    return {n: float(np.linalg.norm(np.asarray(got[n], np.float64) - want[n])
                     / max(np.linalg.norm(want[n]), 1e-30)) for n in want}
