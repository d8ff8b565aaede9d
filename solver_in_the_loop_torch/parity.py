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


def parity_step(device, conv: str = "library", precon: str = "fd",
                compute_dtype: torch.dtype = torch.float32):
    """One SOL-32 train step's loss and gradients on `device` (no update),
    its pressure solves preconditioned as `precon` says, the net computing
    in `compute_dtype`: (loss, step_losses (32,), forward CG iterations,
    {param name: grad})."""
    from solver_in_the_loop_torch.models.features import Normalization
    from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
    from solver_in_the_loop_torch.train.trainer import SolTrainConfig, karman_loss

    data, idx, stats = train_parity_inputs()
    model = parity_model(device, conv, compute_dtype=compute_dtype)
    flow = KarmanFlow(karman_domain(32), advection="shift", max_shift=2, pressure_precon=precon,
                      device=device)
    norm = Normalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"], device)
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


def train_golden_summary(path: str = TRAIN_GOLDEN):
    """A JAX package's parity step (default the karman TRAIN_GOLDEN), laid out
    as parity_summary lays out the port's."""
    with np.load(path) as g:
        return (float(g["loss"]), g["step_losses"],
                dict(zip(g["grad_names"].tolist(), g["grad_norms"].tolist())),
                g["head_weight_grad"])


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
