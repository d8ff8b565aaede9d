#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and `nvcc`
(under $CUDA_HOME or /usr/local/cuda). It imports nothing of JAX. Phases,
each printing one JSON line:

1. env          — card, power limit, torch and CUDA versions
2. build        — compiles every kernel of solver_in_the_loop_torch/csrc with
                  nvcc, one process per source, all started together
3. kernels      — each kernel (tap-sum forward and backward, PCG, CG without
                  preconditioner, the conv kernels in fp32 and in bf16)
                  against its plain PyTorch twin on the card,
                  at the shapes of the karman apply, training and generation
                  paths (the tap-sums also at the Burgers fields and at
                  max_shift 1 and 3, with each launch's grid and block; the
                  CG kernels also at a shape off their 16x8 tiles, with a
                  second launch's bits), with its time, the twin's and its
                  bound; both CG kernels at fixed iteration counts, the
                  time of one iteration and of the set-up; and
                  solve_pressure where its route is not the 64x32 kernel
                  (the plain FD-PCG loop at a batch above 128; the cluster
                  layout at -r 48, -r 65, 128x64, -r 67, -r 79, 256x128 at
                  batch 1, 3 and 5, -r 192 and -r 267), against the CPU,
                  with its time per solve and the plain loop's iterations
                  in float32 and float64 on both devices;
                  the cluster layout (csrc/cg_cluster.cu, both
                  instantiations) against its twin at CLUSTER_CASES, cold,
                  warm and adjoint, timed beside the route the card took
                  there before it
4. apply        — `karman-apply` through the CLI entry point at the full width
                  of the SOL-32 MarsMoon checkpoint (artifacts/a3_k_sol32), 500
                  steps at batch 1 and at batch 5, each after a one-step
                  warm-up run at its batch size, with the kernels' launch counts
5. parity       — steps 1, 5 and 20 of that batch-1 run against the same CLI
                  run on the port's plain path and against frames the JAX
                  package produced on the CPU (tests/data/torch_port/)
6. profile      — where a batch-1 rollout step's time goes (torch.profiler)
7. train        — `karman-train` through the CLI entry point: the Makefile's
                  SOL-32 run (MarsMoon 32x5, batch 3, msteps 32, 64x32) on the
                  first 40 frames of its training set, cut to 16 iterations
                  (TRAIN_REDUCED), with the kernels' launch counts, the CG
                  iterations forward and adjoint, the updates the guard let
                  through, the trace its --profile wrote, and `karman-apply`
                  from the checkpoint it wrote
8. train_parity — one SOL-32 train step on the kernel path against the same
                  step on the plain path and against the JAX package's step
                  (tests/data/torch_port/karman_train_step_sol32.npz)
8b.             — the same step with the nets' convs in the port's conv kernels
                  (`--conv kernel`) against the same golden
9. train_profile — where a training iteration's time goes (torch.profiler)
10. burgers_gen — `burgers-gen --thumb` through the CLI: the Makefile's
                  hi-res training set (seeds 0-9, 128x128, 30 skipped steps)
                  cut to 40 frames, and its test sim seed 100 at the full 200
                  frames; frame 0 of seed 100 against the JAX package's, and
                  the thumbnails' count
11. burgers_train — `burgers-train --conv kernel` through the CLI: the
                  Makefile's SOL-04 run (MarsMoon 32x5, batch 5, msteps 4,
                  32x32) on that set, cut to 1 epoch of 72 iterations
                  (BURGERS_TRAIN_REDUCED), with the kernels' launch counts
11b. burgers_train_bf16 — the same with --bf16 on the bf16 conv kernels, cut
                  to 8 iterations: their launch counts; one full-width SOL-04
                  --bf16 train step against the JAX golden
                  (tests/data/torch_port/burgers_train_step_sol04_bf16.npz),
                  the plain path and cuDNN's bf16 conv; a SOL-32 step's
                  bf16 launches
11c. karman_train_bf16 — `karman-train --bf16 --conv kernel` through the CLI
                  on the train phase's set cut to 8 iterations: finite
                  losses, an update applied, 767 bf16 convs and 384 bf16
                  weight gradients per iteration
11d. resume     — `burgers-train --conv kernel` for 11 epochs, and for 10
                  then `--resume 10 --epochs 11`: the same parameters, bit
                  for bit
12. burgers_apply — `burgers-apply --conv kernel` through the CLI: the
                  Makefile's SOL-04 run_test of the test sim (199 steps) with
                  the trained artifacts/a3_b_sol04 net, after a warm-up run,
                  with the launch counts; and the same run with `--conv library`
13. burgers_parity — 20 steps of that CLI on the JAX golden's inputs against
                  the JAX golden frames, the `--conv library` run and the
                  plain path (tests/data/torch_port/burgers_apply_sol04_r32.npz)
14. burgers_train_parity — one full-width SOL-04 train step with the conv
                  kernels against the JAX package's
                  (tests/data/torch_port/burgers_train_step_sol04.npz)
15. burgers_profile — where a SOL-04 training iteration's and an apply
                  step's time goes, with the conv kernels and with cuDNN
16. karman_gen  — `karman-gen --thumb` through the CLI: the Makefile's hi-res
                  training set (256x128, the 6 Re batched, multigrid pressure
                  solve) cut to KARMAN_GEN_FRAMES frames from step 0
                  (KARMAN_GEN_REDUCED); steps 1, 5 and 20 of sims 0 and 5
                  against the JAX package's
                  (tests/data/torch_port/karman_gen_hires_r128.npz), the
                  thumbnails' count and one against the thumbnail rule, and
                  a profile of its steps
16a. vcycle_kernel — the multigrid V-cycle's kernels (csrc/vcycle.cu) against
                  the plain `_v_cycle` bit for bit at (6, 256, 128) and (1,
                  384, 192), their launches an apply, and the device ms of an
                  apply: launched directly, from the V-cycle's graph, and the
                  plain ops' graph, beside the bytes bound
16b. evaluate   — `karman-apply` of the SOL-32 net from sim 0's frame 0, then
                  `evaluate` against that sim on the card and on the CPU
17. karman_gen_lores — the Makefile's lo-res source run for Re 160000 (64x32,
                  499 steps) from the last frame of sim 0 of that set, with
                  the FD-preconditioned kernel and with the plain CG kernel
                  (`--pressure-precon none`), held to each other
17b. karman_gen_r67 — `karman-gen -r 67` (134x67) for 5 steps with each
                  `--pressure-precon`: one launch of the cluster layout a
                  step and nothing else, frames against the CPU's
18. apply_cg    — `karman-apply --pressure-precon none` at batch 1 and 5, 500
                  steps, the CG kernel's launch counts, and the batch-1 run's
                  steps 1, 5 and 20 against the JAX golden of the apply phase
19. train_parity_cg — the SOL-32 train step with `--pressure-precon none`
                  against the plain path and the JAX package's step
20. apply_b9    — `karman-apply` at batch 9, one more than a thread-block
                  cluster, where the CG kernels run as a cooperative grid, with
                  each `--pressure-precon`: launch counts, and frames against
                  the plain path and the JAX golden
21. pre_gen     — `karman-pre-gen --thumb` through the CLI at the Makefile's
                  width (-r 32: 256x128 hi-res on the cluster layout, 64x32
                  lo-res on the PCG kernel, Re 160000), --beta 1.0 cut to 54
                  frames and --beta 0 cut to 30 (PRE_GEN_REDUCED), after a
                  2-frame warm-up: a pcg_solve and two pcg_cluster_solve
                  launches a frame, a cg_solve a projection of the
                  correction solve, frames 21, 25 and 29
                  against the JAX golden
                  (tests/data/torch_port/karman_pre_gen_r32.npz), every kept
                  correction held to its constraint, seconds per frame split
                  into its four stages, and the correction solve's outer and
                  inner iterations; then 4 frames with the hi-res solves on
                  multigrid and on the cluster layout
22. burgers_pre_gen — `burgers-pre-gen --thumb` -r 32 on the burgers_gen
                  phase's test sim, cut to 35 frames: frames 1, 5 and 19
                  against the JAX golden (burgers_pre_gen_r32.npz)
23. pre_train   — `karman-pre-train --augment --conv kernel` on pre_gen's PRE
                  set and `burgers-pre-train --model jupiter_moon --augment
                  --conv kernel` on burgers_pre_gen's, cut to PRE_TRAIN_EPOCHS
                  epochs of PRE_TRAIN_STEPS full batches of 32, with the
                  histograms: conv launches per step, finite
                  losses, seconds per epoch; and each trainer's two epochs from
                  a seeded start on the golden frames against the JAX golden
                  (pre_train_r32.npz)
24. pre_apply   — `karman-pre-apply` of artifacts/k_pre_train at batch 1, 500
                  steps, with the conv kernels and with cuDNN (3 tap-sums, 1
                  PCG and 12 convs per step), PRE-SR's k_presr_train for 20
                  steps, and `burgers-pre-apply` of artifacts/b_pre_train and
                  a seeded JupiterMoon on the test sim, 199 steps: launches,
                  seconds per step, steps 1, 5 and 20 against the JAX golden
                  (pre_apply_r32.npz)
25. pretf       — `karman-train --pretf artifacts/k_pre_train/model.msgpack`
                  for 2 SOL-32 iterations on the train phase's set: the
                  adopted stats and slope, the launches; and the SOL-32 step
                  from that net against the JAX golden
26. dp_single   — `karman-train --dp --conv kernel` without a launcher, a
                  group of one over NCCL, 4 SOL-32 iterations between two
                  runs without --dp:
                  losses and model.msgpack bit for bit, launches, s/iteration
27. dp_shared   — `python -m torch.distributed.run --nproc-per-node 2
                  chip_smoke.py --dp-rank DIR`: two ranks on the one card over
                  gloo run `karman-train --dp --conv kernel --init zero`
                  (batch 3 padded to 4) and
                  `burgers-train --dp --conv kernel` (batch 5 padded to 6)
                  through the CLI entry point, 4 iterations each: each rank's
                  launches, the losses and leaf norms against the runs
                  without --dp
28. spatial     — the same launcher with `--spatial-rank DIR`: the y-sharded
                  karman step (parallel/spatial.py) on two ranks at 64x32
                  and 256x128, batch 1, `--advect gather` and `shift`, on
                  the FD-PCG (pressure_backend "xla"); at 256x128, batch 1
                  and 6, `shift`, on multigrid ("auto"), its iterations
                  against the unsharded `mg_solve`'s, and one backward at
                  batch 1 against the unsharded step's gradient; each
                  against the unsharded step on the card, the tap-sum
                  launches per rank (each held against its plain twin on
                  the rank's haloed block), ms per step of both
29. flags       — the paths no other phase runs, each through its CLI for 2
                  iterations or 20 steps: karman-train with `--advect
                  gather`, `-m 1`, `--remat-policy pressure` and
                  `pressure+advect`, `--no-remat`, `--pressure-precon
                  none`, `--model mercury`; karman-apply `--arch mercury`;
                  burgers-gen, -train and -apply with `--noforce`; the
                  SOL-32 train step at batch 9 (cooperative grid). Launches
                  against the code's count, first losses (the CPU's first
                  iteration) and frames against the same argv on the CPU

The kernels phase also checks the CG kernel's adjoint and the conv kernels
(forward, input gradient and weight gradient) at the Burgers and karman shapes,
JupiterMoon's and the PRE trainers' batch of 32 among them, and times them
beside cuDNN. Then a line of each phase's wall seconds, the
per-kernel summary line, the card's `nvidia-smi` name and power limit, and as
the last line {"ok": true, "device": {...}}. Any failed check raises, so the script exits non-zero without that
line; without CUDA, or outside a checkout, it exits 1 at once.

    python3 chip_smoke.py --cg-split LABEL=DIR [LABEL=DIR ...]

runs only the CG kernels' fixed-iteration timing, built from each DIR (see
`cg_split`): the 64x32 kernels label by label, the cluster layout's two
instantiations at CG_SPLIT_CLUSTER with the labels in turns, e.g. `old=`
an unpacked `git archive HEAD solver_in_the_loop_torch/csrc`
`new=solver_in_the_loop_torch/csrc` for a change's before and after on one
card;

    python3 chip_smoke.py --cg-ablate DIR [LABEL=DIR ...]

the same on a cluster layout's csrc/ (DIR: this one, or the earlier one
from `git archive 04510b4 solver_in_the_loop_torch/csrc` unpacked) and on
copies of it with a part of the iteration cut out (`CG_ABLATIONS`,
`CG_ABLATIONS_SPLIT_ROWS`), and any further labels;

    python3 chip_smoke.py --cg-general DIR

the general layouts of the one-block CG kernels as csrc/ held them before
the cluster layout (DIR: that csrc/) against the cluster layout (see
`cg_general`), and

    python3 chip_smoke.py --conv-split [fwd] LABEL=DIR [LABEL=DIR ...]

only the bf16 weight gradient's, at every CONV_BF16_GRAD_CASES shape beside
cuDNN's, or with `fwd` the bf16 forward's at every CONV_BF16_CASES shape and
as the input gradient at every CONV_BF16_GRAD_CASES shape, built from each
DIR (see `conv_split`).

    python3 chip_smoke.py --dp-rank DIR | --spatial-rank DIR

is one rank of the dp_shared or the spatial phase, which starts two of
them under `torch.distributed.run`. """

from __future__ import annotations

import contextlib
import functools
import glob
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "artifacts", "a3_k_sol32")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port", "karman_apply_sol32_r32.npz")
OUT_DIR = os.path.join(REPO, "build", "smoke_out")
RE_B1 = [240000.0]
RE_B5 = [240000.0, 480000.0, 960000.0, 1920000.0, 3840000.0]
RE_B8 = RE_B5 + [160000.0, 320000.0, 640000.0]  # a full cluster of the CG kernels
RE_B9 = RE_B8 + [1280000.0]  # more than a cluster: the CG kernels' cooperative grid
B9_STEPS = 100
ODD_RES = 18  # karman at 36x18: sides that are not multiples of the PCG kernel's 16x8 tiles
FIXED_ITERS = (8, 24)  # the fixed iteration counts that time one CG iteration
STEPS = 500
APPLY_SHAPES = [(1, 64, 32), (1, 64, 33), (1, 65, 32), (5, 64, 32), (5, 64, 33), (5, 65, 32)]
TRAIN_SHAPES = [(3, 64, 32), (3, 64, 33), (3, 65, 32)]
# train: the Makefile's SOL-32 run, cut to fit the script
FIXTURE_DIR = os.path.join(REPO, "build", "smoke_fixture")
TRAIN_OUT = os.path.join(REPO, "build", "smoke_train")
# the train phase's --profile run: its own --tf and trace directory
TRAIN_PROFILE_OUT = os.path.join(REPO, "build", "smoke_train_profile")
TRAIN_TRACE = os.path.join(TRAIN_PROFILE_OUT, "trace")
TRAIN_FRAMES = 40
TRAIN_ITERS = 2 * (TRAIN_FRAMES - 32)  # 6 sims / batch 3 x (frames - msteps)
TRAIN_REDUCED = {
    "simsteps": "500 -> 40 frames per sim (1000..1039): 16 iterations, all in the warm-up "
                "epoch",
    "epochs": "100 -> 1",
    "training set": "karman-fdt-hires-set (256x128, frames 1000..1499 from karman-gen; not in "
                    "the repository) -> its first 40 frames, made by the JAX package's "
                    "karman-gen and 4x downsampled (tests/data/torch_port/"
                    "karman_hires_set_head_ds.npz), written as the ds_ frames --skip-ds reads",
    "seed": "0 -> 1: the port's seed-0 glorot draw overflows the unroll on this set "
            "(solver_in_the_loop_torch/parity.py TRAIN_SEED)",
}

# Burgers: the Makefile's hi-res sets (burgers-fdt-hires-set, -testset) and
# its SOL-04 training (burgers-fdt-sol04), cut to fit the script
BURGERS_SET = os.path.join(REPO, "build", "smoke_burgers_set")
BURGERS_TEST = os.path.join(REPO, "build", "smoke_burgers_test")
BURGERS_TF = os.path.join(REPO, "build", "smoke_burgers_tf")
BURGERS_SEEDS = range(10)
BURGERS_SET_FRAMES = 40
BURGERS_TEST_FRAMES = 200
BURGERS_MSTEPS = 4
BURGERS_ITERS = 2 * (BURGERS_SET_FRAMES - BURGERS_MSTEPS)  # 10 sims / batch 5 x (frames - msteps)
BURGERS_TRAIN_REDUCED = {
    "simsteps": "200 -> 40 frames per sim: 72 iterations",
    "epochs": "100 -> 1",
    "training set": "burgers-fdt-hires-set (seeds 0-9, -t 200) -> the same command with -t 40, "
                    "made by the port's burgers-gen in the burgers_gen phase",
}

# karman: the Makefile's hi-res set (karman-fdt-hires-set) and its lo-res
# source runs (karman-fdt-lores-set), cut to fit the script
KARMAN_SET = os.path.join(REPO, "build", "smoke_karman_set")
KARMAN_LORES = os.path.join(REPO, "build", "smoke_karman_lores")
KARMAN_GEN_FRAMES = 21  # up to step 20, the last the golden holds
KARMAN_GEN_REDUCED = {
    "simsteps": "1500 -> 21 frames, all kept (-s 999 -> -s 0): 20 steps from the initial "
                "state, where the Makefile keeps frames 1000..1499 of 1,500",
}
KARMAN_LORES_REDUCED = {
    "initial frame": "sim_000000 frame 1000 of the full hi-res set -> its frame "
                     f"{KARMAN_GEN_FRAMES - 1}, the last of the cut set",
    "Re": "the 6 runs of the Makefile's loop -> the first (Re 160000)",
}
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, FP32 FLOP/s
# outside the tensor cores, TF32 FLOP/s on them
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
# evaluate on the card against the CPU: float32 means of the same values in
# another summation order
EVAL_REL_TOL = 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, n: int, reps: int = 3) -> float:
    """Mean device time of fn over n back-to-back calls, by CUDA events; the
    least of `reps` such runs.

    The calls are queued behind a spin kernel that outlasts their host-side
    issue time, so for a function that does not synchronize, the events see
    the device run the n calls back to back and not the host's issue rate (a
    kernel of a few microseconds is shorter than its Python wrapper). Where
    the host is held up beyond the spin (its cores are shared), a run sees
    the issue rate instead: 34 us for a 7 us kernel once in a run of the
    whole script; the least of the runs is the device's. A function that
    synchronizes (the plain PCG's .item() stop checks) is timed as it runs,
    host time included; one run (`reps` 1) is enough for such a twin."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    issue_s = (time.perf_counter() - t0) / 3 * n
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(reps):
        torch.cuda._sleep(int(min(1.5 * issue_s, 0.5) * 2e9))  # ~2 GHz SM clock
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return min(runs)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _bound(nbytes: float, ops: float, flops: float = FP32_FLOPS):
    """(least time in ms at the card's peak rates, "bytes" or "operations"):
    the bytes at the HBM rate against the operations at `flops`."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tap_sum_bound_ms(shape):
    """Three inputs read and one output written once; per cell the operations
    the 2x2 window needs (csrc/advect.cu): two floors, four hat weights of 4
    operations and four taps of 3 (weight product, multiply, add). Fewer
    where the window is clipped; the bytes bound it either way. max_shift
    does not enter: the taps outside the window carry no weight."""
    cells = shape[0] * shape[1] * shape[2]
    return _bound(16 * cells, cells * (2 + 4 * 4 + 4 * 3))


def tap_sum_bwd_bound_ms(shape):
    """Four inputs read and three outputs written once; per cell the
    operations the windows need (csrc/advect.cu): two floors and four hat
    weights (18), eight hat weights and slopes of the 4x4 slope window (8
    each), 16 taps of ddy and ddx (7 each: g*V, two weight products, two
    multiplies, two adds) and at most four dV terms (3 each). Fewer where a
    window is clipped; the bytes bound it either way."""
    cells = shape[0] * shape[1] * shape[2]
    return _bound(28 * cells, cells * (18 + 8 * 8 + 16 * 7 + 4 * 3))


def pcg_bound_ms(shape, iters: int):
    """Inputs (b, x0, fluid, face masks, Vy, Vx, invd) read and x written once;
    per element and iteration (plus the set-up pass) the four preconditioner
    products 4HW(H+W), at fp32 accuracy, which on the tensor cores is three
    TF32 products each (3xTF32) at the TF32 rate, as conv_bound_ms reckons
    them, and about 28 operations per cell of operator, dots and updates at
    the fp32 rate."""
    b, h, w = shape
    byts = 4 * (3 * b * h * w + 2 * h * w + h * (w + 1) + (h + 1) * w + h * h + w * w)
    passes = b * (iters + 1)
    t_bytes = 1e3 * byts / HBM_BYTES_PER_S
    t_ops = 1e3 * passes * (3 * 4 * h * w * (h + w) / TF32_FLOPS + 28 * h * w / FP32_FLOPS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cg_bound_ms(shape, iters: int):
    """Inputs (b, x0, fluid, face masks) read and x written once; per element
    and iteration (plus the set-up pass) about 26 operations per cell: the
    operator 16, the two dot products 4, the three vector updates 6."""
    b, h, w = shape
    byts = 4 * (3 * b * h * w + h * w + h * (w + 1) + (h + 1) * w)
    return _bound(byts, b * (iters + 1) * 26 * h * w)


def conv_bound_ms(shape, with_skip: bool):
    """x, w, bias (and skip) read and y written once; the 2*M*K*K*Cin*Cout
    operations of the products and their sums at fp32 accuracy, which on the
    tensor cores is three TF32 products each (3xTF32) at the TF32 rate."""
    b, h, w, cin, cout, k = shape
    m = b * h * w
    byts = 4 * (m * cin + k * k * cin * cout + cout + m * cout * (2 if with_skip else 1))
    return _bound(byts, 3 * 2 * m * k * k * cin * cout, TF32_FLOPS)


def conv_wgrad_bound_ms(shape):
    """x and dz read and dW written once; 3 x 2*M*K*K*Cin*Cout operations at
    the TF32 rate, as conv_bound_ms."""
    b, h, w, cin, cout, k = shape
    m = b * h * w
    return _bound(4 * (m * cin + m * cout + k * k * cin * cout), 3 * 2 * m * k * k * cin * cout,
                  TF32_FLOPS)


def conv_bf16_bound_ms(shape, with_skip: bool):
    """x, w, bias (and skip) read and y written once in bf16; the
    2*M*K*K*Cin*Cout operations of one bf16 product per term at the bf16
    tensor-core rate."""
    b, h, w, cin, cout, k = shape
    m = b * h * w
    byts = 2 * (m * cin + k * k * cin * cout + cout + m * cout * (2 if with_skip else 1))
    return _bound(byts, 2 * m * k * k * cin * cout, BF16_FLOPS)


def conv_wgrad_bf16_bound_ms(shape):
    """x and dz read in bf16 and dW written in fp32 once; 2*M*K*K*Cin*Cout
    operations at the bf16 rate."""
    b, h, w, cin, cout, k = shape
    m = b * h * w
    return _bound(2 * (m * cin + m * cout) + 4 * k * k * cin * cout,
                  2 * m * k * k * cin * cout, BF16_FLOPS)


def kernel_wrappers():
    """Every kernel's wrapper (each counts its launches), by kernel name; but
    the V-cycle's (kernels/vcycle.py `v_cycle`), which `phase_vcycle_kernel`
    and the `karman_gen` phase count."""
    from solver_in_the_loop_torch.kernels import advect, cg, conv

    return {"tap_sum_fwd": advect.tap_sum_fwd, "tap_sum_bwd": advect.tap_sum_bwd,
            "pcg_solve": cg.pcg_solve, "cg_solve": cg.cg_solve,
            "pcg_cluster_solve": cg.pcg_cluster_solve, "cg_cluster_solve": cg.cg_cluster_solve,
            "conv_fwd": conv.conv_fwd,
            "conv_wgrad": conv.conv_wgrad, "conv_fwd_bf16": conv.conv_fwd_bf16,
            "conv_wgrad_bf16": conv.conv_wgrad_bf16}


def counts(**launches) -> dict:
    """Launch counts of every kernel: those given, 0 for the others."""
    return {name: launches.get(name, 0) for name in kernel_wrappers()}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_env():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    emit({"phase": "env", "nvidia_smi": smi[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "python": sys.version.split()[0]})
    return smi[0]


def phase_build():
    from solver_in_the_loop_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all(force=True)
    seconds = time.perf_counter() - t0
    resident = cluster_residency()
    emit({"phase": "build", "seconds": seconds, "sources": report,
          "cluster_resident": resident})
    # the cluster layout: no spill in either instantiation; the card keeps
    # at least the clusters kernels/cg.py plans with resident at once
    spills = [ln for ln in report["cg_cluster"]["ptxas"]
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    require(not spills, f"the cluster CG kernels spill registers: {spills}")
    require(all(want <= got for want, got in zip(resident["planned"], resident["least"])),
            f"kernels/cg.py CLUSTER_RESIDENT {resident['planned']} above the card's "
            f"{resident['least']}")
    require(all(native == mirror for native, mirror in resident["smem"].values()),
            f"kernels/cg.py cluster_smem_bytes against csrc/cg_cluster.cu: {resident['smem']}")
    # no spill in the conv kernels, but for the bf16 forward at K = 7 (no net
    # of the repo has a 7x7 conv): it spills 4 bytes, more with its tap loop
    # rolled or its channel loop rolled (measured on the H100)
    for name in ("conv", "conv_bf16"):
        spills, entry = [], None
        for ln in report[name]["ptxas"]:
            if "Compiling entry function" in ln:
                entry = ln
            elif ("spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln
                  and "conv_fwd_bf16_kernelILi7E" not in (entry or "")):
                spills.append((entry, ln))
        require(not spills, f"the {name} kernels spill registers: {spills}")


# (precon, on chip, h, w, band) of csrc/cg_cluster.cu whose residency and
# shared memory the build phase reads: each variant at 256x128 (the most
# shared memory on chip: 208 KB with the preconditioner), 134x67, and the
# L2 variant at the largest elements the JAX gate takes
CLUSTER_VARIANTS = [(False, True, 256, 128, 16), (True, True, 256, 128, 16),
                    (True, True, 134, 67, 16), (False, True, 134, 67, 16),
                    (True, False, 534, 267, 48), (False, False, 626, 313, 48)]


def cluster_residency():
    """cudaOccupancyMaxActiveClusters of csrc/cg_cluster.cu by cluster size
    for each of CLUSTER_VARIANTS; "least" is the smallest of them, which
    kernels/cg.py CLUSTER_RESIDENT ("planned") must not exceed; and each
    variant's shared memory by the kernel's count against kernels/cg.py's
    mirror (`smem`: [native, mirror])."""
    from solver_in_the_loop_torch.kernels import cg

    sizes = range(1, cg.CLUSTER_MAX + 1)
    got, smem = {}, {}
    for precon, on_chip, h, w, band in CLUSTER_VARIANTS:
        key = f"{'pcg' if precon else 'cg'}_{'chip' if on_chip else 'l2'}_{h}x{w}_band{band}"
        got[key] = [cg.cluster_resident(precon, on_chip, h, w, c, band) for c in sizes]
        smem[key] = [cg.cluster_smem_native(precon, on_chip, h, w, band),
                     cg.cluster_smem_bytes(band, h, w, precon, on_chip)]
    return {**got, "least": [min(v[c - 1] for v in got.values()) for c in sizes],
            "planned": list(cg.CLUSTER_RESIDENT), "smem": smem}


def karman_rhs(batch_re, device, steps=30, res=32):
    """A real pressure problem on the card: the projection's RHS after `steps`
    solver steps on the plain path at resolution `res` (64x32 at 32), the
    previous step's pressure (the warm start), and the masks. Made once per
    arguments: the callers only read them."""
    return _karman_rhs(tuple(batch_re), device, steps, res)


@functools.lru_cache(maxsize=None)
def _karman_rhs(batch_re, device, steps, res):
    import torch

    from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
    from solver_in_the_loop_torch.ops.stencils import divergence
    from solver_in_the_loop_torch.parity import plain_path
    from solver_in_the_loop_torch.physics.karman import KarmanFlow, initial_state, karman_domain
    from solver_in_the_loop_torch.train.rollout import karman_rollout

    dom = karman_domain(res)
    flow = KarmanFlow(dom, advection="shift", max_shift=2, device=device)
    re = torch.tensor(list(batch_re), device=device)
    d0, v0 = initial_state(dom, len(batch_re), device)
    with torch.inference_mode(), plain_path():
        fr = karman_rollout(flow, d0, v0, re, steps)
        d = CenteredGrid(fr["dens"][-1], dom)
        v = StaggeredGrid(fr["u"][-1], fr["v"][-1], dom)
        d, v, p_prev, _ = flow.step(d, v, re)
        _, v = flow.pre_projection(d, v, re)
        masks = flow.masks
        div = divergence(v.u * masks.face_u, v.v * masks.face_v)
        rhs = torch.where(masks.fluid > 0, -div, 0.0).contiguous()
        x0 = torch.where(masks.fluid > 0, p_prev, 0.0).contiguous()
    return rhs, x0, masks


def _sample_grid(dy, dx):
    """The grid of F.grid_sample (align_corners=True) that samples each cell
    (j, i) at (j + dy, i + dx)."""
    import torch

    _, h, w = dy.shape
    jj = torch.arange(h, device=dy.device, dtype=dy.dtype)[None, :, None]
    ii = torch.arange(w, device=dy.device, dtype=dy.dtype)[None, None, :]
    return torch.stack([2.0 * (ii + dx) / (w - 1) - 1.0, 2.0 * (jj + dy) / (h - 1) - 1.0], -1)


def grid_sample_yardstick(vals, dy, dx, m):
    """The OPEN tap-sum's library call: bilinear F.grid_sample with the edge
    value repeated outside the field (padding_mode "border"), timed on the
    tap-sum's own inputs, offsets clamped as the solver clamps them, where
    the two compute the same function; and its difference from the
    tap-sum's twin there. A yardstick only: the port never calls it."""
    import torch.nn.functional as F

    from solver_in_the_loop_torch.kernels.advect import tap_sum_fwd_plain

    grid = _sample_grid(dy, dx)

    def sample():
        return F.grid_sample(vals[:, None], grid, mode="bilinear", padding_mode="border",
                             align_corners=True)[:, 0]

    err = float((sample() - tap_sum_fwd_plain(vals, dy, dx, m, False)).abs().max())
    return {"library_ms": time_ms(sample, 200), "library_max_abs_err": err}


# (shape, max_shift, periodic) of the tap-sum cases: the karman training and
# apply fields on both boundaries, the Burgers SOL-04 fields (PERIODIC), and
# max_shift 1 and 3 at the training shape
BURGERS_SHAPES = [(5, 32, 33), (5, 33, 32)]
TAP_CASES = ([(s, 2, p) for s in TRAIN_SHAPES + APPLY_SHAPES for p in (False, True)]
             + [(s, 2, True) for s in BURGERS_SHAPES]
             + [((3, 64, 32), m, p) for m in (1, 3) for p in (False, True)])


def tap_sum_cases(device):
    """Both tap-sum kernels against their twins at TAP_CASES, on "uniform",
    "integer" and "clamped" offsets: the forward, ddy and ddx bit for bit, dV
    bit for bit on clamped offsets and PERIODIC fields and within
    TAP_SUM_BWD_DV_REL_TOL on the rest (the card twin's index_add_ adds an
    OPEN edge cell's several non-zero terms with atomics). Each case prints
    its launch's grid and block. Timed on clamped offsets, the solver's
    (OPEN beside the library's grid_sample), and on uniform ones, where an
    OPEN backward takes its edge path: OPEN at max_shift 2 and every case
    that is not a karman field at max_shift 2."""
    import torch

    from solver_in_the_loop_torch.kernels.advect import (
        launch_config,
        tap_sum_bwd,
        tap_sum_bwd_plain,
        tap_sum_fwd,
        tap_sum_fwd_plain,
    )
    from solver_in_the_loop_torch.parity import (
        TAP_SUM_BWD_DV_REL_TOL,
        TAP_SUM_TOL,
        tap_sum_offsets,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    fwd_cases, bwd_cases = [], []
    for shape, m, periodic in TAP_CASES:
        timed = not periodic or m != 2 or shape in BURGERS_SHAPES
        for offsets in ("uniform", "integer", "clamped"):
            vals, g = (torch.randn(shape, generator=gen, device=device) for _ in range(2))
            dy, dx = tap_sum_offsets(shape, offsets, m, periodic, gen, device)
            base = {"shape": list(shape), "max_shift": m, "periodic": periodic,
                    "offsets": offsets}
            got = tap_sum_fwd(vals, dy, dx, m, periodic)
            want = tap_sum_fwd_plain(vals, dy, dx, m, periodic)
            torch.cuda.synchronize()
            case = {**base, "max_abs_err": float((got - want).abs().max()),
                    "launch": launch_config(shape, m, backward=False)}
            if timed and offsets != "integer":
                case["ms"] = time_ms(lambda: tap_sum_fwd(vals, dy, dx, m, periodic), 200)
                case["plain_ms"] = time_ms(lambda: tap_sum_fwd_plain(vals, dy, dx, m, periodic),
                                           5, reps=1)
                case["bound_ms"], case["bound_by"] = tap_sum_bound_ms(shape)
                case["library_ms"] = None
                if not periodic and offsets == "clamped":
                    case.update(grid_sample_yardstick(vals, dy, dx, m))
            fwd_cases.append(case)
            require(case["max_abs_err"] <= TAP_SUM_TOL,
                    f"tap_sum_fwd {case} differs from its plain twin")

            got = tap_sum_bwd(vals, dy, dx, g, m, periodic)
            want = tap_sum_bwd_plain(vals, dy, dx, g, m, periodic)
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
            dv_rel = errs[0] / float(want[0].abs().max())
            case = {**base, "max_abs_err": max(errs), "dv_abs_err": errs[0],
                    "dv_rel_err": dv_rel, "ddy_abs_err": errs[1], "ddx_abs_err": errs[2],
                    "launch": launch_config(shape, m, backward=True)}
            if timed and offsets != "integer":
                case["ms"] = time_ms(lambda: tap_sum_bwd(vals, dy, dx, g, m, periodic), 200)
                case["plain_ms"] = time_ms(
                    lambda: tap_sum_bwd_plain(vals, dy, dx, g, m, periodic), 5, reps=1)
                case["bound_ms"], case["bound_by"] = tap_sum_bwd_bound_ms(shape)
                case["library_ms"] = None
                if not periodic and offsets == "clamped":
                    grid = _sample_grid(dy, dx)
                    case["library_ms"] = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                        g[:, None], vals[:, None], grid, 0, 1, True, [True, True]), 200)
            bwd_cases.append(case)
            dv_tol = 0.0 if offsets == "clamped" or periodic else TAP_SUM_BWD_DV_REL_TOL
            require(errs[1] <= TAP_SUM_TOL and errs[2] <= TAP_SUM_TOL and dv_rel <= dv_tol,
                    f"tap_sum_bwd {case} differs from its plain twin")
    return fwd_cases, bwd_cases


def cg_problems(device):
    """The CG kernels' cases: karman at 64x32 and batch 1, 3 (training), 5, 8
    (a full cluster) and 9 (a cooperative grid), and at ODD_RES and batch 2."""
    from solver_in_the_loop_torch.parity import PARITY_RE

    return ([karman_rhs(batch_re, device) for batch_re in (RE_B1, PARITY_RE, RE_B5, RE_B8, RE_B9)]
            + [karman_rhs(RE_B5[:2], device, res=ODD_RES)])


# (Re values, res, precon) beside the 64x32 kernel cases: a batch above
# MAX_BATCH at 64x32, the plain FD-PCG loop with either precon; off
# multigrid's sizes at -r 48 and -r 65, and at 128x64, the cluster layout
# (csrc/cg_cluster.cu; at -r 48 without the preconditioner csrc/cg.cu's
# 1,024 threads); and the cluster layout where the card refused the shape
# before it (-r 67, -r 79, -r 267) or took multigrid (256x128 at the
# batches the JAX package's gate takes, -r 192)
ROUTE_CASES = [(RE_B8 * 16 + RE_B1, 32, "fd"), (RE_B8 * 16 + RE_B1, 32, "none"),
               (RE_B1, 48, "fd"), (RE_B1, 65, "fd"), (RE_B1, 65, "none"), (RE_B5[:2], 64, "fd"),
               (RE_B1, 67, "fd"), (RE_B1, 79, "none"), (RE_B1, 128, "fd"),
               (RE_B5[:3], 128, "fd"), (RE_B5, 128, "none"), (RE_B1, 192, "fd"),
               (RE_B1, 267, "fd")]


def pressure_route_cases(device):
    """solve_pressure at ROUTE_CASES on real karman right-hand sides, cold,
    under autograd (the adjoint is a cold solve by the same solver): the
    route and its launches (two of the kernel the route names, none on the
    plain route), the iterations, solution and gradient of a random
    cotangent against the CPU's with the same precon, and the wall ms of one
    solve, host included (the plain loop reads the host once per iteration),
    beside one wall-clock solve of multigrid's where the card took it before
    the kernel did, else of the plain FD-PCG loop.
    The iterations are held to those of the route's function in the plain
    loop (FD-PCG, or CG without the preconditioner) on the CPU; as a
    witness, that loop runs in float32 and in float64 on the card and on
    the CPU: where float64 agrees on both and float32 does not, the gap is
    rounding near the stop threshold."""
    import torch

    from solver_in_the_loop_torch.kernels import cg
    from solver_in_the_loop_torch.ops.poisson import (
        ProjectionMasks,
        _mg_applicable,
        fd_factors,
        pressure_cg_solve,
        pressure_route,
        solve_pressure,
    )
    from solver_in_the_loop_torch.parity import (
        CG_ITER_TOL,
        PCG_ITER_TOL,
        PCG_REL_TOL,
        TRAIN_PARITY_TOL,
    )

    cases = []
    for batch_re, res, precon in ROUTE_CASES:
        rhs, _, masks = karman_rhs(batch_re, device, res=res)
        route = pressure_route(rhs.shape, device, precon=precon)
        cot = torch.randn(rhs.shape, generator=torch.Generator(device=device).manual_seed(3),
                          device=device)
        reset_launches()
        div = (-rhs).requires_grad_()
        p, iters = solve_pressure(div, masks, precon=precon)
        (grad,) = torch.autograd.grad(p, div, cot)
        torch.cuda.synchronize()
        launches = read_launches()
        cpu_masks = ProjectionMasks(*(m.cpu() for m in (masks.fluid, masks.face_u, masks.face_v)))
        div_cpu = (-rhs).cpu().requires_grad_()
        p_cpu, iters_cpu = solve_pressure(div_cpu, cpu_masks, precon=precon)
        (grad_cpu,) = torch.autograd.grad(p_cpu, div_cpu, cot.cpu())
        witness = {}
        fd = precon == "fd" or route == "pcg_plain"
        for dtype in (torch.float32, torch.float64):
            for where, ms in (("card", masks), ("cpu", cpu_masks)):
                b = rhs.to(where if where == "cpu" else device, dtype)
                ops = [b, torch.zeros_like(b)] + [m.to(b) for m in (ms.fluid, ms.face_u,
                                                                      ms.face_v)]
                if fd:
                    ops += [f.to(b) for f in fd_factors(rhs.shape[1], rhs.shape[2], b.device)]
                solve = cg.pcg_solve_plain if fd else cg.cg_solve_plain
                witness[f"{where}_{str(dtype)[6:]}"] = int(solve(*ops, 1e-5, 1000)[1])
        bsz, h, w = rhs.shape
        kernel = {"pcg": "pcg_solve" if cg._pcg_fast(h, w) else "pcg_cluster_solve",
                  "cg": "cg_solve" if h * w <= cg.CG_MAX_CELLS else "cg_cluster_solve"}.get(route)
        case = {"shape": list(rhs.shape), "precon": precon, "route": route, "iters": int(iters),
                "cpu_iters": int(iters_cpu), "plain_loop_iters": witness,
                "rel_err": rel_err(p.detach().cpu(), p_cpu.detach()),
                "grad_rel_err": rel_err(grad.cpu(), grad_cpu),
                "kernel_launches": {k: v for k, v in launches.items() if v},
                "ms": time_ms(lambda: solve_pressure(-rhs, masks, precon=precon), 3)}
        ops = (rhs, torch.zeros_like(rhs), masks.fluid, masks.face_u, masks.face_v)
        if _mg_applicable(rhs.shape):  # the route the card took there before the kernel did
            case["multigrid_ms"] = _wall_ms(lambda: pressure_cg_solve(*ops, "multigrid", 1e-5,
                                                                      1000))
        elif route != "pcg_plain":  # the plain FD-PCG loop, the JAX package's XLA route
            case["pcg_plain_ms"] = _wall_ms(lambda: cg.pcg_solve_plain(
                *ops, *fd_factors(h, w, device), 1e-5, 1000))
        cases.append(case)
        expect = "pcg_plain" if len(batch_re) > cg.MAX_BATCH else "pcg" if fd else "cg"
        require(route == expect and case["kernel_launches"] == ({kernel: 2} if kernel else {}),
                f"pressure route {case}")
        # the iterations against the route's plain loop on the CPU (at 128x64
        # the CPU takes multigrid, another algorithm)
        iter_tol = CG_ITER_TOL if route == "cg" else PCG_ITER_TOL
        require(abs(case["iters"] - witness["cpu_float32"]) <= iter_tol
                and case["rel_err"] <= PCG_REL_TOL
                and case["grad_rel_err"] <= TRAIN_PARITY_TOL["head_grad"],
                f"pressure route against the CPU {case}")
    return cases


def fixed_iter_cases(device):
    """Both CG kernels at fixed iteration counts: tol 0 makes the threshold 0,
    so each runs exactly max_iter iterations. Cold starts on karman
    right-hand sides at batch 1, 3 and 9, timed at FIXED_ITERS: the slope is
    the time of one iteration (us_per_iter), the intercept the set-up and
    the write-back (setup_ms)."""
    import torch

    from solver_in_the_loop_torch.kernels import cg
    from solver_in_the_loop_torch.ops.poisson import fd_factors
    from solver_in_the_loop_torch.parity import PARITY_RE

    lo, hi = FIXED_ITERS
    out = {"pcg_solve": [], "cg_solve": []}
    for batch_re in (RE_B1, PARITY_RE, RE_B9):
        rhs, _, masks = karman_rhs(batch_re, device)
        ops = (rhs, torch.zeros_like(rhs), masks.fluid, masks.face_u, masks.face_v)
        fd = fd_factors(rhs.shape[1], rhs.shape[2], device)
        for name, solve, extra in (("pcg_solve", cg.pcg_solve, fd), ("cg_solve", cg.cg_solve, ())):
            ms = {}
            for max_iter in (lo, hi):
                args = (*ops, *extra, 0.0, max_iter)
                _, iters = solve(*args)
                require(int(iters) == max_iter, f"{name} ran {int(iters)} of {max_iter} iterations")
                ms[max_iter] = time_ms(lambda: solve(*args), 50)
            us = 1e3 * (ms[hi] - ms[lo]) / (hi - lo)
            out[name].append({"shape": list(rhs.shape), f"ms_{lo}": ms[lo], f"ms_{hi}": ms[hi],
                              "us_per_iter": us, "setup_ms": ms[lo] - lo * us / 1e3})
    return out


# (Re values, res, precon) of the cluster layout (csrc/cg_cluster.cu): the
# shapes the card refused before it at -r 67 (the lo-res karman-gen with
# either precon) and -r 79, the PRE generator's 256x128 at the batches the
# JAX package's gate takes, -r 192 and its largest elements, -r 267 with
# the preconditioner and -r 313 without (both in the L2 variant, as -r 192
# with it; the others on chip); and 256x128 at batch 6, multigrid's route,
# the kernel timed for ROADMAP B5
RE_B3, RE_B6 = RE_B5[:3], RE_B5 + RE_B8[5:6]
CLUSTER_CASES = [(RE_B1, 67, "fd"), (RE_B1, 67, "none"), (RE_B1, 79, "none"), (RE_B1, 128, "fd"),
                 (RE_B3, 128, "fd"), (RE_B5, 128, "none"), (RE_B1, 192, "fd"), (RE_B1, 267, "fd"),
                 (RE_B1, 313, "none"), (RE_B6, 128, "fd")]


def _wall_ms(fn) -> float:
    """Wall ms of one call of fn, synchronized: for the plain loops, which
    read the host once per iteration."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def cluster_kernel_cases(device):
    """Both instantiations of csrc/cg_cluster.cu through their wrappers
    (pcg_cluster_solve, cg_cluster_solve) at CLUSTER_CASES on real karman
    right-hand sides, cold and warm: the solution within PCG_REL_TOL /
    CG_REL_TOL of its max from the twin on the card, the same bits from a
    second launch, the iterations beside the twin's; the adjoint through
    autograd against the plain path's, two launches; ms per solve, the
    twin's (one call), the bound, us per iteration and set-up at
    FIXED_ITERS, and the wall ms of one solve by the route the card took
    there before this layout: multigrid where it applies, else the plain
    FD-PCG loop. pressure_route_cases holds the cold solves' iterations to
    the CPU's float32 loop; from a warm start the float32 loops of the two
    devices part by up to three themselves (PERF.md)."""
    from unittest import mock

    import torch

    from solver_in_the_loop_torch.kernels import cg
    from solver_in_the_loop_torch.ops.poisson import _mg_applicable, fd_factors, pressure_cg_solve
    from solver_in_the_loop_torch.parity import CG_REL_TOL, PCG_REL_TOL, plain_path

    cases = []
    tol, max_iter = 1e-5, 1000
    lo, hi = FIXED_ITERS
    for batch_re, res, precon in CLUSTER_CASES:
        rhs, warm, masks = karman_rhs(batch_re, device, res=res)
        shape = tuple(rhs.shape)
        ops = (masks.fluid, masks.face_u, masks.face_v)
        fd = fd_factors(shape[1], shape[2], device)
        pre = precon == "fd"
        kernel, plain = ((cg.pcg_cluster_solve, cg.pcg_solve_plain) if pre
                         else (cg.cg_cluster_solve, cg.cg_solve_plain))
        extra = fd if pre else ()
        rel_tol = PCG_REL_TOL if pre else CG_REL_TOL
        base = {"shape": list(shape), "precon": precon, "plan": cg.cluster_plan(shape, pre),
                "on_chip": cg.cluster_on_chip(shape, pre)}
        for start in ("cold", "warm"):
            x0 = warm if start == "warm" else torch.zeros_like(rhs)
            args = (rhs, x0, *ops, *extra, tol, max_iter)
            x_k, it_k = kernel(*args)
            x_again, it_again = kernel(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x_p, it_p = plain(*args)
            plain_ms = 1e3 * (time.perf_counter() - t0)  # it reads the host every iteration
            case = {**base, "start": start, "iters": int(it_k), "plain_iters": int(it_p),
                    "rel_err": rel_err(x_k, x_p), "max_abs_err": float((x_k - x_p).abs().max()),
                    "deterministic": bool(torch.equal(x_k, x_again)) and int(it_again) == int(it_k),
                    "ms": time_ms(lambda: kernel(*args), 3), "plain_ms": plain_ms}
            case["us_per_iter"] = 1e3 * case["ms"] / max(case["iters"], 1)
            case["bound_ms"], case["bound_by"] = (pcg_bound_ms if pre else cg_bound_ms)(
                shape, case["iters"])
            if _mg_applicable(shape):  # the card's route before this layout
                case["multigrid_ms"] = _wall_ms(lambda: pressure_cg_solve(
                    rhs, x0, *ops, "multigrid", tol, max_iter))
            else:
                case["pcg_plain_ms"] = _wall_ms(lambda: cg.pcg_solve_plain(rhs, x0, *ops, *fd, tol,
                                                                           max_iter))
            cases.append(case)
            require(case["rel_err"] <= rel_tol and case["deterministic"],
                    f"{kernel.__name__} against its twin {case}")
        ms = {}
        for n in (lo, hi):
            args = (rhs, torch.zeros_like(rhs), *ops, *extra, 0.0, n)
            require(int(kernel(*args)[1]) == n, f"{kernel.__name__} at tol 0 ran other than {n}")
            ms[n] = time_ms(lambda: kernel(*args), 3)
        us = 1e3 * (ms[hi] - ms[lo]) / (hi - lo)
        cot = torch.randn(shape, generator=torch.Generator(device=device).manual_seed(7),
                          device=device)

        def grad():
            b = rhs.clone().requires_grad_()
            x, _ = pressure_cg_solve(b, warm, *ops, "pcg" if pre else "cg", tol, max_iter)
            return torch.autograd.grad(x, b, cot)[0]

        reset = kernel.launches
        # the op's wrapper takes the cluster layout at every shape here
        with mock.patch.object(cg, "pcg_solve" if pre else "cg_solve", kernel):
            got = grad()
        adjoint_launches = kernel.launches - reset
        with plain_path():
            want = grad()
        cases.append({**base, "start": "adjoint", "rel_err": rel_err(got, want),
                      "max_abs_err": float((got - want).abs().max()),
                      "launches": adjoint_launches, f"ms_{lo}": ms[lo], f"ms_{hi}": ms[hi],
                      "fixed_us_per_iter": us, "setup_ms": ms[lo] - lo * us / 1e3})
        require(cases[-1]["rel_err"] <= rel_tol and adjoint_launches == 2,
                f"{kernel.__name__} adjoint {cases[-1]}")
    return cases


def phase_kernels(device):
    import torch

    from solver_in_the_loop_torch.kernels.cg import pcg_solve, pcg_solve_plain
    from solver_in_the_loop_torch.ops.poisson import fd_factors
    from solver_in_the_loop_torch.parity import (
        CG_ITER_TOL,
        CG_REL_TOL,
        CONV_BF16_ULPS,
        CONV_FWD_REL_TOL,
        CONV_WGRAD_BF16_REL_TOL,
        CONV_WGRAD_REL_TOL,
        PCG_ITER_TOL,
        PCG_REL_TOL,
        TAP_SUM_BWD_DV_REL_TOL,
        TAP_SUM_TOL,
    )

    seconds = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    tap_cases, bwd_cases = part("tap_sum", tap_sum_cases, device)

    t0 = time.perf_counter()
    pcg_cases = []
    tol, max_iter = 1e-5, 1000
    for rhs, warm, masks in cg_problems(device):
        vy, vx, invd = fd_factors(rhs.shape[1], rhs.shape[2], device)
        for start in ("cold", "warm"):
            x0 = warm if start == "warm" else torch.zeros_like(rhs)
            args = (rhs, x0, masks.fluid, masks.face_u, masks.face_v, vy, vx, invd, tol, max_iter)
            x_k, it_k = pcg_solve(*args)
            x_p, it_p = pcg_solve_plain(*args)
            x_again, it_again = pcg_solve(*args)
            torch.cuda.synchronize()
            case = {"shape": list(rhs.shape), "start": start, "iters": int(it_k),
                    "plain_iters": int(it_p), "rel_err": rel_err(x_k, x_p),
                    "max_abs_err": float((x_k - x_p).abs().max()),
                    "deterministic": bool(torch.equal(x_k, x_again)) and int(it_again) == int(it_k),
                    "ms": time_ms(lambda: pcg_solve(*args), 50),
                    "plain_ms": time_ms(lambda: pcg_solve_plain(*args), 5, reps=1)}
            case["bound_ms"], case["bound_by"] = pcg_bound_ms(rhs.shape, case["iters"])
            pcg_cases.append(case)
            require(abs(case["iters"] - case["plain_iters"]) <= PCG_ITER_TOL,
                    f"pcg_solve iterations {case}")
            require(case["rel_err"] <= PCG_REL_TOL, f"pcg_solve solution {case}")
            require(case["deterministic"], f"pcg_solve is not deterministic {case}")
    seconds["pcg_solve"] = time.perf_counter() - t0
    cg_cases = part("cg_solve", cg_kernel_cases, device)
    routes = part("pressure_route", pressure_route_cases, device)
    cluster = part("cluster", cluster_kernel_cases, device)
    fixed_iter = part("fixed_iter", fixed_iter_cases, device)
    conv_cases, wgrad_cases = part("conv", conv_kernel_cases, device)
    bf16_cases, bf16_wgrad_cases = part("conv_bf16", conv_bf16_kernel_cases, device)
    emit({"phase": "kernels", "seconds": seconds, "library_ms": "tap-sum on OPEN domains (the cases timed on "
          "clamped offsets): F.grid_sample (bilinear, border padding, align_corners) forward "
          "and aten.grid_sampler_2d_backward, the same function on the offsets the solver "
          "clamps (library_max_abs_err); tap-sum on PERIODIC domains, PCG and CG: none, no "
          "single PyTorch call computes their function; conv_fwd: F.conv2d (cuDNN, TF32 off) "
          "on the same NHWC data seen as NCHW, with the bias but not the skip or activation; "
          "conv_fwd as the input gradient: aten.convolution_backward, input gradient only; "
          "conv_wgrad: aten.convolution_backward, weight gradient only; the bf16 kernels: "
          "the same calls on the bf16 tensors (cuDNN's bf16 conv)",
          "tap_sum_fwd": tap_cases, "tap_sum_bwd": bwd_cases, "pcg_solve": pcg_cases,
          "cg_solve": cg_cases, "cg_cluster": cluster, "conv_fwd": conv_cases,
          "conv_wgrad": wgrad_cases,
          "conv_fwd_bf16": bf16_cases, "conv_wgrad_bf16": bf16_wgrad_cases,
          "fixed_iter": fixed_iter, "pressure_route": routes,
          "tolerances": {"tap_sum_abs": TAP_SUM_TOL, "tap_sum_bwd_dv_rel": TAP_SUM_BWD_DV_REL_TOL,
                         "pcg_rel": PCG_REL_TOL, "pcg_iters": PCG_ITER_TOL,
                         "cg_rel": CG_REL_TOL, "cg_iters": CG_ITER_TOL,
                         "conv_fwd_rel": CONV_FWD_REL_TOL, "conv_wgrad_rel": CONV_WGRAD_REL_TOL,
                         "conv_bf16_ulps": CONV_BF16_ULPS,
                         "conv_wgrad_bf16_rel": CONV_WGRAD_BF16_REL_TOL}})
    return {"tap_sum_fwd": tap_cases, "tap_sum_bwd": bwd_cases, "pcg_solve": pcg_cases,
            "cg_solve": cg_cases, "conv_fwd": conv_cases, "conv_wgrad": wgrad_cases,
            "pcg_cluster_solve": [c for c in cluster if c["precon"] == "fd"],
            "cg_cluster_solve": [c for c in cluster if c["precon"] == "none"],
            "conv_fwd_bf16": bf16_cases, "conv_wgrad_bf16": bf16_wgrad_cases}


def cg_kernel_cases(device):
    """The CG kernel against its twin on real karman right-hand sides at
    batch 1, 3 (training), 5, 8 (a full cluster) and 9 (a cooperative grid),
    and at batch 2 and ODD_RES (cg_problems), cold and warm: the solution
    within CG_REL_TOL of its max, the iterations within CG_ITER_TOL, the same
    bits from a second launch; its adjoint, and the PCG kernel's at batch 9,
    through autograd against the plain path's; times, the twin's and the
    bound."""
    import torch

    from solver_in_the_loop_torch.kernels import cg
    from solver_in_the_loop_torch.parity import CG_ITER_TOL, CG_REL_TOL, PARITY_RE, plain_path

    cases = []
    tol, max_iter = 1e-5, 1000
    for rhs, warm, masks in cg_problems(device):
        for start in ("cold", "warm"):
            x0 = warm if start == "warm" else torch.zeros_like(rhs)
            args = (rhs, x0, masks.fluid, masks.face_u, masks.face_v, tol, max_iter)
            x_k, it_k = cg.cg_solve(*args)
            x_p, it_p = cg.cg_solve_plain(*args)
            x_again, it_again = cg.cg_solve(*args)
            torch.cuda.synchronize()
            case = {"shape": list(rhs.shape), "start": start, "iters": int(it_k),
                    "plain_iters": int(it_p), "rel_err": rel_err(x_k, x_p),
                    "max_abs_err": float((x_k - x_p).abs().max()),
                    "deterministic": bool(torch.equal(x_k, x_again)) and int(it_again) == int(it_k),
                    "ms": time_ms(lambda: cg.cg_solve(*args), 50),
                    "plain_ms": time_ms(lambda: cg.cg_solve_plain(*args), 3, reps=1)}
            case["bound_ms"], case["bound_by"] = cg_bound_ms(rhs.shape, case["iters"])
            cases.append(case)
            require(abs(case["iters"] - case["plain_iters"]) <= CG_ITER_TOL,
                    f"cg_solve iterations {case}")
            require(case["rel_err"] <= CG_REL_TOL, f"cg_solve solution {case}")
            require(case["deterministic"], f"cg_solve is not deterministic {case}")

    # the adjoint: the gradient through the "cg" ("pcg") route of
    # silt::pressure_cg_solve is a cold solve by the kernel, at batch 9 in
    # the cooperative grid's layout
    from solver_in_the_loop_torch.ops.poisson import pressure_cg_solve
    from solver_in_the_loop_torch.parity import PCG_REL_TOL

    for batch_re, op in ((PARITY_RE, "cg"), (RE_B9, "cg"), (RE_B9, "pcg")):
        rhs, warm, masks = karman_rhs(batch_re, device)
        cot = torch.randn(rhs.shape, generator=torch.Generator(device=device).manual_seed(7),
                          device=device)
        ops = (masks.fluid, masks.face_u, masks.face_v)

        def grad():
            b = rhs.clone().requires_grad_()
            x, _ = pressure_cg_solve(b, warm, *ops, op, tol, max_iter)
            return torch.autograd.grad(x, b, cot)[0]

        got = grad()
        with plain_path():
            want = grad()
        case = {"shape": list(rhs.shape), "start": "adjoint", "op": op,
                "rel_err": rel_err(got, want), "max_abs_err": float((got - want).abs().max())}
        cases.append(case)
        tol_rel = CG_REL_TOL if op == "cg" else PCG_REL_TOL
        require(case["rel_err"] <= tol_rel, f"{op}_solve adjoint {case}")
    return cases


# (B, H, W, Cin, Cout, K, act, skip, where): every conv of MarsMoon at the
# Burgers training and apply shapes and the karman stems, one 3x3 conv, and
# the activations with and without skip
CONV_CASES = [
    (5, 32, 32, 4, 32, 5, "leaky_relu", False, "burgers train: stem"),
    (5, 32, 32, 32, 32, 5, "leaky_relu", False, "burgers train: block conv1"),
    (5, 32, 32, 32, 32, 5, "leaky_relu", True, "burgers train: block conv2"),
    (5, 32, 32, 32, 2, 5, "none", False, "burgers train: head"),
    (1, 32, 32, 4, 32, 5, "leaky_relu", False, "burgers apply: stem"),
    (1, 32, 32, 32, 32, 5, "leaky_relu", False, "burgers apply: block conv1"),
    (1, 32, 32, 32, 32, 5, "leaky_relu", True, "burgers apply: block conv2"),
    (1, 32, 32, 32, 2, 5, "none", False, "burgers apply: head"),
    (3, 64, 32, 3, 32, 5, "leaky_relu", False, "karman train: stem"),
    (1, 64, 32, 3, 32, 5, "leaky_relu", False, "karman apply: stem"),
    (5, 32, 32, 32, 32, 3, "relu", True, "3x3"),
    (5, 32, 32, 32, 32, 5, "relu", False, "relu"),
    (5, 32, 32, 32, 32, 5, "none", True, "none with skip"),
    (1, 64, 32, 3, 32, 5, "relu", False, "mercury karman apply: conv1"),
    (1, 64, 32, 32, 64, 5, "relu", False, "mercury karman apply: conv2"),
    (1, 64, 32, 64, 2, 5, "none", False, "mercury karman apply: head"),
    # JupiterMoon (burgers-pre-train --model jupiter_moon, batch 32, and the
    # apply at batch 1): the 5x5 convs with ReLU, the 3x3 with skip and
    # LeakyReLU, the head
    (32, 32, 32, 4, 32, 5, "relu", False, "jupiter train: stem"),
    (32, 32, 32, 32, 32, 5, "relu", False, "jupiter train: block conv1 32"),
    (32, 32, 32, 32, 64, 5, "relu", False, "jupiter train: block conv1 32->64"),
    (32, 32, 32, 64, 64, 5, "relu", False, "jupiter train: block conv1 64"),
    (32, 32, 32, 64, 32, 5, "relu", False, "jupiter train: block conv1 64->32"),
    (32, 32, 32, 32, 32, 3, "leaky_relu", True, "jupiter train: block conv2 32"),
    (32, 32, 32, 64, 64, 3, "leaky_relu", True, "jupiter train: block conv2 64"),
    (32, 32, 32, 32, 2, 5, "none", False, "jupiter train: head"),
    (1, 32, 32, 4, 32, 5, "relu", False, "jupiter apply: stem"),
    (1, 32, 32, 32, 64, 5, "relu", False, "jupiter apply: block conv1 32->64"),
    (1, 32, 32, 64, 64, 5, "relu", False, "jupiter apply: block conv1 64"),
    (1, 32, 32, 64, 32, 5, "relu", False, "jupiter apply: block conv1 64->32"),
    (1, 32, 32, 64, 64, 3, "leaky_relu", True, "jupiter apply: block conv2 64"),
    # MarsMoon in karman-pre-train (batch 32, 64x32)
    (32, 64, 32, 3, 32, 5, "leaky_relu", False, "karman pre-train: stem"),
    (32, 64, 32, 32, 32, 5, "leaky_relu", True, "karman pre-train: block conv2"),
    (32, 64, 32, 32, 2, 5, "none", False, "karman pre-train: head"),
]
# input gradients (conv_fwd with the flipped, channel-transposed kernel) and
# weight gradients: (B, H, W, Cin, Cout, K) of the forward conv
CONV_GRAD_CASES = [
    (5, 32, 32, 4, 32, 5, "burgers train: stem"),
    (5, 32, 32, 32, 32, 5, "burgers train: block"),
    (5, 32, 32, 32, 2, 5, "burgers train: head"),
    (3, 64, 32, 3, 32, 5, "karman train: stem"),
    (3, 64, 32, 32, 32, 5, "karman train: block"),
    (5, 32, 32, 32, 32, 3, "3x3"),
    (1, 64, 32, 3, 32, 5, "mercury karman apply: conv1"),
    (1, 64, 32, 32, 64, 5, "mercury karman apply: conv2"),
    (1, 64, 32, 64, 2, 5, "mercury karman apply: head"),
    (32, 32, 32, 4, 32, 5, "jupiter train: stem"),
    (32, 32, 32, 32, 32, 5, "jupiter train: block conv1 32"),
    (32, 32, 32, 32, 64, 5, "jupiter train: block conv1 32->64"),
    (32, 32, 32, 64, 64, 5, "jupiter train: block conv1 64"),
    (32, 32, 32, 64, 32, 5, "jupiter train: block conv1 64->32"),
    (32, 32, 32, 32, 32, 3, "jupiter train: block conv2 32"),
    (32, 32, 32, 64, 64, 3, "jupiter train: block conv2 64"),
    (32, 32, 32, 32, 2, 5, "jupiter train: head"),
    (32, 64, 32, 3, 32, 5, "karman pre-train: stem"),
    (32, 64, 32, 32, 32, 5, "karman pre-train: block"),
    (32, 64, 32, 32, 2, 5, "karman pre-train: head"),
]


def conv_kernel_cases(device):
    """conv_fwd (also as the input gradient) and conv_wgrad against their
    twins, with their times, the twins', cuDNN's and their bounds."""
    import torch
    import torch.nn.functional as F

    from solver_in_the_loop_torch.kernels.conv import (
        conv_fwd,
        conv_fwd_plain,
        conv_wgrad,
        conv_wgrad_plain,
    )
    from solver_in_the_loop_torch.parity import CONV_FWD_REL_TOL, CONV_WGRAD_REL_TOL

    gen = torch.Generator(device=device).manual_seed(1)

    def inputs(b, h, w, cin, cout, k):
        x = torch.randn((b, h, w, cin), generator=gen, device=device)
        wt = 0.1 * torch.randn((cout, cin, k, k), generator=gen, device=device)
        bias = 0.1 * torch.randn((cout,), generator=gen, device=device)
        dz = torch.randn((b, h, w, cout), generator=gen, device=device)
        return x, wt, bias, dz

    def calls(b):
        """Back-to-back calls a time takes: a batch-32 call runs 0.05-0.6 ms,
        so 50 of them outlast the host's issue as 200 of the smaller do."""
        return 200 if b <= 5 else 50

    fwd_cases = []
    for *shape, act, with_skip, where in CONV_CASES:
        x, wt, bias, skip = inputs(*shape)
        n = calls(shape[0])
        skip = skip if with_skip else None
        w = wt.permute(2, 3, 1, 0)
        r = shape[5] // 2
        got = conv_fwd(x, w, bias, skip, act, 0.3)
        want = conv_fwd_plain(x, w, bias, skip, act, 0.3)
        torch.cuda.synchronize()
        case = {"shape": shape, "act": act, "skip": with_skip, "where": where, "dgrad": False,
                "max_abs_err": float((got - want).abs().max()), "rel_err": rel_err(got, want),
                "ms": time_ms(lambda: conv_fwd(x, w, bias, skip, act, 0.3), n),
                "plain_ms": time_ms(lambda: conv_fwd_plain(x, w, bias, skip, act, 0.3), 10,
                                    reps=1),
                "library_ms": time_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), wt, bias,
                                                       padding=r), n)}
        case["bound_ms"], case["bound_by"] = conv_bound_ms(shape, with_skip)
        fwd_cases.append(case)
        require(case["rel_err"] <= CONV_FWD_REL_TOL, f"conv_fwd {case} differs from its twin")

    wgrad_cases = []
    for *shape, where in CONV_GRAD_CASES:
        x, wt, _, dz = inputs(*shape)
        n = calls(shape[0])
        w = wt.permute(2, 3, 1, 0).transpose(2, 3)  # the input gradient's kernel
        got = conv_fwd(dz, w, flip=True)
        want = conv_fwd_plain(dz, w, flip=True)
        b, h, wd, cin, cout, k = shape
        xn, dzn = x.permute(0, 3, 1, 2), dz.permute(0, 3, 1, 2)
        case = {"shape": [b, h, wd, cout, cin, k], "act": "none", "skip": False, "where": where,
                "dgrad": True, "max_abs_err": float((got - want).abs().max()),
                "rel_err": rel_err(got, want),
                "ms": time_ms(lambda: conv_fwd(dz, w, flip=True), n),
                "plain_ms": time_ms(lambda: conv_fwd_plain(dz, w, flip=True), 10, reps=1),
                "library_ms": time_ms(lambda: torch.ops.aten.convolution_backward(
                    dzn, xn, wt, None, [1, 1], [k // 2, k // 2], [1, 1], False, [0, 0], 1,
                    [True, False, False]), n)}
        case["bound_ms"], case["bound_by"] = conv_bound_ms(case["shape"], False)
        fwd_cases.append(case)
        require(case["rel_err"] <= CONV_FWD_REL_TOL, f"conv_fwd (dgrad) {case} differs")

        got = conv_wgrad(x, dz, k)
        want = conv_wgrad_plain(x, dz, k)
        torch.cuda.synchronize()
        case = {"shape": shape, "where": where, "max_abs_err": float((got - want).abs().max()),
                "rel_err": rel_err(got, want),
                "deterministic": bool(torch.equal(got, conv_wgrad(x, dz, k))),
                "ms": time_ms(lambda: conv_wgrad(x, dz, k), n),
                "plain_ms": time_ms(lambda: conv_wgrad_plain(x, dz, k), 10, reps=1),
                "library_ms": time_ms(lambda: torch.ops.aten.convolution_backward(
                    dzn, xn, wt, None, [1, 1], [k // 2, k // 2], [1, 1], False, [0, 0], 1,
                    [False, True, False]), n)}
        case["bound_ms"], case["bound_by"] = conv_wgrad_bound_ms(shape)
        wgrad_cases.append(case)
        require(case["rel_err"] <= CONV_WGRAD_REL_TOL, f"conv_wgrad {case} differs from its twin")
        require(case["deterministic"], f"conv_wgrad {case} is not deterministic")
    return fwd_cases, wgrad_cases


# the bf16 convs of MarsMoon under --bf16 --conv kernel: (B, H, W, Cin, Cout,
# K, act, skip, where) at the Burgers block shape and the karman shape, the
# stems and heads, and a 3x3 conv; input and weight gradients at the same
# (B, H, W, Cin, Cout, K) of the forward conv
CONV_BF16_CASES = [
    (5, 32, 32, 32, 32, 5, "leaky_relu", True, "burgers train: block conv2"),
    (5, 32, 32, 32, 32, 5, "leaky_relu", False, "burgers train: block conv1"),
    (5, 32, 32, 4, 32, 5, "leaky_relu", False, "burgers train: stem"),
    (5, 32, 32, 32, 2, 5, "none", False, "burgers train: head"),
    (3, 64, 32, 32, 32, 5, "leaky_relu", True, "karman train: block conv2"),
    (3, 64, 32, 3, 32, 5, "leaky_relu", False, "karman train: stem"),
    (5, 32, 32, 32, 32, 3, "relu", True, "3x3"),
]
CONV_BF16_GRAD_CASES = [
    (5, 32, 32, 32, 32, 5, "burgers train: block"),
    (5, 32, 32, 4, 32, 5, "burgers train: stem"),
    (5, 32, 32, 32, 2, 5, "burgers train: head"),
    (3, 64, 32, 32, 32, 5, "karman train: block"),
    (5, 32, 32, 32, 32, 3, "3x3"),
    (3, 64, 32, 3, 32, 5, "karman train: stem"),
    (3, 64, 32, 32, 2, 5, "karman train: head"),
]


def conv_bf16_launch(shape, dgrad: bool = False):
    """The launch configuration csrc/conv_bf16.cu takes for a conv of `shape`
    (B, H, W, Cin, Cout, K): the forward's plan (kernels/conv.py
    `fwd_bf16_plan`; with `dgrad`, of the input gradient's conv) and the
    weight gradient's (`wgrad_bf16_plan`)."""
    from solver_in_the_loop_torch.kernels.conv import fwd_bf16_plan, wgrad_bf16_plan

    b, h, w, cin, cout, k = shape
    fwd = fwd_bf16_plan(b, h, w, *((cout, cin) if dgrad else (cin, cout)), k)
    if dgrad:
        return fwd
    return fwd, wgrad_bf16_plan(*shape)


def conv_bf16_kernel_cases(device):
    """conv_fwd_bf16 (also as the input gradient) and conv_wgrad_bf16 against
    their twins on the card, with their times, the twins', cuDNN's bf16 conv
    and their bounds."""
    import torch
    import torch.nn.functional as F

    from solver_in_the_loop_torch.kernels.conv import (
        conv_fwd_bf16,
        conv_fwd_plain,
        conv_wgrad_bf16,
        conv_wgrad_plain,
    )
    from solver_in_the_loop_torch.parity import (
        CONV_BF16_ULPS,
        CONV_WGRAD_BF16_REL_TOL,
        bf16_errors,
    )

    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(2)

    def inputs(b, h, w, cin, cout, k):
        x = torch.randn((b, h, w, cin), generator=gen, device=device).to(bf16)
        wt = (0.1 * torch.randn((cout, cin, k, k), generator=gen, device=device)).to(bf16)
        bias = (0.1 * torch.randn((cout,), generator=gen, device=device)).to(bf16)
        dz = torch.randn((b, h, w, cout), generator=gen, device=device).to(bf16)
        return x, wt, bias, dz

    fwd_cases = []
    for *shape, act, with_skip, where in CONV_BF16_CASES:
        x, wt, bias, skip = inputs(*shape)
        skip = skip if with_skip else None
        w = wt.permute(2, 3, 1, 0)
        r = shape[5] // 2
        got = conv_fwd_bf16(x, w, bias, skip, act, 0.3)
        want = conv_fwd_plain(x, w, bias, skip, act, 0.3)
        torch.cuda.synchronize()
        case = {"shape": shape, "act": act, "skip": with_skip, "where": where, "dgrad": False,
                "launch": conv_bf16_launch(shape)[0],
                "max_abs_err": float((got.float() - want.float()).abs().max()),
                "bf16_err": bf16_errors(got, want),
                "deterministic": bool(torch.equal(got, conv_fwd_bf16(x, w, bias, skip, act, 0.3))),
                "ms": time_ms(lambda: conv_fwd_bf16(x, w, bias, skip, act, 0.3), 200),
                "plain_ms": time_ms(lambda: conv_fwd_plain(x, w, bias, skip, act, 0.3), 10,
                                    reps=1),
                "library_ms": time_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), wt, bias,
                                                       padding=r), 200)}
        case["bound_ms"], case["bound_by"] = conv_bf16_bound_ms(shape, with_skip)
        fwd_cases.append(case)
        require(case["bf16_err"] <= CONV_BF16_ULPS, f"conv_fwd_bf16 {case} differs from its twin")
        require(case["deterministic"], f"conv_fwd_bf16 {case} is not deterministic")

    wgrad_cases = []
    for *shape, where in CONV_BF16_GRAD_CASES:
        x, wt, _, dz = inputs(*shape)
        w = wt.permute(2, 3, 1, 0).transpose(2, 3)  # the input gradient's kernel
        got = conv_fwd_bf16(dz, w, flip=True)
        want = conv_fwd_plain(dz, w, flip=True)
        b, h, wd, cin, cout, k = shape
        xn, dzn = x.permute(0, 3, 1, 2), dz.permute(0, 3, 1, 2)
        case = {"shape": [b, h, wd, cout, cin, k], "act": "none", "skip": False, "where": where,
                "dgrad": True, "launch": conv_bf16_launch(shape, dgrad=True),
                "max_abs_err": float((got.float() - want.float()).abs().max()),
                "bf16_err": bf16_errors(got, want),
                "deterministic": bool(torch.equal(got, conv_fwd_bf16(dz, w, flip=True))),
                "ms": time_ms(lambda: conv_fwd_bf16(dz, w, flip=True), 200),
                "plain_ms": time_ms(lambda: conv_fwd_plain(dz, w, flip=True), 10, reps=1),
                "library_ms": time_ms(lambda: torch.ops.aten.convolution_backward(
                    dzn, xn, wt, None, [1, 1], [k // 2, k // 2], [1, 1], False, [0, 0], 1,
                    [True, False, False]), 200)}
        case["bound_ms"], case["bound_by"] = conv_bf16_bound_ms(case["shape"], False)
        fwd_cases.append(case)
        require(case["bf16_err"] <= CONV_BF16_ULPS, f"conv_fwd_bf16 (dgrad) {case} differs")
        require(case["deterministic"], f"conv_fwd_bf16 (dgrad) {case} is not deterministic")

        got = conv_wgrad_bf16(x, dz, k)
        want = conv_wgrad_plain(x, dz, k)
        torch.cuda.synchronize()
        case = {"shape": shape, "where": where, "launch": conv_bf16_launch(shape)[1],
                "max_abs_err": float((got - want).abs().max()), "rel_err": rel_err(got, want),
                "deterministic": bool(torch.equal(got, conv_wgrad_bf16(x, dz, k))),
                "ms": time_ms(lambda: conv_wgrad_bf16(x, dz, k), 200),
                "plain_ms": time_ms(lambda: conv_wgrad_plain(x, dz, k), 10, reps=1),
                "library_ms": time_ms(lambda: torch.ops.aten.convolution_backward(
                    dzn, xn, wt, None, [1, 1], [k // 2, k // 2], [1, 1], False, [0, 0], 1,
                    [False, True, False]), 200)}
        case["bound_ms"], case["bound_by"] = conv_wgrad_bf16_bound_ms(shape)
        wgrad_cases.append(case)
        require(case["rel_err"] <= CONV_WGRAD_BF16_REL_TOL,
                f"conv_wgrad_bf16 {case} differs from its twin")
        require(case["deterministic"], f"conv_wgrad_bf16 {case} is not deterministic")
    return fwd_cases, wgrad_cases


def apply_argv(re_list, simsteps: int):
    """karman-apply's arguments for the SOL-32 rollout at res 32 from the
    built-in initial state."""
    return ["-o", OUT_DIR, "--model", os.path.join(CKPT, "model.msgpack"),
            "--stats", os.path.join(CKPT, "dataStats.json"), "--arch", "mars_moon",
            "-r", "32", "-l", "100", "-t", str(simsteps), "--re", *[str(int(r)) for r in re_list]]


def run_cli_argv(argv):
    """`python -m solver_in_the_loop_torch karman-apply ...` in this process,
    writing to OUT_DIR; returns its frames and the number of scenes it wrote."""
    from solver_in_the_loop_torch import __main__ as cli

    shutil.rmtree(OUT_DIR, ignore_errors=True)
    frames = cli.main(argv)
    scenes = len(os.listdir(OUT_DIR))
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    return frames, scenes


def run_cli(re_list, simsteps: int):
    return run_cli_argv(["karman-apply", *apply_argv(re_list, simsteps)])


def phase_apply(re_list):
    """The main path: a one-step warm-up run (model and cuDNN set-up), then the
    500-step run with every launch count set to 0 just before it."""
    import numpy as np
    import torch

    run_cli(re_list, 2)
    reset_launches()
    frames, scenes = run_cli(re_list, STEPS)
    launches = read_launches()
    steps = STEPS - 1
    iters = frames["cg_iters"].cpu().numpy()
    finite = all(bool(torch.isfinite(v).all()) for k, v in frames.items() if k != "rollout_seconds")
    line = {"phase": "apply", "batch": len(re_list), "re": re_list, "steps": steps,
            "seconds_per_step": frames["rollout_seconds"] / steps,
            "rollout_seconds": frames["rollout_seconds"], "launches": launches,
            "cg_iters_p50": float(np.percentile(iters, 50)),
            "cg_iters_p95": float(np.percentile(iters, 95)), "cg_iters_max": int(iters.max()),
            "finite": finite, "scenes": scenes,
            "max_abs_u": float(frames["u"].abs().max()), "max_abs_v": float(frames["v"].abs().max())}
    emit(line)
    require(launches == counts(tap_sum_fwd=3 * steps, pcg_solve=steps),
            f"launch counts {launches} != 3x{steps} tap-sum, no backward, {steps} pcg, "
            "no conv kernel (--conv library)")
    require(finite, "non-finite frames in the rollout")
    require(scenes == len(re_list), f"wrote {scenes} scenes for {len(re_list)} Re")
    return launches, frames


def phase_parity(frames):
    """Steps 1, 5 and 20 of the timed batch-1 run (`frames`) against the same
    CLI run on the plain path and against the JAX package's golden frames."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch.parity import ROLLOUT_REL_TOL, plain_path

    with plain_path():
        plain, _ = run_cli(RE_B1, 21)
    golden = np.load(GOLDEN)
    line = {"phase": "parity", "steps": [1, 5, 20], "tolerance": ROLLOUT_REL_TOL,
            "vs_plain": {}, "vs_jax_golden": {}}
    worst = 0.0
    for field in ("dens", "u", "v"):
        for step in (1, 5, 20):
            got = frames[field][step - 1].cpu()
            e_plain = rel_err(got, plain[field][step - 1].cpu())
            e_gold = rel_err(got, torch.from_numpy(golden[f"{field}_{step}"]))
            line["vs_plain"][f"{field}_{step}"] = e_plain
            line["vs_jax_golden"][f"{field}_{step}"] = e_gold
            worst = max(worst, e_plain, e_gold)
    line["worst"] = worst
    emit(line)
    require(worst <= ROLLOUT_REL_TOL, f"rollout parity {worst} > {ROLLOUT_REL_TOL}")


def phase_profile(steps=50):
    """Where a rollout step's time goes at batch 1: wall time per step without
    and with torch.profiler, the device's busy and idle share, and device
    time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from solver_in_the_loop_torch.apps import karman_apply
    from solver_in_the_loop_torch.train.rollout import karman_rollout

    args = karman_apply.build_parser().parse_args(apply_argv(RE_B1, steps + 1))
    flow, d0, v0, re, model, norm = karman_apply.prepare(args)

    def rollout():
        return karman_rollout(flow, d0, v0, re, steps, model=model, norm=norm)

    rollout()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rollout()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies); CPU ops carry their kernels'
    # time too and would count it twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kernels)
    groups = {"pcg_solve": ("pcg_kernel",), "tap_sum_fwd": ("tap_sum_fwd_kernel",),
              "convolution": ("xmma", "cudnn", "conv", "nhwcToNchw", "nchwToNhwc")}
    by_group = {g: {"launches_per_step": 0.0, "ms_per_step": 0.0} for g in (*groups, "other")}
    for e in kernels:
        g = next((g for g, keys in groups.items() if any(k in e.key for k in keys)), "other")
        by_group[g]["launches_per_step"] += e.count / steps
        by_group[g]["ms_per_step"] += dev_us(e) / 1e3 / steps
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    line = {"phase": "profile", "batch": 1, "steps": steps,
            "wall_ms_per_step": 1e3 * wall / steps,
            "wall_ms_per_step_profiled": 1e3 * wall_prof / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share_profiled": 1.0 - busy_us / 1e6 / wall_prof,
            "device_launches_per_step": sum(e.count for e in kernels) / steps,
            "by_group": by_group,
            "top_device_ms_per_step": [{"name": e.key[:80], "calls_per_step": e.count / steps,
                                        "ms_per_step": dev_us(e) / 1e3 / steps} for e in top]}
    emit(line)
    require(busy_us > 0, "the profiler saw no device time")


def write_train_fixture():
    """The training set's first frames (parity.TRAIN_SET) written as the
    downsampled ds_dens / ds_velo scenes that `--skip-ds` reads."""
    import numpy as np

    from solver_in_the_loop_torch.io.scene import Scene
    from solver_in_the_loop_torch.parity import train_set

    shutil.rmtree(FIXTURE_DIR, ignore_errors=True)
    data = train_set()
    for b, re in enumerate(data["re"].tolist()):
        sc = Scene.create(FIXTURE_DIR)
        sc.write_params({"re": re})
        sc.write_centered_batch("ds_dens", range(TRAIN_FRAMES), data["dens"][b, :TRAIN_FRAMES])
        sc.write_staggered_batch("ds_velo", range(TRAIN_FRAMES), data["u"][b, :TRAIN_FRAMES],
                                 data["v"][b, :TRAIN_FRAMES])
    return {"sims": len(data["re"]), "frames": TRAIN_FRAMES,
            "max_abs_u": float(np.abs(data["u"]).max()),
            "max_abs_v": float(np.abs(data["v"]).max())}


def train_argv():
    """The Makefile's SOL-32 command (karman-fdt-sol32) on the fixture, cut
    as TRAIN_REDUCED says."""
    from solver_in_the_loop_torch.parity import TRAIN_SEED

    return ["--train", FIXTURE_DIR, "--skip-ds", "-s", "4", "-l", "100", "-t", str(TRAIN_FRAMES),
            "-m", "32", "-n", "6", "-b", "3", "--epochs", "1", "--lr", "1e-4",
            "--seed", str(TRAIN_SEED), "--tf", TRAIN_OUT]


def _percentiles(values):
    import numpy as np

    a = np.asarray(values)
    return {"p50": float(np.percentile(a, 50)), "p95": float(np.percentile(a, 95)),
            "max": int(a.max())}


def phase_train():
    """The slice's main path: `karman-train` through the CLI entry point at
    the SOL-32 width, every launch count set to 0 just before it, then
    `karman-apply` for 20 steps from the checkpoint it wrote; and the same
    command with --profile and no epoch, whose one traced step writes a
    trace. (Its update is kept and taken at the full learning rate, before
    any warm-up epoch, as the JAX CLI takes it: from this seed's glorot net
    that step overflows the unroll, so it stays out of the trained run.)"""
    from unittest import mock

    import numpy as np
    import torch

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch.kernels import cg
    from solver_in_the_loop_torch.utils import profiling

    fixture = write_train_fixture()
    shutil.rmtree(TRAIN_OUT, ignore_errors=True)
    record = []
    real = cg.pcg_solve

    def pcg_solve(*args):
        """Records each solve's iteration count (a device tensor, no sync).
        The wrapper counts its launches on the module's `pcg_solve`, which
        is this function while it is installed."""
        x, iters = real(*args)
        record.append(iters)
        return x, iters

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(cg, "pcg_solve", pcg_solve):
        reset_launches()
        t0 = time.perf_counter()
        result = cli.main(["karman-train", *train_argv()])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    iters = len(result.losses)
    msteps = 32
    # per iteration under pressure+conv: every step's three tap-sums forward
    # and again in the recompute; the backward of u's and v's (density does
    # not reach the loss), not for step 0, whose inputs are data; one solve
    # per step forward and one adjoint per step but step 0
    per_iter = counts(tap_sum_fwd=2 * 3 * msteps, tap_sum_bwd=2 * (msteps - 1),
                      pcg_solve=msteps + (msteps - 1))
    solves = torch.stack(record).cpu().numpy().reshape(iters, per_iter["pcg_solve"])
    fwd_iters, adj_iters = solves[:, :msteps], solves[:, msteps:]
    frames, _ = run_cli_argv(["karman-apply", "-o", OUT_DIR, "--model",
                              os.path.join(TRAIN_OUT, "model.msgpack"), "--stats",
                              os.path.join(TRAIN_OUT, "dataStats.json"), "-r", "32", "-l", "100",
                              "-t", "20", "--re", "240000"])
    apply_finite = all(bool(torch.isfinite(v).all()) for k, v in frames.items()
                       if k != "rollout_seconds")
    shutil.rmtree(TRAIN_PROFILE_OUT, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    cli.main(["karman-train", *train_argv(), "--tf", TRAIN_PROFILE_OUT, "--epochs", "0",
              "--profile", TRAIN_TRACE])
    profile_seconds = time.perf_counter() - t0
    profile_launches = read_launches()
    traces = profiling.trace_files(TRAIN_TRACE)
    applied = iters - result.notfinite
    line = {"phase": "train", "argv": train_argv(), "reduced": TRAIN_REDUCED, "fixture": fixture,
            "iterations": iters, "seconds": seconds,
            "sec_per_iter_median_after_first": float(np.median(result.iter_seconds[1:])),
            "sec_per_iter_first": result.iter_seconds[0],
            "sec_per_iter": result.iter_seconds,
            "first_loss": result.losses[0], "last_loss": result.losses[-1],
            "losses": result.losses, "guard_skipped": result.notfinite,
            "updates_applied": applied,
            "launches": launches,
            "launches_per_iter": {k: v / iters for k, v in launches.items()},
            "predicted_per_iter": per_iter,
            "cg_iters_forward": _percentiles(fwd_iters), "cg_iters_adjoint": _percentiles(adj_iters),
            "max_memory_allocated_bytes": peak,
            "profile_run": {"seconds": profile_seconds, "launches": profile_launches,
                            "trace": {os.path.basename(t): os.path.getsize(t) for t in traces}},
            "checkpoint": sorted(os.listdir(TRAIN_OUT)),
            "apply_from_checkpoint": {"steps": 19, "finite": apply_finite,
                                      "max_abs_u": float(frames["u"].abs().max())}}
    emit(line)
    require(iters == TRAIN_ITERS, f"{iters} iterations, expected {TRAIN_ITERS}")
    require(all(np.isfinite(result.losses)), "a training loss is not finite")
    # fewer than MAX_CONSECUTIVE_ERRORS iterations: every skip is a non-finite gradient
    require(applied >= 1, "the non-finite guard skipped every update")
    require(result.losses[-1] <= result.losses[0],
            f"the last loss {result.losses[-1]} exceeds the first {result.losses[0]}")
    require(launches == {k: v * iters for k, v in per_iter.items()},
            f"launch counts {launches} != {per_iter} per iteration x {iters}")
    require(len(traces) == 1 and os.path.getsize(traces[0]) > 0,
            f"--profile wrote {traces} to {TRAIN_TRACE}")
    require(profile_launches == per_iter, f"the --profile run's launches {profile_launches}")
    require(np.array_equal(fwd_iters, np.asarray(result.cg_iters)),
            "the recorded forward solves are not the trainer's")
    for name in ("model.msgpack", "dataStats.json"):
        require(os.path.isfile(os.path.join(TRAIN_OUT, name)), f"{name} was not written")
    require(apply_finite, "karman-apply from the trained checkpoint gave non-finite frames")
    return launches


KARMAN_BF16_OUT = os.path.join(REPO, "build", "smoke_karman_bf16")
KARMAN_BF16_FRAMES = 36  # (6 sims / batch 3) x (36 - msteps 32) = 8 iterations


def phase_karman_train_bf16():
    """`karman-train --bf16 --conv kernel` through the CLI on the train
    phase's set, its first KARMAN_BF16_FRAMES frames, `--seed 1`, every
    launch count set to 0 just before it: finite losses, an update applied,
    and each kernel's launches per iteration, the nets' 767 convs (384
    forward, 383 input gradients: not the step-0 stem, whose input is data)
    and 384 weight gradients on the bf16 kernels."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch import __main__ as cli

    args = train_argv()
    args[args.index("-t") + 1] = str(KARMAN_BF16_FRAMES)
    args[args.index("--tf") + 1] = KARMAN_BF16_OUT
    argv = ["karman-train", *args, "--bf16", "--conv", "kernel"]
    shutil.rmtree(KARMAN_BF16_OUT, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    result = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    iters = len(result.losses)
    msteps = 32
    # as the train phase counts them, and the nets' convs on the bf16 kernels
    per_iter = counts(tap_sum_fwd=2 * 3 * msteps, tap_sum_bwd=2 * (msteps - 1),
                      pcg_solve=msteps + (msteps - 1), conv_fwd_bf16=2 * 12 * msteps - 1,
                      conv_wgrad_bf16=12 * msteps)
    line = {"phase": "karman_train_bf16", "argv": argv,
            "reduced": {**TRAIN_REDUCED, "simsteps": f"500 -> {KARMAN_BF16_FRAMES} frames per "
                        f"sim (1000..{999 + KARMAN_BF16_FRAMES}): "
                        f"{2 * (KARMAN_BF16_FRAMES - msteps)} iterations"},
            "iterations": iters, "seconds": seconds,
            "sec_per_iter_median_after_first": float(np.median(result.iter_seconds[1:])),
            "first_loss": result.losses[0], "last_loss": result.losses[-1],
            "losses": result.losses, "guard_skipped": result.notfinite,
            "updates_applied": iters - result.notfinite, "launches": launches,
            "predicted_per_iter": per_iter}
    emit(line)
    require(iters == 2 * (KARMAN_BF16_FRAMES - msteps), f"{iters} bf16 karman iterations")
    require(all(np.isfinite(result.losses)), "a bf16 karman training loss is not finite")
    require(iters - result.notfinite >= 1, "the non-finite guard skipped every bf16 karman update")
    require(launches == {k: v * iters for k, v in per_iter.items()},
            f"bf16 karman launch counts {launches} != {per_iter} per iteration x {iters}")
    return launches


def phase_train_parity(device):
    """One SOL-32 train step (kernel path) against the same step on the plain
    path on the card and against the JAX package's step (the golden file)."""
    from solver_in_the_loop_torch import parity as par

    kernel = par.parity_summary(par.parity_step(device))
    with par.plain_path():
        plain_step = par.parity_step(device)
    plain = par.parity_summary(plain_step)
    golden = par.train_golden_summary()
    reset_launches()
    conv_kernel = par.parity_summary(par.parity_step(device, "kernel"))
    conv_launches = read_launches()
    line = {"phase": "train_parity", "tolerances": par.TRAIN_PARITY_TOL,
            "kernel_loss": kernel[0], "plain_loss": plain[0], "jax_loss": golden[0],
            "conv_kernel_loss": conv_kernel[0],
            "plain_cg_iters_forward": plain_step[2].tolist(),
            "vs_plain": par.parity_errors(kernel, plain),
            "vs_jax_golden": par.parity_errors(kernel, golden),
            "plain_vs_jax_golden": par.parity_errors(plain, golden),
            "conv_kernel_vs_jax_golden": par.parity_errors(conv_kernel, golden),
            "conv_kernel_launches": conv_launches}
    emit(line)
    for against in ("vs_plain", "vs_jax_golden", "conv_kernel_vs_jax_golden"):
        for key, tol in par.TRAIN_PARITY_TOL.items():
            require(line[against][key] <= tol, f"train parity {against} {key}: "
                    f"{line[against][key]} > {tol}")
    # 32 steps x 12 convs forward, all but the step-0 stem's input gradient
    require(conv_launches["conv_fwd"] == 2 * 12 * par.PARITY_MSTEPS - 1
            and conv_launches["conv_wgrad"] == 12 * par.PARITY_MSTEPS,
            f"conv launches of the karman step {conv_launches}")


def phase_train_profile(device, iters=1):
    """Where a SOL-32 training iteration's time goes (the parity set-up with
    the CLI's optimizer): wall time per iteration against device busy time,
    and device ms per iteration by group; and the wall time per iteration
    without remat, beside it. The pressure solve's forward and
    adjoint launches are one kernel; they are told apart by their order in
    each iteration (the forward solves all come first)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from solver_in_the_loop_torch.models.features import Normalization
    from solver_in_the_loop_torch.parity import (
        PARITY_MSTEPS,
        PARITY_RE,
        parity_model,
        train_parity_inputs,
    )
    from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
    from solver_in_the_loop_torch.train.trainer import (
        SolTrainConfig,
        make_karman_train_step,
        make_optimizer,
    )

    data, idx, stats = train_parity_inputs()
    model = parity_model(device)
    flow = KarmanFlow(karman_domain(32), advection="shift", max_shift=2, device=device)
    norm = Normalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"], device)
    cfg = SolTrainConfig(msteps=PARITY_MSTEPS, clip_grad=True, lr=1e-5)
    step = make_karman_train_step(flow, model, make_optimizer(model, cfg), cfg)
    tdata = {k: torch.from_numpy(a).to(device) for k, a in data.items()}
    tidx = torch.from_numpy(idx).to(device)

    def one():
        loss = step(tdata, norm, tidx)[0]
        float(loss)

    def timed(n=2):
        one()
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            one()
            walls.append(time.perf_counter() - t0)
        return walls

    # the same iterations without the per-step checkpoint: what the remat
    # policy costs on the host
    cfg.remat = False
    walls_no_remat = timed()
    cfg.remat = True
    walls = timed()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            one()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    groups = {"tap_sum_fwd": ("tap_sum_fwd_kernel",), "tap_sum_bwd": ("tap_sum_bwd_kernel",),
              "pcg": ("pcg_kernel",), "conv_forward": ("fprop",),
              "conv_backward": ("dgrad", "wgrad"),
              "conv_layout": ("nhwcToNchw", "nchwToNhwc")}
    names = ["tap_sum_fwd", "tap_sum_bwd", "pcg_forward", "pcg_adjoint", "conv_forward",
             "conv_backward", "conv_layout", "other"]
    by_group = {g: {"launches_per_iter": 0.0, "ms_per_iter": 0.0} for g in names}
    per_iter_pcg = 2 * PARITY_MSTEPS - 1
    pcg_seen = 0
    for e in events:
        g = next((g for g, keys in groups.items() if any(k in e.name for k in keys)), "other")
        if g == "pcg":
            g = "pcg_forward" if pcg_seen % per_iter_pcg < PARITY_MSTEPS else "pcg_adjoint"
            pcg_seen += 1
        by_group[g]["launches_per_iter"] += 1 / iters
        by_group[g]["ms_per_iter"] += e.time_range.elapsed_us() / 1e3 / iters
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
    line = {"phase": "train_profile", "batch": len(PARITY_RE), "msteps": PARITY_MSTEPS,
            "remat": cfg.remat_policy, "iterations_profiled": iters,
            "wall_ms_per_iter": 1e3 * float(np.median(walls)),
            "wall_ms_per_iter_all": [1e3 * w for w in walls],
            "wall_ms_per_iter_no_remat": 1e3 * float(np.median(walls_no_remat)),
            "wall_ms_per_iter_profiled": 1e3 * wall_prof / iters,
            "device_busy_ms_per_iter": busy_ms,
            "device_idle_share_profiled": 1.0 - busy_ms * iters / (1e3 * wall_prof),
            "device_launches_per_iter": len(events) / iters, "by_group": by_group}
    emit(line)
    require(busy_ms > 0, "the profiler saw no device time")
    require(pcg_seen == per_iter_pcg * iters, f"{pcg_seen} pcg launches in {iters} iterations")
    return line


def burgers_gen_argv(out: str, seed: int, frames: int):
    """The Makefile's burgers-gen command for one sim."""
    return ["burgers-gen", "-o", out, "-r", "128", "-l", "32", "--dt", "0.1", "-s", "30",
            "-t", str(frames), "--seed", str(seed), "--thumb"]


def phase_burgers_gen():
    """The Burgers data path through the CLI: the training set cut to 40
    frames and the test sim at full length; frame 0 of the test sim against
    the JAX package's."""
    import numpy as np

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch import parity as par
    from solver_in_the_loop_torch.io.scene import Scene, read_array

    for d in (BURGERS_SET, BURGERS_TEST):
        shutil.rmtree(d, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    for seed in BURGERS_SEEDS:
        cli.main(burgers_gen_argv(BURGERS_SET, seed, BURGERS_SET_FRAMES))
    set_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    test = cli.main(["burgers-gen", "-o", BURGERS_TEST, *par.BURGERS_GEN_ARGV,
                     "-t", str(BURGERS_TEST_FRAMES), "--thumb"])
    test_seconds = time.perf_counter() - t0
    launches = read_launches()
    frame0 = read_array(test.frame_path("velo", 0))
    with np.load(par.BURGERS_APPLY_GOLDEN) as g:
        err = float(np.abs(frame0 - g["velo_hi"]).max() / np.abs(g["velo_hi"]).max())
    scenes = Scene.list(BURGERS_SET)
    last = read_array(test.frame_path("velo", BURGERS_TEST_FRAMES - 1))
    thumbs = {d: sum(len(files) for _, _, files in os.walk(os.path.join(d, "thumb")))
              for d in (BURGERS_SET, BURGERS_TEST)}
    line = {"phase": "burgers_gen", "set_sims": len(scenes), "set_frames": BURGERS_SET_FRAMES,
            "thumbs_set": thumbs[BURGERS_SET], "thumbs_test": thumbs[BURGERS_TEST],
            "set_seconds": set_seconds, "test_frames": len(test.frames("velo")),
            "test_seconds": test_seconds,
            "seconds_per_step_test": test_seconds / (BURGERS_TEST_FRAMES + 30 - 1),
            "frame0_rel_err_vs_jax_golden": err, "tolerance": par.BURGERS_GEN_REL_TOL,
            "launches": launches, "last_frame_finite": bool(np.isfinite(last).all()),
            "last_frame_max_abs": float(np.abs(last).max())}
    emit(line)
    require(len(scenes) == len(BURGERS_SEEDS)
            and all(sc.frames("velo") == list(range(BURGERS_SET_FRAMES)) for sc in scenes),
            "the training set's scenes or frames are incomplete")
    require(line["test_frames"] == BURGERS_TEST_FRAMES, "the test sim's frames are incomplete")
    require(err <= par.BURGERS_GEN_REL_TOL, f"burgers-gen frame 0 differs from JAX's by {err}")
    require(line["last_frame_finite"], "the test sim's last frame is not finite")
    # four fields (velU, velV, frcU, frcV) of every written frame
    require(thumbs == {BURGERS_SET: 4 * len(BURGERS_SEEDS) * BURGERS_SET_FRAMES,
                       BURGERS_TEST: 4 * BURGERS_TEST_FRAMES}, f"thumbnails written: {thumbs}")


def burgers_train_argv():
    """The Makefile's SOL-04 command (burgers-fdt-sol04) on the cut set, with
    the port's conv kernels."""
    return ["burgers-train", "--train", BURGERS_SET, "--tf", BURGERS_TF, "--epochs", "1",
            "--lr", "0.0001", "--dt", "0.1", "-t", str(BURGERS_SET_FRAMES), "-s", "4",
            "-m", str(BURGERS_MSTEPS), "-n", "10", "-b", "5", "--seed", "0", "--conv", "kernel"]


def phase_burgers_train():
    """The Burgers training path: `burgers-train --conv kernel` through the CLI
    entry point, every launch count set to 0 just before it."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch import __main__ as cli

    shutil.rmtree(BURGERS_TF, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    result = cli.main(burgers_train_argv())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    iters = len(result.losses)
    m = BURGERS_MSTEPS
    # per iteration under pressure+conv: two tap-sums (u, v) per step forward
    # and again in the recompute; their backward for steps 1..m-1 (step 0
    # advects data); 12 convs per step, their input gradients but the step-0
    # stem's, and 12 weight gradients per step; no solve
    per_iter = counts(tap_sum_fwd=2 * 2 * m, tap_sum_bwd=2 * (m - 1),
                      conv_fwd=12 * m + 12 * m - 1, conv_wgrad=12 * m)
    line = {"phase": "burgers_train", "argv": burgers_train_argv(),
            "reduced": BURGERS_TRAIN_REDUCED, "iterations": iters, "seconds": seconds,
            "sec_per_iter_median_after_first": float(np.median(result.iter_seconds[1:])),
            "sec_per_iter_first": result.iter_seconds[0],
            "first_loss": result.losses[0], "last_loss": result.losses[-1],
            "losses": result.losses, "guard_skipped": result.notfinite,
            "updates_applied": iters - result.notfinite, "launches": launches,
            "launches_per_iter": {k: v / iters for k, v in launches.items()},
            "predicted_per_iter": per_iter,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "checkpoint": sorted(os.listdir(BURGERS_TF))}
    emit(line)
    require(iters == BURGERS_ITERS, f"{iters} iterations, expected {BURGERS_ITERS}")
    require(all(np.isfinite(result.losses)), "a Burgers training loss is not finite")
    require(result.losses[-1] <= result.losses[0],
            f"the last loss {result.losses[-1]} exceeds the first {result.losses[0]}")
    require(launches == {k: v * iters for k, v in per_iter.items()},
            f"launch counts {launches} != {per_iter} per iteration x {iters}")
    for name in ("model.msgpack", "dataStats.json", "model_epoch0001.msgpack"):
        require(os.path.isfile(os.path.join(BURGERS_TF, name)), f"{name} was not written")
    return launches


BF16_FRAMES = 8  # burgers_train_bf16: (10 sims / batch 5) x (8 - msteps 4) = 8 iterations
BURGERS_TF_BF16 = os.path.join(REPO, "build", "smoke_burgers_tf_bf16")


def phase_burgers_train_bf16(device):
    """`burgers-train --bf16 --conv kernel` through the CLI on the cut set,
    every launch count set to 0 just before it: the bf16 conv kernels'
    launches, finite losses, an update applied; then one full-width SOL-04
    train step with --bf16 on the kernels against the JAX golden (the Pallas
    conv in interpret mode), the plain path and cuDNN's bf16 conv, and one
    SOL-32 step's bf16 launches."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch import parity as par

    bf16 = torch.bfloat16
    argv = ["burgers-train", "--train", BURGERS_SET, "--tf", BURGERS_TF_BF16,
            "--epochs", "1", "--lr", "0.0001", "--dt", "0.1", "-t", str(BF16_FRAMES), "-s", "4",
            "-m", str(BURGERS_MSTEPS), "-n", "10", "-b", "5", "--seed", "0", "--conv", "kernel",
            "--bf16"]
    shutil.rmtree(BURGERS_TF_BF16, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    result = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    iters = len(result.losses)
    m = BURGERS_MSTEPS
    # as burgers_train counts them, on the bf16 kernels
    per_iter = counts(tap_sum_fwd=2 * 2 * m, tap_sum_bwd=2 * (m - 1),
                      conv_fwd_bf16=12 * m + 12 * m - 1, conv_wgrad_bf16=12 * m)

    reset_launches()
    kernel = par.parity_summary(par.burgers_parity_step(device, "kernel", compute_dtype=bf16))
    step_launches = read_launches()
    with par.plain_path():
        plain = par.parity_summary(par.burgers_parity_step(device, "kernel", compute_dtype=bf16))
    library = par.parity_summary(par.burgers_parity_step(device, "library", compute_dtype=bf16))
    golden = par.train_golden_summary(par.BURGERS_TRAIN_GOLDEN_BF16)
    reset_launches()
    karman = par.parity_step(device, "kernel", compute_dtype=bf16)
    karman_launches = read_launches()
    line = {"phase": "burgers_train_bf16", "argv": argv,
            "reduced": {"simsteps": f"200 -> {BF16_FRAMES} frames per sim: {2 * (BF16_FRAMES - m)} "
                                    "iterations, on the burgers_gen phase's set",
                        "epochs": "100 -> 1"},
            "iterations": iters, "seconds": seconds,
            "sec_per_iter_median_after_first": float(np.median(result.iter_seconds[1:])),
            "first_loss": result.losses[0], "last_loss": result.losses[-1],
            "guard_skipped": result.notfinite, "updates_applied": iters - result.notfinite,
            "launches": launches, "predicted_per_iter": per_iter,
            "tolerances": par.TRAIN_PARITY_TOL_BF16, "kernel_loss": kernel[0],
            "jax_loss": golden[0], "step_launches": step_launches,
            "vs_jax_golden": par.parity_errors(kernel, golden),
            "vs_plain": par.parity_errors(kernel, plain),
            "library_vs_jax_golden": par.parity_errors(library, golden),
            "karman_sol32_step": {"loss": karman[0], "launches": karman_launches}}
    emit(line)
    require(iters == 2 * (BF16_FRAMES - m), f"{iters} bf16 iterations")
    require(all(np.isfinite(result.losses)), "a bf16 training loss is not finite")
    require(iters - result.notfinite >= 1, "the non-finite guard skipped every bf16 update")
    require(launches == {k: v * iters for k, v in per_iter.items()},
            f"bf16 launch counts {launches} != {per_iter} per iteration x {iters}")
    require(step_launches == per_iter, f"bf16 parity step launches {step_launches}")
    for against in ("vs_jax_golden", "vs_plain"):
        for key, tol in par.TRAIN_PARITY_TOL_BF16.items():
            require(line[against][key] <= tol, f"bf16 train parity {against} {key}: "
                    f"{line[against][key]} > {tol}")
    msteps = par.PARITY_MSTEPS
    require(np.isfinite(karman[0]) and karman_launches["conv_fwd_bf16"] == 2 * 12 * msteps - 1
            and karman_launches["conv_wgrad_bf16"] == 12 * msteps,
            f"bf16 launches of the karman step {karman_launches}")
    return launches, karman_launches


RESUME_DIR = os.path.join(REPO, "build", "smoke_resume")
RESUME_FRAMES = 6  # (5 sims / batch 5) x (6 - msteps 4) = 2 iterations per epoch


def phase_resume():
    """`burgers-train --conv kernel` three ways on the cut set: 11 epochs
    uninterrupted, 10 epochs, and those resumed with --resume 10 --epochs 11;
    the resumed run must end on the uninterrupted run's parameters, bit for
    bit (the kernels are deterministic), with the same losses."""
    import numpy as np

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch.train import checkpoint as ckpt

    shutil.rmtree(RESUME_DIR, ignore_errors=True)

    def train(tf, *extra):
        return cli.main(["burgers-train", "--train", BURGERS_SET, "--tf",
                         os.path.join(RESUME_DIR, tf), "--lr", "0.0001", "--dt", "0.1",
                         "-t", str(RESUME_FRAMES), "-s", "4", "-m", str(BURGERS_MSTEPS), "-n", "5",
                         "-b", "5", "--seed", "0", "--conv", "kernel", *extra])

    t0 = time.perf_counter()
    whole = train("whole", "--epochs", "11")
    train("cut", "--epochs", "10")
    resumed = train("cut", "--resume", "10", "--epochs", "11")
    seconds = time.perf_counter() - t0
    trees = [ckpt._flatten(ckpt.read_msgpack(os.path.join(RESUME_DIR, tf, "model.msgpack"))
                           ["params"]["params"]) for tf in ("whole", "cut")]
    equal = trees[0].keys() == trees[1].keys() and all(
        np.array_equal(trees[0][k], trees[1][k]) for k in trees[0])
    epoch10 = ckpt.read_msgpack(os.path.join(RESUME_DIR, "cut", "model_epoch0010.msgpack"))
    line = {"phase": "resume", "seconds": seconds, "iterations_whole": len(whole.losses),
            "iterations_resumed": len(resumed.losses),
            "last_losses": [whole.losses[-1], resumed.losses[-1]], "params_bit_equal": equal,
            "epoch10_keys": sorted(epoch10),
            "max_abs_param_diff": max(float(np.abs(trees[0][k] - trees[1][k]).max())
                                      for k in trees[0])}
    emit(line)
    require("opt_state" in epoch10, "the epoch checkpoint holds no optimizer state")
    require(len(resumed.losses) * 11 == len(whole.losses), "the resumed run's iterations")
    require(resumed.losses == whole.losses[-len(resumed.losses):],
            "the resumed run's losses differ from the uninterrupted run's")
    require(equal, "the resumed run ends on other parameters than the uninterrupted run")


def burgers_apply_argv(conv: str, simsteps: int):
    """The Makefile's burgers-fdt-sol04/run_test for sim 0 of the test set,
    with the trained artifacts/a3_b_sol04 net."""
    from solver_in_the_loop_torch import parity as par

    sim = os.path.join(BURGERS_TEST, "sim_000000")
    return ["burgers-apply", "-o", OUT_DIR, "--stats",
            os.path.join(par.BURGERS_CKPT, "dataStats.json"),
            "--model", os.path.join(par.BURGERS_CKPT, "model.msgpack"),
            "--initvH", os.path.join(sim, "velo_000000.npz"),
            "--loadfH", os.path.join(sim, "forc_0*.npz"), "-d", "4", "-r", "32", "-l", "32",
            "--dt", "0.1", "-t", str(simsteps), "--conv", conv]


def phase_burgers_apply():
    """The Burgers serving path: a warm-up run, then the 199-step run_test
    with every launch count set to 0 just before it (--conv kernel), and the
    same run with cuDNN (--conv library) beside it."""
    import torch

    steps = BURGERS_TEST_FRAMES - 1
    line = {"phase": "burgers_apply", "steps": steps, "batch": 1}
    for conv in ("library", "kernel"):
        run_cli_argv(burgers_apply_argv(conv, 2))
        reset_launches()
        frames, scenes = run_cli_argv(burgers_apply_argv(conv, BURGERS_TEST_FRAMES))
        launches = read_launches()
        finite = bool(torch.isfinite(frames["u"]).all() and torch.isfinite(frames["v"]).all())
        line[conv] = {"seconds_per_step": frames["rollout_seconds"] / steps,
                      "rollout_seconds": frames["rollout_seconds"], "launches": launches,
                      "finite": finite, "scenes": scenes,
                      "max_abs_u": float(frames["u"].abs().max())}
        require(finite and scenes == 1, f"burgers-apply --conv {conv}: finite {finite}, "
                f"{scenes} scenes")
    emit(line)
    want = counts(tap_sum_fwd=2 * steps, conv_fwd=12 * steps)
    require(line["kernel"]["launches"] == want,
            f"burgers-apply launch counts {line['kernel']['launches']} != {want}")
    return line["kernel"]["launches"]


def phase_burgers_parity():
    """20 steps of burgers-apply on the JAX golden's inputs with the conv
    kernels, against the JAX golden frames, the same run with cuDNN and the
    same run on the plain path."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch import parity as par

    inputs = par.burgers_apply_inputs(os.path.join(REPO, "build", "smoke_burgers_golden_inputs"))
    runs = {}
    for name, conv in (("kernel", "kernel"), ("library", "library"), ("plain", "kernel")):
        argv = ["burgers-apply", *par.burgers_apply_argv(OUT_DIR, inputs, conv)]
        if name == "plain":
            with par.plain_path():
                runs[name], _ = run_cli_argv(argv)
        else:
            runs[name], _ = run_cli_argv(argv)
    golden = np.load(par.BURGERS_APPLY_GOLDEN)
    line = {"phase": "burgers_parity", "steps": [1, 5, par.BURGERS_GOLDEN_STEPS],
            "tolerance": par.ROLLOUT_REL_TOL, "vs_jax_golden": {}, "vs_library": {},
            "vs_plain": {}}
    worst = 0.0
    for field in ("u", "v"):
        for step in line["steps"]:
            got = runs["kernel"][field][step - 1, 0].cpu()
            errs = {"vs_jax_golden": rel_err(got, torch.from_numpy(golden[field][step - 1])),
                    "vs_library": rel_err(got, runs["library"][field][step - 1, 0].cpu()),
                    "vs_plain": rel_err(got, runs["plain"][field][step - 1, 0].cpu())}
            for key, e in errs.items():
                line[key][f"{field}_{step}"] = e
                worst = max(worst, e)
    line["worst"] = worst
    emit(line)
    require(worst <= par.ROLLOUT_REL_TOL, f"Burgers rollout parity {worst} > {par.ROLLOUT_REL_TOL}")


def phase_burgers_train_parity(device):
    """One full-width SOL-04 train step with the conv kernels against the JAX
    package's (golden), the plain path and cuDNN."""
    from solver_in_the_loop_torch import parity as par

    reset_launches()
    kernel = par.parity_summary(par.burgers_parity_step(device, "kernel"))
    launches = read_launches()
    with par.plain_path():
        plain = par.parity_summary(par.burgers_parity_step(device, "kernel"))
    library = par.parity_summary(par.burgers_parity_step(device, "library"))
    golden = par.train_golden_summary(par.BURGERS_TRAIN_GOLDEN)
    line = {"phase": "burgers_train_parity", "tolerances": par.TRAIN_PARITY_TOL,
            "kernel_loss": kernel[0], "jax_loss": golden[0], "launches": launches,
            "vs_jax_golden": par.parity_errors(kernel, golden),
            "vs_plain": par.parity_errors(kernel, plain),
            "vs_library": par.parity_errors(kernel, library),
            "library_vs_jax_golden": par.parity_errors(library, golden)}
    emit(line)
    for against in ("vs_jax_golden", "vs_plain", "vs_library"):
        for key, tol in par.TRAIN_PARITY_TOL.items():
            require(line[against][key] <= tol, f"Burgers train parity {against} {key}: "
                    f"{line[against][key]} > {tol}")


def _device_profile(run, iters: int, per: int = 1):
    """Wall ms of `run` without and with torch.profiler, and device ms and
    launches by kernel group, each per call of `run` divided by `per`; and
    the kernel wrappers' launch counts over the same profiled calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0) / per)
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_prof = 1e3 * (time.perf_counter() - t0) / (iters * per)
    wrapper_launches = {k: v / (iters * per) for k, v in read_launches().items()}
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    groups = {"tap_sum_fwd": ("tap_sum_fwd_kernel",), "tap_sum_bwd": ("tap_sum_bwd_kernel",),
              "conv_fwd": ("::conv_fwd_kernel",), "conv_wgrad": ("::conv_wgrad_kernel",),
              "cudnn_conv": ("xmma", "cudnn", "fprop", "dgrad", "wgrad", "nhwcToNchw",
                             "nchwToNhwc", "implicit_gemm")}
    by_group = {g: {"launches": 0.0, "ms": 0.0} for g in (*groups, "other")}
    for e in events:
        g = next((g for g, keys in groups.items() if any(k in e.name for k in keys)), "other")
        by_group[g]["launches"] += 1 / (iters * per)
        by_group[g]["ms"] += e.time_range.elapsed_us() / 1e3 / (iters * per)
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / (iters * per)
    return {"wall_ms": sorted(walls)[1], "wall_ms_all": walls, "wall_ms_profiled": wall_prof,
            "device_busy_ms": busy_ms, "device_idle_share_profiled": 1.0 - busy_ms / wall_prof,
            "device_launches": len(events) / (iters * per), "by_group": by_group,
            "wrapper_launches": wrapper_launches}


def phase_burgers_profile(device, apply_steps=50):
    """Where a SOL-04 training iteration (the parity set-up with the CLI's
    optimizer, batch 5, msteps 4) and a batch-1 apply step go, with the conv
    kernels and with cuDNN: wall against device busy, by kernel group."""
    import torch

    from solver_in_the_loop_torch import parity as par
    from solver_in_the_loop_torch.apps import burgers_apply
    from solver_in_the_loop_torch.models.features import Normalization
    from solver_in_the_loop_torch.physics.burgers import BurgersFlow, burgers_domain
    from solver_in_the_loop_torch.train.trainer import (
        SolTrainConfig,
        make_burgers_train_step,
        make_optimizer,
    )

    data, idx, stats = par.burgers_train_parity_inputs()
    tdata = {k: torch.from_numpy(a).to(device) for k, a in data.items()}
    tidx = torch.from_numpy(idx).to(device)
    norm = Normalization.burgers(stats["std.v"], stats["std.u"], stats["std.fv"], stats["std.fu"],
                                 device)
    flow = BurgersFlow(burgers_domain(32), advection="shift", max_shift=2)
    line = {"phase": "burgers_profile", "train": {}, "apply": {},
            "train_setup": "batch 5, msteps 4, 32x32, remat pressure+conv, from "
                           "artifacts/a3_b_sol04, per iteration",
            "apply_setup": f"run_test of the test sim, batch 1, per step over {apply_steps} steps"}
    for conv in ("library", "kernel"):
        model = par.parity_model(device, conv, par.BURGERS_CKPT, in_channels=4)
        cfg = SolTrainConfig(msteps=par.BURGERS_PARITY_MSTEPS, clip_grad=True, lr=1e-5)
        step = make_burgers_train_step(flow, model, make_optimizer(model, cfg), cfg,
                                       dt=par.BURGERS_DT)
        line["train"][conv] = _device_profile(lambda: float(step(tdata, norm, tidx)[0]), 1)

        args = burgers_apply.build_parser().parse_args(
            burgers_apply_argv(conv, apply_steps + 1)[1:])
        rollout, v0, fu, fv = burgers_apply.prepare(args)
        line["apply"][conv] = _device_profile(lambda: rollout(v0, fu, fv), 1, per=apply_steps)
    emit(line)
    # one device launch per wrapper call: 95 conv_fwd and 48 conv_wgrad per
    # SOL-04 iteration (as burgers_train counts them), 12 conv_fwd per apply step
    want = {"train": {"conv_fwd": 95, "conv_wgrad": 48}, "apply": {"conv_fwd": 12, "conv_wgrad": 0}}
    for part in ("train", "apply"):
        prof = line[part]["kernel"]
        require(prof["device_busy_ms"] > 0, "the profiler saw no device time")
        require(prof["by_group"]["cudnn_conv"]["launches"] == 0,
                f"the {part} profile with --conv kernel shows cuDNN kernels")
        for name, n in want[part].items():
            device, wrapper = prof["by_group"][name]["launches"], prof["wrapper_launches"][name]
            require(abs(device - n) < 1e-6 and abs(wrapper - n) < 1e-6,
                    f"the {part} profile: {device} {name} device launches and {wrapper} wrapper "
                    f"calls per {'iteration' if part == 'train' else 'step'}, expected {n} each")


def _frames_errors(got, want_of, fields=("dens", "u", "v"), steps=(1, 5, 20)):
    """Relative errors of frames `got` (dict of (T, B, ...) tensors) at
    `steps` against want_of(field, step) (numpy or tensor), per field_step,
    and the worst."""
    import torch

    errs = {}
    for field in fields:
        for step in steps:
            want = want_of(field, step)
            want = torch.as_tensor(want) if not isinstance(want, torch.Tensor) else want.cpu()
            errs[f"{field}_{step}"] = rel_err(got[field][step - 1].cpu(), want)
    return errs, max(errs.values())


@contextlib.contextmanager
def eager_plain_cycle():
    """mg_pcg_solve with its V-cycle eager and on the plain ops: no graph,
    and ops/multigrid.py `_v_cycle` in the kernels' place."""
    from unittest import mock

    from solver_in_the_loop_torch.kernels import vcycle
    from solver_in_the_loop_torch.ops import multigrid as mg

    with mock.patch.object(mg, "graphed_cycle", lambda h, b: (None, 0)), \
            mock.patch.object(vcycle, "v_cycle", lambda h, b: mg._v_cycle(h, b, 0)):
        yield


def vcycle_bound_ms(h, batch: int):
    """The least device time of one V-cycle apply: its right-hand side read
    and its result written once, and every level's masks and smoother
    diagonal read once, at the HBM rate (the ~60 operations a cell and sweep
    take less)."""
    floats = 2 * batch * h.levels[0].diag.numel()
    for lv in h.levels:
        floats += sum(t.numel() for t in (lv.masks.fluid, lv.masks.face_u, lv.masks.face_v,
                                          lv.diag))
    return 1e3 * 4 * floats / HBM_BYTES_PER_S


def phase_vcycle_kernel(device):
    """The multigrid V-cycle's kernels (kernels/vcycle.py, csrc/vcycle.cu) at
    the hi-res generator's (6, 256, 128) on a real karman right-hand side and
    at (1, 384, 192): bit-equal to the plain `_v_cycle`, launched directly and
    replayed from the V-cycle's graph, 2 (levels - 1) + 1 launches an apply;
    the device ms of an apply launched directly, from the kernels' graph (the
    main path: copy-in, replay, copy-out) and from a graph of the plain ops
    (the main path before the kernels), beside `vcycle_bound_ms`."""
    from unittest import mock

    import torch

    from solver_in_the_loop_torch.kernels import vcycle
    from solver_in_the_loop_torch.ops import multigrid as mg
    from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain

    cases = []
    for batch, res in ((6, 128), (1, 192)):
        if batch == 6:
            rhs, _, masks = karman_rhs(RE_B6, device, res=res)
        else:
            masks = KarmanFlow(karman_domain(res), device=device).masks
            gen = torch.Generator(device=device).manual_seed(res)
            rhs = torch.randn((batch,) + tuple(masks.fluid.shape[1:]), generator=gen,
                              device=device) * masks.fluid
        rhs = rhs.contiguous()
        h = mg.build_mg_hierarchy(masks, karman_domain(res))
        levels = len(h.levels)
        before = vcycle.v_cycle.launches
        direct = vcycle.v_cycle(h, rhs)
        launches = vcycle.v_cycle.launches - before
        graph = mg.GraphedCycle(h, rhs)
        with mock.patch.object(vcycle, "v_cycle", lambda h, b: mg._v_cycle(h, b, 0)):
            plain_graph = mg.GraphedCycle(h, rhs)
        gen = torch.Generator(device=device).manual_seed(levels)
        equal = []
        for b in (rhs, torch.randn(rhs.shape, generator=gen, device=device) * masks.fluid):
            want = mg._v_cycle(h, b, 0)
            equal.append(bool(torch.equal(vcycle.v_cycle(h, b), want))
                         and bool(torch.equal(graph(b), want))
                         and bool(torch.equal(plain_graph(b), want)))
        torch.cuda.synchronize()
        bound = vcycle_bound_ms(h, batch)
        ms = {"kernels_direct": time_ms(lambda: vcycle.v_cycle(h, rhs), 50),
              "kernels_graph": time_ms(lambda: graph(rhs), 50),
              "plain_graph": time_ms(lambda: plain_graph(rhs), 20)}
        cases.append({"shape": list(rhs.shape), "levels": levels,
                      "level_shapes": [list(lv.diag.shape[1:]) for lv in h.levels],
                      "launches_per_apply": launches, "bit_equal": all(equal),
                      "direct_equals_plain": bool(torch.equal(direct, mg._v_cycle(h, rhs, 0))),
                      "device_ms": ms, "bound_ms": bound,
                      "roofline_pct": 100 * bound / ms["kernels_graph"],
                      "speedup_over_plain_graph": ms["plain_graph"] / ms["kernels_graph"]})
    emit({"phase": "vcycle_kernel", "cases": cases})
    for case in cases:
        require(case["bit_equal"] and case["direct_equals_plain"],
                f"the V-cycle kernels against the plain cycle: {case}")
        require(case["launches_per_apply"] == 2 * (case["levels"] - 1) + 1,
                f"V-cycle kernel launches an apply: {case}")
    return cases


def multigrid_graph_case(device, reps: int = 5):
    """The "multigrid" route of `pressure_cg_solve` at the hi-res generator's
    (6, 256, 128) on a real karman right-hand side, cold and warm, with its
    V-cycle graph (ops/multigrid.py `GraphedCycle`, of the kernels) and with
    the graph turned off and the plain ops in the kernels' place (the eager
    V-cycle, `eager_plain_cycle`): the
    wall ms of a solve, host included (the median of `reps`, taken in turns),
    the iterations and the solutions, which are the same to the bit; the
    recorded counters of the graphed solves on a fresh hierarchy (every
    V-cycle replayed and run by the kernels, one capture); the device memory
    a capture takes (its static buffers and graph pool); and the device ms
    of one preconditioner apply, the graph's copy-in, replay and copy-out."""
    import statistics
    from unittest import mock

    import torch

    from solver_in_the_loop_torch.ops import multigrid as mg
    from solver_in_the_loop_torch.ops.poisson import pressure_cg_solve
    from solver_in_the_loop_torch.utils import profiling

    rhs, warm, masks = karman_rhs(RE_B6, device, res=128)
    ops = (masks.fluid, masks.face_u, masks.face_v, "multigrid", 1e-5, 1000)
    starts = {"cold": torch.zeros_like(rhs), "warm": warm}
    case = {"shape": list(rhs.shape)}
    with mock.patch.object(mg, "_HIERARCHIES", {}):
        with profiling.recording() as rec:
            graphed = {s: pressure_cg_solve(rhs, x0, *ops) for s, x0 in starts.items()}
        counters = rec.read()["counters"]
        with eager_plain_cycle():
            plain = {s: pressure_cg_solve(rhs, x0, *ops) for s, x0 in starts.items()}
        for s, x0 in starts.items():
            ms = {"graph": [], "eager": []}
            for _ in range(reps):
                for label in ("eager", "graph"):
                    with eager_plain_cycle() if label == "eager" else contextlib.nullcontext():
                        ms[label].append(_wall_ms(lambda: pressure_cg_solve(rhs, x0, *ops)))
            case[s] = {"iters": int(graphed[s][1]), "eager_iters": int(plain[s][1]),
                       "bit_equal": bool(torch.equal(graphed[s][0], plain[s][0])),
                       "graph_ms": statistics.median(ms["graph"]),
                       "eager_ms": statistics.median(ms["eager"]), "ms": ms}
        h = mg.cached_hierarchy(masks.fluid, masks.face_u, masks.face_v)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        graph = mg.GraphedCycle(h, rhs)
        case["capture_bytes"] = {"allocated": torch.cuda.memory_allocated() - before[0],
                                 "reserved": torch.cuda.memory_reserved() - before[1]}
        case["apply_device_ms"] = time_ms(lambda: graph(rhs), 20)
    case["counters"] = {k: sum(v) for k, v in counters.items() if k.startswith("multigrid.")}
    return case


def phase_karman_gen(device):
    """The Makefile's hi-res training-set command (karman-fdt-hires-set)
    through the CLI at full width, cut as KARMAN_GEN_REDUCED says, every launch
    count set to 0 just before it: the route (multigrid), no kernel launch but
    the V-cycle's (its nine kernels warmed up and captured once),
    multigrid iterations and seconds per step, finite frames, and steps 1, 5
    and 20 of sims 0 and 5 against the JAX golden; then where a step's time
    goes (torch.profiler, 2 steps from the last frame), and the solve with
    its V-cycle graph against the eager V-cycle (`multigrid_graph_case`)."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch import parity as par
    from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
    from solver_in_the_loop_torch.io import thumbs
    from solver_in_the_loop_torch.io.scene import Scene
    from solver_in_the_loop_torch.kernels import vcycle
    from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
    from solver_in_the_loop_torch.train.rollout import karman_rollout

    shutil.rmtree(KARMAN_SET, ignore_errors=True)
    argv = ["karman-gen", "-o", KARMAN_SET, *par.KARMAN_HIRES_ARGV,
            "-t", str(KARMAN_GEN_FRAMES), "-s", "0", "--thumb"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    vcycle_before = vcycle.v_cycle.launches
    t0 = time.perf_counter()
    frames = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    vcycle_launches = vcycle.v_cycle.launches - vcycle_before
    steps = KARMAN_GEN_FRAMES - 1
    iters = frames["cg_iters"].cpu().numpy()
    finite = all(bool(torch.isfinite(frames[k]).all()) for k in ("dens", "u", "v"))
    golden = np.load(par.KARMAN_GEN_GOLDEN)
    vs_golden, worst = {}, 0.0
    for i, sim in enumerate(par.KARMAN_GEN_SIMS):
        per_sim = {k: v[:, sim] for k, v in frames.items() if k in ("dens", "u", "v")}
        errs, w = _frames_errors(per_sim, lambda f, t: golden[f][i, par.KARMAN_GEN_STEPS.index(t)],
                                 steps=par.KARMAN_GEN_STEPS)
        vs_golden[f"sim_{sim}"] = errs
        worst = max(worst, w)
    scenes = Scene.list(KARMAN_SET)
    # one thumbnail against the thumbnail rule on its frame
    last_sim = Scene(os.path.join(KARMAN_SET, f"sim_{len(par.KARMAN_HIRES_RE) - 1:06d}"))
    png = os.path.join(thumbs.thumb_dir_for(last_sim.path), f"velU_{steps:06d}.png")
    thumb_ok = bool(np.array_equal(thumbs.png_pixels(png), thumbs.thumb_pixels(
        last_sim.read_staggered("velo", steps)[0][0], 10000.0)))

    # where a step's time goes: 2 steps from the last frame, warm-started cold
    dom = karman_domain(128, 100.0)
    flow = KarmanFlow(dom, advection="gather", max_shift=4, device=device)
    re = torch.tensor(par.KARMAN_HIRES_RE, device=device)
    d = CenteredGrid(frames["dens"][-1].contiguous(), dom)
    v = StaggeredGrid(frames["u"][-1].contiguous(), frames["v"][-1].contiguous(), dom)
    prof = _device_profile(lambda: karman_rollout(flow, d, v, re, 2), 1, per=2)
    line = {"phase": "karman_gen", "argv": argv, "reduced": KARMAN_GEN_REDUCED,
            "route": frames["route"], "batch": len(par.KARMAN_HIRES_RE),
            "shape": list(frames["dens"].shape[1:]), "steps": steps,
            "seconds": seconds, "rollout_seconds": frames["rollout_seconds"],
            "seconds_per_step": frames["rollout_seconds"] / steps,
            "write_seconds": frames["write_seconds"], "thumbs": frames["thumbs"],
            "thumb_equals_rule": thumb_ok, "launches": launches,
            "vcycle_launches": vcycle_launches,
            "mg_iters_per_step": _percentiles(iters), "mg_iters_first_steps": iters[:8].tolist(),
            "finite": finite, "scenes": len(scenes),
            "frames_per_scene": len(scenes[0].frames("dens")) if scenes else 0,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "tolerance": par.ROLLOUT_REL_TOL, "vs_jax_golden": vs_golden, "worst": worst,
            "profile_2_steps": prof, "vcycle_graph": multigrid_graph_case(device)}
    emit(line)
    graph = line["vcycle_graph"]
    require(all(graph[s]["bit_equal"] and graph[s]["iters"] == graph[s]["eager_iters"]
                for s in ("cold", "warm")), f"the V-cycle's graph against the eager one: {graph}")
    require(graph["counters"]["multigrid.graph_replays"] == graph["counters"]["multigrid.vcycles"]
            == graph["counters"]["multigrid.kernel_cycles"]
            and graph["counters"]["multigrid.graph_captures"] == 1,
            f"the V-cycle graph's counters: {graph['counters']}")
    require(frames["route"] == "multigrid", f"karman-gen hi-res took {frames['route']}")
    require(all(n == 0 for n in launches.values()), f"kernel launches in karman-gen: {launches}")
    # the V-cycle's nine kernels, run once to warm up and once into its graph
    require(vcycle_launches == 2 * 9, f"V-cycle kernel launches in karman-gen: {vcycle_launches}")
    require(finite, "non-finite frames in the hi-res karman-gen")
    require(len(scenes) == 6 and line["frames_per_scene"] == KARMAN_GEN_FRAMES,
            f"{len(scenes)} scenes of {line['frames_per_scene']} frames")
    # dens, velU and velV of every frame, frame 0 included
    require(frames["thumbs"] == 3 * 6 * KARMAN_GEN_FRAMES, f"{frames['thumbs']} thumbnails")
    require(thumb_ok, f"{png} is not the thumbnail rule on its frame")
    require(worst <= par.ROLLOUT_REL_TOL, f"hi-res karman-gen vs the JAX golden: {worst}")
    return launches


EVAL_DIR = os.path.join(REPO, "build", "smoke_evaluate")


def phase_evaluate():
    """The accuracy metric on the card: karman-apply with the trained SOL-32
    net from frame 0 of sim 0 of the karman_gen phase's hi-res frames (as the
    Makefile's run_test starts from frame 1000), KARMAN_GEN_FRAMES - 1 steps,
    then `evaluate` against that sim on the card and with --device cpu: the
    two JSON lines agree within EVAL_REL_TOL."""
    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch import parity as par

    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    sim = os.path.join(KARMAN_SET, "sim_000000")
    cli.main(["karman-apply", "-o", EVAL_DIR, "--model", os.path.join(CKPT, "model.msgpack"),
              "--stats", os.path.join(CKPT, "dataStats.json"),
              "--initdH", os.path.join(sim, "dens_000000.npz"),
              "--initvH", os.path.join(sim, "velo_000000.npz"), "-d", "4", "-r", "32", "-l", "100",
              "--re", str(int(par.KARMAN_HIRES_RE[0])), "-t", str(KARMAN_GEN_FRAMES)])
    argv = ["evaluate", "--run", os.path.join(EVAL_DIR, "sim_000000"), "--ref", sim,
            "--ref-offset", "0", "--scale", "4", "--steps", str(KARMAN_GEN_FRAMES - 1)]
    t0 = time.perf_counter()
    card = cli.main(argv)
    card_seconds = time.perf_counter() - t0
    cpu = cli.main([*argv, "--device", "cpu"])
    pairs = list(zip([card["mae_mean"], card["mae_final"], *card["mae_per_step_head"]],
                     [cpu["mae_mean"], cpu["mae_final"], *cpu["mae_per_step_head"]]))
    worst = max(abs(a - b) / abs(b) for a, b in pairs)
    line = {"phase": "evaluate", "argv": argv, "card": card, "cpu": cpu,
            "card_seconds": card_seconds, "worst_rel_diff": worst, "tolerance": EVAL_REL_TOL}
    emit(line)
    require(card["steps"] == cpu["steps"] == KARMAN_GEN_FRAMES - 1, f"evaluate steps {line}")
    require(worst <= EVAL_REL_TOL, f"evaluate on the card and the CPU differ by {worst}")


def lores_argv(precon: str):
    """The Makefile's karman-fdt-lores-set command for Re 160000, from the
    last frame of sim 0 of the cut hi-res set."""
    sim = os.path.join(KARMAN_SET, "sim_000000")
    last = KARMAN_GEN_FRAMES - 1
    return ["karman-gen", "-o", os.path.join(KARMAN_LORES, precon), "-r", "32", "-l", "100",
            "--re", "160000", "--seed", "0", "--skipsteps", "0", "-t", "500", "-d", "4",
            "--initdH", os.path.join(sim, f"dens_{last:06d}.npz"),
            "--initvH", os.path.join(sim, f"velo_{last:06d}.npz"), "--pressure-precon", precon,
            "--thumb"]


def phase_karman_gen_lores():
    """The lo-res source run with the FD-preconditioned kernel and with the
    plain CG kernel, every launch count set to 0 just before each: 499 solves
    each, and the two runs' frames 1, 5 and 20 within ROLLOUT_REL_TOL."""
    import torch

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch.parity import ROLLOUT_REL_TOL

    shutil.rmtree(KARMAN_LORES, ignore_errors=True)
    runs, line = {}, {"phase": "karman_gen_lores", "argv": lores_argv("none"),
                      "reduced": KARMAN_LORES_REDUCED}
    for precon in ("fd", "none"):
        reset_launches()
        frames = cli.main(lores_argv(precon))
        launches = read_launches()
        iters = frames["cg_iters"].cpu().numpy()
        runs[precon] = frames
        line[precon] = {"route": frames["route"], "launches": launches,
                        "seconds_per_step": frames["rollout_seconds"] / 499,
                        "rollout_seconds": frames["rollout_seconds"],
                        "write_seconds": frames["write_seconds"],
                        "cg_iters": _percentiles(iters),
                        "finite": all(bool(torch.isfinite(frames[k]).all())
                                      for k in ("dens", "u", "v"))}
        kernel = "pcg_solve" if precon == "fd" else "cg_solve"
        want = {k: (499 if k == kernel else 0) for k in launches}
        require(launches == want, f"lo-res karman-gen --pressure-precon {precon}: {launches}")
        require(line[precon]["finite"], f"non-finite frames with --pressure-precon {precon}")
    errs, worst = _frames_errors(runs["none"], lambda f, t: runs["fd"][f][t - 1])
    line.update(none_vs_fd=errs, worst=worst, tolerance=ROLLOUT_REL_TOL)
    emit(line)
    require(worst <= ROLLOUT_REL_TOL, f"lo-res CG vs PCG frames differ by {worst}")
    return line["fd"]["launches"], line["none"]["launches"]


KARMAN_R67 = os.path.join(REPO, "build", "smoke_karman_r67")
R67_FRAMES = 6
R67_REDUCED = {"simsteps": f"1500 -> {R67_FRAMES} frames, all kept (-s 0): "
                           f"{R67_FRAMES - 1} steps from the initial state",
               "Re": "the 6 runs of the Makefile's loop -> one (Re 160000)"}


def r67_argv(precon: str, device: str):
    """`karman-gen -r 67` (134x67), off the one-block layouts and off
    multigrid's sizes, on `device`."""
    return ["karman-gen", "-o", os.path.join(KARMAN_R67, f"{device}_{precon}"), "-r", "67", "-l",
            "100", "--re", "160000", "--seed", "0", "-s", "0", "-t", str(R67_FRAMES),
            "--pressure-precon", precon, "--device", device]


def phase_karman_gen_r67():
    """`karman-gen -r 67`, where the card refused the pressure solve before
    the cluster layout, through the CLI with each --pressure-precon, every
    launch count set to 0 just before each card run: one launch of the
    cluster layout a step (pcg_cluster_solve with fd, cg_cluster_solve with
    none) and nothing else, so no solve takes a plain loop or the CPU; its
    frames 1, 3 and 5 against the same command on the CPU (--device cpu),
    within ROLLOUT_REL_TOL."""
    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch.parity import ROLLOUT_REL_TOL

    shutil.rmtree(KARMAN_R67, ignore_errors=True)
    steps = R67_FRAMES - 1
    line = {"phase": "karman_gen_r67", "argv": r67_argv("fd", "cuda"), "reduced": R67_REDUCED,
            "tolerance": ROLLOUT_REL_TOL}
    for precon, kernel in (("fd", "pcg_cluster_solve"), ("none", "cg_cluster_solve")):
        reset_launches()
        frames = cli.main(r67_argv(precon, "cuda"))
        launches = read_launches()
        cpu = cli.main(r67_argv(precon, "cpu"))
        errs, worst = _frames_errors(frames, lambda f, t: cpu[f][t - 1], steps=(1, 3, 5))
        line[precon] = {"route": frames["route"], "launches": launches,
                        "seconds_per_step": frames["rollout_seconds"] / steps,
                        "cpu_seconds_per_step": cpu["rollout_seconds"] / steps,
                        "cg_iters": frames["cg_iters"].cpu().flatten().tolist(),
                        "cpu_cg_iters": cpu["cg_iters"].cpu().flatten().tolist(),
                        "errors_vs_cpu": errs, "worst": worst}
    emit(line)
    for precon, kernel in (("fd", "pcg_cluster_solve"), ("none", "cg_cluster_solve")):
        require(line[precon]["launches"] == counts(**{kernel: steps})
                and line[precon]["route"] == ("pcg" if precon == "fd" else "cg"),
                f"karman-gen -r 67 --pressure-precon {precon}: {line[precon]}")
        require(line[precon]["worst"] <= ROLLOUT_REL_TOL,
                f"karman-gen -r 67 --pressure-precon {precon} differs from the CPU: "
                f"{line[precon]['errors_vs_cpu']}")
    return line["fd"]["launches"], line["none"]["launches"]


def phase_apply_cg():
    """karman-apply with --pressure-precon none at batch 1 and 5: a one-step
    warm-up, then the 500-step run with every launch count set to 0 just
    before it; the batch-1 run's steps 1, 5 and 20 against the JAX golden."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch.parity import ROLLOUT_REL_TOL

    line = {"phase": "apply_cg", "steps": STEPS - 1}
    steps = STEPS - 1
    golden = np.load(GOLDEN)
    for re_list in (RE_B1, RE_B5):
        run_cli_argv(["karman-apply", *apply_argv(re_list, 2), "--pressure-precon", "none"])
        reset_launches()
        frames, scenes = run_cli_argv(["karman-apply", *apply_argv(re_list, STEPS),
                                       "--pressure-precon", "none"])
        launches = read_launches()
        iters = frames["cg_iters"].cpu().numpy()
        finite = all(bool(torch.isfinite(v).all()) for k, v in frames.items()
                     if k != "rollout_seconds")
        entry = {"seconds_per_step": frames["rollout_seconds"] / steps,
                 "rollout_seconds": frames["rollout_seconds"], "launches": launches,
                 "cg_iters": _percentiles(iters), "finite": finite, "scenes": scenes}
        want = counts(tap_sum_fwd=3 * steps, cg_solve=steps)
        require(launches == want, f"apply_cg at batch {len(re_list)}: {launches} != {want}")
        require(finite and scenes == len(re_list), f"apply_cg at batch {len(re_list)}: "
                f"finite {finite}, {scenes} scenes")
        if re_list == RE_B1:
            entry["vs_jax_golden"], entry["worst"] = _frames_errors(
                frames, lambda f, t: golden[f"{f}_{t}"])
            require(entry["worst"] <= ROLLOUT_REL_TOL,
                    f"apply_cg vs the JAX golden: {entry['worst']}")
            b1_launches = launches
        line[f"b{len(re_list)}"] = entry
    line["tolerance"] = ROLLOUT_REL_TOL
    emit(line)
    return b1_launches


def phase_apply_b9():
    """karman-apply at batch 9, one more than a cluster, with each
    preconditioner option: a one-step warm-up, then a B9_STEPS run with every
    launch count set to 0 just before it (each pressure solve one launch of
    the kernel the option names, as a cooperative grid); steps 1, 5 and 20
    against the same CLI run on the plain path, and those of its first
    element (Re 240000) against the JAX golden of the apply phase."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch.ops.poisson import pressure_route
    from solver_in_the_loop_torch.parity import ROLLOUT_REL_TOL, plain_path

    golden = np.load(GOLDEN)
    steps = B9_STEPS - 1
    line = {"phase": "apply_b9", "re": RE_B9, "steps": steps, "tolerance": ROLLOUT_REL_TOL}
    all_launches = {}
    def argv(precon, simsteps):
        return ["karman-apply", *apply_argv(RE_B9, simsteps), "--pressure-precon", precon]

    for precon in ("fd", "none"):
        run_cli_argv(argv(precon, 2))
        reset_launches()
        frames, scenes = run_cli_argv(argv(precon, B9_STEPS))
        launches = read_launches()
        with plain_path():
            plain, _ = run_cli_argv(argv(precon, 21))
        kernel = "pcg_solve" if precon == "fd" else "cg_solve"
        want = {k: 0 for k in launches}
        want.update({"tap_sum_fwd": 3 * steps, kernel: steps})
        finite = all(bool(torch.isfinite(frames[k]).all()) for k in ("dens", "u", "v"))
        route = pressure_route((len(RE_B9), 64, 32), "cuda", precon=precon)
        entry = {"route": route, "launches": launches, "finite": finite,
                 "scenes": scenes, "seconds_per_step": frames["rollout_seconds"] / steps,
                 "cg_iters": _percentiles(frames["cg_iters"].cpu().numpy())}
        entry["vs_plain"], worst_plain = _frames_errors(
            frames, lambda f, t: plain[f][t - 1])
        first = {k: frames[k][:, :1] for k in ("dens", "u", "v")}
        entry["first_vs_jax_golden"], worst_gold = _frames_errors(
            first, lambda f, t: golden[f"{f}_{t}"])
        entry["worst"] = max(worst_plain, worst_gold)
        line[precon] = entry
        all_launches[precon] = launches
        require(route == {"fd": "pcg", "none": "cg"}[precon],
                f"apply_b9 {precon}: route {route}")
        require(launches == want, f"apply_b9 --pressure-precon {precon}: {launches} != {want}")
        require(finite and scenes == len(RE_B9), f"apply_b9 {precon}: finite {finite}, "
                f"{scenes} scenes")
    emit(line)
    for precon in ("fd", "none"):
        require(line[precon]["worst"] <= ROLLOUT_REL_TOL,
                f"apply_b9 {precon} frames differ by {line[precon]['worst']}")
    return all_launches["fd"], all_launches["none"]


def phase_train_parity_cg(device):
    """One SOL-32 train step with --pressure-precon none (every solve, forward
    and adjoint, by the CG kernel), every launch count set to 0 just before
    it, against the same step on the plain path and the JAX package's step
    (made with its FD-PCG; both sides solve to the same tolerance)."""
    from solver_in_the_loop_torch import parity as par

    reset_launches()
    step = par.parity_step(device, precon="none")
    launches = read_launches()
    kernel = par.parity_summary(step)
    with par.plain_path():
        plain_step = par.parity_step(device, precon="none")
    plain = par.parity_summary(plain_step)
    golden = par.train_golden_summary()
    msteps = par.PARITY_MSTEPS
    want = counts(tap_sum_fwd=2 * 3 * msteps, tap_sum_bwd=2 * (msteps - 1),
                  cg_solve=msteps + (msteps - 1))
    line = {"phase": "train_parity_cg", "tolerances": par.TRAIN_PARITY_TOL,
            "kernel_loss": kernel[0], "plain_loss": plain[0], "jax_loss": golden[0],
            "launches": launches, "predicted": want,
            "cg_iters_forward": step[2].tolist(),
            "plain_cg_iters_forward": plain_step[2].tolist(),
            "vs_plain": par.parity_errors(kernel, plain),
            "vs_jax_golden": par.parity_errors(kernel, golden),
            "plain_vs_jax_golden": par.parity_errors(plain, golden)}
    emit(line)
    require(launches == want, f"train_parity_cg launches {launches} != {want}")
    for against in ("vs_plain", "vs_jax_golden"):
        for key, tol in par.TRAIN_PARITY_TOL.items():
            require(line[against][key] <= tol, f"train parity (CG) {against} {key}: "
                    f"{line[against][key]} > {tol}")
    return launches


PRE_SET = os.path.join(REPO, "build", "smoke_pre_set")
# --beta 1.0 writes the PRE set the pre_train phase trains on: 33 frames,
# one batch of 32 and one validation frame (--val 0.05)
PRE_SET_FRAMES = 54
PRE_GEN_REDUCED = {
    "simsteps": f"1500 -> {PRE_SET_FRAMES} with --beta 1.0 (frames 21..{PRE_SET_FRAMES - 1} "
                "kept), 30 with --beta 0 (21..29)",
    "skipsteps": "999 -> 20",
    "Re": "the 6 runs of the Makefile's loop -> the first (Re 160000)",
}
BURGERS_PRE_SET = os.path.join(REPO, "build", "smoke_burgers_pre_set")
BURGERS_PRE_SET_FRAMES = 35  # 34 frames: one batch of 32 and a validation frame
BURGERS_PRE_REDUCED = {"simsteps": f"200 -> {BURGERS_PRE_SET_FRAMES}",
                       "sims": "the 10 training sims -> the test sim seed 100"}
PRE_TF = os.path.join(REPO, "build", "smoke_pre_tf")
PRE_TRAIN_EPOCHS = 3
PRE_TRAIN_STEPS = 4
PRE_TRAIN_REDUCED = {"epochs": f"400 -> {PRE_TRAIN_EPOCHS}",
                     "steps per epoch": f"len(set) // 32 -> {PRE_TRAIN_STEPS}: the sets are "
                                        "cut to the pre_gen phases' 33 and 34 frames, so each "
                                        "step is the one full batch of 32 of a fresh "
                                        "permutation"}
PRE_APPLY_OUT = os.path.join(REPO, "build", "smoke_pre_apply")
PRETF_OUT = os.path.join(REPO, "build", "smoke_pretf")
PRETF_FRAMES = 33  # 6 sims / batch 3 x (33 - msteps 32) = 2 iterations


def _scene_errors(sim: str, golden, keys, prefix: str = ""):
    """{golden key: max |frame - golden| / max |golden|} for golden keys
    "<prefix><name>_<frame>" of frames written under scene `sim`."""
    import numpy as np

    from solver_in_the_loop_torch.io.scene import read_array

    out = {}
    for key in keys:
        name, frame = key[len(prefix) if key.startswith(prefix) else 0:].rsplit("_", 1)
        got = read_array(os.path.join(sim, f"{name}_{int(frame):06d}.npz"))
        want = golden[key]
        out[key] = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    return out


def pre_divergence(sim: str, frames) -> dict:
    """{frame: max |G^T corr| on the valid lo-res cells / max |corr_u|} of
    the karman PRE corrections written under scene `sim` (-r 32): the
    constraint the projected CG holds them to."""
    import torch

    from solver_in_the_loop_torch.io.scene import legacy_to_staggered, read_array
    from solver_in_the_loop_torch.physics.karman import karman_domain
    from solver_in_the_loop_torch.pre import lsq

    geom = lsq.build_pre_geometry(karman_domain(32), karman_domain(128), 4, bnd=2)
    apply_gt, cells = lsq.make_apply_gt(geom), torch.from_numpy(geom.lo_cells)
    out = {}
    for f in frames:
        u, v = (torch.from_numpy(a) for a in legacy_to_staggered(
            read_array(os.path.join(sim, f"corr_{f:06d}.npz"))))
        div = apply_gt({"u": u, "v": v}) * cells
        out[f] = float(div.abs().max()) / (float(u.abs().max()) + 1e-9)
    return out


def phase_pre_gen():
    """karman-pre-gen through the CLI at the Makefile's width (-r 32: 64x32
    corrected lo-res, 256x128 hi-res, Re 160000) with --beta 1.0 and
    --beta 0, cut to 30 frames, every launch count set to 0 just before
    each: one pcg_solve per frame (the lo-res step), two pcg_cluster_solve
    (the hi-res step and the projection, the cluster layout as the JAX
    package takes its Pallas kernel there), a cg_solve for each of the
    correction solve's projections, no tap-sum (--advect gather); the
    kept frames 21, 25 and 29 against the JAX golden, every kept correction
    held to its constraint (G^T corr on the valid cells within PRE_DIV_TOL
    of its max); seconds per frame and their split, and the correction
    solve's iterations. --beta 1.0 runs PRE_SET_FRAMES frames, the
    pre_train phase's set. Then PRE_SPLIT_FRAMES frames twice, the hi-res
    solves on multigrid (the card's route before the cluster layout) and on
    the cluster layout, for the hi-res step's and the projection's seconds
    a frame."""
    import numpy as np

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch import parity as par
    from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain

    shutil.rmtree(PRE_SET, ignore_errors=True)
    line = {"phase": "pre_gen", "argv": par.KARMAN_PRE_GEN_ARGV, "reduced": PRE_GEN_REDUCED,
            "hires_route": KarmanFlow(karman_domain(128), device="cuda").pressure_route(1),
            "tolerance": par.ROLLOUT_REL_TOL}
    launches_by_beta = {}
    # a two-frame warm-up: the multigrid hierarchies, the operators of the
    # correction solve and cuDNN's set-up stay out of the timed runs
    cli.main(["karman-pre-gen", "-o", os.path.join(PRE_SET, "warmup"), "-r", "32", "-l", "100",
              "--re", "160000", "-t", "3", "-s", "1"])
    with np.load(par.KARMAN_PRE_GEN_GOLDEN) as golden:
        for beta in par.PRE_BETAS:
            frames = PRE_SET_FRAMES if beta == "1.0" else par.KARMAN_PRE_FRAMES
            steps = frames - 1
            argv = list(par.KARMAN_PRE_GEN_ARGV)
            argv[argv.index("-t") + 1] = str(frames)
            reset_launches()
            res = cli.main(["karman-pre-gen", "-o", os.path.join(PRE_SET, beta), *argv,
                            "--beta", beta, "--thumb"])
            launches = read_launches()
            launches_by_beta[beta] = launches
            keys = [k for k in golden.files if k.startswith(f"b{beta}_")]
            if beta == par.PRE_BETAS[0]:
                keys += [f"{n}_{par.PRE_GOLDEN_FRAMES[-1]}" for n in par.PRE_HI_NAMES]
            errs = _scene_errors(res["scene"], golden, keys, f"b{beta}_")
            thumbs = sum(len(f) for _, _, f in os.walk(os.path.join(PRE_SET, beta, "thumb")))
            sec = res["seconds"]
            div = pre_divergence(res["scene"], res["frames"])
            line[f"beta_{beta}"] = {
                "frames_run": frames, "launches": launches,
                "seconds_per_frame": sec["rollout"] / steps,
                "split_seconds_per_frame": {k: sec[k] / steps for k in
                                            ("hires_step", "lores_step", "projection", "lsq")},
                "write_seconds": sec["write"],
                "lsq_outer": {"mean": float(res["lsq_outer"].mean()),
                              "max": int(res["lsq_outer"].max())},
                "lsq_inner": {"mean": float(res["lsq_inner"].mean()),
                              "max": int(res["lsq_inner"].max())},
                "frames": res["frames"], "thumbs": thumbs,
                "corr_divergence": {"max": max(div.values()), "tolerance": par.PRE_DIV_TOL,
                                    "frames": len(div)},
                "errors_vs_jax_golden": errs, "worst": max(errs.values())}
            # a frame's correction solve projects b, its warm start and the
            # start's residual, then once an outer iteration: a cg_solve each
            projections = int(res["lsq_outer"].sum()) + 3 * steps
            require(launches == counts(pcg_solve=steps, pcg_cluster_solve=2 * steps,
                                       cg_solve=projections),
                    f"karman-pre-gen --beta {beta}: launches {launches}, expected {steps} "
                    f"pcg_solve, {2 * steps} pcg_cluster_solve, {projections} cg_solve and "
                    "nothing else")
            require(res["frames"] == list(range(par.PRE_SKIP + 1, frames)),
                    f"karman-pre-gen --beta {beta} kept frames {res['frames']}")
            require(max(div.values()) <= par.PRE_DIV_TOL,
                    f"karman-pre-gen --beta {beta}: a correction breaks its constraint: {div}")
            require(thumbs == 5 * len(res["frames"]), f"{thumbs} thumbnails")
            require(line[f"beta_{beta}"]["worst"] <= par.ROLLOUT_REL_TOL,
                    f"karman-pre-gen --beta {beta} frames differ from the JAX golden: {errs}")
    line["hires_split"] = pre_gen_split()
    emit(line)
    require(line["hires_route"] == "pcg", f"hi-res route {line['hires_route']}")
    return launches_by_beta[par.PRE_BETAS[0]]


PRE_SPLIT_FRAMES = 4


def pre_gen_split():
    """karman-pre-gen -r 32 for PRE_SPLIT_FRAMES frames with the hi-res
    solves on multigrid ("multigrid", the JAX package's Pallas gate taken
    away, so the route falls to it as it did on the card before the cluster
    layout) and on the cluster layout ("kernel"): seconds a frame of each
    stage."""
    from unittest import mock

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch import parity as par
    from solver_in_the_loop_torch.ops import poisson

    argv = list(par.KARMAN_PRE_GEN_ARGV)
    argv[argv.index("-t") + 1] = str(PRE_SPLIT_FRAMES)
    argv[argv.index("-s") + 1] = "0"
    split = {}
    for route in ("multigrid", "kernel"):
        with mock.patch.object(poisson, "jax_kernel_gate",
                               poisson.jax_kernel_gate if route == "kernel"
                               else lambda shape, precon="fd": False):
            res = cli.main(["karman-pre-gen", "-o", os.path.join(PRE_SET, f"split_{route}"),
                            *argv, "--beta", "1.0"])
        sec = res["seconds"]
        split[route] = {k: sec[k] / (PRE_SPLIT_FRAMES - 1) for k in
                        ("hires_step", "lores_step", "projection", "lsq")}
    return split


def phase_burgers_pre_gen():
    """burgers-pre-gen through the CLI at the Makefile's width (-r 32 from
    128x128) on the test sim the burgers_gen phase wrote, cut to 20 frames,
    every launch count set to 0 just before it (no kernel: --advect gather,
    no pressure solve); frames 1, 5 and 19 against the JAX golden."""
    import numpy as np

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch import parity as par

    shutil.rmtree(BURGERS_PRE_SET, ignore_errors=True)
    sim = os.path.join(BURGERS_TEST, "sim_000000")
    argv = ["burgers-pre-gen", "-o", BURGERS_PRE_SET, "-r", "32", "-l", "32", "--dt",
            str(par.BURGERS_DT), "-t", str(BURGERS_PRE_SET_FRAMES), "--beta", "1.0",
            "--initvH", os.path.join(sim, "velo_000000.npz"),
            "--loadfH", os.path.join(sim, "forc_0*.npz"), "--thumb"]
    reset_launches()
    res = cli.main(argv)
    launches = read_launches()
    with np.load(par.BURGERS_PRE_GEN_GOLDEN) as golden:
        errs = _scene_errors(res["scene"], golden, golden.files)
    frames = BURGERS_PRE_SET_FRAMES - 1
    thumbs = sum(len(f) for _, _, f in os.walk(os.path.join(BURGERS_PRE_SET, "thumb")))
    line = {"phase": "burgers_pre_gen", "argv": argv, "reduced": BURGERS_PRE_REDUCED,
            "launches": launches, "seconds_per_frame": res["seconds"]["rollout"] / frames,
            "write_seconds": res["seconds"]["write"],
            "lsq_iters": {"mean": float(res["lsq_outer"].mean()),
                          "max": int(res["lsq_outer"].max())},
            "thumbs": thumbs, "errors_vs_jax_golden": errs, "worst": max(errs.values()),
            "tolerance": par.ROLLOUT_REL_TOL}
    emit(line)
    require(launches == counts(), f"burgers-pre-gen launched {launches}")
    require(thumbs == 4 * frames, f"{thumbs} thumbnails")
    require(line["worst"] <= par.ROLLOUT_REL_TOL,
            f"burgers-pre-gen frames differ from the JAX golden: {errs}")


def _pre_train_parity(scenario: str, arch: str):
    """The port's two epochs (`--conv kernel`) from the seeded start on the
    golden frames against the JAX golden: losses, every parameter (its
    difference's norm over the golden's), stats.json."""
    import numpy as np

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch import parity as par

    root = os.path.join(PRE_TF, f"parity_{scenario}")
    shutil.rmtree(root, ignore_errors=True)
    pats = par.write_pre_set(os.path.join(root, "set"), scenario)
    opath = os.path.join(root, "tf")
    par.write_pre_start(opath, scenario, arch)
    res = cli.main([f"{scenario}-pre-train", "-o", opath, "--model", arch, *par.PRE_TRAIN_ARGV,
                    *pats, "--conv", "kernel"])
    want = par.pre_train_golden(scenario)
    got = {n: p.detach().cpu().numpy() for n, p in res["model"].state_dict().items()}
    require(set(got) == set(want["leaves"]), f"{scenario}-pre-train parameters {sorted(got)}")
    leaves = par.leaf_errors(got, want["leaves"])
    losses = want["losses"]
    errs = {"losses": float(np.max(np.abs(np.asarray(res["losses"]) - losses) / np.abs(losses))),
            "leaves": max(leaves.values()), "worst_leaf": max(leaves, key=leaves.get),
            "stats": par.stats_errors(res["stats"], want["stats"])}
    require(errs["losses"] <= par.PRE_LOSS_REL_TOL and errs["leaves"] <= par.PRE_TRAIN_REL_TOL
            and errs["stats"] <= par.PRE_STATS_REL_TOL,
            f"{scenario}-pre-train differs from the JAX golden: {errs}")
    return errs


def phase_pre_train():
    """karman-pre-train (MarsMoon) on the pre_gen phase's PRE set and
    burgers-pre-train --model jupiter_moon on the burgers_pre_gen phase's,
    both with the Makefile's flags (--seed 0 --val 0.05 --augment) and
    --conv kernel, cut to PRE_TRAIN_EPOCHS epochs of PRE_TRAIN_STEPS steps,
    with the histograms, every launch count set to 0 just before each: the
    conv launches per step, finite losses, seconds per epoch; then each
    trainer's two epochs from a seeded start on the golden frames against
    the JAX golden."""
    import numpy as np

    from solver_in_the_loop_torch import __main__ as cli

    runs = {"karman": ("mars_moon", [os.path.join(PRE_SET, "1.0", "sim_0*")], 12),
            "burgers": ("jupiter_moon", [os.path.join(BURGERS_PRE_SET, "sim_0*")], 14)}
    line = {"phase": "pre_train", "reduced": PRE_TRAIN_REDUCED}
    all_launches = {}
    for scenario, (arch, pats, convs) in runs.items():
        opath = os.path.join(PRE_TF, scenario)
        shutil.rmtree(opath, ignore_errors=True)
        # the trainer's split: --val 0.05 of the frames, at least one
        frames = len(glob.glob(os.path.join(pats[0], "corr_*.npz")))
        train_frames = frames - max(1, int(0.05 * frames))
        require(train_frames >= 32, f"{scenario}-pre-train: {train_frames} training frames, "
                "fewer than a batch of 32")
        argv = [f"{scenario}-pre-train", "-o", opath, "--model", arch, "--seed", "0",
                "--val", "0.05", "--augment", "--epochs", str(PRE_TRAIN_EPOCHS),
                "--steps", str(PRE_TRAIN_STEPS), "--conv", "kernel", *pats]
        reset_launches()
        res = cli.main(argv)
        launches = read_launches()
        steps = PRE_TRAIN_EPOCHS * PRE_TRAIN_STEPS
        # per step: every conv forward, the input gradient of each but the
        # stem (it reads data), every weight gradient; per epoch the
        # validation forward
        want = counts(conv_fwd=steps * (2 * convs - 1) + PRE_TRAIN_EPOCHS * convs,
                      conv_wgrad=steps * convs)
        all_launches[scenario] = launches
        line[scenario] = {"argv": argv, "train_frames": train_frames, "batch": 32,
                          "launches": launches,
                          "launches_per_step": {k: v / steps for k, v in launches.items()},
                          "losses": res["losses"], "val_losses": res["val_losses"],
                          "seconds_per_epoch": res["seconds_per_epoch"],
                          "histograms": res["histograms"],
                          "parity_vs_jax_golden": _pre_train_parity(scenario, arch)}
        require(launches == want, f"{scenario}-pre-train launches {launches} != {want}")
        require(all(np.isfinite(res["losses"] + res["val_losses"])),
                f"{scenario}-pre-train loss not finite")
        channels = 3 if scenario == "karman" else 4
        require(res["histograms"] == 2 * channels + 2 * 2, f"{res['histograms']} histograms")
        for name in ("model.msgpack", "stats.json", f"model_epoch{PRE_TRAIN_EPOCHS:04d}.msgpack"):
            require(os.path.isfile(os.path.join(opath, name)), f"{name} was not written")
    emit(line)
    return all_launches


def phase_pre_apply():
    """karman-pre-apply of artifacts/k_pre_train at the Makefile's run_test
    shape (batch 1, -t 500, from the built-in initial state at Re 240000)
    with --conv kernel and with cuDNN, and burgers-pre-apply of
    artifacts/b_pre_train and a seeded JupiterMoon on the test sim (199
    steps) with --conv kernel, each after a two-step warm-up, every launch
    count set to 0 just before it; steps 1, 5 and 20 against the JAX golden
    (the karman runs' own frames; Burgers on the golden's inputs; PRE-SR's
    k_presr_train 20 steps)."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch import parity as par

    shutil.rmtree(PRE_APPLY_OUT, ignore_errors=True)
    golden = dict(np.load(par.PRE_APPLY_GOLDEN))
    line = {"phase": "pre_apply", "tolerance": par.ROLLOUT_REL_TOL}
    steps = 499

    def errors(frames, label, fields):
        return {f"{k}_{t}": float(np.abs(frames[k][t - 1, 0].cpu().numpy()
                                         - golden[f"{label}_{k}"][i]).max()
                                  / np.abs(golden[f"{label}_{k}"][i]).max())
                for k in fields for i, t in enumerate(par.PRE_APPLY_GOLDEN_STEPS)}

    main_launches = None
    for conv in ("kernel", "library"):
        out = os.path.join(PRE_APPLY_OUT, f"karman_{conv}")
        cli.main(["karman-pre-apply", *par.karman_pre_apply_argv(out, steps=2), "--conv", conv])
        reset_launches()
        frames = cli.main(["karman-pre-apply", *par.karman_pre_apply_argv(out, steps=steps),
                           "--conv", conv])
        launches = read_launches()
        errs = errors(frames, "k_pre", ("dens", "u", "v"))
        line[f"karman_{conv}"] = {"launches": launches,
                                  "seconds_per_step": frames["rollout_seconds"] / steps,
                                  "finite": bool(torch.isfinite(frames["u"]).all()),
                                  "errors_vs_jax_golden": errs, "worst": max(errs.values())}
        want = counts(tap_sum_fwd=3 * steps, pcg_solve=steps,
                      conv_fwd=12 * steps if conv == "kernel" else 0)
        require(launches == want, f"karman-pre-apply --conv {conv}: {launches} != {want}")
        require(line[f"karman_{conv}"]["finite"], "karman-pre-apply frames not finite")
        require(line[f"karman_{conv}"]["worst"] <= par.ROLLOUT_REL_TOL,
                f"karman-pre-apply --conv {conv} differs from the JAX golden: {errs}")
        main_launches = main_launches or launches
    frames = cli.main(["karman-pre-apply", *par.karman_pre_apply_argv(
        os.path.join(PRE_APPLY_OUT, "presr"), par.KARMAN_PRESR_CKPT), "--conv", "kernel"])
    errs = errors(frames, "k_presr", ("dens", "u", "v"))
    line["karman_presr_20_steps"] = {"errors_vs_jax_golden": errs, "worst": max(errs.values())}
    require(max(errs.values()) <= par.ROLLOUT_REL_TOL, f"PRE-SR apply differs: {errs}")

    jm = par.jupiter_checkpoint(os.path.join(PRE_APPLY_OUT, "jupiter_net"))
    nets = {"b_pre_train": (os.path.join(par.BURGERS_PRE_CKPT, "model.msgpack"),
                            os.path.join(par.BURGERS_PRE_CKPT, "stats.json"), "mars_moon", 12),
            "jupiter": (jm["model"], jm["stats"], "jupiter_moon", 14)}
    sim = os.path.join(BURGERS_TEST, "sim_000000")
    inputs = par.burgers_apply_inputs(os.path.join(PRE_APPLY_OUT, "inputs"))
    burgers_launches = {}
    for label, (model, stats, arch, convs) in nets.items():
        out = os.path.join(PRE_APPLY_OUT, label)
        argv = ["burgers-pre-apply", "-o", out, "--model", model, "--stats", stats, "--arch",
                arch, "--initvH", os.path.join(sim, "velo_000000.npz"),
                "--loadfH", os.path.join(sim, "forc_0*.npz"), "-d", "4", "-r", "32", "-l", "32",
                "--dt", str(par.BURGERS_DT), "--conv", "kernel"]
        cli.main([*argv, "-t", "3"])
        reset_launches()
        frames = cli.main([*argv, "-t", str(BURGERS_TEST_FRAMES)])
        launches = read_launches()
        bsteps = BURGERS_TEST_FRAMES - 1
        golden_frames = cli.main(["burgers-pre-apply", *par.burgers_pre_apply_argv(
            os.path.join(out, "golden_inputs"), inputs, model, stats, arch), "--conv", "kernel"])
        errs = errors(golden_frames, label, ("u", "v"))
        line[f"burgers_{label}"] = {"arch": arch, "launches": launches,
                                    "seconds_per_step": frames["rollout_seconds"] / bsteps,
                                    "finite": bool(torch.isfinite(frames["u"]).all()),
                                    "errors_vs_jax_golden": errs, "worst": max(errs.values())}
        want = counts(tap_sum_fwd=2 * bsteps, conv_fwd=convs * bsteps)
        require(launches == want, f"burgers-pre-apply {label}: {launches} != {want}")
        require(line[f"burgers_{label}"]["finite"], f"burgers-pre-apply {label} not finite")
        require(max(errs.values()) <= par.ROLLOUT_REL_TOL,
                f"burgers-pre-apply {label} differs from the JAX golden: {errs}")
        burgers_launches[label] = launches
    emit(line)
    return main_launches, burgers_launches["jupiter"]


def phase_pretf(device):
    """`karman-train --pretf artifacts/k_pre_train/model.msgpack` through the
    CLI on the train phase's fixture, cut to 2 SOL-32 iterations, every
    launch count set to 0 just before it: the adopted stats and slope in
    dataStats.json, finite losses, the launches; and the SOL-32 train step
    from that net with its adopted scales against the JAX golden."""
    import numpy as np

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch import parity as par

    shutil.rmtree(PRETF_OUT, ignore_errors=True)
    pretf = os.path.join(par.KARMAN_PRE_CKPT, "model.msgpack")
    argv = ["karman-train", *[a if a != TRAIN_OUT else PRETF_OUT for a in train_argv()],
            "--pretf", pretf]
    argv[argv.index("-t") + 1] = str(PRETF_FRAMES)
    reset_launches()
    result = cli.main(argv)
    launches = read_launches()
    with open(os.path.join(PRETF_OUT, "dataStats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(par.KARMAN_PRE_CKPT, "stats.json")) as f:
        pre = json.load(f)
    iters = len(result.losses)
    summary = par.parity_summary(par.parity_step(device, conv="kernel", pretf=par.KARMAN_PRE_CKPT))
    errs = par.parity_errors(summary, par.train_golden_summary(par.PRE_TRAIN_GOLDEN, "pretf_"))
    line = {"phase": "pretf", "argv": argv, "reduced": {"iterations": "936 per epoch -> 2"},
            "iterations": iters, "losses": result.losses, "launches": launches,
            "launches_per_iter": {k: v / max(iters, 1) for k, v in launches.items()},
            "adopted": {k: stats.get(k) for k in ("in.std", "out.std", "leaky_alpha")},
            "step_errors_vs_jax_golden": errs, "tolerances": par.TRAIN_PARITY_TOL}
    emit(line)
    require(iters == 2, f"{iters} iterations, expected 2")
    require(all(np.isfinite(result.losses)), "a --pretf training loss is not finite")
    require(stats["in.std"] == pre["in.std"] and stats["out.std"] == pre["out.std"]
            and stats["leaky_alpha"] == pre["leaky_alpha"],
            f"dataStats.json did not adopt the PRE net's stats: {line['adopted']}")
    require(launches == {k: v * iters for k, v in counts(tap_sum_fwd=192, tap_sum_bwd=62,
                                                           pcg_solve=63).items()},
            f"--pretf launches {launches}")
    for key, tol in par.TRAIN_PARITY_TOL.items():
        require(errs[key] <= tol, f"--pretf step {key} {errs[key]} > {tol}")


DP_DIR = os.path.join(REPO, "build", "smoke_dp")
DP_FRAMES = 34  # 6 sims / batch 3 x (34 - msteps 32) = 4 iterations
DP_BURGERS_FRAMES = 6  # 10 sims / batch 5 x (6 - msteps 4) = 4 iterations
# the padded batch on 2 ranks against the run without --dp, held to the
# train parity's loss tolerance and every leaf's norm to its gradient one.
# The karman runs of that comparison start from --init zero: from the train
# phase's glorot draw (losses of 1e7) two runs without --dp, one at CG
# tolerance 1e-5 and one at 1e-7, parted by 2e-3 at the fourth loss on the
# card, and the --dp run (each rank's CG stopping on its own rows) by as much
DP_LOSS_RTOL = 1e-4
DP_LEAF_RTOL = 1e-3
DP_SHARED_INIT = ["--init", "zero"]
# a SOL-32 iteration's launches with --conv kernel, in every rank
DP_KARMAN_PER_ITER = dict(tap_sum_fwd=192, tap_sum_bwd=62, pcg_solve=63, conv_fwd=767,
                          conv_wgrad=384)
SPATIAL_RES = (32, 128)  # 64x32 (SOL-32) and 256x128 (the hi-res set), pressure_backend "xla"
SPATIAL_REL_TOL = 1e-4  # of each field's largest value: the sharded gather test's tolerance
SPATIAL_STEPS = 3  # timed steps, after one warm-up step, of each configuration
# the multigrid cases at 256x128 (pressure_backend "auto"): batch 1, and the
# hi-res generator's batch of 6 (its Re); the backward at batch 1
SPATIAL_MG_BATCHES = (1, 6)
SPATIAL_MG_ITER_TOL = 1  # sharded against unsharded multigrid iterations
SPATIAL_GRAD_REL_TOL = 1e-4  # of each input's largest gradient


def dp_karman_argv(tf):
    """The Makefile's SOL-32 command on the train phase's fixture, cut to
    DP_FRAMES frames: 4 iterations at batch 3, the convs in the port's
    kernels, which are deterministic (cuDNN's default algorithms are not:
    two runs without --dp on the card parted at the fourth loss)."""
    argv = ["karman-train", *[a if a != TRAIN_OUT else tf for a in train_argv()],
            "--conv", "kernel"]
    argv[argv.index("-t") + 1] = str(DP_FRAMES)
    return argv


def dp_burgers_argv(tf):
    """The SOL-04 command with the conv kernels on the burgers_gen set, cut to
    DP_BURGERS_FRAMES frames: 4 iterations at batch 5."""
    argv = [a if a != BURGERS_TF else tf for a in burgers_train_argv()]
    argv[argv.index("-t") + 1] = str(DP_BURGERS_FRAMES)
    return argv


def _leaves(tf):
    from solver_in_the_loop_torch.train import checkpoint as ckpt

    return ckpt._flatten(ckpt.read_msgpack(os.path.join(tf, "model.msgpack"))["params"]["params"])


def _steady(result) -> float:
    import numpy as np

    return float(np.median(result.iter_seconds[1:]))


def phase_dp_single():
    """`karman-train --dp` without a launcher, a group of one over NCCL,
    between two runs without --dp (4 SOL-32 iterations each, every launch
    count set to 0 before each run): the same losses and model.msgpack, bit
    for bit, the same launches, and the seconds per iteration of each."""
    from solver_in_the_loop_torch import __main__ as cli

    shutil.rmtree(DP_DIR, ignore_errors=True)
    runs, launches = {}, {}
    for name in ("plain", "dp", "plain_again"):
        reset_launches()
        runs[name] = cli.main([*dp_karman_argv(os.path.join(DP_DIR, name))]
                              + (["--dp"] if name == "dp" else []))
        launches[name] = read_launches()
    leaves = {name: _leaves(os.path.join(DP_DIR, name)) for name in ("plain", "dp")}
    equal = leaves["dp"].keys() == leaves["plain"].keys() and all(
        leaves["dp"][k].tobytes() == leaves["plain"][k].tobytes() for k in leaves["plain"])
    line = {"phase": "dp_single", "argv": dp_karman_argv("TF") + ["--dp"],
            "reduced": {"iterations": "936 per epoch -> 4"}, "losses": runs["dp"].losses,
            "losses_equal": runs["dp"].losses == runs["plain"].losses, "params_bit_equal": equal,
            "launches": launches["dp"],
            "sec_per_iter_median_after_first": {k: _steady(r) for k, r in runs.items()},
            "sec_per_iter": {k: r.iter_seconds for k, r in runs.items()}}
    emit(line)
    require(len(runs["dp"].losses) == 4, f"{len(runs['dp'].losses)} --dp iterations, expected 4")
    require(line["losses_equal"], "--dp as a group of one changed the losses")
    require(equal, "--dp as a group of one changed model.msgpack")
    require(launches["dp"] == launches["plain"] == {
        k: 4 * v for k, v in counts(**DP_KARMAN_PER_ITER).items()},
            f"--dp launches {launches['dp']}, without --dp {launches['plain']}")
    return launches["dp"]


def torchrun(mode: str, out: str, timeout: int = 600):
    """`python -m torch.distributed.run --standalone --nproc-per-node 2
    chip_smoke.py MODE OUT`: two ranks on the one card; returns each rank's
    JSON from OUT."""
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           os.path.abspath(__file__), mode, out]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr, flush=True)
    require(proc.returncode == 0, f"{mode} under torch.distributed.run exited {proc.returncode}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def dp_rank(out: str) -> int:
    """One rank of `dp_shared`: karman-train --dp --init zero (4 SOL-32 iterations) and
    burgers-train --dp --conv kernel (4 SOL-04 iterations) through the CLI
    entry point in one process group, each rank's launch counts set to 0
    before each run; writes OUT/rank{r}.json."""
    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch.parallel import mesh as pmesh

    mesh = pmesh.data_parallel_mesh("cuda")
    try:
        line = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
                "device": str(mesh.device)}
        for name, argv in (("karman", dp_karman_argv(os.path.join(out, "karman_tf"))
                            + DP_SHARED_INIT),
                           ("burgers", dp_burgers_argv(os.path.join(out, "burgers_tf")))):
            reset_launches()
            result = cli.main(argv + ["--dp"])
            line[name] = {"losses": result.losses, "iter_seconds": result.iter_seconds,
                          "launches": read_launches()}
        with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(line, f)
    finally:
        mesh.close()
    return 0


def phase_dp_shared():
    """`karman-train --dp --conv kernel --init zero` and `burgers-train --dp
    --conv kernel` on two ranks time-sliced on the one card (gloo): batch 3
    padded to 4, batch 5 to 6. Each rank's launches; rank 0's losses and
    its model.msgpack's leaf norms against the same runs without --dp, at
    DP_LOSS_RTOL and DP_LEAF_RTOL; every rank's losses the same."""
    import numpy as np

    from solver_in_the_loop_torch import __main__ as cli

    out = os.path.join(DP_DIR, "shared")
    plain_tf = {"karman": os.path.join(DP_DIR, "karman_plain"),
                "burgers": os.path.join(DP_DIR, "burgers_plain")}
    plain = {}
    for name, argv in (("karman", dp_karman_argv(plain_tf["karman"]) + DP_SHARED_INIT),
                       ("burgers", dp_burgers_argv(plain_tf["burgers"]))):
        shutil.rmtree(plain_tf[name], ignore_errors=True)
        plain[name] = cli.main(argv)
    t0 = time.perf_counter()
    ranks = torchrun("--dp-rank", out)
    seconds = time.perf_counter() - t0
    line = {"phase": "dp_shared", "note": "two ranks time-sliced on one card over gloo: a "
            "correctness run, not a scaling figure", "torchrun_seconds": seconds,
            "backend": ranks[0]["backend"], "devices": [r["device"] for r in ranks]}
    for name in ("karman", "burgers"):
        got, want = ranks[0][name]["losses"], plain[name].losses
        leaves = _leaves(os.path.join(out, f"{name}_tf")), _leaves(plain_tf[name])
        leaf_err = max(abs(float(np.linalg.norm(leaves[0][k])) / float(np.linalg.norm(v)) - 1.0)
                       for k, v in leaves[1].items())
        line[name] = {"losses": got, "losses_without_dp": want,
                      "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(got, want)),
                      "leaf_norm_rel_err": leaf_err,
                      "launches_by_rank": [r[name]["launches"] for r in ranks],
                      "sec_per_iter_median_after_first": float(np.median(
                          ranks[0][name]["iter_seconds"][1:])),
                      "sec_per_iter_without_dp": _steady(plain[name])}
    emit(line)
    for name, per_iter in (("karman", counts(**DP_KARMAN_PER_ITER)),
                           ("burgers", counts(tap_sum_fwd=16, tap_sum_bwd=6, conv_fwd=95,
                                              conv_wgrad=48))):
        require(ranks[0]["size"] == 2 and ranks[0]["backend"] == "gloo", f"the group {ranks[0]}")
        require(ranks[1][name]["losses"] == ranks[0][name]["losses"],
                f"{name}: the ranks logged other losses")
        require(len(ranks[0][name]["losses"]) == 4, f"{name}: not 4 iterations")
        require(line[name]["loss_rel_err"] <= DP_LOSS_RTOL,
                f"{name}: --dp losses {line[name]['loss_rel_err']} from the run without it")
        require(line[name]["leaf_norm_rel_err"] <= DP_LEAF_RTOL,
                f"{name}: --dp leaf norms {line[name]['leaf_norm_rel_err']} from the run without it")
        for r in ranks:
            require(r[name]["launches"] == {k: 4 * v for k, v in per_iter.items()},
                    f"{name} rank {r['rank']} launches {r[name]['launches']}")
    return [{**ranks[r]["karman"]["launches"]} for r in range(2)], \
        [{**ranks[r]["burgers"]["launches"]} for r in range(2)]


def _moving_state(res, device, batch: int = 1):
    """The karman initial state at res, perturbed from a seed: density, u
    and v with room to move, each batch element its own draw."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch.physics import karman

    dom = karman.karman_domain(res)
    d0, v0 = karman.initial_state(dom, batch)
    rng = np.random.RandomState(res)
    noise = [rng.rand(*d0.values.shape), rng.randn(*v0.u.shape), rng.randn(*v0.v.shape)]
    fields = [d0.values + 0.5 * torch.from_numpy(noise[0]).float(),
              v0.u + 0.3 * torch.from_numpy(noise[1]).float(),
              v0.v + 0.3 * torch.from_numpy(noise[2]).float()]
    return dom, [f.to(device) for f in fields]


@contextlib.contextmanager
def recorded_tap_sums():
    """Within it every tap-sum wrapper call appends (name, args, output) to
    the list it yields: the inputs the path gave the kernel and what the
    kernel returned. The wrappers stay the kernels' own (the solver reaches
    them through kernels/advect.py's module names) and their launch counts
    run on across it."""
    from solver_in_the_loop_torch.kernels import advect

    calls, own = [], {}
    for name in ("tap_sum_fwd", "tap_sum_bwd"):
        fn = own[name] = getattr(advect, name)

        def record(*args, _fn=fn, _name=name):
            out = _fn(*args)
            calls.append((_name, args, out))
            return out

        record.launches = fn.launches  # the wrapper counts under its module name
        setattr(advect, name, record)
    try:
        yield calls
    finally:
        for name, fn in own.items():
            fn.launches = getattr(advect, name).launches
            setattr(advect, name, fn)


def held_tap_sums(calls) -> list:
    """Each recorded tap-sum launch's output against its plain twin on the
    same inputs: the forward, ddy and ddx within TAP_SUM_TOL, dV within
    TAP_SUM_BWD_DV_REL_TOL of its largest (the karman fields are OPEN). One
    entry a launch, with its shape and "ok"."""
    import torch

    from solver_in_the_loop_torch.kernels.advect import tap_sum_bwd_plain, tap_sum_fwd_plain
    from solver_in_the_loop_torch.parity import TAP_SUM_BWD_DV_REL_TOL, TAP_SUM_TOL

    held = []
    for name, args, got in calls:
        args = [a.detach() if torch.is_tensor(a) else a for a in args]
        got = [t.detach() for t in got] if isinstance(got, tuple) else got.detach()
        entry = {"kernel": name, "shape": list(args[0].shape)}
        if name == "tap_sum_fwd":
            entry["max_abs_err"] = float((got - tap_sum_fwd_plain(*args)).abs().max())
            entry["ok"] = entry["max_abs_err"] <= TAP_SUM_TOL
        else:
            want = tap_sum_bwd_plain(*args)
            errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
            entry.update(dv_rel_err=errs[0] / float(want[0].abs().max()), ddy_abs_err=errs[1],
                         ddx_abs_err=errs[2])
            entry["ok"] = (entry["dv_rel_err"] <= TAP_SUM_BWD_DV_REL_TOL
                           and max(errs[1:]) <= TAP_SUM_TOL)
        held.append(entry)
    return held


def spatial_rank(out: str) -> int:
    """One rank of `spatial`: the y-sharded karman step on 2 ranks on the one
    card at 64x32 and 256x128, batch 1, both advection modes, from a
    perturbed state; rank 0 also runs the unsharded step on the card. The
    tap-sum launches of the sharded steps are counted per rank."""
    import torch

    from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
    from solver_in_the_loop_torch.parallel import spatial
    from solver_in_the_loop_torch.physics import karman

    mesh = spatial.spatial_mesh("cuda")
    re = torch.tensor([1.6e5], device=mesh.device)
    line = {"rank": mesh.rank, "backend": mesh.backend, "cases": []}
    try:
        for res in SPATIAL_RES:
            dom, full = _moving_state(res, mesh.device)
            for advection in ("gather", "shift"):
                flow = karman.KarmanFlow(dom, advection=advection, max_shift=2, pressure_tol=1e-6,
                                         pressure_max_iter=1000, device=mesh.device)
                step = spatial.make_sharded_step_y(flow, mesh, "xla")
                blocks = spatial.shard_staggered_y(mesh, *full)
                with recorded_tap_sums() as calls:
                    step(*blocks, re)  # warm-up
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(SPATIAL_STEPS):
                    got = step(*blocks, re)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0) / SPATIAL_STEPS
                case = {"res": [dom.ny, dom.nx], "advection": advection, "backend": "xla",
                        "batch": 1, "route": "pcg_plain",
                        "launches": {k: v / SPATIAL_STEPS for k, v in read_launches().items()},
                        "ms_per_step_sharded": ms, "tap_sums_held": held_tap_sums(calls)}
                whole = [spatial.gather_y(mesh, a, n)
                         for a, n in zip(got, (dom.ny, dom.ny, dom.ny + 1))]
                if mesh.rank == 0:
                    def plain():
                        d, vel, _, _ = flow.step(CenteredGrid(full[0], dom),
                                                 StaggeredGrid(full[1], full[2], dom), re)
                        return d.values, vel.u, vel.v

                    plain()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(SPATIAL_STEPS):
                        want = plain()
                    torch.cuda.synchronize()
                    case["ms_per_step_unsharded"] = 1e3 * (time.perf_counter() - t0) / SPATIAL_STEPS
                    case["route_unsharded"] = flow.pressure_route(1)
                    case["max_abs_err_rel"] = {
                        k: float((a - b).abs().max() / b.abs().max())
                        for k, a, b in zip(("dens", "u", "v"), whole, want)}
                    div = ((whole[1][:, :, 1:] - whole[1][:, :, :-1])
                           + (whole[2][:, 1:] - whole[2][:, :-1])) * flow.masks.fluid
                    case["max_fluid_divergence"] = float(div.abs().max())
                    case["finite"] = bool(all(torch.isfinite(a).all() for a in whole))
                line["cases"].append(case)
        for batch in SPATIAL_MG_BATCHES:
            line["cases"].append(spatial_mg_case(mesh, batch))
        line["backward"] = spatial_backward(mesh)
        with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(line, f)
    finally:
        mesh.close()
    return 0


def _spatial_mg_flow(batch, mesh):
    import torch

    from solver_in_the_loop_torch.parallel import spatial
    from solver_in_the_loop_torch.parity import KARMAN_HIRES_RE
    from solver_in_the_loop_torch.physics import karman

    dom, full = _moving_state(128, mesh.device, batch)
    flow = karman.KarmanFlow(dom, advection="shift", max_shift=2, pressure_tol=1e-6,
                             pressure_max_iter=1000, device=mesh.device)
    re = torch.tensor(KARMAN_HIRES_RE[:batch], device=mesh.device)
    return dom, full, flow, spatial.YShardedKarman(flow, mesh), re


def spatial_mg_case(mesh, batch: int) -> dict:
    """The sharded `shift` step at 256x128 and `batch` on the route
    pressure_backend "auto" takes there (multigrid): ms per step after a
    warm-up step, the launches a step, and the iterations of its solve; on
    rank 0 the unsharded step on the card (its fields, ms per step, route)
    and the unsharded `mg_solve`'s iterations on the same right-hand side."""
    import torch

    from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
    from solver_in_the_loop_torch.ops.multigrid import mg_solve
    from solver_in_the_loop_torch.parallel import spatial

    dom, full, flow, shard, re = _spatial_mg_flow(batch, mesh)
    blocks = spatial.shard_staggered_y(mesh, *full)
    with recorded_tap_sums() as calls:
        shard.step(*blocks, re)  # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SPATIAL_STEPS):
        got = shard.step(*blocks, re)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / SPATIAL_STEPS
    case = {"res": [dom.ny, dom.nx], "advection": "shift", "backend": "auto", "batch": batch,
            "route": shard.pressure_route,
            "sharded_levels_rows_per_rank": [lv.blocks[0][1] for lv in shard.mg_levels],
            "levels": len(shard.mg.levels),
            "launches": {k: v / SPATIAL_STEPS for k, v in read_launches().items()},
            "ms_per_step_sharded": ms, "tap_sums_held": held_tap_sums(calls)}
    _, u, v = shard.pre_projection(blocks[0], blocks[1], shard.to_faces(blocks[2]), re)
    case["iters_sharded"] = int(shard.project_faces(u, v)[3])
    whole = [spatial.gather_y(mesh, a, n) for a, n in zip(got, (dom.ny, dom.ny, dom.ny + 1))]
    if mesh.rank == 0:
        def plain():
            d, vel, _, _ = flow.step(CenteredGrid(full[0], dom),
                                     StaggeredGrid(full[1], full[2], dom), re)
            return d.values, vel.u, vel.v

        plain()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPATIAL_STEPS):
            want = plain()
        torch.cuda.synchronize()
        case["ms_per_step_unsharded"] = 1e3 * (time.perf_counter() - t0) / SPATIAL_STEPS
        case["route_unsharded"] = flow.pressure_route(batch)
        case["max_abs_err_rel"] = {k: float((a - b).abs().max() / b.abs().max())
                                   for k, a, b in zip(("dens", "u", "v"), whole, want)}
        div = ((whole[1][:, :, 1:] - whole[1][:, :, :-1])
               + (whole[2][:, 1:] - whole[2][:, :-1])) * flow.masks.fluid
        case["max_fluid_divergence"] = float(div.abs().max())
        case["finite"] = bool(all(torch.isfinite(a).all() for a in whole))
        m = flow.masks
        _, vel = flow.pre_projection(CenteredGrid(full[0], dom),
                                     StaggeredGrid(full[1], full[2], dom), re)
        div = ((vel.u * m.face_u)[:, :, 1:] - (vel.u * m.face_u)[:, :, :-1]
               + (vel.v * m.face_v)[:, 1:] - (vel.v * m.face_v)[:, :-1])
        rhs = torch.where(m.fluid > 0, -div, 0.0).contiguous()
        case["iters_mg_unsharded"] = int(mg_solve(rhs, torch.zeros_like(rhs), m.fluid, m.face_u,
                                                  m.face_v, flow.pressure_tol,
                                                  flow.pressure_max_iter)[1])
    return case


def spatial_backward(mesh) -> dict:
    """One backward through the sharded (1, 256, 128) multigrid step: the
    gradient of sum(w * outputs) in its inputs (its adjoint a cold sharded
    multigrid solve), every launch count set to 0 just before the step and
    read after its backward; on rank 0 the unsharded step's gradient on the
    card and the largest difference, relative to each input's largest."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
    from solver_in_the_loop_torch.parallel import spatial

    dom, full, flow, shard, re = _spatial_mg_flow(1, mesh)
    rng = np.random.RandomState(7)
    w = [torch.from_numpy(rng.randn(*a.shape).astype(np.float32)).to(mesh.device) for a in full]
    ins = [b.clone().requires_grad_() for b in spatial.shard_staggered_y(mesh, *full)]
    w_s = spatial.shard_staggered_y(mesh, *w)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_tap_sums() as calls:
        out = shard.step(*ins, re)
        sum((a * b).sum() for a, b in zip(w_s, out)).backward()
    torch.cuda.synchronize()
    line = {"res": [dom.ny, dom.nx], "batch": 1, "route": shard.pressure_route,
            "ms_step_and_backward": 1e3 * (time.perf_counter() - t0), "launches": read_launches(),
            "tap_sums_held": held_tap_sums(calls)}
    grads = [spatial.gather_y(mesh, t.grad, n) for t, n in zip(ins, (dom.ny, dom.ny, dom.ny + 1))]
    if mesh.rank == 0:
        ref = [a.clone().requires_grad_() for a in full]
        d, vel, _, _ = flow.step(CenteredGrid(ref[0], dom), StaggeredGrid(ref[1], ref[2], dom), re)
        sum((a * b).sum() for a, b in zip(w, (d.values, vel.u, vel.v))).backward()
        line["route_unsharded"] = flow.pressure_route(1)
        line["grad_err_rel"] = {k: float((g - r.grad).abs().max() / r.grad.abs().max())
                                for k, g, r in zip(("dens", "u", "v"), grads, ref)}
        line["finite"] = bool(all(torch.isfinite(g).all() for g in grads))
    return line


def phase_spatial():
    """The y-sharded karman step (parallel/spatial.py) on two ranks
    time-sliced on the one card over gloo, against the unsharded step on the
    card: each field within SPATIAL_REL_TOL of its largest value, the fluid
    divergence under 1e-3, 3 tap-sums a `shift` step in each rank; at
    pressure_backend "xla" (64x32 and 256x128, both advection modes) and
    "auto", multigrid (256x128, batch 1 and 6), there also the solve's
    iterations within SPATIAL_MG_ITER_TOL of the unsharded `mg_solve`'s,
    and one backward: 3 tap-sums and their 3 backward launches in each rank,
    the gradient within SPATIAL_GRAD_REL_TOL of the unsharded step's. Every
    tap-sum launch of a warm-up step and of the backward, on its rank's
    haloed block, is held against its plain twin (`held_tap_sums`)."""
    t0 = time.perf_counter()
    ranks = torchrun("--spatial-rank", os.path.join(DP_DIR, "spatial"))
    line = {"phase": "spatial", "note": "two ranks time-sliced on one card over gloo, the rows "
            "moved through host memory: a correctness run, not a scaling figure",
            "torchrun_seconds": time.perf_counter() - t0, "backend": ranks[0]["backend"],
            "cases": ranks[0]["cases"], "backward": ranks[0]["backward"],
            "launches_by_rank": [[c["launches"] for c in r["cases"]] for r in ranks],
            "backward_launches_by_rank": [r["backward"]["launches"] for r in ranks],
            "tap_sums_held_by_rank": [[c["tap_sums_held"] for c in r["cases"]]
                                      + [r["backward"]["tap_sums_held"]] for r in ranks]}
    emit(line)
    for case in ranks[0]["cases"]:
        what = f"spatial {case['res']} b{case['batch']} {case['advection']} {case['backend']}"
        require(case["finite"], f"{what}: a field is not finite")
        for k, err in case["max_abs_err_rel"].items():
            require(err <= SPATIAL_REL_TOL, f"{what}: {k} {err} from the unsharded step")
        require(case["max_fluid_divergence"] < 1e-3, f"{what}: divergence "
                f"{case['max_fluid_divergence']}")
        # the unsharded step's solve: the kernel at 64x32 and at 256x128
        # batch 1, multigrid at the hi-res generator's batch
        want = "multigrid" if case["batch"] == 6 else "pcg"
        require(case["route_unsharded"] == want, f"{what}: route {case['route_unsharded']}")
        if case["backend"] == "auto":
            require(case["route"] == "multigrid", f"{what}: sharded route {case['route']}")
            require(abs(case["iters_sharded"] - case["iters_mg_unsharded"]) <= SPATIAL_MG_ITER_TOL,
                    f"{what}: {case['iters_sharded']} sharded multigrid iterations, "
                    f"{case['iters_mg_unsharded']} unsharded")
    bwd = ranks[0]["backward"]
    require(bwd["route"] == "multigrid" and bwd["finite"], f"spatial backward {bwd}")
    for k, err in bwd["grad_err_rel"].items():
        require(err <= SPATIAL_GRAD_REL_TOL, f"spatial backward: {k} gradient {err} from the "
                "unsharded step's")
    for r in ranks:
        for case in r["cases"]:
            want = counts(tap_sum_fwd=3) if case["advection"] == "shift" else counts()
            require(case["launches"] == want, f"rank {r['rank']} {case['res']} b{case['batch']} "
                    f"{case['advection']} {case['backend']}: launches {case['launches']} a step")
        # the three advected fields' tap-sums, and each one's backward
        want = counts(tap_sum_fwd=3, tap_sum_bwd=3)
        require(r["backward"]["launches"] == want,
                f"rank {r['rank']} backward launches {r['backward']['launches']}")
        for case in [*r["cases"], {**r["backward"], "advection": "shift", "backend": "backward"}]:
            held = case["tap_sums_held"]
            want = {"tap_sum_fwd": 3 if case["advection"] == "shift" else 0,
                    "tap_sum_bwd": 3 if case["backend"] == "backward" else 0}
            got = {k: sum(e["kernel"] == k for e in held) for k in want}
            require(got == want and all(e["ok"] for e in held),
                    f"rank {r['rank']} {case['res']} b{case['batch']} {case['backend']}: tap-sums "
                    f"held against their twins {held}")
    return ([[c["launches"] for c in r["cases"]] for r in ranks],
            [r["backward"]["launches"] for r in ranks])


FLAGS_DIR = os.path.join(REPO, "build", "smoke_flags")
FLAGS_TRAIN_FRAMES = 33  # (6 sims / batch 3) x (33 - msteps 32) = 2 iterations
# karman-train's flags that no other phase runs on the card, each added to
# the train phase's command
FLAGS_KARMAN = {"advect_gather": ["--advect", "gather"], "non": ["-m", "1"],
                "remat_pressure": ["--remat-policy", "pressure"],
                "remat_pressure_advect": ["--remat-policy", "pressure+advect"],
                "no_remat": ["--no-remat"], "precon_none": ["--pressure-precon", "none"],
                "mercury": ["--model", "mercury"]}
FLAGS_BURGERS_SET = os.path.join(FLAGS_DIR, "burgers_noforce_set")
FLAGS_BURGERS_SIMS = 5
FLAGS_BURGERS_FRAMES = 6  # (5 sims / batch 5) x (6 - msteps 4) = 2 iterations
FLAGS_APPLY_STEPS = 20
FLAGS_LOSS_RTOL = 1e-4  # the first loss on the card against the same argv on the CPU
FLAGS_B9_ROWS = 9  # one more than a cluster: the CG kernels' cooperative grid
FLAGS_REDUCED = {
    "karman-train": f"the train phase's set and settings, -t {FLAGS_TRAIN_FRAMES} (-t 2 at -m 1): "
                    "2 iterations",
    "karman-apply": f"{FLAGS_APPLY_STEPS} frames from the 2-iteration mercury checkpoint",
    "burgers-gen": f"the Makefile's -r 128 -s 30 command, seeds 0-{FLAGS_BURGERS_SIMS - 1}, "
                   f"{FLAGS_BURGERS_FRAMES} frames",
    "burgers-train": f"SOL-04 on that set, -n {FLAGS_BURGERS_SIMS} -t {FLAGS_BURGERS_FRAMES}: "
                     "2 iterations",
    "burgers-apply": f"{FLAGS_APPLY_STEPS} frames of that 2-iteration net from sim 0's frame 0"}


def flags_karman_argv(name: str, tf: str):
    """The train phase's karman-train command at FLAGS_TRAIN_FRAMES frames
    with the flag FLAGS_KARMAN names; -m 1 (NON) at -t 2."""
    args = train_argv()
    args[args.index("--tf") + 1] = tf
    extra = FLAGS_KARMAN[name]
    if extra[0] == "-m":
        args[args.index("-m") + 1] = extra[1]
        args[args.index("-t") + 1] = str(int(extra[1]) + 1)
        extra = []
    else:
        args[args.index("-t") + 1] = str(FLAGS_TRAIN_FRAMES)
    return ["karman-train", *args, *extra]


def flags_karman_per_iter(name: str) -> dict:
    """A karman-train iteration's launches under the flag FLAGS_KARMAN
    names, from the train phase's count: the tap-sums (none with --advect
    gather) once forward and once more where the remat policy recomputes
    the advection (pressure+conv and pressure do, pressure+advect and
    --no-remat keep it), their backward for steps 1..m-1; a solve a step and
    an adjoint a step but step 0 by the kernel the precon names."""
    m = 1 if name == "non" else 32
    taps = 0 if name == "advect_gather" else 3
    passes = 1 if name in ("remat_pressure_advect", "no_remat") else 2
    solve = "cg_solve" if name == "precon_none" else "pcg_solve"
    return counts(tap_sum_fwd=passes * taps * m, tap_sum_bwd=(2 if taps else 0) * (m - 1),
                  **{solve: 2 * m - 1})


def flags_burgers_train_argv(train: str, tf: str):
    return ["burgers-train", "--train", train, "--tf", tf, "--epochs", "1", "--lr", "0.0001",
            "--dt", "0.1", "-t", str(FLAGS_BURGERS_FRAMES), "-s", "4", "-m", "4",
            "-n", str(FLAGS_BURGERS_SIMS), "-b", str(FLAGS_BURGERS_SIMS), "--seed", "0",
            "--noforce"]


def cpu_first_loss(argv) -> float:
    """The first loss of the train command `argv` with --device cpu, in this
    process: its epoch schedule cut to the first iteration, which the cut
    leaves as it was (the same shuffle draws the same first batch)."""
    from unittest import mock

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch.train.dataset import EpochSchedule

    whole = EpochSchedule.epoch_indices
    with mock.patch.object(EpochSchedule, "epoch_indices",
                           lambda self, msteps: whole(self, msteps)[:1]):
        return cli.main(argv + ["--device", "cpu"]).losses[0]


def _train_entry(result, launches, per_iter, argv):
    import numpy as np

    iters = len(result.losses)
    return {"argv": argv, "iterations": iters, "losses": result.losses,
            "guard_skipped": result.notfinite, "updates_applied": iters - result.notfinite,
            "sec_per_iter": result.iter_seconds, "launches": launches,
            "predicted_per_iter": per_iter,
            "finite": bool(np.all(np.isfinite(result.losses))),
            "launches_ok": launches == {k: v * iters for k, v in per_iter.items()}}


def _apply_entry(argv, per_step, fields):
    """`argv` (karman-apply or burgers-apply, FLAGS_APPLY_STEPS frames) on
    the card, every launch count set to 0 just before it, and on the CPU:
    launches, and frames 1, 5 and the last against the CPU's."""
    import torch

    from solver_in_the_loop_torch.parity import ROLLOUT_REL_TOL

    reset_launches()
    frames, _ = run_cli_argv(argv)
    launches = read_launches()
    cpu, _ = run_cli_argv(argv + ["--device", "cpu"])
    steps = FLAGS_APPLY_STEPS - 1
    errs, worst = _frames_errors(frames, lambda f, t: cpu[f][t - 1], fields, (1, 5, steps))
    want = counts(**{k: v * steps for k, v in per_step.items()})
    return {"argv": argv, "steps": steps, "launches": launches, "predicted": want,
            "launches_ok": launches == want, "vs_cpu": errs, "worst": worst,
            "tolerance": ROLLOUT_REL_TOL,
            "finite": all(bool(torch.isfinite(frames[k]).all()) for k in fields)}


def phase_flags(device):
    """The paths no other phase runs on the card, each through its CLI in
    this process, cut as FLAGS_REDUCED says, every launch count set to 0
    just before it: karman-train with each flag of FLAGS_KARMAN, karman-apply
    --arch mercury from the mercury run's checkpoint, burgers-gen,
    burgers-train and burgers-apply with --noforce, and the SOL-32 train step
    at batch 9 (the CG kernels' cooperative grid, forward and adjoint).
    Finite losses, an update applied, the launches against the count the
    code predicts; the first loss within FLAGS_LOSS_RTOL of the same argv
    on the CPU (its first iteration, `cpu_first_loss`), the
    generated and applied frames against the CPU's, the batch-9 step against
    the plain path within the train parity's tolerances."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch import parity as par
    from solver_in_the_loop_torch.io.scene import Scene, read_array

    shutil.rmtree(FLAGS_DIR, ignore_errors=True)
    os.makedirs(FLAGS_DIR)
    line = {"phase": "flags", "reduced": FLAGS_REDUCED}
    # burgers-gen --noforce first: burgers-train runs on its set
    gen_argv = ["burgers-gen", "-r", "128", "-l", "32", "--dt", "0.1", "-s", "30",
                "-t", str(FLAGS_BURGERS_FRAMES), "--noforce"]
    reset_launches()
    t0 = time.perf_counter()
    for seed in range(FLAGS_BURGERS_SIMS):
        cli.main(gen_argv + ["-o", FLAGS_BURGERS_SET, "--seed", str(seed)])
    gen_seconds = time.perf_counter() - t0
    gen_launches = read_launches()
    cpu_set = os.path.join(FLAGS_DIR, "burgers_noforce_cpu")
    cli.main(gen_argv + ["-o", cpu_set, "--seed", "0", "--device", "cpu"])
    card0, cpu0 = Scene.list(FLAGS_BURGERS_SET)[0], Scene.list(cpu_set)[0]
    gen_err = max(rel_err(*(torch.from_numpy(read_array(sc.frame_path("velo", t)))
                            for sc in (card0, cpu0)))
                  for t in range(FLAGS_BURGERS_FRAMES))
    line["burgers_gen_noforce"] = {
        "argv": gen_argv, "sims": len(Scene.list(FLAGS_BURGERS_SET)), "seconds": gen_seconds,
        "launches": gen_launches, "sim0_vs_cpu": gen_err, "tolerance": par.BURGERS_GEN_REL_TOL}
    runs, launches, cpu_argv = {}, {}, {}
    for name in FLAGS_KARMAN:
        argv = flags_karman_argv(name, os.path.join(FLAGS_DIR, name))
        reset_launches()
        result = cli.main(argv)
        launches[name] = read_launches()
        runs[name] = _train_entry(result, launches[name], flags_karman_per_iter(name), argv)
        cpu_argv[name] = flags_karman_argv(name, os.path.join(FLAGS_DIR, "cpu", name))
    tf = os.path.join(FLAGS_DIR, "mercury")
    runs["karman_apply_mercury"] = _apply_entry(
        ["karman-apply", "-o", OUT_DIR, "--model", os.path.join(tf, "model.msgpack"),
         "--stats", os.path.join(tf, "dataStats.json"), "--arch", "mercury", "-r", "32",
         "-l", "100", "-t", str(FLAGS_APPLY_STEPS), "--re", "240000"],
        {"tap_sum_fwd": 3, "pcg_solve": 1}, ("dens", "u", "v"))
    tf = os.path.join(FLAGS_DIR, "burgers_tf")
    argv = flags_burgers_train_argv(FLAGS_BURGERS_SET, tf)
    reset_launches()
    result = cli.main(argv)
    launches["burgers_noforce"] = read_launches()
    # the train phase's Burgers count without the conv kernels (cuDNN)
    runs["burgers_noforce"] = _train_entry(result, launches["burgers_noforce"],
                                           counts(tap_sum_fwd=16, tap_sum_bwd=6), argv)
    cpu_argv["burgers_noforce"] = flags_burgers_train_argv(FLAGS_BURGERS_SET,
                                                           os.path.join(FLAGS_DIR, "cpu", "burgers"))
    sim0 = os.path.join(FLAGS_BURGERS_SET, "sim_000000")
    runs["burgers_apply_noforce"] = _apply_entry(
        ["burgers-apply", "-o", OUT_DIR, "--noforce",
         "--stats", os.path.join(tf, "dataStats.json"),
         "--model", os.path.join(tf, "model.msgpack"),
         "--initvH", os.path.join(sim0, "velo_000000.npz"), "-d", "4", "-r", "32",
         "-l", "32", "--dt", "0.1", "-t", str(FLAGS_APPLY_STEPS)],
        {"tap_sum_fwd": 2}, ("u", "v"))
    reset_launches()
    b9 = par.parity_summary(par.parity_step(device, rows=FLAGS_B9_ROWS))
    launches["train_step_b9"] = read_launches()
    with par.plain_path():
        b9_plain = par.parity_summary(par.parity_step(device, rows=FLAGS_B9_ROWS))
    msteps = par.PARITY_MSTEPS
    want = counts(tap_sum_fwd=2 * 3 * msteps, tap_sum_bwd=2 * (msteps - 1),
                  pcg_solve=2 * msteps - 1)
    runs["train_step_b9"] = {"rows": FLAGS_B9_ROWS, "loss": b9[0], "plain_loss": b9_plain[0],
                             "launches": launches["train_step_b9"], "predicted": want,
                             "launches_ok": launches["train_step_b9"] == want,
                             "finite": bool(np.isfinite(b9[0])),
                             "vs_plain": par.parity_errors(b9, b9_plain)}
    t0 = time.perf_counter()
    for name, argv in cpu_argv.items():
        first = cpu_first_loss(argv)
        runs[name]["cpu_first_loss"] = first
        runs[name]["first_loss_rel_err_vs_cpu"] = abs(runs[name]["losses"][0] - first) / abs(first)
    line["cpu_first_losses_seconds"] = time.perf_counter() - t0
    line.update(runs)
    emit(line)
    gen = line["burgers_gen_noforce"]
    require(gen["sims"] == FLAGS_BURGERS_SIMS and gen["launches"] == counts(),
            f"burgers-gen --noforce: {gen['sims']} sims, launches {gen['launches']}")
    require(gen["sim0_vs_cpu"] <= gen["tolerance"], f"burgers-gen --noforce frames "
            f"{gen['sim0_vs_cpu']} from the CPU's")
    for name in (*FLAGS_KARMAN, "burgers_noforce"):
        run = runs[name]
        require(run["iterations"] == 2 and run["finite"], f"flags {name}: {run['iterations']} "
                f"iterations, losses {run['losses']}")
        require(run["updates_applied"] >= 1, f"flags {name}: no update applied")
        require(run["launches_ok"], f"flags {name}: launches {run['launches']}, predicted "
                f"{run['predicted_per_iter']} an iteration")
        require(run["first_loss_rel_err_vs_cpu"] <= FLAGS_LOSS_RTOL, f"flags {name}: first "
                f"loss {run['losses'][0]}, on the CPU {run['cpu_first_loss']}")
    for name in ("karman_apply_mercury", "burgers_apply_noforce"):
        run = runs[name]
        require(run["finite"] and run["launches_ok"], f"flags {name}: finite {run['finite']}, "
                f"launches {run['launches']} != {run['predicted']}")
        require(run["worst"] <= run["tolerance"], f"flags {name}: frames {run['worst']} from "
                "the CPU's")
        launches[name] = run["launches"]
    run = runs["train_step_b9"]
    require(run["finite"] and run["launches_ok"], f"flags train_step_b9: {run}")
    for key, tol in par.TRAIN_PARITY_TOL.items():
        require(run["vs_plain"][key] <= tol, f"flags train_step_b9 {key}: "
                f"{run['vs_plain'][key]} > {tol}")
    return launches


# (Re values, res, precon) of --cg-split's cluster timing: the PRE
# generator's 256x128 at batch 1 and 3, the largest element with the
# preconditioner (534x267, its fields in L2), -r 67 both ways and 256x128 at
# batch 5 without
CG_SPLIT_CLUSTER = [(RE_B1, 128, "fd"), (RE_B3, 128, "fd"), (RE_B1, 267, "fd"),
                    (RE_B1, 67, "fd"), (RE_B1, 67, "none"), (RE_B5, 128, "none")]


def cluster_solver(lib, device):
    """A caller of `silt_cg_cluster_solve` in a library of csrc/cg_cluster.cu
    (a ctypes CDLL) on the plan kernels/cg.py gives the shape: (b, x0, fluid,
    face_u, face_v, fd or None, max_iter) -> (x, iterations) at tol 0, which
    runs max_iter iterations. It takes either ABI: this layout's (the
    on-chip flag after precon) or the earlier layout's (no flag; its library
    has no `silt_cg_cluster_smem`), with the scratch each one takes."""
    import ctypes

    import torch

    from solver_in_the_loop_torch.kernels import build, cg

    flagged = hasattr(lib, "silt_cg_cluster_smem")
    fn = lib.silt_cg_cluster_solve
    fn.argtypes = ([ctypes.c_int] * (2 if flagged else 1) + [ctypes.c_void_p] * 12
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def solve(b, x0, fluid, face_u, face_v, fd, max_iter):
        bsz, h, w = b.shape
        pre = fd is not None
        blocks, band = cg.cluster_plan(b.shape, pre)
        on_chip = cg.cluster_on_chip(b.shape, pre)
        x = torch.empty_like(b)
        iters = torch.empty((), dtype=torch.int32, device=device)
        shape = (cg.cluster_work_shape(b.shape, pre, on_chip) if flagged
                 else (bsz, 5 if pre else 4, h, w))
        work = None if shape is None else torch.empty(shape, dtype=torch.float32, device=device)
        sync = torch.zeros(1 + 2 * bsz, dtype=torch.int32, device=device) if bsz > 1 else None
        ptr = [None if t is None else t.data_ptr()
               for t in (b, x0, fluid, face_u, face_v, *(fd or (None,) * 3), x, iters, work, sync)]
        flags = [int(pre), int(on_chip)] if flagged else [int(pre)]
        err = fn(*flags, *ptr, bsz, h, w, blocks, band, 0.0, max_iter,
                 torch.cuda.current_stream().cuda_stream)
        build.check(err, "cluster_solver")
        return x, iters

    return solve


def cg_split(specs) -> int:
    """`python3 chip_smoke.py --cg-split LABEL=DIR [LABEL=DIR ...]`: only the
    fixed-iteration timing of the CG kernels, built from each DIR (csrc/ or a
    copy of it: an earlier version, or one with a part of the iteration
    taken out, whose us_per_iter subtracted from the kernel's is that part's
    share of an iteration), one nvcc per source and DIR, all started
    together. Both 64x32 kernels (fixed_iter_cases) label by label, one JSON
    line per label with its ptxas report; then both instantiations of the
    cluster layout at CG_SPLIT_CLUSTER, every label in turn at each shape,
    the labels in order and then in reverse (old, new, new, old), at
    FIXED_ITERS iterations, one JSON line per shape: each label's us per
    iteration and set-up in each turn, the iterations run, and the largest
    difference of its solution from the first label's."""
    import ctypes
    from pathlib import Path
    from unittest import mock

    import torch

    from solver_in_the_loop_torch.kernels import build, cg
    from solver_in_the_loop_torch.ops.poisson import fd_factors

    device = torch.device("cuda", 0)
    new_dir, new_build = build.CSRC, build.BUILD_DIR
    labels, dirs, procs = [], {}, []
    for spec in specs:
        label, src = spec.split("=", 1)
        labels.append(label)
        dirs[label] = (Path(src).resolve(), Path(REPO, "build", "kernels_split", label))
        build.CSRC, build.BUILD_DIR = dirs[label]
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in ("pcg", "cg", "cg_cluster"):
            cmd = [build.nvcc_path(), *build.COMMON_FLAGS, *build.SOURCES[name], "-o",
                   str(build._lib_path(name)), str(build.CSRC / f"{name}.cu")]
            procs.append((label, name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True)))
    ptxas = {label: {} for label in labels}
    for label, name, proc in procs:
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"nvcc failed for {label} {name}:\n{log}")
        ptxas[label][name] = [ln.strip() for ln in log.splitlines()
                              if "ptxas info" in ln or "spill" in ln]
    solvers = {}
    # a copy of an earlier version may carve more shared memory in the plain
    # CG (the fluid and both face masks beside p): every launch gets that room
    cg_bytes = cg.cg_smem_bytes
    with mock.patch.object(cg, "cg_smem_bytes", lambda h, w: max(
            cg_bytes(h, w), 4 * (2 * h * w + h * (w + 1) + (h + 1) * w))):
        for label in labels:
            build.CSRC, build.BUILD_DIR = dirs[label]
            build._loaded.clear()
            build._functions.clear()
            solvers[label] = cluster_solver(ctypes.CDLL(str(build._lib_path("cg_cluster"))),
                                            device)
            emit({"phase": "cg_split", "label": label, "csrc": str(dirs[label][0]),
                  "ptxas": ptxas[label], **fixed_iter_cases(device)})
    build.CSRC, build.BUILD_DIR = new_dir, new_build
    build._loaded.clear()
    build._functions.clear()
    lo, hi = FIXED_ITERS
    for batch_re, res, precon in CG_SPLIT_CLUSTER:
        rhs, _, masks = karman_rhs(batch_re, device, res=res)
        shape = tuple(rhs.shape)
        pre = precon == "fd"
        ops = (rhs, torch.zeros_like(rhs), masks.fluid, masks.face_u, masks.face_v,
               fd_factors(shape[1], shape[2], device) if pre else None)
        runs = {label: {lo: [], hi: []} for label in labels}
        iters = {label: set() for label in labels}
        first = {}
        for label in labels + labels[::-1]:
            for n in (lo, hi):
                x, it = solvers[label](*ops, n)
                iters[label].add((n, int(it)))
                first.setdefault(label, x)
                runs[label][n].append(time_ms(lambda: solvers[label](*ops, n), 10))
        line = {"phase": "cg_split_cluster", "shape": list(shape), "precon": precon,
                "plan": cg.cluster_plan(shape, pre), "on_chip": cg.cluster_on_chip(shape, pre)}
        for label in labels:
            t = runs[label]
            us = [1e3 * (b - a) / (hi - lo) for a, b in zip(t[lo], t[hi])]
            line[label] = {"iters": sorted(iters[label]), f"ms_{lo}": t[lo], f"ms_{hi}": t[hi],
                           "us_per_iter": us,
                           "setup_ms": [a - lo * u / 1e3 for a, u in zip(t[lo], us)],
                           "max_abs_diff_vs_first": float((first[label] - first[labels[0]])
                                                          .abs().max())}
        emit(line)
    return 0


# Cuts of csrc/cg_cluster.cu for --cg-ablate, each (text, replacement, how
# many times it occurs), for the earlier layout (git archive 04510b4) and
# for this one. The earlier one's: "products" runs the preconditioner's
# four products with no k-step (z = 0; the loop still runs its iterations,
# its updates and its barriers); "l1" reads the cross-band operands r and
# t1 through L1 (__ldg) instead of L2 (__ldcg), as if they were near, at
# the same addresses; "barriers" keeps the stop test's cluster barrier and
# drops the others (the reductions' and those that publish r and t1), each
# a block barrier instead, so its sums read stale posts and its solution
# is wrong; its stop test is max_iter alone, so that no block of a cluster
# stops before the others (tol 0 stops nothing early). This layout's:
# "products", "l1" (the B fragments of Vy^T r and Vy t1) and "barriers" as
# the earlier one's (every cluster barrier of the loop cut); "threads256"
# runs blocks of 256 threads.
CG_ABLATIONS = {
    "products": [("const int steps = (klen + 7) >> 3;", "const int steps = 0;", 1)],
    "l1": [("tile<kConst, kLive>", "tile<kConst, kConst>", 2)],
    "barriers": [("    cluster.sync();\n    const int lane = threadIdx.x & 31;",
                  "    __syncthreads();\n    const int lane = threadIdx.x & 31;", 1),
                 ("cluster.sync();  // t1 complete", "__syncthreads();  // t1 complete", 1),
                 ("cluster.sync();  // r complete", "__syncthreads();  // r complete", 1),
                 ("const bool any = busy(rs > thresh);", "const bool any = busy(true);", 1)],
}
CG_ABLATIONS_SPLIT_ROWS = {
    "products": [("const int steps = h8 >> 3;", "const int steps = 0;", 1),
                 ("const int steps = w8 >> 3;", "const int steps = 0;", 1),
                 ("const int steps = (klen + 7) >> 3;", "const int steps = 0;", 1)],
    "l1": [("b0[u] = __ldcg(", "b0[u] = __ldg(", 1), ("b1[u] = __ldcg(", "b1[u] = __ldg(", 1),
           ("tile<kConst, kLive>", "tile<kConst, kConst>", 2)],
    "barriers": [("    cluster_arrive();\n}", "    __syncthreads();\n}", 1),
                 ("    cluster_wait();\n", "", 1),
                 ("cluster.sync();  // t1 complete", "__syncthreads();  // t1 complete", 2),
                 ("const bool any = busy(rs > thresh);", "const bool any = busy(true);", 1)],
    "threads256": [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;", 1)],
}


def cg_ablate(src: str, more) -> int:
    """`python3 chip_smoke.py --cg-ablate DIR [LABEL=DIR ...]`: a cluster
    layout split into its parts. Writes a copy of DIR (a csrc/) for each
    cut of CG_ABLATIONS (the earlier layout) or CG_ABLATIONS_SPLIT_ROWS (this
    one's, whose source has `split_step`) under build/cg_ablate/ and runs
    cg_split on DIR (label "base"), the cuts and any further labels."""
    from pathlib import Path

    root = Path(REPO, "build", "cg_ablate")
    source = (Path(src) / "cg_cluster.cu").read_text()
    ablations = CG_ABLATIONS_SPLIT_ROWS if "split_step" in source else CG_ABLATIONS
    specs = [f"base={src}"]
    for name, cuts in ablations.items():
        dst = root / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
        text = source
        for old, new, count in cuts:
            require(text.count(old) == count, f"--cg-ablate {name}: {old!r} occurs "
                    f"{text.count(old)} times in {src}/cg_cluster.cu, not {count}")
            text = text.replace(old, new)
        (dst / "cg_cluster.cu").write_text(text)
        specs.append(f"{name}={dst}")
    return cg_split(specs + list(more))


def conv_split(specs) -> int:
    """`python3 chip_smoke.py --conv-split [fwd] LABEL=DIR [LABEL=DIR ...]`:
    only one kernel of conv_bf16.cu, built from each DIR (csrc/ or a copy of
    it, an earlier version or a variant), one nvcc per DIR, all started
    together: the weight gradient at every CONV_BF16_GRAD_CASES shape beside
    cuDNN's bf16 weight gradient, or with `fwd` the forward at every
    CONV_BF16_CASES shape beside F.conv2d and as the input gradient at every
    CONV_BF16_GRAD_CASES shape beside convolution_backward. Each shape is
    timed for every label in turn, the labels in order and then in reverse;
    one JSON line per label with its ptxas report, its ms per shape (both
    passes), its error against the twin and whether a second launch gives
    the same bits."""
    import ctypes
    from pathlib import Path

    import torch
    import torch.nn.functional as F

    from solver_in_the_loop_torch.kernels import build, conv
    from solver_in_the_loop_torch.parity import bf16_errors

    fwd = specs[:1] == ["fwd"]
    specs = specs[1:] if fwd else specs
    symbol = "silt_conv_fwd_bf16" if fwd else "silt_conv_wgrad_bf16"
    argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4 + [ctypes.c_int]
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
                if fwd else
                [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6
                + [ctypes.c_void_p])
    device = torch.device("cuda", 0)
    libs = {}
    for spec in specs:  # each label's library, named as build.py names it
        label, src = spec.split("=", 1)
        build.CSRC = Path(src).resolve()
        build.BUILD_DIR = Path(REPO, "build", "kernels_split", label)
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = build._lib_path("conv_bf16")
        cmd = [build.nvcc_path(), *build.COMMON_FLAGS, *build.SOURCES["conv_bf16"], "-o",
               str(out), str(build.CSRC / "conv_bf16.cu")]
        libs[label] = (src, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    fns, lines = {}, {}
    entry = "fwd_bf16" if fwd else "wgrad"
    for label, (src, out, proc) in libs.items():
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"nvcc failed for {src}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[label] = fn
        lines[label] = {"phase": "conv_split", "kernel": "conv_fwd_bf16" if fwd
                        else "conv_wgrad_bf16", "label": label, "csrc": src,
                        "ptxas": [ln for ln in log.splitlines()
                                  if entry in ln or "spill" in ln or "Used" in ln],
                        "cases": []}
    key = ("conv_bf16", symbol)
    gen = torch.Generator(device=device).manual_seed(2)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=device)).to(bf16)

    # (shape, where, the kernel's call, its twin's, the library's, bound, the
    # error against the twin by its name)
    runs = []
    if fwd:
        for *shape, act, with_skip, where in CONV_BF16_CASES:
            b, h, wd, cin, cout, k = shape
            x, wt, bias = randn(b, h, wd, cin), randn(cout, cin, k, k, scale=0.1), \
                randn(cout, scale=0.1)
            skip = randn(b, h, wd, cout) if with_skip else None
            w = wt.permute(2, 3, 1, 0)
            runs.append((shape, where, functools.partial(
                conv.conv_fwd_bf16, x, w, bias, skip, act, 0.3),
                functools.partial(conv.conv_fwd_plain, x, w, bias, skip, act, 0.3),
                functools.partial(F.conv2d, x.permute(0, 3, 1, 2), wt, bias, padding=k // 2),
                conv_bf16_bound_ms(shape, with_skip)[0], ("bf16_err", bf16_errors)))
        for *shape, where in CONV_BF16_GRAD_CASES:
            b, h, wd, cin, cout, k = shape
            x, wt, dz = randn(b, h, wd, cin), randn(cout, cin, k, k, scale=0.1), \
                randn(b, h, wd, cout)
            w = wt.permute(2, 3, 1, 0).transpose(2, 3)
            runs.append(([b, h, wd, cout, cin, k], f"dX {where}", functools.partial(
                conv.conv_fwd_bf16, dz, w, flip=True),
                functools.partial(conv.conv_fwd_plain, dz, w, flip=True),
                functools.partial(torch.ops.aten.convolution_backward, dz.permute(0, 3, 1, 2),
                                  x.permute(0, 3, 1, 2), wt, None, [1, 1], [k // 2, k // 2],
                                  [1, 1], False, [0, 0], 1, [True, False, False]),
                conv_bf16_bound_ms([b, h, wd, cout, cin, k], False)[0],
                ("bf16_err", bf16_errors)))
    else:
        for *shape, where in CONV_BF16_GRAD_CASES:
            b, h, wd, cin, cout, k = shape
            x, dz = randn(b, h, wd, cin), randn(b, h, wd, cout)
            wt = torch.zeros((cout, cin, k, k), device=device, dtype=bf16)
            runs.append((shape, where, functools.partial(conv.conv_wgrad_bf16, x, dz, k),
                         functools.partial(conv.conv_wgrad_plain, x, dz, k),
                         functools.partial(torch.ops.aten.convolution_backward,
                                           dz.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wt,
                                           None, [1, 1], [k // 2, k // 2], [1, 1], False, [0, 0],
                                           1, [False, True, False]),
                         conv_wgrad_bf16_bound_ms(shape)[0], ("rel_err", rel_err)))
    for shape, where, run, plain, library, bound, (err_name, err) in runs:
        want = plain()
        cases = {}
        for label in list(fns) + list(fns)[::-1]:
            build._functions[key] = fns[label]
            got = run()
            torch.cuda.synchronize()
            case = cases.setdefault(label, {
                "shape": shape, "where": where, err_name: err(got, want),
                "deterministic": bool(torch.equal(got, run())), "ms": [], "bound_ms": bound})
            case["ms"].append(time_ms(run, 200))
        library_ms = time_ms(library, 200)
        for label, case in cases.items():
            lines[label]["cases"].append({**case, "library_ms": library_ms})
    build._functions.pop(key, None)
    for line in lines.values():
        emit(line)
    return 0


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "solver_in_the_loop_torch")):
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from solver_in_the_loop_torch.models.networks import disable_tf32

    disable_tf32()
    if sys.argv[1:2] == ["--cg-split"]:
        return cg_split(sys.argv[2:])
    if sys.argv[1:2] == ["--cg-ablate"]:
        return cg_ablate(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--cg-general"]:
        return cg_general(sys.argv[2])
    if sys.argv[1:2] == ["--conv-split"]:
        return conv_split(sys.argv[2:])
    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_rank(sys.argv[2])
    if sys.argv[1:2] == ["--spatial-rank"]:
        return spatial_rank(sys.argv[2])
    device = torch.device("cuda", 0)
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("env", phase_env)
    timed("build", phase_build)
    cases = timed("kernels", phase_kernels, device)
    apply_launches, frames_b1 = timed("apply_b1", phase_apply, RE_B1)
    timed("apply_b5", phase_apply, RE_B5)
    timed("parity", phase_parity, frames_b1)
    timed("profile", phase_profile)
    train_launches = timed("train", phase_train)
    timed("train_parity", phase_train_parity, device)
    timed("train_profile", phase_train_profile, device)
    timed("burgers_gen", phase_burgers_gen)
    burgers_train_launches = timed("burgers_train", phase_burgers_train)
    bf16_launches, karman_bf16_launches = timed("burgers_train_bf16", phase_burgers_train_bf16,
                                                device)
    karman_train_bf16_launches = timed("karman_train_bf16", phase_karman_train_bf16)
    timed("resume", phase_resume)
    burgers_apply_launches = timed("burgers_apply", phase_burgers_apply)
    timed("burgers_parity", phase_burgers_parity)
    timed("burgers_train_parity", phase_burgers_train_parity, device)
    timed("burgers_profile", phase_burgers_profile, device)
    gen_launches = timed("karman_gen", phase_karman_gen, device)
    timed("vcycle_kernel", phase_vcycle_kernel, device)
    timed("evaluate", phase_evaluate)
    lores_fd_launches, lores_cg_launches = timed("karman_gen_lores", phase_karman_gen_lores)
    r67_fd_launches, r67_cg_launches = timed("karman_gen_r67", phase_karman_gen_r67)
    apply_cg_launches = timed("apply_cg", phase_apply_cg)
    train_cg_launches = timed("train_parity_cg", phase_train_parity_cg, device)
    b9_fd_launches, b9_cg_launches = timed("apply_b9", phase_apply_b9)
    pre_gen_launches = timed("pre_gen", phase_pre_gen)
    timed("burgers_pre_gen", phase_burgers_pre_gen)
    pre_train_launches = timed("pre_train", phase_pre_train)
    pre_apply_launches, jupiter_apply_launches = timed("pre_apply", phase_pre_apply)
    timed("pretf", phase_pretf, device)
    dp_single_launches = timed("dp_single", phase_dp_single)
    dp_karman_launches, dp_burgers_launches = timed("dp_shared", phase_dp_shared)
    spatial_launches, spatial_bwd_launches = timed("spatial", phase_spatial)
    flags_launches = timed("flags", phase_flags, device)
    emit({"phase": "seconds", **seconds})

    def at(name, shape, **match):
        return next(c for c in cases[name] if list(c["shape"]) == list(shape) and "ms" in c
                    and all(c[k] == v for k, v in match.items()))

    tap_main = {"max_shift": 2, "periodic": False, "offsets": "clamped"}
    rows = [("tap_sum_fwd", "advect.cu", "advect_kernel.py:128",
             at("tap_sum_fwd", (3, 64, 32), **tap_main)),
            ("tap_sum_bwd", "advect.cu", "advect_kernel.py:143",
             at("tap_sum_bwd", (3, 64, 32), **tap_main)),
            ("pcg_solve", "pcg.cu", "cg_kernel.py:112", at("pcg_solve", (3, 64, 32), start="warm")),
            ("cg_solve", "cg.cu", "cg_kernel.py:39", at("cg_solve", (1, 64, 32), start="warm")),
            ("pcg_cluster_solve", "cg_cluster.cu", "cg_kernel.py:112",
             at("pcg_cluster_solve", (1, 256, 128), start="warm")),
            ("cg_cluster_solve", "cg_cluster.cu", "cg_kernel.py:39",
             at("cg_cluster_solve", (1, 134, 67), start="warm")),
            ("conv_fwd", "conv.cu", "conv_kernel.py:123",
             at("conv_fwd", (5, 32, 32, 32, 32, 5), act="leaky_relu", skip=True)),
            ("conv_wgrad", "conv.cu", "conv_kernel.py:191",
             at("conv_wgrad", (5, 32, 32, 32, 32, 5))),
            ("conv_fwd_bf16", "conv_bf16.cu", "conv_kernel.py:123",
             at("conv_fwd_bf16", (5, 32, 32, 32, 32, 5), act="leaky_relu", skip=True)),
            ("conv_wgrad_bf16", "conv_bf16.cu", "conv_kernel.py:191",
             at("conv_wgrad_bf16", (5, 32, 32, 32, 32, 5)))]
    # the per-element TPU kernels that the same CUDA kernel replaces at batch 1
    per_element = {"pcg_solve": "cg_kernel.py:180", "cg_solve": "cg_kernel.py:235",
                   "pcg_cluster_solve": "cg_kernel.py:180", "cg_cluster_solve": "cg_kernel.py:235"}
    # the main path of each kernel: karman training for the tap-sum and the
    # PCG, Burgers training for the conv kernels, the lo-res karman-gen with
    # the preconditioner off for the CG; the PRE generator's hi-res solves
    # for the cluster layout's PCG, karman-gen -r 67 without the
    # preconditioner for its CG
    main_path = {"tap_sum_fwd": train_launches, "tap_sum_bwd": train_launches,
                 "pcg_solve": train_launches, "cg_solve": lores_cg_launches,
                 "pcg_cluster_solve": pre_gen_launches, "cg_cluster_solve": r67_cg_launches,
                 "conv_fwd": burgers_train_launches, "conv_wgrad": burgers_train_launches,
                 "conv_fwd_bf16": bf16_launches, "conv_wgrad_bf16": bf16_launches}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"solver_in_the_loop_torch/csrc/{src}",
         "replaces": f"solver_in_the_loop_tpu/ops/pallas/{tpu}",
         **({"also_replaces": f"solver_in_the_loop_tpu/ops/pallas/{per_element[name]}"}
            if name in per_element else {}),
         "launches": main_path[name][name],
         "launches_by_path": {"karman_train": train_launches[name],
                              "karman_apply_b1": apply_launches[name],
                              "burgers_train": burgers_train_launches[name],
                              "burgers_apply": burgers_apply_launches[name],
                              "karman_gen_hires": gen_launches[name],
                              "karman_gen_lores_fd": lores_fd_launches[name],
                              "karman_gen_lores_none": lores_cg_launches[name],
                              "karman_gen_r67_fd": r67_fd_launches[name],
                              "karman_gen_r67_none": r67_cg_launches[name],
                              "karman_apply_b1_cg": apply_cg_launches[name],
                              "karman_train_step_cg": train_cg_launches[name],
                              "karman_apply_b9_fd": b9_fd_launches[name],
                              "karman_apply_b9_cg": b9_cg_launches[name],
                              "burgers_train_bf16": bf16_launches[name],
                              "karman_train_step_bf16": karman_bf16_launches[name],
                              "karman_train_bf16": karman_train_bf16_launches[name],
                              "karman_pre_gen": pre_gen_launches[name],
                              "karman_pre_train": pre_train_launches["karman"][name],
                              "burgers_pre_train_jupiter": pre_train_launches["burgers"][name],
                              "karman_pre_apply_b1": pre_apply_launches[name],
                              "burgers_pre_apply_jupiter": jupiter_apply_launches[name],
                              "karman_train_dp_single": dp_single_launches[name],
                              **{f"karman_train_dp_rank{r}": dp_karman_launches[r][name]
                                 for r in range(2)},
                              **{f"burgers_train_dp_rank{r}": dp_burgers_launches[r][name]
                                 for r in range(2)},
                              **{f"spatial_step_rank{r}": [c[name] for c in spatial_launches[r]]
                                 for r in range(2)},
                              **{f"spatial_backward_rank{r}": spatial_bwd_launches[r][name]
                                 for r in range(2)},
                              **{f"flags_{k}": v[name] for k, v in flags_launches.items()}},
         "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
         "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
         "shape": row["shape"]}
        for name, src, tpu, row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
