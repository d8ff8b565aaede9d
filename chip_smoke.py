#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and `nvcc`
(under $CUDA_HOME or /usr/local/cuda). It imports nothing of JAX. Phases,
each printing one JSON line:

1. env          — card, power limit, torch and CUDA versions
2. build        — compiles every kernel of solver_in_the_loop_torch/csrc with
                  nvcc, one process per source, all started together
3. kernels      — each kernel (tap-sum forward and backward, PCG) against its
                  plain PyTorch twin on the card, at the shapes of the karman
                  apply and training paths, with its time, the twin's and its
                  bound
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
                  through, and `karman-apply` from the checkpoint it wrote
8. train_parity — one SOL-32 train step on the kernel path against the same
                  step on the plain path and against the JAX package's step
                  (tests/data/torch_port/karman_train_step_sol32.npz)
9. train_profile — where a training iteration's time goes (torch.profiler)

Then the per-kernel summary line, the card's `nvidia-smi` name and power
limit, and as the last line {"ok": true, "device": {...}}. Any failed check
raises, so the script exits non-zero without that line; without CUDA, or
outside a checkout, it exits 1 at once.
"""

from __future__ import annotations

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
STEPS = 500
APPLY_SHAPES = [(1, 64, 32), (1, 64, 33), (1, 65, 32), (5, 64, 32), (5, 64, 33), (5, 65, 32)]
TRAIN_SHAPES = [(3, 64, 32), (3, 64, 33), (3, 65, 32)]
# train: the Makefile's SOL-32 run, cut to fit the script
FIXTURE_DIR = os.path.join(REPO, "build", "smoke_fixture")
TRAIN_OUT = os.path.join(REPO, "build", "smoke_train")
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

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, FP32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, n: int) -> float:
    """Mean device time of fn over n back-to-back calls, by CUDA events.

    The calls are queued behind a spin kernel that outlasts their host-side
    issue time, so for a function that does not synchronize, the events see
    the device run the n calls back to back and not the host's issue rate (a
    kernel of a few microseconds is shorter than its Python wrapper). A
    function that synchronizes (the plain PCG's .item() stop checks) is timed
    as it runs, host time included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    issue_s = (time.perf_counter() - t0) / 3 * n
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * issue_s, 0.5) * 2e9))  # ~2 GHz SM clock
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _bound(nbytes: float, ops: float):
    """(least time in ms at the card's peak rates, "bytes" or "operations")."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tap_sum_bound_ms(shape, m: int):
    """Three inputs read and one output written once; per cell 2(2m+2) hat
    weights of 4 operations and (2m+2)^2 taps of 3 (weight product, multiply, add)."""
    cells = shape[0] * shape[1] * shape[2]
    taps = 2 * m + 2
    ops = cells * (4 * 2 * taps + 3 * taps * taps)
    return _bound(16 * cells, ops)


def tap_sum_bwd_bound_ms(shape, m: int):
    """Four inputs read and three outputs written once; per cell the hat
    weights and slopes of 2(2m+2) offsets (8 operations each) and, per tap,
    10 operations: g*V, two weight products with their multiply-adds into
    ddy and ddx, and g*wy*wx added into dV. About 3x the forward's."""
    cells = shape[0] * shape[1] * shape[2]
    taps = 2 * m + 2
    ops = cells * (8 * 2 * taps + 10 * taps * taps)
    return _bound(28 * cells, ops)


def pcg_bound_ms(shape, iters: int):
    """Inputs (b, x0, fluid, face masks, Vy, Vx, invd) read and x written once;
    per element and iteration (plus the set-up pass) the four preconditioner
    products 4HW(H+W) and about 28 operations per cell of operator, dots and updates."""
    b, h, w = shape
    byts = 4 * (3 * b * h * w + 2 * h * w + h * (w + 1) + (h + 1) * w + h * h + w * w)
    ops = b * (iters + 1) * (4 * h * w * (h + w) + 28 * h * w)
    return _bound(byts, ops)


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
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": report})


def karman_rhs(batch_re, device, steps=30):
    """A real pressure problem on the card: the projection's RHS after `steps`
    solver steps on the plain path, the previous step's pressure (the warm
    start), and the masks."""
    import torch

    from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
    from solver_in_the_loop_torch.ops.stencils import divergence
    from solver_in_the_loop_torch.parity import plain_path
    from solver_in_the_loop_torch.physics.karman import KarmanFlow, initial_state, karman_domain
    from solver_in_the_loop_torch.train.rollout import karman_rollout

    dom = karman_domain(32)
    flow = KarmanFlow(dom, advection="shift", max_shift=2, device=device)
    re = torch.tensor(batch_re, device=device)
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


def _offsets(shape, kind, gen, device):
    """Tap-sum offsets: "uniform" in +-2.5 (beyond the taps' reach), "integer"
    (the same rounded: every tap on a kink or a tie of the hat weights), or
    "clamped" (uniform, then clamped into the field as the OPEN solver does)."""
    import torch

    dy = torch.rand(shape, generator=gen, device=device) * 5.0 - 2.5
    dx = torch.rand(shape, generator=gen, device=device) * 5.0 - 2.5
    if kind == "integer":
        return dy.round(), dx.round()
    if kind == "clamped":
        jj = torch.arange(shape[1], device=device, dtype=dy.dtype)[None, :, None]
        ii = torch.arange(shape[2], device=device, dtype=dy.dtype)[None, None, :]
        dy = (torch.clamp(jj + dy.clamp(-2, 2), 0.0, shape[1] - 1.0) - jj).contiguous()
        dx = (torch.clamp(ii + dx.clamp(-2, 2), 0.0, shape[2] - 1.0) - ii).contiguous()
    return dy, dx


def phase_kernels(device):
    import torch

    from solver_in_the_loop_torch.kernels.advect import (
        tap_sum_bwd,
        tap_sum_bwd_plain,
        tap_sum_fwd,
        tap_sum_fwd_plain,
    )
    from solver_in_the_loop_torch.kernels.cg import pcg_solve, pcg_solve_plain
    from solver_in_the_loop_torch.ops.poisson import fd_factors
    from solver_in_the_loop_torch.parity import (
        PARITY_RE,
        PCG_ITER_TOL,
        PCG_REL_TOL,
        TAP_SUM_BWD_DV_REL_TOL,
        TAP_SUM_TOL,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    m = 2
    tap_cases = []
    for shape in TRAIN_SHAPES + APPLY_SHAPES:
        for periodic in (False, True):
            for offsets in ("uniform", "integer"):
                vals = torch.randn(shape, generator=gen, device=device)
                dy, dx = _offsets(shape, offsets, gen, device)
                got = tap_sum_fwd(vals, dy, dx, m, periodic)
                want = tap_sum_fwd_plain(vals, dy, dx, m, periodic)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                case = {"shape": list(shape), "periodic": periodic, "offsets": offsets,
                        "max_abs_err": err}
                if offsets == "uniform" and not periodic:
                    case["ms"] = time_ms(lambda: tap_sum_fwd(vals, dy, dx, m, periodic), 200)
                    case["plain_ms"] = time_ms(
                        lambda: tap_sum_fwd_plain(vals, dy, dx, m, periodic), 20)
                    case["bound_ms"], case["bound_by"] = tap_sum_bound_ms(shape, m)
                tap_cases.append(case)
                require(err <= TAP_SUM_TOL, f"tap_sum_fwd {case} differs from its plain twin")

    bwd_cases = []
    for shape in TRAIN_SHAPES + APPLY_SHAPES:
        for periodic in (False, True):
            kinds = ("uniform", "integer") + (("clamped",) if shape in TRAIN_SHAPES
                                              and not periodic else ())
            for offsets in kinds:
                vals, g = (torch.randn(shape, generator=gen, device=device) for _ in range(2))
                dy, dx = _offsets(shape, offsets, gen, device)
                got = tap_sum_bwd(vals, dy, dx, g, m, periodic)
                want = tap_sum_bwd_plain(vals, dy, dx, g, m, periodic)
                torch.cuda.synchronize()
                errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
                dv_rel = errs[0] / float(want[0].abs().max())
                case = {"shape": list(shape), "periodic": periodic, "offsets": offsets,
                        "max_abs_err": max(errs), "dv_abs_err": errs[0], "dv_rel_err": dv_rel,
                        "ddy_abs_err": errs[1], "ddx_abs_err": errs[2]}
                if offsets == "uniform" and not periodic:
                    case["ms"] = time_ms(lambda: tap_sum_bwd(vals, dy, dx, g, m, periodic), 200)
                    case["plain_ms"] = time_ms(
                        lambda: tap_sum_bwd_plain(vals, dy, dx, g, m, periodic), 10)
                    case["bound_ms"], case["bound_by"] = tap_sum_bwd_bound_ms(shape, m)
                bwd_cases.append(case)
                dv_tol = 0.0 if offsets == "clamped" else TAP_SUM_BWD_DV_REL_TOL
                require(errs[1] <= TAP_SUM_TOL and errs[2] <= TAP_SUM_TOL and dv_rel <= dv_tol,
                        f"tap_sum_bwd {case} differs from its plain twin")

    pcg_cases = []
    tol, max_iter = 1e-5, 1000
    for batch_re in (RE_B1, PARITY_RE, RE_B5):
        rhs, warm, masks = karman_rhs(batch_re, device)
        vy, vx, invd = fd_factors(rhs.shape[1], rhs.shape[2], device)
        for start in ("cold", "warm"):
            x0 = warm if start == "warm" else torch.zeros_like(rhs)
            args = (rhs, x0, masks.fluid, masks.face_u, masks.face_v, vy, vx, invd, tol, max_iter)
            x_k, it_k = pcg_solve(*args)
            x_p, it_p = pcg_solve_plain(*args)
            torch.cuda.synchronize()
            case = {"shape": list(rhs.shape), "start": start, "iters": int(it_k),
                    "plain_iters": int(it_p), "rel_err": rel_err(x_k, x_p),
                    "max_abs_err": float((x_k - x_p).abs().max()),
                    "ms": time_ms(lambda: pcg_solve(*args), 50),
                    "plain_ms": time_ms(lambda: pcg_solve_plain(*args), 5)}
            case["bound_ms"], case["bound_by"] = pcg_bound_ms(rhs.shape, case["iters"])
            pcg_cases.append(case)
            require(abs(case["iters"] - case["plain_iters"]) <= PCG_ITER_TOL,
                    f"pcg_solve iterations {case}")
            require(case["rel_err"] <= PCG_REL_TOL, f"pcg_solve solution {case}")
    emit({"phase": "kernels", "library_ms": "none: no single PyTorch call computes any "
          "kernel's function", "tap_sum_fwd": tap_cases, "tap_sum_bwd": bwd_cases,
          "pcg_solve": pcg_cases,
          "tolerances": {"tap_sum_abs": TAP_SUM_TOL, "tap_sum_bwd_dv_rel": TAP_SUM_BWD_DV_REL_TOL,
                         "pcg_rel": PCG_REL_TOL, "pcg_iters": PCG_ITER_TOL}})
    return {"tap_sum_fwd": tap_cases, "tap_sum_bwd": bwd_cases, "pcg_solve": pcg_cases}


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

    from solver_in_the_loop_torch.kernels.advect import tap_sum_bwd, tap_sum_fwd
    from solver_in_the_loop_torch.kernels.cg import pcg_solve

    run_cli(re_list, 2)
    tap_sum_fwd.launches = tap_sum_bwd.launches = pcg_solve.launches = 0
    frames, scenes = run_cli(re_list, STEPS)
    launches = {"tap_sum_fwd": tap_sum_fwd.launches, "tap_sum_bwd": tap_sum_bwd.launches,
                "pcg_solve": pcg_solve.launches}
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
    require(launches == {"tap_sum_fwd": 3 * steps, "tap_sum_bwd": 0, "pcg_solve": steps},
            f"launch counts {launches} != 3x{steps} tap-sum, no backward, {steps} pcg")
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
    `karman-apply` for 20 steps from the checkpoint it wrote."""
    from unittest import mock

    import numpy as np
    import torch

    from solver_in_the_loop_torch import __main__ as cli
    from solver_in_the_loop_torch.kernels import advect, cg

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
    advect.tap_sum_fwd.launches = advect.tap_sum_bwd.launches = pcg_solve.launches = 0
    with mock.patch.object(cg, "pcg_solve", pcg_solve):
        t0 = time.perf_counter()
        result = cli.main(["karman-train", *train_argv()])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {"tap_sum_fwd": advect.tap_sum_fwd.launches,
                "tap_sum_bwd": advect.tap_sum_bwd.launches, "pcg_solve": pcg_solve.launches}
    peak = torch.cuda.max_memory_allocated()
    iters = len(result.losses)
    msteps = 32
    # per iteration under pressure+conv: every step's three tap-sums forward
    # and again in the recompute; the backward of u's and v's (density does
    # not reach the loss), not for step 0, whose inputs are data; one solve
    # per step forward and one adjoint per step but step 0
    per_iter = {"tap_sum_fwd": 2 * 3 * msteps, "tap_sum_bwd": 2 * (msteps - 1),
                "pcg_solve": msteps + (msteps - 1)}
    solves = torch.stack(record).cpu().numpy().reshape(iters, per_iter["pcg_solve"])
    fwd_iters, adj_iters = solves[:, :msteps], solves[:, msteps:]
    frames, _ = run_cli_argv(["karman-apply", "-o", OUT_DIR, "--model",
                              os.path.join(TRAIN_OUT, "model.msgpack"), "--stats",
                              os.path.join(TRAIN_OUT, "dataStats.json"), "-r", "32", "-l", "100",
                              "-t", "20", "--re", "240000"])
    apply_finite = all(bool(torch.isfinite(v).all()) for k, v in frames.items()
                       if k != "rollout_seconds")
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
    require(np.array_equal(fwd_iters, np.asarray(result.cg_iters)),
            "the recorded forward solves are not the trainer's")
    for name in ("model.msgpack", "dataStats.json"):
        require(os.path.isfile(os.path.join(TRAIN_OUT, name)), f"{name} was not written")
    require(apply_finite, "karman-apply from the trained checkpoint gave non-finite frames")
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
    line = {"phase": "train_parity", "tolerances": par.TRAIN_PARITY_TOL,
            "kernel_loss": kernel[0], "plain_loss": plain[0], "jax_loss": golden[0],
            "plain_cg_iters_forward": plain_step[2].tolist(),
            "vs_plain": par.parity_errors(kernel, plain),
            "vs_jax_golden": par.parity_errors(kernel, golden),
            "plain_vs_jax_golden": par.parity_errors(plain, golden)}
    emit(line)
    for against in ("vs_plain", "vs_jax_golden"):
        for key, tol in par.TRAIN_PARITY_TOL.items():
            require(line[against][key] <= tol, f"train parity {against} {key}: "
                    f"{line[against][key]} > {tol}")


def phase_train_profile(device, iters=2):
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

    def timed(n=3):
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
    device = torch.device("cuda", 0)
    smi = phase_env()
    phase_build()
    cases = phase_kernels(device)
    apply_launches, frames_b1 = phase_apply(RE_B1)
    phase_apply(RE_B5)
    phase_parity(frames_b1)
    phase_profile()
    train_launches = phase_train()
    phase_train_parity(device)
    phase_train_profile(device)

    def at(name, shape, **match):
        return next(c for c in cases[name] if c["shape"] == list(shape) and "ms" in c
                    and all(c[k] == v for k, v in match.items()))

    rows = [("tap_sum_fwd", "advect.cu", "advect_kernel.py:128", at("tap_sum_fwd", (3, 64, 32))),
            ("tap_sum_bwd", "advect.cu", "advect_kernel.py:143", at("tap_sum_bwd", (3, 64, 32))),
            ("pcg_solve", "pcg.cu", "cg_kernel.py:112", at("pcg_solve", (3, 64, 32), start="warm"))]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"solver_in_the_loop_torch/csrc/{src}",
         "replaces": f"solver_in_the_loop_tpu/ops/pallas/{tpu}",
         "launches": train_launches[name],
         "launches_by_path": {"train": train_launches[name], "apply_b1": apply_launches[name]},
         "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
         "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": None, "shape": row["shape"]}
        for name, src, tpu, row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
