#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and `nvcc`
(under $CUDA_HOME or /usr/local/cuda). It imports nothing of JAX. Phases,
each printing one JSON line:

1. env      — card, power limit, torch and CUDA versions
2. build    — compiles every kernel of solver_in_the_loop_torch/csrc with nvcc
3. kernels  — each kernel against its plain PyTorch twin on the card, at the
              shapes of the karman apply path, with its time and the twin's
4. apply    — `karman-apply` through the CLI entry point at the full width of
              the SOL-32 MarsMoon checkpoint (artifacts/a3_k_sol32), 500
              steps at batch 1 and at batch 5, each after a one-step warm-up
              run at its batch size, with the kernels' launch counts
5. parity   — steps 1, 5 and 20 of that batch-1 run against the same CLI run
              on the port's plain path and against frames the JAX package
              produced on the CPU (tests/data/torch_port/)
6. profile  — where a batch-1 rollout step's time goes (torch.profiler)

Then the per-kernel summary line, the card's `nvidia-smi` name and power
limit, and as the last line {"ok": true, "device": {...}}. Any failed check
raises, so the script exits non-zero without that line; without CUDA, or
outside a checkout, it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "artifacts", "a3_k_sol32")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port", "karman_apply_sol32_r32.npz")
OUT_DIR = os.path.join(REPO, "build", "smoke_out")
RE_B1 = [240000.0]
RE_B5 = [240000.0, 480000.0, 960000.0, 1920000.0, 3840000.0]
STEPS = 500

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, FP32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# Tolerances. The tap-sum kernel rounds every multiply and add on its own
# in the twin's order, so it must match bit for bit. The PCG kernel sums its
# dot products and matrix products in another order than the twin (cuBLAS
# einsums, torch.sum), so the iterates differ in the last bits: the iteration
# counts may differ by one and the solutions by 1e-4 of their max, the order
# of the CG tolerance 1e-5 amplified by the operator's condition. The rollout
# feeds such differences back through 20 steps of a chaotic flow, hence 1e-3.
TAP_SUM_TOL = 0.0
PCG_REL_TOL = 1e-4
PCG_ITER_TOL = 1
ROLLOUT_REL_TOL = 1e-3


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


@contextlib.contextmanager
def plain_path():
    """Swap both kernels' wrappers for their plain PyTorch twins at the two
    places the solver calls them, so the same code runs without a kernel."""
    from solver_in_the_loop_torch.kernels.advect import tap_sum_fwd_plain
    from solver_in_the_loop_torch.kernels.cg import pcg_solve_plain
    from solver_in_the_loop_torch.ops import interp, poisson

    with mock.patch.object(interp, "tap_sum_fwd", tap_sum_fwd_plain), \
            mock.patch.object(poisson, "pcg_solve", pcg_solve_plain):
        yield


def karman_rhs(batch_re, device, steps=30):
    """A real pressure problem on the card: the projection's RHS after `steps`
    solver steps on the plain path, the previous step's pressure (the warm
    start), and the masks."""
    import torch

    from solver_in_the_loop_torch.core.grids import CenteredGrid, StaggeredGrid
    from solver_in_the_loop_torch.ops.stencils import divergence
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


def phase_kernels(device):
    import torch

    from solver_in_the_loop_torch.kernels.advect import tap_sum_fwd, tap_sum_fwd_plain
    from solver_in_the_loop_torch.kernels.cg import pcg_solve, pcg_solve_plain
    from solver_in_the_loop_torch.ops.poisson import fd_factors

    gen = torch.Generator(device=device).manual_seed(0)
    m = 2
    tap_cases = []
    for shape in [(1, 64, 32), (1, 64, 33), (1, 65, 32), (5, 64, 32), (5, 64, 33), (5, 65, 32)]:
        for periodic in (False, True):
            for offsets in ("uniform", "integer"):
                vals = torch.randn(shape, generator=gen, device=device)
                dy = (torch.rand(shape, generator=gen, device=device) * 5.0 - 2.5)
                dx = (torch.rand(shape, generator=gen, device=device) * 5.0 - 2.5)
                if offsets == "integer":
                    dy, dx = dy.round(), dx.round()
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

    pcg_cases = []
    tol, max_iter = 1e-5, 1000
    for batch_re in (RE_B1, RE_B5):
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
    emit({"phase": "kernels", "library_ms": "none: no single PyTorch call computes either "
          "kernel's function", "tap_sum_fwd": tap_cases, "pcg_solve": pcg_cases,
          "tolerances": {"tap_sum_abs": TAP_SUM_TOL, "pcg_rel": PCG_REL_TOL,
                         "pcg_iters": PCG_ITER_TOL}})
    return tap_cases, pcg_cases


def apply_argv(re_list, simsteps: int):
    """karman-apply's arguments for the SOL-32 rollout at res 32 from the
    built-in initial state."""
    return ["-o", OUT_DIR, "--model", os.path.join(CKPT, "model.msgpack"),
            "--stats", os.path.join(CKPT, "dataStats.json"), "--arch", "mars_moon",
            "-r", "32", "-l", "100", "-t", str(simsteps), "--re", *[str(int(r)) for r in re_list]]


def run_cli(re_list, simsteps: int):
    """`python -m solver_in_the_loop_torch karman-apply ...` in this process;
    returns its frames and the number of scenes it wrote."""
    from solver_in_the_loop_torch import __main__ as cli

    shutil.rmtree(OUT_DIR, ignore_errors=True)
    frames = cli.main(["karman-apply", *apply_argv(re_list, simsteps)])
    scenes = len(os.listdir(OUT_DIR))
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    return frames, scenes


def phase_apply(re_list):
    """The main path: a one-step warm-up run (model and cuDNN set-up), then the
    500-step run with every launch count set to 0 just before it."""
    import numpy as np
    import torch

    from solver_in_the_loop_torch.kernels.advect import tap_sum_fwd
    from solver_in_the_loop_torch.kernels.cg import pcg_solve

    run_cli(re_list, 2)
    tap_sum_fwd.launches = 0
    pcg_solve.launches = 0
    frames, scenes = run_cli(re_list, STEPS)
    launches = {"tap_sum_fwd": tap_sum_fwd.launches, "pcg_solve": pcg_solve.launches}
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
    require(launches == {"tap_sum_fwd": 3 * steps, "pcg_solve": steps},
            f"launch counts {launches} != 3x{steps} tap-sum, {steps} pcg")
    require(finite, "non-finite frames in the rollout")
    require(scenes == len(re_list), f"wrote {scenes} scenes for {len(re_list)} Re")
    return launches, frames


def phase_parity(frames):
    """Steps 1, 5 and 20 of the timed batch-1 run (`frames`) against the same
    CLI run on the plain path and against the JAX package's golden frames."""
    import numpy as np
    import torch

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
    tap_cases, pcg_cases = phase_kernels(device)
    launches, frames_b1 = phase_apply(RE_B1)
    phase_apply(RE_B5)
    phase_parity(frames_b1)
    phase_profile()

    main_tap = next(c for c in tap_cases if c["shape"] == [1, 64, 32] and "ms" in c)
    main_pcg = next(c for c in pcg_cases if c["shape"][0] == 1 and c["start"] == "warm")
    emit({"kernels": [
        {"name": "tap_sum_fwd", "route": "cuda", "source": "solver_in_the_loop_torch/csrc/advect.cu",
         "replaces": "solver_in_the_loop_tpu/ops/pallas/advect_kernel.py:128",
         "launches": launches["tap_sum_fwd"],
         "max_abs_err": max(c["max_abs_err"] for c in tap_cases),
         "ms": main_tap["ms"], "plain_ms": main_tap["plain_ms"], "bound_ms": main_tap["bound_ms"],
         "bound_by": main_tap["bound_by"], "library_ms": None},
        {"name": "pcg_solve", "route": "cuda", "source": "solver_in_the_loop_torch/csrc/pcg.cu",
         "replaces": "solver_in_the_loop_tpu/ops/pallas/cg_kernel.py:180",
         "launches": launches["pcg_solve"],
         "max_abs_err": max(c["max_abs_err"] for c in pcg_cases),
         "ms": main_pcg["ms"], "plain_ms": main_pcg["plain_ms"], "bound_ms": main_pcg["bound_ms"],
         "bound_by": main_pcg["bound_by"], "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
