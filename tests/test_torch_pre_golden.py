"""The JAX goldens of chip_smoke.py's PRE phases, and the port's CPU runs
held to them.

* `karman_pre_gen_r32.npz`: karman-pre-gen at the Makefile's width (-r 32,
  Re 160000) cut to 30 frames (20 skipped), with --beta 1.0 and --beta 0:
  the lo-res frames (densC, veloC, dens, velo, corr) 21, 25 and 29 of both,
  the hi-res ones (densH, veloH) of frame 29 (legacy layout).
* `burgers_pre_gen_r32.npz`: burgers-pre-gen -r 32 -t 20 from the Makefile's
  test sim seed 100 (the JAX burgers-gen at 128x128): frames 1, 5 and 19 of
  veloC, velo, corr and forc, and veloH of frame 19.
* `pre_apply_r32.npz`: 20 steps of karman-pre-apply with
  artifacts/k_pre_train and k_presr_train from the built-in initial state
  (-r 32, Re 240000), and of burgers-pre-apply on the Burgers apply golden's
  inputs with artifacts/b_pre_train (MarsMoon) and a JupiterMoon of seeded
  weights (parity.jupiter_checkpoint).
* `pre_train_r32.npz`: both pre-trainers' two epochs (`--resume 1 --epochs
  3`) from seeded weights (parity.write_pre_start) on the PRE golden frames
  (parity.write_pre_set): the epochs' losses, every parameter (the
  port's names) and stats.json; and the SOL-32 train step from the
  `--pretf` net artifacts/k_pre_train with its adopted normalisation.

Regenerate all four with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_pre_golden.py

(~3 min). The tolerances are those of solver_in_the_loop_torch/parity.py,
which chip_smoke.py holds the card to.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from solver_in_the_loop_tpu.apps import burgers_gen as jax_bgen
from solver_in_the_loop_tpu.apps import burgers_pre_apply as jax_bpa
from solver_in_the_loop_tpu.apps import burgers_pre_gen as jax_bpg
from solver_in_the_loop_tpu.apps import karman_pre_apply as jax_kpa
from solver_in_the_loop_tpu.apps import karman_pre_gen as jax_kpg
from solver_in_the_loop_tpu.apps import pre_train as jax_pt
from solver_in_the_loop_tpu.models.features import Normalization as JNormalization
from solver_in_the_loop_tpu.models.networks import build_model as jax_build_model
from solver_in_the_loop_tpu.physics import karman as jk
from solver_in_the_loop_tpu.train import checkpoint as jax_ckpt
from solver_in_the_loop_tpu.train import trainer as jtrainer

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.io import scene as torch_scene
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.train.checkpoint import params_from_jax, read_msgpack

torch.set_num_threads(2)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _frames(sim: str, names, frames, prefix: str = "") -> dict:
    return {f"{prefix}{n}_{f}": torch_scene.read_array(os.path.join(sim, f"{n}_{f:06d}.npz"))
            for n in names for f in frames}


def karman_pre_gen_argv(out: str, beta: str) -> list:
    return ["-o", out, *parity.KARMAN_PRE_GEN_ARGV, "--beta", beta]


def make_karman_pre_gen_golden():
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for beta in parity.PRE_BETAS:
            jax_kpg.main(karman_pre_gen_argv(os.path.join(tmp, beta), beta))
            sim = os.path.join(tmp, beta, "sim_000000")
            out.update(_frames(sim, parity.PRE_LO_NAMES, parity.PRE_GOLDEN_FRAMES, f"b{beta}_"))
            if beta == parity.PRE_BETAS[0]:
                out.update(_frames(sim, parity.PRE_HI_NAMES, parity.PRE_GOLDEN_FRAMES[-1:]))
    return out


def burgers_test_sim(out: str) -> str:
    """The JAX package's burgers-gen of the Makefile's test sim seed 100,
    cut to the frames burgers-pre-gen replays; returns its scene."""
    jax_bgen.main(["-o", out, *parity.BURGERS_GEN_ARGV, "-t", str(parity.BURGERS_PRE_FRAMES)])
    return os.path.join(out, "sim_000000")


def burgers_pre_gen_argv(out: str, sim: str) -> list:
    return ["-o", out, "-r", "32", "-l", "32", "--dt", str(parity.BURGERS_DT),
            "-t", str(parity.BURGERS_PRE_FRAMES),
            "--initvH", os.path.join(sim, "velo_000000.npz"),
            "--loadfH", os.path.join(sim, "forc_0*.npz")]


def make_burgers_pre_gen_golden():
    with tempfile.TemporaryDirectory() as tmp:
        sim = burgers_test_sim(os.path.join(tmp, "hires"))
        jax_bpg.main(burgers_pre_gen_argv(os.path.join(tmp, "pre"), sim))
        pre = os.path.join(tmp, "pre", "sim_000000")
        out = _frames(pre, parity.BURGERS_PRE_NAMES, parity.BURGERS_PRE_GOLDEN_FRAMES)
        out.update(_frames(pre, ("veloH",), parity.BURGERS_PRE_GOLDEN_FRAMES[-1:]))
    return out


def burgers_pre_nets(tmp: str) -> dict:
    """{label: (model, stats, arch)} of the Burgers PRE rollouts."""
    jm = parity.jupiter_checkpoint(os.path.join(tmp, "jm"))
    return {"b_pre_train": (os.path.join(parity.BURGERS_PRE_CKPT, "model.msgpack"),
                            os.path.join(parity.BURGERS_PRE_CKPT, "stats.json"), "mars_moon"),
            "jupiter": (jm["model"], jm["stats"], "jupiter_moon")}


def make_pre_apply_golden():
    """The PRE rollouts' frames at PRE_APPLY_GOLDEN_STEPS."""
    out = {}
    steps = [t - 1 for t in parity.PRE_APPLY_GOLDEN_STEPS]
    with tempfile.TemporaryDirectory() as tmp:
        for label, ckpt_dir in (("k_pre", parity.KARMAN_PRE_CKPT),
                                ("k_presr", parity.KARMAN_PRESR_CKPT)):
            frames = jax_kpa.main(parity.karman_pre_apply_argv(os.path.join(tmp, label),
                                                               ckpt_dir))
            for k in ("dens", "u", "v"):
                out[f"{label}_{k}"] = np.asarray(frames[k])[steps, 0]
        inputs = parity.burgers_apply_inputs(os.path.join(tmp, "inputs"))
        for label, (model, stats, arch) in burgers_pre_nets(tmp).items():
            frames = jax_bpa.main(parity.burgers_pre_apply_argv(os.path.join(tmp, label), inputs,
                                                                model, stats, arch))
            for k in ("u", "v"):
                out[f"{label}_{k}"] = np.asarray(frames[k])[steps, 0]
    return out


PRE_TRAIN_NETS = (("karman", "mars_moon"), ("burgers", "jupiter_moon"))


def _epoch_params(opath: str, epoch: int, arch: str, in_channels: int) -> dict:
    tree = read_msgpack(os.path.join(opath, f"model_epoch{epoch:04d}.msgpack"))
    model = build_model(arch, in_channels=in_channels)
    return {n: t.numpy() for n, t in params_from_jax(tree["params"]["params"], arch,
                                                     model).items()}


def _capture_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def make_pretf_step():
    """The JAX package's SOL-32 parity step (parity.train_parity_inputs) from
    the --pretf net artifacts/k_pre_train with the normalisation karman-train
    adopts from it, as parity.parity_summary lays it out."""
    data, idx, stats = parity.train_parity_inputs()
    with open(os.path.join(parity.KARMAN_PRE_CKPT, "stats.json")) as f:
        pre = json.load(f)
    dom = jk.karman_domain(32)
    flow = jk.KarmanFlow(dom, advection="shift", max_shift=2)
    model = jax_build_model("mars_moon", leaky_slope=pre["leaky_alpha"])
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((len(idx), dom.ny, dom.nx, 3)))
    params, _ = jax_ckpt.load_checkpoint(os.path.join(parity.KARMAN_PRE_CKPT, "model.msgpack"),
                                         params)
    cfg = jtrainer.SolTrainConfig(msteps=parity.PARITY_MSTEPS, batch_size=len(idx),
                                  clip_grad=True)
    capture = _capture_grads()
    step = jtrainer.make_karman_train_step(flow, model.apply, capture, cfg)
    norm = JNormalization(jnp.asarray([pre["in.std"][0], pre["in.std"][1], stats["ext.std"]],
                                      jnp.float32), jnp.asarray(pre["out.std"][:2], jnp.float32))
    _, grads, loss, step_losses = step(params, capture.init(params),
                                       {k: jnp.asarray(a) for k, a in data.items()}, norm,
                                       jnp.asarray(idx, jnp.int32))
    port = build_model("mars_moon")
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads["params"]), "mars_moon",
                            port)
    names = list(port.state_dict())
    return {"pretf_loss": np.float64(loss), "pretf_step_losses": np.asarray(step_losses),
            "pretf_grad_names": np.asarray(names),
            "pretf_grad_norms": np.asarray([float(grads[n].norm()) for n in names]),
            "pretf_head_weight_grad": grads["head.weight"].numpy()}


def make_pre_train_golden():
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for scenario, arch in PRE_TRAIN_NETS:
            pats = parity.write_pre_set(os.path.join(tmp, f"{scenario}_set"), scenario)
            opath = os.path.join(tmp, f"{scenario}_tf")
            parity.write_pre_start(opath, scenario, arch)
            jax_pt.main(["-o", opath, "--model", arch, *parity.PRE_TRAIN_ARGV, *pats],
                        scenario=scenario)
            params = _epoch_params(opath, 3, arch, 3 if scenario == "karman" else 4)
            with open(os.path.join(opath, "metrics.jsonl")) as f:
                losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
            with open(os.path.join(opath, "stats.json")) as f:
                out[f"{scenario}_stats"] = np.asarray(f.read())
            out[f"{scenario}_losses"] = np.asarray(losses)
            out.update({f"{scenario}_leaf_{n}": p for n, p in params.items()})
    out.update(make_pretf_step())
    return out


# ---------------------------------------------------------------------------
# the port's CPU runs held to the goldens (the card's phases check the same)
# ---------------------------------------------------------------------------

def test_port_karman_pre_gen_matches_golden(tmp_path):
    """karman-pre-gen --beta 1.0 at full width on the CPU (multigrid at
    256x128, the PCG twin at 64x32): the golden frames within
    ROLLOUT_REL_TOL of each field's max."""
    beta = parity.PRE_BETAS[0]
    res = torch_cli.main(["karman-pre-gen", *karman_pre_gen_argv(str(tmp_path), beta),
                          "--device", "cpu"])
    got = _frames(res["scene"], parity.PRE_LO_NAMES, parity.PRE_GOLDEN_FRAMES, f"b{beta}_")
    got.update(_frames(res["scene"], parity.PRE_HI_NAMES, parity.PRE_GOLDEN_FRAMES[-1:]))
    with np.load(parity.KARMAN_PRE_GEN_GOLDEN) as g:
        errors = {k: _rel(v, g[k]) for k, v in got.items()}
    assert max(errors.values()) <= parity.ROLLOUT_REL_TOL, errors


def test_port_burgers_pre_gen_matches_golden(tmp_path):
    """burgers-pre-gen on the port's own test sim (burgers-gen seed 100):
    the golden frames within ROLLOUT_REL_TOL."""
    torch_cli.main(["burgers-gen", "-o", str(tmp_path / "hires"), *parity.BURGERS_GEN_ARGV,
                    "-t", str(parity.BURGERS_PRE_FRAMES), "--device", "cpu"])
    res = torch_cli.main(["burgers-pre-gen", *burgers_pre_gen_argv(
        str(tmp_path / "pre"), str(tmp_path / "hires" / "sim_000000")), "--device", "cpu"])
    got = _frames(res["scene"], parity.BURGERS_PRE_NAMES, parity.BURGERS_PRE_GOLDEN_FRAMES)
    got.update(_frames(res["scene"], ("veloH",), parity.BURGERS_PRE_GOLDEN_FRAMES[-1:]))
    with np.load(parity.BURGERS_PRE_GEN_GOLDEN) as g:
        errors = {k: _rel(v, g[k]) for k, v in got.items()}
    assert max(errors.values()) <= parity.ROLLOUT_REL_TOL, errors


@pytest.mark.parametrize("conv", ["library", "kernel"])
def test_port_pre_apply_matches_golden(tmp_path, conv):
    with np.load(parity.PRE_APPLY_GOLDEN) as g:
        golden = {k: g[k] for k in g.files}
    for label, ckpt_dir in (("k_pre", parity.KARMAN_PRE_CKPT),
                            ("k_presr", parity.KARMAN_PRESR_CKPT)):
        frames = torch_cli.main(["karman-pre-apply", *parity.karman_pre_apply_argv(
            str(tmp_path / label), ckpt_dir), "--conv", conv, "--device", "cpu"])
        for k in ("dens", "u", "v"):
            for i, step in enumerate(parity.PRE_APPLY_GOLDEN_STEPS):
                assert _rel(frames[k][step - 1, 0], golden[f"{label}_{k}"][i]) \
                    <= parity.ROLLOUT_REL_TOL, (label, k, step)
    inputs = parity.burgers_apply_inputs(str(tmp_path / "inputs"))
    for label, (model, stats, arch) in burgers_pre_nets(str(tmp_path)).items():
        frames = torch_cli.main(["burgers-pre-apply", *parity.burgers_pre_apply_argv(
            str(tmp_path / label), inputs, model, stats, arch), "--conv", conv,
            "--device", "cpu"])
        for k in ("u", "v"):
            for i, step in enumerate(parity.PRE_APPLY_GOLDEN_STEPS):
                assert _rel(frames[k][step - 1, 0], golden[f"{label}_{k}"][i]) \
                    <= parity.ROLLOUT_REL_TOL, (label, k, step)


@pytest.mark.parametrize("scenario,arch", PRE_TRAIN_NETS)
def test_port_pre_train_matches_golden(tmp_path, scenario, arch):
    """Two epochs of the port's pre-trainer from the seeded start on the
    golden frames: losses within PRE_LOSS_REL_TOL, every parameter within
    PRE_TRAIN_REL_TOL in norm, stats.json key for key."""
    pats = parity.write_pre_set(str(tmp_path / "set"), scenario)
    opath = str(tmp_path / "tf")
    parity.write_pre_start(opath, scenario, arch)
    res = torch_cli.main([f"{scenario}-pre-train", "-o", opath, "--model", arch,
                          *parity.PRE_TRAIN_ARGV, *pats, "--device", "cpu"])
    want = parity.pre_train_golden(scenario)
    assert _rel(res["losses"], want["losses"]) <= parity.PRE_LOSS_REL_TOL
    got = {n: p.detach().numpy() for n, p in res["model"].state_dict().items()}
    assert set(got) == set(want["leaves"])
    errors = parity.leaf_errors(got, want["leaves"])
    assert max(errors.values()) <= parity.PRE_TRAIN_REL_TOL, errors
    assert res["stats"] == want["stats"]


def test_port_pretf_step_matches_golden():
    summary = parity.parity_summary(parity.parity_step(torch.device("cpu"),
                                                       pretf=parity.KARMAN_PRE_CKPT))
    errors = parity.parity_errors(summary, parity.train_golden_summary(
        parity.PRE_TRAIN_GOLDEN, prefix="pretf_"))
    for key, tol in parity.TRAIN_PARITY_TOL.items():
        assert errors[key] <= tol, (key, errors)


if __name__ == "__main__":
    os.makedirs(parity.DATA, exist_ok=True)
    for path, make in ((parity.KARMAN_PRE_GEN_GOLDEN, make_karman_pre_gen_golden),
                       (parity.BURGERS_PRE_GEN_GOLDEN, make_burgers_pre_gen_golden),
                       (parity.PRE_APPLY_GOLDEN, make_pre_apply_golden),
                       (parity.PRE_TRAIN_GOLDEN, make_pre_train_golden)):
        if sys.argv[1:] and os.path.basename(path) not in sys.argv[1:]:
            continue
        np.savez_compressed(path, **make())
        print(f"wrote {path}", file=sys.stderr)
