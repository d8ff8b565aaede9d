"""The JAX goldens of chip_smoke.py's Burgers phases, and the port's CPU runs
held to them.

* `burgers_apply_sol04_r32.npz`: hi-res frame 0 of the Makefile's test sim
  (`burgers-gen --seed 100 -r 128 -l 32 --dt 0.1 -s 30`, legacy layout), its
  first 20 forces 4x downsampled by the JAX loader's downsampling (legacy
  layout, 32x32), and the JAX package's 20 `burgers-apply` frames from those
  inputs with the trained SOL-04 checkpoint (artifacts/a3_b_sol04, -d 4 -r 32).
* `burgers_train_step_sol04.npz`: one SOL-04 train step at full width (MarsMoon
  32x5 with the trained weights, batch 5, msteps 4, 32x32, remat
  pressure+conv) on the inputs of `parity.burgers_train_parity_inputs`: the
  loss, the 4 step losses, every parameter's gradient norm and the head
  conv's gradient.
* `burgers_train_step_sol04_bf16.npz`: the same step with the net in
  bfloat16 (`--bf16`) and its convs in the JAX Pallas conv (interpret mode),
  the path the port's `--bf16 --conv kernel` takes.

Regenerate all three with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_burgers_golden.py

(~1 min). The tolerances are those of solver_in_the_loop_torch/parity.py,
which chip_smoke.py holds the card to.
"""

from __future__ import annotations

import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from solver_in_the_loop_tpu.apps import burgers_apply as jax_apply
from solver_in_the_loop_tpu.apps import burgers_gen as jax_gen
from solver_in_the_loop_tpu.core.resample import downsample_staggered as jax_downsample
from solver_in_the_loop_tpu.io import scene as jax_scene
from solver_in_the_loop_tpu.models.features import Normalization as JNormalization
from solver_in_the_loop_tpu.models.networks import build_model as jax_build_model
from solver_in_the_loop_tpu.ops.pallas import conv_kernel as ck
from solver_in_the_loop_tpu.physics import burgers as jb
from solver_in_the_loop_tpu.train import checkpoint as jax_ckpt
from solver_in_the_loop_tpu.train import trainer as jtrainer

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.io import scene as torch_scene
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.train.checkpoint import params_from_jax

torch.set_num_threads(2)

STEPS = parity.BURGERS_GOLDEN_STEPS
CKPT = parity.BURGERS_CKPT


def _capture_grads():
    """An optimizer whose state after `update` is the gradient itself."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def jax_gen_test_sim(out: str, simsteps: int) -> str:
    """The JAX package's burgers-gen of the Makefile's test sim seed 100,
    cut to `simsteps` frames; returns its scene directory."""
    jax_gen.main(["-o", out, *parity.BURGERS_GEN_ARGV, "-t", str(simsteps)])
    return os.path.join(out, "sim_000000")


def make_apply_golden():
    with tempfile.TemporaryDirectory() as tmp:
        sim = jax_gen_test_sim(os.path.join(tmp, "hires"), STEPS + 1)
        velo_hi = jax_scene.read_array(os.path.join(sim, "velo_000000.npz"))
        forces = []
        for t in range(STEPS):
            fu, fv = jax_scene.legacy_to_staggered(
                jax_scene.read_array(os.path.join(sim, f"forc_{t:06d}.npz")))
            fu, fv = jax_downsample(jnp.asarray(fu), jnp.asarray(fv), 4)
            forces.append(jax_scene.staggered_to_legacy(np.asarray(fu), np.asarray(fv)))
        frames = jax_apply.main([
            "-o", os.path.join(tmp, "apply"), "--model", os.path.join(CKPT, "model.msgpack"),
            "--stats", os.path.join(CKPT, "dataStats.json"),
            "--initvH", os.path.join(sim, "velo_000000.npz"),
            "--loadfH", os.path.join(sim, "forc_0*.npz"),
            "-d", "4", "-r", "32", "-l", "32", "--dt", str(parity.BURGERS_DT), "-t", str(STEPS + 1)])
    return {"velo_hi": np.asarray(velo_hi, np.float32), "forc_ds": np.stack(forces),
            "u": np.asarray(frames["u"])[:, 0], "v": np.asarray(frames["v"])[:, 0]}


def make_train_golden(bf16: bool = False):
    """The JAX package's Burgers parity step, as parity.parity_summary lays
    out the port's; with `bf16` the net computes in bfloat16 on the Pallas
    conv in interpret mode (the caller sets conv_kernel._INTERPRET)."""
    data, idx, stats = parity.burgers_train_parity_inputs()
    dom = jb.burgers_domain(32)
    flow = jb.BurgersFlow(dom, advection="shift", max_shift=2)
    model = jax_build_model("mars_moon", leaky_slope=stats["leaky_alpha"],
                            compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((len(idx), dom.ny, dom.nx, 4)))
    params, _ = jax_ckpt.load_checkpoint(os.path.join(CKPT, "model.msgpack"), params)
    cfg = jtrainer.SolTrainConfig(msteps=parity.BURGERS_PARITY_MSTEPS, batch_size=len(idx),
                                  clip_grad=True, dt=parity.BURGERS_DT)
    capture = _capture_grads()
    step = jtrainer.make_burgers_train_step(flow, model.apply, capture, cfg)
    norm = JNormalization.burgers(stats["std.v"], stats["std.u"], stats["std.fv"], stats["std.fu"])
    _, grads, loss, step_losses = step(params, capture.init(params),
                                       {k: jnp.asarray(a) for k, a in data.items()}, norm,
                                       jnp.asarray(idx, jnp.int32))
    port = build_model("mars_moon", in_channels=4)
    grads = params_from_jax(jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32),
                                                   grads["params"]), "mars_moon", port)
    names = list(port.state_dict())
    return {"loss": np.float64(loss), "step_losses": np.asarray(step_losses),
            "grad_names": np.asarray(names),
            "grad_norms": np.asarray([float(grads[n].norm()) for n in names]),
            "head_weight_grad": grads["head.weight"].numpy()}


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_apply_golden_inputs_match_fresh_jax_run(tmp_path):
    """The committed frame 0 and forces are what the JAX package generates
    today (up to last-bit differences between CPUs' float32 kernels)."""
    sim = jax_gen_test_sim(str(tmp_path), 2)
    with np.load(parity.BURGERS_APPLY_GOLDEN) as g:
        assert _rel(g["velo_hi"], jax_scene.read_array(os.path.join(sim, "velo_000000.npz"))) \
            <= 1e-5
        fu, fv = jax_scene.legacy_to_staggered(
            jax_scene.read_array(os.path.join(sim, "forc_000001.npz")))
        fu, fv = jax_downsample(jnp.asarray(fu), jnp.asarray(fv), 4)
        want = jax_scene.staggered_to_legacy(np.asarray(fu), np.asarray(fv))
        assert _rel(g["forc_ds"][1], want) <= 1e-5
        assert g["u"].shape == (STEPS, 32, 33) and g["v"].shape == (STEPS, 33, 32)


def test_port_gen_frame0_matches_golden(tmp_path):
    """The port's burgers-gen of the test sim on the CPU: frame 0 (after the
    30 skipped steps at 128x128) within BURGERS_GEN_REL_TOL of the JAX one."""
    torch_cli.main(["burgers-gen", "-o", str(tmp_path), *parity.BURGERS_GEN_ARGV, "-t", "1",
                    "--device", "cpu"])
    got = torch_scene.read_array(str(tmp_path / "sim_000000" / "velo_000000.npz"))
    with np.load(parity.BURGERS_APPLY_GOLDEN) as g:
        assert _rel(got, g["velo_hi"]) <= parity.BURGERS_GEN_REL_TOL


@pytest.mark.parametrize("conv", ["library", "kernel"])
def test_port_cli_on_golden_inputs_matches_golden(tmp_path, conv):
    """burgers-apply on the golden's inputs (the CLI path chip_smoke.py's
    burgers_parity runs): every field within ROLLOUT_REL_TOL at steps 1, 5, 20."""
    inputs = parity.burgers_apply_inputs(str(tmp_path / "inputs"))
    frames = torch_cli.main(["burgers-apply", *parity.burgers_apply_argv(
        str(tmp_path / "out"), inputs, conv), "--device", "cpu"])
    with np.load(parity.BURGERS_APPLY_GOLDEN) as g:
        for field in ("u", "v"):
            for step in (1, 5, STEPS):
                assert _rel(frames[field][step - 1, 0].numpy(), g[field][step - 1]) \
                    <= parity.ROLLOUT_REL_TOL, (field, step)


@pytest.mark.parametrize("conv", ["library", "kernel"])
def test_port_cpu_train_step_matches_golden(conv):
    summary = parity.parity_summary(parity.burgers_parity_step(torch.device("cpu"), conv))
    errors = parity.parity_errors(summary,
                                  parity.train_golden_summary(parity.BURGERS_TRAIN_GOLDEN))
    for key, tol in parity.TRAIN_PARITY_TOL.items():
        assert errors[key] <= tol, (key, errors)


if __name__ == "__main__":
    os.makedirs(parity.DATA, exist_ok=True)
    np.savez_compressed(parity.BURGERS_APPLY_GOLDEN, **make_apply_golden())
    print(f"wrote {parity.BURGERS_APPLY_GOLDEN}", file=sys.stderr)
    np.savez_compressed(parity.BURGERS_TRAIN_GOLDEN, **make_train_golden())
    print(f"wrote {parity.BURGERS_TRAIN_GOLDEN}", file=sys.stderr)
    ck._INTERPRET = True
    np.savez_compressed(parity.BURGERS_TRAIN_GOLDEN_BF16, **make_train_golden(bf16=True))
    print(f"wrote {parity.BURGERS_TRAIN_GOLDEN_BF16}", file=sys.stderr)
