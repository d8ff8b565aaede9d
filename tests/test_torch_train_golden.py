"""The JAX golden of chip_smoke.py's `train_parity` phase, and the port's
CPU train step held to it; the training set of chip_smoke.py's `train`
phase, and the JAX record of its first batch, which the port's CPU step is
held to.

One SOL-32 train step at full width (MarsMoon 32x5 with the trained
artifacts/a3_k_sol32 weights, batch 3, msteps 32, 64x32, remat
pressure+conv, CG tol 1e-5) on the inputs of `parity.train_parity_inputs`
(numpy only). The golden file holds the JAX package's loss, its 32 step
losses, the norm of every parameter's gradient and the head conv's whole
gradient. Regenerate the three files with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_golden.py

(~5 min). The card's step is held to the golden by chip_smoke.py with the
tolerances of solver_in_the_loop_torch/parity.py; this test holds the port's
CPU step (the kernels' plain twins) to the same tolerances.

The `train` phase trains a fresh glorot-initialised net (`--init
reference`, `--seed parity.TRAIN_SEED`) on parity.TRAIN_SET: the first 40
frames of the Makefile's hi-res training set, made by the JAX package's
karman-gen and loader. The record holds the JAX package's loss, step
losses and gradient norms for the first batch of that run with the port's
initial weights, and, for the choice of the seed, the port's first loss of
`--seed s` for s = 0..7 and the first loss of the JAX package's own seed-0
draw (carried into the port) on the seed-0 batch.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from solver_in_the_loop_tpu.apps import karman_gen as jax_gen
from solver_in_the_loop_tpu.models.features import Normalization as JNormalization
from solver_in_the_loop_tpu.models.networks import build_model as jax_build_model
from solver_in_the_loop_tpu.physics import karman as jk
from solver_in_the_loop_tpu.train import checkpoint as jax_ckpt
from solver_in_the_loop_tpu.train import dataset as jdataset
from solver_in_the_loop_tpu.train import trainer as jtrainer

from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
from solver_in_the_loop_torch.train import trainer
from solver_in_the_loop_torch.train.checkpoint import params_from_jax, params_to_jax
from solver_in_the_loop_torch.train.dataset import EpochSchedule
from solver_in_the_loop_torch.utils.stats import abs_std

GOLDEN = Path(parity.TRAIN_GOLDEN)
TRAIN_SET = Path(parity.TRAIN_SET)
FIXTURE_RECORD = GOLDEN.parent / "karman_train_fixture_first_batch.json"
HIRES_RE = [160000, 320000, 640000, 1280000, 2560000, 5120000]  # Makefile:36-38
REAL_STATS = Path(parity.CKPT) / "dataStats.json"  # of the whole set, 500 frames per sim


def _capture_grads():
    """An optimizer whose state after `update` is the gradient itself."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def make_train_golden():
    """The JAX package's parity step, as parity.parity_summary lays it out."""
    data, idx, stats = parity.train_parity_inputs()
    dom = jk.karman_domain(32)
    flow = jk.KarmanFlow(dom, advection="shift", max_shift=2)
    model = jax_build_model("mars_moon", leaky_slope=stats["leaky_alpha"])
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((len(idx), dom.ny, dom.nx, 3)))
    params, _ = jax_ckpt.load_checkpoint(str(Path(parity.CKPT) / "model.msgpack"), params)
    cfg = jtrainer.SolTrainConfig(msteps=parity.PARITY_MSTEPS, batch_size=len(idx),
                                  clip_grad=True)
    capture = _capture_grads()
    step = jtrainer.make_karman_train_step(flow, model.apply, capture, cfg)
    norm = JNormalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"])
    _, grads, loss, step_losses = step(params, capture.init(params),
                                       {k: jnp.asarray(a) for k, a in data.items()}, norm,
                                       jnp.asarray(idx, jnp.int32))
    port = build_model("mars_moon")
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads["params"]), "mars_moon",
                            port)
    names = list(port.state_dict())
    return {"loss": np.float64(loss), "step_losses": np.asarray(step_losses),
            "grad_names": np.asarray(names),
            "grad_norms": np.asarray([float(grads[n].norm()) for n in names]),
            "head_weight_grad": grads["head.weight"].numpy()}


def make_train_set():
    """The first 40 frames of karman-fdt-hires-set: the Makefile's karman-gen
    command with -t 1040 (frames 1000..1039 after its 999 warm-up steps),
    then the JAX loader's 4x downsampling to 64x32."""
    with tempfile.TemporaryDirectory() as tmp:
        jax_gen.main(["-o", tmp, "-r", "128", "-l", "100", "--seed", "0", "-t", "1040",
                      "--re", *[str(r) for r in HIRES_RE]])
        ds = jdataset.load_karman_dataset(tmp, num_frames=40, num_sims=len(HIRES_RE))
    return {k: np.asarray(getattr(ds, k), np.float32) for k in ("dens", "u", "v", "re")}


def _norm(data, cls):
    return cls.karman(abs_std(data["v"]), abs_std(data["u"]), float(np.std(np.abs(data["re"]))))


def first_batch(seed):
    """The first batch and the reference init of `karman-train --seed seed` on
    the training set."""
    idx = EpochSchedule(len(HIRES_RE), 40, 3, seed=seed).epoch_indices(32)[0]
    model = build_model("mars_moon", init="reference",
                        generator=torch.Generator().manual_seed(seed))
    return idx, model


def port_first_batch(data, idx, model):
    """The port's (CPU) loss and step losses of one batch; gradients with
    model.parameters() requiring them."""
    flow = KarmanFlow(karman_domain(32), advection="shift", max_shift=2)
    cfg = trainer.SolTrainConfig(msteps=32, clip_grad=True)
    loss, step_losses, _ = trainer.karman_loss(
        flow, model, _norm(data, Normalization), {k: torch.from_numpy(a) for k, a in data.items()},
        torch.from_numpy(idx.astype(np.int64)), cfg)
    return loss, step_losses


def make_fixture_record():
    """The JAX package's loss, step losses and gradient norms on the first
    batch of chip_smoke's training run, and the first losses that chose its
    seed."""
    data = parity.train_set()
    idx, model = first_batch(parity.TRAIN_SEED)
    dom = jk.karman_domain(32)
    flow = jk.KarmanFlow(dom, advection="shift", max_shift=2)
    jmodel = jax_build_model("mars_moon", init="reference", leaky_slope=0.3)
    params = {"params": params_to_jax(model, "mars_moon")}
    cfg = jtrainer.SolTrainConfig(msteps=32, batch_size=3, clip_grad=True)
    capture = _capture_grads()
    step = jtrainer.make_karman_train_step(flow, jmodel.apply, capture, cfg)
    _, grads, loss, step_losses = step(params, capture.init(params),
                                       {k: jnp.asarray(a) for k, a in data.items()},
                                       _norm(data, JNormalization), jnp.asarray(idx))
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads["params"]), "mars_moon",
                            model)
    record = {"loss": float(loss), "step_losses": np.asarray(step_losses).tolist(),
              "grad_norms": {n: float(g.norm()) for n, g in grads.items()}}
    with torch.no_grad():
        record["first_loss_by_seed"] = [float(port_first_batch(data, *first_batch(s))[0])
                                        for s in range(8)]
        jax_key0 = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((3, dom.ny, dom.nx, 3)))
        port = build_model("mars_moon")
        port.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jax_key0["params"]), "mars_moon", port))
        record["jax_seed0_draw_first_loss"] = float(
            port_first_batch(data, first_batch(0)[0], port)[0])
    return record


def test_port_cpu_train_step_matches_golden():
    torch.set_num_threads(4)
    summary = parity.parity_summary(parity.parity_step(torch.device("cpu")))
    errors = parity.parity_errors(summary, parity.train_golden_summary())
    for key, tol in parity.TRAIN_PARITY_TOL.items():
        assert errors[key] <= tol, (key, errors)


def test_train_set_statistics_match_the_whole_set():
    """The 40 frames stand in for the 500 of the Makefile's set: their
    normalization statistics are within 10 % of those the JAX package's real
    SOL-32 run computed over all of them, and the Re are the set's."""
    data = parity.train_set()
    want = json.loads(REAL_STATS.read_text())
    assert data["dens"].shape == (6, 40, 64, 32) and data["re"].tolist() == HIRES_RE
    for key, field in (("std.dens", "dens"), ("std.v", "v"), ("std.u", "u")):
        np.testing.assert_allclose(abs_std(data[field]), want[key], rtol=0.1)
    np.testing.assert_allclose(float(np.std(data["re"])), want["ext.std"], rtol=1e-6)


def test_port_fixture_first_batch_matches_jax_record():
    """The first batch of chip_smoke's training run: finite gradients, and
    the loss, step losses and gradient norms of the JAX package. Tolerances
    as parity.TRAIN_PARITY_TOL: 32 steps of CG solves to 1e-5 on both sides."""
    torch.set_num_threads(4)
    with open(FIXTURE_RECORD) as f:
        want = json.load(f)
    idx, model = first_batch(parity.TRAIN_SEED)
    loss, step_losses = port_first_batch(parity.train_set(), idx, model)
    loss.backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    tol = parity.TRAIN_PARITY_TOL
    np.testing.assert_allclose(step_losses.detach().numpy(), want["step_losses"],
                               rtol=tol["step_losses"])
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=tol["loss"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(float(p.grad.norm()), want["grad_norms"][name],
                                   rtol=tol["grad_norms"], err_msg=name)
    # the seed's draw is the stable one of the record's eight
    assert want["first_loss_by_seed"][parity.TRAIN_SEED] == min(want["first_loss_by_seed"])


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(TRAIN_SET, **make_train_set())
    print(f"wrote {TRAIN_SET}", file=sys.stderr)
    np.savez_compressed(GOLDEN, **make_train_golden())
    print(f"wrote {GOLDEN}", file=sys.stderr)
    with open(FIXTURE_RECORD, "w") as f:
        json.dump(make_fixture_record(), f, indent=1)
    print(f"wrote {FIXTURE_RECORD}", file=sys.stderr)
