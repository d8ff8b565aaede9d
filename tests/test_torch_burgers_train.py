"""Burgers SOL training in the PyTorch port against the JAX package (CPU), the
remat policy's treatment of the fused conv, the burgers-train CLI, and the
karman paths under the "kernel" conv implementation.

One train step (MarsMoon 32x5 from a fresh glorot draw carried into the JAX
package, batch 2, msteps 3, 16x16, numpy data) under every remat policy and
both conv implementations against JAX's `make_burgers_train_step`: the same
float32 formulas, so the loss and step losses agree to 1e-5 and the
gradient norms, sums over all rows and steps in another order, to 1e-4.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from solver_in_the_loop_tpu.models.features import Normalization as JNormalization
from solver_in_the_loop_tpu.models.networks import build_model as jax_build_model
from solver_in_the_loop_tpu.physics import burgers as jb
from solver_in_the_loop_tpu.train import trainer as jtrainer

import torch_dist_ranks as ranks

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.kernels import conv as kconv
from solver_in_the_loop_torch.models.features import Normalization
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.physics import burgers as tb
from solver_in_the_loop_torch.physics.karman import KarmanFlow, karman_domain
from solver_in_the_loop_torch.train import trainer
from solver_in_the_loop_torch.train.checkpoint import params_from_jax, params_to_jax

torch.set_num_threads(2)

RES, ROWS, MSTEPS = 16, 2, 3
SCALES = [0.4, 0.38, 0.16, 0.15]


def _data():
    rng = np.random.RandomState(11)
    frames = MSTEPS + 2
    data = {"u": rng.randn(2, frames, RES, RES + 1), "v": rng.randn(2, frames, RES + 1, RES),
            "fu": 0.15 * rng.randn(2, frames, RES, RES + 1),
            "fv": 0.15 * rng.randn(2, frames, RES + 1, RES)}
    data = {k: (0.5 * a).astype(np.float32) for k, a in data.items()}
    idx = np.asarray([[0, 1], [1, 0]], np.int64)
    return data, idx


def _port_model(in_channels, conv="library"):
    return build_model("mars_moon", in_channels=in_channels, init="reference",
                       generator=torch.Generator().manual_seed(3), conv=conv)


@functools.lru_cache(maxsize=None)
def jax_step(use_force: bool):
    """JAX's loss, step losses and per-parameter gradient norms (port names)."""
    data, idx = _data()
    in_ch = 4 if use_force else 2
    port = _port_model(in_ch)
    dom = jb.burgers_domain(RES)
    flow = jb.BurgersFlow(dom, advection="shift", max_shift=2)
    model = jax_build_model("mars_moon", leaky_slope=0.3)
    params = {"params": params_to_jax(port, "mars_moon")}
    cfg = jtrainer.SolTrainConfig(msteps=MSTEPS, batch_size=ROWS, clip_grad=True, dt=0.1)
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step = jtrainer.make_burgers_train_step(flow, model.apply, capture, cfg, use_force=use_force)
    norm = (JNormalization.burgers(*SCALES) if use_force
            else JNormalization(jnp.asarray(SCALES[:2]), jnp.asarray(SCALES[:2])))
    _, grads, loss, step_losses = step(params, capture.init(params),
                                       {k: jnp.asarray(a) for k, a in data.items()}, norm,
                                       jnp.asarray(idx, jnp.int32))
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads["params"]), "mars_moon",
                            port)
    return float(loss), np.asarray(step_losses), {n: float(g.norm()) for n, g in grads.items()}


def port_step(use_force=True, conv="library", remat=True, policy="pressure+conv"):
    """The port's loss, step losses and raw gradient norms of the same step."""
    data, idx = _data()
    model = _port_model(4 if use_force else 2, conv)
    flow = tb.BurgersFlow(tb.burgers_domain(RES), advection="shift", max_shift=2)
    norm = (Normalization.burgers(*SCALES) if use_force
            else Normalization(torch.tensor(SCALES[:2]), torch.tensor(SCALES[:2])))
    cfg = trainer.SolTrainConfig(msteps=MSTEPS, clip_grad=True, remat=remat, remat_policy=policy)
    loss, step_losses = trainer.burgers_loss(
        flow, model, norm, {k: torch.from_numpy(a) for k, a in data.items()},
        torch.from_numpy(idx), cfg, dt=0.1, use_force=use_force)
    loss.backward()
    return loss.item(), step_losses.detach().numpy(), {n: float(p.grad.norm())
                                                       for n, p in model.named_parameters()}


def test_train_step_updates_every_parameter():
    data, idx = _data()
    model = _port_model(4, "kernel")
    flow = tb.BurgersFlow(tb.burgers_domain(RES), advection="shift", max_shift=2)
    cfg = trainer.SolTrainConfig(msteps=MSTEPS, clip_grad=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    train_step = trainer.make_burgers_train_step(flow, model, trainer.make_optimizer(model, cfg),
                                                 cfg, dt=0.1)
    loss, step_losses, iters, applied = train_step(
        {k: torch.from_numpy(a) for k, a in data.items()}, Normalization.burgers(*SCALES),
        torch.from_numpy(idx))
    np.testing.assert_allclose(float(loss), jax_step(True)[0], rtol=1e-5)
    assert iters is None and applied and step_losses.shape == (MSTEPS,)
    assert all(not torch.equal(p, before[n]) for n, p in model.named_parameters())


def _compare(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    for name, norm in want[2].items():
        np.testing.assert_allclose(got[2][name], norm, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("conv", ["library", "kernel"])
@pytest.mark.parametrize("remat,policy", [(False, "pressure+conv"), (True, "pressure"),
                                          (True, "pressure+conv"), (True, "pressure+advect")])
def test_train_step_matches_jax(conv, remat, policy):
    _compare(port_step(conv=conv, remat=remat, policy=policy), jax_step(True))


def test_noforce_train_step_matches_jax():
    _compare(port_step(use_force=False, conv="kernel"), jax_step(False))


@pytest.mark.parametrize("policy,recomputed", [("pressure+conv", 0), ("pressure", 12 * MSTEPS)])
def test_remat_policy_saves_the_fused_conv(monkeypatch, policy, recomputed):
    """Under pressure+conv no silt::conv re-runs in the backward pass: the
    backward launches only the input gradients (every conv but the step-0
    stem, whose input is data) and one weight gradient per conv; under
    `pressure` every conv of the unroll runs again."""
    calls = {"forward": 0, "dgrad": 0, "wgrad": 0}

    def fwd(*args, flip=False, **kw):
        calls["dgrad" if flip else "forward"] += 1
        return kconv.conv_fwd_plain(*args, flip=flip, **kw)

    def wgrad(*args):
        calls["wgrad"] += 1
        return kconv.conv_wgrad_plain(*args)

    monkeypatch.setattr(kconv, "conv_fwd", fwd)
    monkeypatch.setattr(kconv, "conv_wgrad", wgrad)
    data, idx = _data()
    model = _port_model(4, "kernel")
    flow = tb.BurgersFlow(tb.burgers_domain(RES), advection="shift", max_shift=2)
    cfg = trainer.SolTrainConfig(msteps=MSTEPS, remat_policy=policy)
    loss, _ = trainer.burgers_loss(flow, model, Normalization.burgers(*SCALES),
                                   {k: torch.from_numpy(a) for k, a in data.items()},
                                   torch.from_numpy(idx), cfg)
    convs = 12 * MSTEPS
    assert calls == {"forward": convs, "dgrad": 0, "wgrad": 0}
    loss.backward()
    assert calls == {"forward": convs + recomputed, "dgrad": convs - 1, "wgrad": convs}


def _gen_set(root, sims=2):
    for seed in range(sims):
        torch_cli.main(["burgers-gen", "-o", str(root), "-r", "32", "-t", "8", "--seed", str(seed),
                        "--device", "cpu"])


def test_train_cli_end_to_end(tmp_path):
    """burgers-train on the CPU through the kernel path's twins: checkpoints
    in the JAX package's format that the port's burgers-apply reads."""
    _gen_set(tmp_path / "hires")
    tf = tmp_path / "tf"
    result = torch_cli.main(["burgers-train", "--train", str(tmp_path / "hires"), "-n", "2",
                             "-b", "1", "-t", "8", "-m", "2", "-e", "1", "--lr", "1e-4",
                             "--tf", str(tf), "--conv", "kernel", "--device", "cpu"])
    assert len(result.losses) == 2 * (8 - 2) and np.all(np.isfinite(result.losses))
    assert result.cg_iters == []
    assert {"dataStats.json", "model.msgpack", "model_epoch0001.msgpack"} <= set(os.listdir(tf))
    sim = tmp_path / "hires" / "sim_000000"
    frames = torch_cli.main(["burgers-apply", "-o", str(tmp_path / "out"),
                             "--model", str(tf / "model.msgpack"),
                             "--stats", str(tf / "dataStats.json"),
                             "--initvH", str(sim / "velo_000000.npz"),
                             "--loadfH", str(sim / "forc_0*.npz"), "-t", "4", "--device", "cpu"])
    assert bool(torch.isfinite(frames["u"]).all())


@pytest.mark.parametrize("batch", ["2", "1"])
def test_train_cli_dp_on_two_ranks(tmp_path, batch):
    """`burgers-train --dp --conv kernel --device cpu` on 2 ranks of a
    launcher's environment (tests/torch_dist_ranks.py), one row each or
    (-b 1) a batch padded with a zero-weighted row: the losses of the run
    without --dp within rtol 1e-4 (sums in another order), the same on both
    ranks, and only rank 0 writes dataStats.json, the checkpoints and the
    metrics."""
    _gen_set(tmp_path / "hires")
    args = ["--train", str(tmp_path / "hires"), "-n", "2", "-b", batch, "-t", "5", "-m", "2",
            "-e", "1", "--lr", "1e-4", "--conv", "kernel", "--device", "cpu"]
    want = torch_cli.main(["burgers-train", *args, "--tf", str(tmp_path / "plain")])
    got = ranks.spawn(ranks.cli_rank, 2,
                      ["burgers-train", *args, "--tf", str(tmp_path / "tf"), "--dp"])
    assert got[0]["losses"] == got[1]["losses"] and len(want.losses) == 3 * (2 // int(batch))
    np.testing.assert_allclose(got[0]["losses"], want.losses, rtol=1e-4)
    assert sorted(got[0]["writes"]) == ["checkpoint", "checkpoint", "metrics", "stats"]
    assert got[1]["writes"] == []
    assert {"dataStats.json", "model.msgpack", "model_epoch0001.msgpack"} <= set(
        os.listdir(tmp_path / "tf"))


def test_karman_step_with_kernel_convs_matches_library():
    """One karman train step's loss and gradients with the nets' convs in the
    fused op ("kernel") against the same weights in nn.Conv2d ("library")."""
    dom = karman_domain(8)
    flow = KarmanFlow(dom, advection="shift", max_shift=2)
    rng = np.random.RandomState(2)
    data = {"dens": rng.rand(2, 5, dom.ny, dom.nx), "u": 0.3 * rng.randn(2, 5, dom.ny, dom.nx + 1),
            "v": 1.0 + 0.3 * rng.randn(2, 5, dom.ny + 1, dom.nx),
            "re": np.asarray([240000.0, 480000.0])}
    data = {k: torch.from_numpy(np.asarray(a, np.float32)) for k, a in data.items()}
    idx = torch.tensor([[0, 0], [1, 1]])
    norm = Normalization.karman(0.3, 0.3, 1e5)
    cfg = trainer.SolTrainConfig(msteps=3)
    results = []
    for conv in ("library", "kernel"):
        model = build_model("mars_moon", init="reference",
                            generator=torch.Generator().manual_seed(0), conv=conv)
        loss, step_losses, _ = trainer.karman_loss(flow, model, norm, data, idx, cfg)
        loss.backward()
        results.append((loss.item(), step_losses.detach(),
                        {n: p.grad for n, p in model.named_parameters()}))
    (l_lib, s_lib, g_lib), (l_ker, s_ker, g_ker) = results
    np.testing.assert_allclose(l_ker, l_lib, rtol=1e-5)
    torch.testing.assert_close(s_ker, s_lib, rtol=1e-5, atol=0)
    for name, g in g_lib.items():
        assert float((g_ker[name] - g).norm() / g.norm()) <= 1e-4, name


def test_karman_apply_cli_with_kernel_convs(tmp_path):
    ckpt = parity.CKPT
    args = ["--model", os.path.join(ckpt, "model.msgpack"), "--stats",
            os.path.join(ckpt, "dataStats.json"), "-r", "8", "-t", "4", "--re", "240000",
            "--device", "cpu"]
    lib = torch_cli.main(["karman-apply", "-o", str(tmp_path / "lib"), *args])
    ker = torch_cli.main(["karman-apply", "-o", str(tmp_path / "ker"), *args, "--conv", "kernel"])
    for key in ("dens", "u", "v"):
        assert float((ker[key] - lib[key]).abs().max() / lib[key].abs().max()) <= 1e-4, key
