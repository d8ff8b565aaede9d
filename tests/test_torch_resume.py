"""Resuming training across the two packages, and the trainers' flags, on the CPU.

* The optimizer state in the JAX package's epoch checkpoints
  (`apply_if_finite(chain(clip_by_leaf_norm, inject_hyperparams(adam)))` in
  flax's layout): a JAX state after a finite and a non-finite step loads into
  the port's GuardedAdam (train/checkpoint.py `opt_state_from_jax`), and one
  more step on each side gives the same moments (1e-5 of each tensor's
  max) and parameters (1e-5 of the step's size: optax and torch.optim.Adam
  write the same blend and update in other float32 operations, a few ulps
  apart) and the same guard counters; the port's epoch
  checkpoint loads in the JAX package's `load_epoch_checkpoint` with the JAX
  trainer's templates, with and without the clip.
* `--resume`, both families at a tiny size: a run stopped after epoch 10 and
  resumed with `--resume 10 --epochs 11` ends on the parameters of an
  uninterrupted 11-epoch run, bit for bit.
* `--inittf` starts from the file's parameters, `--profile` writes a trace
  that names the train step's phases (the program's `silt.train.*` spans)
  and keeps its step's update as the JAX CLI does (the same parameters from
  the same start, within 1e-3 of a step's size), `--reg-loss` changes
  nothing, `--debug-nans` raises FloatingPointError at a NaN and changes
  nothing on a finite run, `--bf16` trains (`--dp`:
  tests/test_torch_parallel.py and the CLI tests).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from solver_in_the_loop_tpu.apps import burgers_train as jax_burgers_train
from solver_in_the_loop_tpu.models.networks import build_model as jax_build_model
from solver_in_the_loop_tpu.train import checkpoint as jax_ckpt
from solver_in_the_loop_tpu.train import trainer as jtrainer

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch.io.scene import Scene
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.train import checkpoint as tckpt
from solver_in_the_loop_torch.train import trainer
from solver_in_the_loop_torch.utils import profiling

torch.set_num_threads(1)

LR = 1e-3


def _grads(params, seed, nan=False):
    """Gradients of the flax params' layout, from numpy; one NaN with `nan`."""
    rng = np.random.RandomState(seed)
    leaves, tree = jax.tree_util.tree_flatten(params)
    grads = [(0.01 * rng.randn(*np.shape(a))).astype(np.float32) for a in leaves]
    if nan:
        grads[0].flat[0] = np.nan
    return jax.tree_util.tree_unflatten(tree, grads)


def _port_step(model, optimizer, grads):
    """One GuardedAdam step on gradients given in the flax params' layout."""
    for name, g in tckpt.params_from_jax(grads["params"], "mars_moon", model).items():
        dict(model.named_parameters())[name].grad = g.clone()
    return optimizer.step()


def _jax_setup(clip=True):
    model = jax_build_model("mars_moon", init="reference")
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    opt = jtrainer.make_optimizer(jtrainer.SolTrainConfig(clip_grad=clip, lr=LR))
    return params, opt, opt.init(params)


def _port_setup(clip=True):
    model = build_model("mars_moon")
    optimizer = trainer.make_optimizer(model, trainer.SolTrainConfig(clip_grad=clip, lr=LR))
    return model, optimizer


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _moments(opt_state, clip=True):
    adam = opt_state.inner_state[1 if clip else 0].inner_state[0]
    return adam.count, adam.mu, adam.nu


def test_jax_optimizer_state_resumes_in_the_port(tmp_path):
    params, opt, state = _jax_setup()
    for seed, nan in ((1, False), (2, True)):  # a finite step, then a skipped one
        updates, state = opt.update(_grads(params, seed, nan), state, params)
        params = optax.apply_updates(params, updates)
    jax_ckpt.save_checkpoint(str(tmp_path), params, state, epoch=2)

    model, optimizer = _port_setup()
    assert tckpt.load_epoch_checkpoint(str(tmp_path), 2, model, "mars_moon", optimizer)
    assert (optimizer.notfinite_count, optimizer.last_finite, optimizer.total_notfinite) == \
        (1, False, 1)
    assert optimizer.adam.param_groups[0]["lr"] == pytest.approx(LR)

    g3 = _grads(params, 3)
    updates, state = opt.update(g3, state, params)
    params = optax.apply_updates(params, updates)
    assert _port_step(model, optimizer, g3)
    assert (optimizer.notfinite_count, optimizer.last_finite, optimizer.total_notfinite) == \
        (0, True, 1)
    count, mu, nu = _moments(state)
    names = dict(model.named_parameters())
    want = {k: tckpt.params_from_jax(t["params"], "mars_moon", model)
            for k, t in (("p", params), ("mu", mu), ("nu", nu))}
    for name, p in names.items():
        st = optimizer.adam.state[p]
        assert int(st["step"]) == int(count) == 2
        # the update is about lr: optax and torch write it with other float32
        # operations, a few ulps of it apart
        assert float((p.detach() - want["p"][name]).abs().max()) <= 1e-5 * LR, name
        assert _rel(st["exp_avg"], want["mu"][name]) <= 1e-5, name
        assert _rel(st["exp_avg_sq"], want["nu"][name]) <= 1e-5, name


@pytest.mark.parametrize("clip", [True, False])
def test_port_epoch_checkpoint_loads_in_jax(tmp_path, clip):
    model, optimizer = _port_setup(clip)
    params, opt, template = _jax_setup(clip)
    for seed, nan in ((4, False), (5, False), (6, True)):
        _port_step(model, optimizer, _grads(params, seed, nan))
    optimizer.set_learning_rate(0.5 * LR)
    path = tckpt.save_checkpoint(str(tmp_path), model, "mars_moon", optimizer, epoch=10)
    assert path.endswith("model_epoch0010.msgpack")

    got_params, got_state = jax_ckpt.load_epoch_checkpoint(str(tmp_path), 10, params, template)
    assert int(got_state.notfinite_count) == 1 and not bool(got_state.last_finite)
    assert int(got_state.total_notfinite) == 1
    inject = got_state.inner_state[1 if clip else 0]
    assert int(inject.count) == 2
    assert float(inject.hyperparams["learning_rate"]) == pytest.approx(0.5 * LR)
    count, mu, nu = _moments(got_state, clip)
    assert int(count) == 2
    for key, tree in (("p", got_params), ("mu", mu), ("nu", nu)):
        loaded = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, tree["params"]),
                                       "mars_moon", model)
        for name, p in model.named_parameters():
            st = optimizer.adam.state[p]
            mine = {"p": p.detach(), "mu": st["exp_avg"], "nu": st["exp_avg_sq"]}[key]
            assert torch.equal(loaded[name], mine), (key, name)
    # and the JAX state the loader returns steps on in JAX
    opt.update(_grads(params, 7), got_state, got_params)

    # back into the port: the same state
    again_model, again = _port_setup(clip)
    tckpt.load_epoch_checkpoint(str(tmp_path), 10, again_model, "mars_moon", again)
    assert again.total_notfinite == 1 and again.notfinite_count == 1 and not again.last_finite
    for (name, p), q in zip(model.named_parameters(), again_model.parameters()):
        assert torch.equal(p, q)
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(optimizer.adam.state[p][key], again.adam.state[q][key])


def test_optimizer_state_of_another_chain_is_refused(tmp_path):
    model, optimizer = _port_setup(clip=True)
    _port_step(model, optimizer, _grads(_jax_setup()[0], 8))
    tckpt.save_checkpoint(str(tmp_path), model, "mars_moon", optimizer, epoch=1)
    other_model, other = _port_setup(clip=False)
    with pytest.raises(ValueError, match="inner_state"):
        tckpt.load_epoch_checkpoint(str(tmp_path), 1, other_model, "mars_moon", other)


# ------------------------------------------------------------- the CLIs


def _karman_set(parent, sims=2, frames=4):
    """Hi-res (64x32) karman-like frames: 4x downsampled they are res 8."""
    rng = np.random.RandomState(21)
    for s in range(sims):
        sc = Scene.create(str(parent))
        sc.write_params({"re": 160000.0 * 2 ** s})
        for f in range(frames):
            sc.write_centered("dens", f, rng.rand(1, 64, 32).astype(np.float32))
            sc.write_staggered("velo", f, (0.2 * rng.randn(1, 64, 33)).astype(np.float32),
                               (1.0 + 0.2 * rng.randn(1, 65, 32)).astype(np.float32))


def _burgers_set(parent, sims=2):
    for seed in range(sims):
        torch_cli.main(["burgers-gen", "-o", str(parent), "-r", "32", "-t", "4", "--seed",
                        str(seed), "--device", "cpu"])


FAMILIES = {
    "karman": (_karman_set, ["-t", "4", "-m", "2", "-n", "2", "-b", "2", "--init", "zero"]),
    "burgers": (_burgers_set, ["-t", "4", "-m", "2", "-n", "2", "-b", "2"]),
}


def _train(family, data, tf, *extra):
    args = [f"{family}-train", "--train", str(data), "--tf", str(tf), "--lr", "1e-3",
            "--seed", "0", "--device", "cpu", *FAMILIES[family][1], *extra]
    return torch_cli.main(args)


def _params(path):
    return tckpt.read_msgpack(str(path))["params"]["params"]


def _equal_trees(a, b):
    flat_a, flat_b = tckpt._flatten(a), tckpt._flatten(b)
    return flat_a.keys() == flat_b.keys() and all(np.array_equal(flat_a[k], flat_b[k])
                                                  for k in flat_a)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_resume_ends_on_the_uninterrupted_parameters(tmp_path, family):
    FAMILIES[family][0](tmp_path / "hires")
    whole = _train(family, tmp_path / "hires", tmp_path / "whole", "-e", "11")
    _train(family, tmp_path / "hires", tmp_path / "cut", "-e", "10")
    assert (tmp_path / "cut" / "model_epoch0010.msgpack").is_file()
    stats = (tmp_path / "cut" / "dataStats.json").read_text()
    resumed = _train(family, tmp_path / "hires", tmp_path / "cut", "--resume", "10", "-e", "11")
    assert (tmp_path / "cut" / "dataStats.json").read_text() == stats
    assert len(resumed.losses) * 11 == len(whole.losses)
    assert resumed.losses == whole.losses[-len(resumed.losses):]
    assert _equal_trees(_params(tmp_path / "cut" / "model.msgpack"),
                        _params(tmp_path / "whole" / "model.msgpack"))
    opt = tckpt.read_msgpack(str(tmp_path / "whole" / "model_epoch0010.msgpack"))["opt_state"]
    assert int(opt["inner_state"]["1"]["inner_state"]["0"]["count"]) == len(whole.losses) * 10 // 11


def test_resume_takes_the_slope_of_the_stats(tmp_path):
    _burgers_set(tmp_path / "hires")
    _train("burgers", tmp_path / "hires", tmp_path / "tf", "-e", "1", "--leaky-alpha", "0.2")
    seen = []
    real = trainer.make_burgers_train_step

    def spy(flow, model, *args, **kwargs):
        seen.append(model.leaky_slope)
        return real(flow, model, *args, **kwargs)

    from solver_in_the_loop_torch.apps import burgers_train

    burgers_train.make_burgers_train_step = spy
    try:
        _train("burgers", tmp_path / "hires", tmp_path / "tf", "--resume", "1", "-e", "2")
    finally:
        burgers_train.make_burgers_train_step = real
    assert seen == [0.2]


def test_inittf_starts_from_the_file(tmp_path):
    _burgers_set(tmp_path / "hires")
    start = build_model("mars_moon", in_channels=4, init="reference",
                        generator=torch.Generator().manual_seed(9))
    path = tckpt.save_checkpoint(str(tmp_path / "init"), start, "mars_moon")
    _train("burgers", tmp_path / "hires", tmp_path / "tf", "-e", "0", "--inittf", path)
    assert _equal_trees(_params(tmp_path / "tf" / "model.msgpack"), _params(path))


def test_profile_keeps_its_step_as_the_jax_cli(tmp_path):
    """--profile from the same --inittf start and no epoch: one traced step on
    the pairs (0, 0), its update kept, on both sides."""
    _burgers_set(tmp_path / "hires")
    start = build_model("mars_moon", in_channels=4, init="reference",
                        generator=torch.Generator().manual_seed(9))
    init = tckpt.save_checkpoint(str(tmp_path / "init"), start, "mars_moon")
    common = ["--train", str(tmp_path / "hires"), "-t", "4", "-m", "2", "-n", "2", "-b", "2",
              "-e", "0", "--lr", "1e-3", "--inittf", init]
    _train("burgers", tmp_path / "hires", tmp_path / "port", "-e", "0", "--inittf", init,
           "--profile", str(tmp_path / "port_trace"))
    with pytest.raises(IndexError):
        # the JAX CLI's last log line reads the losses of a run without an
        # epoch, after it has written model.msgpack
        jax_burgers_train.main([*common, "--tf", str(tmp_path / "jax"),
                                "--profile", str(tmp_path / "jax_trace")])
    files = profiling.trace_files(str(tmp_path / "port_trace"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    # the operator reads the train step's phases off the trace
    for phase in ("forward", "backward", "recompute", "optimizer", "guard"):
        assert f"silt.train.{phase}" in names, phase
    assert {"silt.solver", "silt.net"} <= names
    got, want, before = (tckpt._flatten(_params(p)) for p in (
        tmp_path / "port" / "model.msgpack", tmp_path / "jax" / "model.msgpack", init))
    for key in want:
        assert not np.array_equal(want[key], before[key]), key  # the step was kept
        # Adam's first step is lr * g / (|g| + eps), about lr; a gradient
        # near eps passes the two sides' relative gradient difference into
        # its step, so they agree to 1e-3 of a step (a step from other
        # frames would differ by about lr)
        assert np.abs(got[key] - want[key]).max() <= 1e-3 * 1e-3, key


def test_reg_loss_changes_nothing(tmp_path):
    _karman_set(tmp_path / "hires")
    plain = _train("karman", tmp_path / "hires", tmp_path / "a", "-e", "1")
    reg = _train("karman", tmp_path / "hires", tmp_path / "b", "-e", "1", "--reg-loss")
    assert plain.losses == reg.losses
    assert _equal_trees(_params(tmp_path / "a" / "model.msgpack"),
                        _params(tmp_path / "b" / "model.msgpack"))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_debug_nans_raises_on_a_nan_weight(tmp_path, family):
    FAMILIES[family][0](tmp_path / "hires")
    model = build_model("mars_moon", in_channels=3 if family == "karman" else 4,
                        init="zero", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.weight[0, 0, 2, 2] = float("nan")
    path = tckpt.save_checkpoint(str(tmp_path / "init"), model, "mars_moon")
    with pytest.raises(FloatingPointError, match="NaN"):
        _train(family, tmp_path / "hires", tmp_path / "tf", "-e", "1", "--inittf", path,
               "--debug-nans")


def test_debug_nans_backward_check():
    """A NaN that appears only in the backward pass raises too: sqrt at 0
    times 0 is finite forward, and its gradient 0 / (2 sqrt(0)) is NaN."""
    cfg = trainer.SolTrainConfig(debug_nans=True)
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="backward"):
        with trainer._forward_context(cfg):
            loss = (torch.sqrt(x) * 0.0).sum()
        trainer._backward(loss, cfg)


def test_debug_nans_changes_nothing_on_a_finite_run(tmp_path):
    _burgers_set(tmp_path / "hires")
    plain = _train("burgers", tmp_path / "hires", tmp_path / "a", "-e", "1")
    checked = _train("burgers", tmp_path / "hires", tmp_path / "b", "-e", "1", "--debug-nans")
    assert plain.losses == checked.losses
    assert _equal_trees(_params(tmp_path / "a" / "model.msgpack"),
                        _params(tmp_path / "b" / "model.msgpack"))


@pytest.mark.parametrize("conv", ["library", "kernel"])
def test_bf16_training_runs(tmp_path, conv):
    _burgers_set(tmp_path / "hires")
    result = _train("burgers", tmp_path / "hires", tmp_path / "tf", "-e", "1", "--bf16",
                    "--conv", conv)
    assert len(result.losses) == 2 and np.isfinite(result.losses).all()
    params = tckpt._flatten(_params(tmp_path / "tf" / "model.msgpack"))
    assert all(a.dtype == np.float32 for a in params.values())
