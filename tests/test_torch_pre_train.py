"""The port's PRE trainer (`karman-pre-train`, `burgers-pre-train`),
JupiterMoon and the PRE statistics against the JAX package on the CPU.

* the loaded arrays and stats.json (zero-centred and `--nozerocen`,
  `--nsigma`, `--novdata`) key for key;
* JupiterMoon's forward (1e-5 of the output's max) and parameter gradients
  (1e-4 of each gradient's max) against the JAX model with the same
  weights, under both conv implementations, and its checkpoint names;
* two epochs of both trainers from the same start (`--resume 1` of a
  seeded checkpoint) against the JAX CLI: the epochs' losses within
  PRE_LOSS_REL_TOL, each parameter within PRE_TRAIN_REL_TOL in norm
  (parity.py says why not element by element);
* `--resume` bit-identical to an uninterrupted run, the epoch checkpoints'
  pruning and the histogram PNGs;
* utils/stats.py against the JAX package's functions.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.apps import pre_train as jax_pt
from solver_in_the_loop_tpu.models.networks import build_model as jax_build_model
from solver_in_the_loop_tpu.utils import stats as jax_stats

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.apps import pre_train
from solver_in_the_loop_torch.io import scene as torch_scene
from solver_in_the_loop_torch.io.thumbs import png_pixels
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.train.checkpoint import (
    params_from_jax,
    params_to_jax,
    read_msgpack,
)
from solver_in_the_loop_torch.utils import stats as torch_stats

torch.set_num_threads(2)

FWD_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-4


def write_pre_scenes(root, scenario: str, sims: int = 2, frames: int = 5, seed: int = 0):
    """Random PRE scenes (velo, corr, and forc for Burgers) at 16x8
    (karman, Re 160000 * 2^i) or 16x16 (Burgers), a fifth of the entries
    zero so the nonzero masks matter. Returns the trainer's patterns."""
    rng = np.random.RandomState(seed)
    y, x = (16, 8) if scenario == "karman" else (16, 16)
    names = ("velo", "corr") if scenario == "karman" else ("velo", "corr", "forc")
    for s in range(sims):
        sc = torch_scene.Scene.create(str(root))
        sc.write_params({"re": 160000.0 * 2 ** s} if scenario == "karman" else {})
        for f in range(1, frames + 1):
            for name in names:
                scale = 0.01 if name == "corr" else 1.0
                u = scale * rng.randn(1, y, x + 1) * (rng.rand(1, y, x + 1) > 0.2)
                v = scale * rng.randn(1, y + 1, x) * (rng.rand(1, y + 1, x) > 0.2)
                sc.write_staggered(name, f, u.astype(np.float32), v.astype(np.float32))
    return [os.path.join(str(root), "sim_0*")]


@pytest.mark.parametrize("scenario", ["karman", "burgers"])
def test_load_pre_data_matches_jax(tmp_path, scenario):
    pats = write_pre_scenes(tmp_path, scenario)
    got = pre_train.load_pre_data(pats, scenario)
    want = jax_pt.load_pre_data(pats, scenario)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("flags", [[], ["--nozerocen"], ["--nsigma", "2", "--val", "0.3"],
                                   ["--novdata", "--leaky-alpha", "0.01"]])
@pytest.mark.parametrize("scenario", ["karman", "burgers"])
def test_stats_json_matches_jax(tmp_path, scenario, flags):
    """stats.json key for key (no epoch trained)."""
    pats = write_pre_scenes(tmp_path / "set", scenario)
    argv = ["--epochs", "0", "--nostats", *flags, *pats]
    jax_pt.main(["-o", str(tmp_path / "jax"), *argv], scenario=scenario)
    res = torch_cli.main([f"{scenario}-pre-train", "-o", str(tmp_path / "port"), *argv,
                          "--device", "cpu"])
    with open(tmp_path / "jax" / "stats.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "stats.json") as f:
        assert json.load(f) == want
    assert res["stats"] == want
    assert res["losses"] == []


def _jax_jupiter(port):
    model = jax_build_model("jupiter_moon", leaky_slope=port.leaky_slope)
    return model, {"params": jax.tree_util.tree_map(jnp.asarray,
                                                    params_to_jax(port, "jupiter_moon"))}


@pytest.mark.parametrize("conv", ["library", "kernel"])
def test_jupiter_moon_matches_jax(conv):
    port = parity.seeded_weights(build_model("jupiter_moon", in_channels=4, leaky_slope=0.3,
                                             conv=conv), 1)
    model, params = _jax_jupiter(port)
    x = np.random.RandomState(0).randn(2, 16, 16, 4).astype(np.float32)
    y = np.random.RandomState(1).randn(2, 16, 16, 2).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    out = port(torch.from_numpy(x))
    assert float(np.abs(out.detach().numpy() - want).max() / np.abs(want).max()) <= FWD_REL_TOL

    def loss(p):
        return jnp.mean((model.apply(p, jnp.asarray(x)) - jnp.asarray(y)) ** 2)

    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)["params"]),
                            "jupiter_moon", port)
    torch.mean((out - torch.from_numpy(y)) ** 2).backward()
    for name, p in port.named_parameters():
        w = grads[name].numpy()
        assert float(np.abs(p.grad.numpy() - w).max() / np.abs(w).max()) <= GRAD_REL_TOL, name


def test_jupiter_moon_checkpoint_names_round_trip():
    port = parity.seeded_weights(build_model("jupiter_moon", in_channels=4), 2)
    tree = params_to_jax(port, "jupiter_moon")
    assert sorted(tree) == ["Conv_0", "Conv_1"] + [f"_JupiterBlock_{k}" for k in range(6)]
    assert sorted(tree["_JupiterBlock_2"]) == ["Conv_0", "Conv_1", "Conv_2"]
    assert sorted(tree["_JupiterBlock_3"]) == ["Conv_0", "Conv_1"]
    assert tree["_JupiterBlock_0"]["Conv_1"]["kernel"].shape == (3, 3, 32, 32)
    back = params_from_jax(tree, "jupiter_moon", port)
    for name, t in port.state_dict().items():
        assert torch.equal(back[name], t), name


def test_jupiter_moon_refuses_the_older_checkpoint():
    """artifacts/b_pre_jm holds the JupiterMoon of before the JAX package's
    block fix (`_ResBlock_k` with 5x5 second convs): neither package's
    jupiter_moon loads it (ROADMAP.md C5)."""
    path = os.path.join(parity.REPO, "artifacts", "b_pre_jm", "model.msgpack")
    tree = read_msgpack(path)["params"]["params"]
    assert "_ResBlock_0" in tree and tree["_ResBlock_0"]["Conv_1"]["kernel"].shape[0] == 5
    with pytest.raises(KeyError, match="_ResBlock_0"):
        params_from_jax(tree, "jupiter_moon", build_model("jupiter_moon", in_channels=4))


PARITY_CASES = [("karman", "mars_moon", "library", []), ("karman", "mars_moon", "kernel", []),
                ("burgers", "jupiter_moon", "library", []),
                ("burgers", "mars_moon", "library", ["--nozerocen"])]


@pytest.mark.parametrize("scenario,arch,conv,flags", PARITY_CASES)
def test_two_epochs_match_jax(tmp_path, scenario, arch, conv, flags):
    """From the same seeded start (both load model_epoch0001 with --resume
    1): the same batches, flips and schedule, so the epochs' losses and the
    parameters agree."""
    pats = write_pre_scenes(tmp_path / "set", scenario, frames=6)
    for side in ("jax", "port"):
        parity.write_pre_start(str(tmp_path / side), scenario, arch)
    argv = ["--model", arch, *parity.PRE_TRAIN_ARGV, *flags, *pats]
    jax_pt.main(["-o", str(tmp_path / "jax"), *argv], scenario=scenario)
    res = torch_cli.main([f"{scenario}-pre-train", "-o", str(tmp_path / "port"), *argv,
                          "--conv", conv, "--device", "cpu"])
    with open(tmp_path / "jax" / "metrics.jsonl") as f:
        losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    np.testing.assert_allclose(res["losses"], losses, rtol=parity.PRE_LOSS_REL_TOL)
    model = build_model(arch, in_channels=3 if scenario == "karman" else 4)
    want = params_from_jax(read_msgpack(str(tmp_path / "jax" / "model.msgpack"))["params"][
        "params"], arch, model)
    got = {n: p.detach().numpy() for n, p in res["model"].state_dict().items()}
    errors = parity.leaf_errors(got, {n: t.numpy() for n, t in want.items()})
    assert max(errors.values()) <= parity.PRE_TRAIN_REL_TOL, errors
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        f for f in os.listdir(tmp_path / "jax") if f != "stats.pdf")


@pytest.mark.parametrize("scenario", ["karman", "burgers"])
def test_resume_is_bit_identical(tmp_path, scenario):
    """3 epochs straight against 2 then --resume 2 --epochs 3, with flips
    and reshuffles (--steps beyond one pass); the pruned epochs."""
    pats = write_pre_scenes(tmp_path / "set", scenario, frames=4)
    argv = ["--augment", "--bsize", "3", "--steps", "4", "--nostats", "--leaky-alpha", "0.2",
            *pats, "--device", "cpu"]
    cmd = f"{scenario}-pre-train"
    whole = torch_cli.main([cmd, "-o", str(tmp_path / "a"), "--epochs", "3", *argv])
    torch_cli.main([cmd, "-o", str(tmp_path / "b"), "--epochs", "2", *argv])
    # the restart must take the slope from stats.json, not from the CLI default
    argv_resume = [a for a in argv if a not in ("--leaky-alpha", "0.2")]
    resumed = torch_cli.main([cmd, "-o", str(tmp_path / "b"), "--epochs", "3", "--resume", "2",
                              *argv_resume])
    assert resumed["stats"]["leaky_alpha"] == 0.2
    for (n, a), b in zip(whole["model"].state_dict().items(),
                         resumed["model"].state_dict().values()):
        assert torch.equal(a, b), n
    assert resumed["losses"] == whole["losses"][2:]
    assert sorted(f for f in os.listdir(tmp_path / "b") if f.startswith("model")) == [
        "model.msgpack", "model_epoch0003.msgpack"]


def test_histogram_pngs(tmp_path):
    """stats-png/{name}_{c}.png for the inputs, labels and their normalised
    training parts; each bar's height follows the histogram's log counts."""
    pats = write_pre_scenes(tmp_path / "set", "karman")
    res = torch_cli.main(["karman-pre-train", "-o", str(tmp_path / "tf"), "--epochs", "0",
                          *pats, "--device", "cpu"])
    files = sorted(os.listdir(tmp_path / "tf" / "stats-png"))
    assert res["histograms"] == len(files) == 3 + 2 + 3 + 2
    assert "input_train_norm_2.png" in files and "labels_1.png" in files
    inputs, _ = pre_train.load_pre_data(pats, "karman")
    pixels = png_pixels(str(tmp_path / "tf" / "stats-png" / "inputs_0.png"))
    assert pixels.shape == (pre_train.HIST_H, pre_train.HIST_BINS * pre_train.HIST_BAR_W)
    counts, _ = np.histogram(inputs[..., 0].reshape(-1), bins=pre_train.HIST_BINS)
    heights = (pixels[:, ::pre_train.HIST_BAR_W] == 0).sum(axis=0)
    want = np.round(pre_train.HIST_H * np.log1p(counts) / np.log1p(counts.max()))
    np.testing.assert_array_equal(heights, want)


def test_pre_lr_schedule_and_pruning_match_jax(tmp_path):
    lr_p = lr_j = 1e-3
    for epoch in range(200):
        lr_p, lr_j = pre_train.pre_lr_schedule(epoch, lr_p), jax_pt.pre_lr_schedule(epoch, lr_j)
        assert lr_p == lr_j
    for epoch in (1, 2, 50, 51, 52, 101):
        open(tmp_path / f"model_epoch{epoch:04d}.msgpack", "w").close()
    for cur in (2, 3, 51, 52, 53, 102):
        assert pre_train._epoch_path_keep(str(tmp_path), cur) == jax_pt._epoch_path_keep(
            str(tmp_path), cur)


def test_stats_functions_match_jax():
    rng = np.random.RandomState(0)
    data = (rng.randn(3, 5, 4, 3) * (rng.rand(3, 5, 4, 3) > 0.3)).astype(np.float32)
    data[..., 2] = 0.0
    for nonzero in (False, True):
        got, want = torch_stats.channel_stats(data, nonzero), jax_stats.channel_stats(data,
                                                                                        nonzero)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    mean, std = data.mean((0, 1, 2)), data.std((0, 1, 2)) + 1.0
    for fn in ("standardize", "destandardize", "normalize", "denormalize"):
        np.testing.assert_array_equal(getattr(torch_stats, fn)(data, mean, std),
                                      getattr(jax_stats, fn)(data, mean, std))
    np.testing.assert_array_equal(torch_stats.nonzero_channel_mean(data),
                                  jax_pt.nonzero_channel_mean(data))
    np.testing.assert_array_equal(torch_stats.nonzero_channel_std(data),
                                  jax_pt.nonzero_channel_std(data))
    nested = {"a": np.float32(1.5), "b": {"c": np.arange(3)}, "d": (np.int64(2), "x")}
    assert torch_stats.stats_dict_to_lists(nested) == jax_stats.stats_dict_to_lists(nested)
