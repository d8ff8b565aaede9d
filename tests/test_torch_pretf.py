"""`--pretf` on both SOL trainers against the JAX package on the CPU: the
supervised-init contract (train/checkpoint.py `adopt_pretf_stats`) adopts
the PRE net's in.std, out.std and LeakyReLU slope as the JAX function does,
and `karman-train` / `burgers-train --pretf` start from the PRE net's
weights with the same dataStats.json and the same first loss as the JAX
CLIs (tolerances as tests/test_torch_train_cli.py: 1e-6 for the dataset
statistics, 1e-5 for the first loss)."""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.apps import burgers_gen as jax_bgen
from solver_in_the_loop_tpu.apps import burgers_train as jax_btrain
from solver_in_the_loop_tpu.apps import karman_train as jax_ktrain
from solver_in_the_loop_tpu.train import checkpoint as jax_ckpt

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.train import checkpoint as tckpt
from test_torch_train_cli import _write_hires_scenes

torch.set_num_threads(2)
log = logging.getLogger(__name__)
NETS = {"karman": os.path.join(parity.REPO, "artifacts", "k_pre_train"),
        "burgers": os.path.join(parity.REPO, "artifacts", "b_pre_train")}


@pytest.mark.parametrize("scenario", ["karman", "burgers"])
@pytest.mark.parametrize("alpha", [0.3, 0.01])
def test_adopt_pretf_stats_matches_jax(scenario, alpha):
    base = {"std.v": 0.5, "std.u": 0.4, "ext.std": 1234.0}
    got, want = dict(base), dict(base)
    args_p = argparse.Namespace(pretf=os.path.join(NETS[scenario], "model.msgpack"),
                                leaky_alpha=alpha)
    args_j = argparse.Namespace(**vars(args_p))
    tckpt.adopt_pretf_stats(got, args_p, log)
    jax_ckpt.adopt_pretf_stats(want, args_j, log)
    assert got == want and args_p.leaky_alpha == args_j.leaky_alpha == 0.01
    with open(os.path.join(NETS[scenario], "stats.json")) as f:
        assert got["in.std"] == json.load(f)["in.std"]


def _check_against_jax(tmp_path, got, want):
    np.testing.assert_allclose(got.losses[0], want.losses[0], rtol=1e-5)
    assert np.isfinite(got.losses).all()
    stats = [json.loads((tmp_path / s / "tf" / "dataStats.json").read_text())
             for s in ("port", "jax")]
    assert stats[0].keys() == stats[1].keys()
    for key in stats[1]:
        np.testing.assert_allclose(stats[0][key], stats[1][key], rtol=1e-6)
    return stats[0]


def test_karman_train_pretf_matches_jax_cli(tmp_path):
    argv = ["-t", "4", "-m", "2", "-n", "2", "-b", "2", "-e", "1", "--lr", "1e-4", "--seed", "0",
            "--pretf", os.path.join(NETS["karman"], "model.msgpack")]
    for side in ("port", "jax"):
        _write_hires_scenes(str(tmp_path / side / "hires"))
    got = torch_cli.main(["karman-train", "--train", str(tmp_path / "port" / "hires"),
                          "--tf", str(tmp_path / "port" / "tf"), *argv, "--device", "cpu"])
    want = jax_ktrain.main(["--train", str(tmp_path / "jax" / "hires"),
                            "--tf", str(tmp_path / "jax" / "tf"), *argv])
    stats = _check_against_jax(tmp_path, got, want)
    with open(os.path.join(NETS["karman"], "stats.json")) as f:
        pre = json.load(f)
    assert stats["in.std"] == pre["in.std"] and stats["out.std"] == pre["out.std"]
    assert stats["leaky_alpha"] == 0.01


def test_burgers_train_pretf_matches_jax_cli(tmp_path):
    argv = ["-t", "6", "-m", "2", "-n", "2", "-b", "2", "-e", "1", "--lr", "1e-4", "--seed", "0",
            "--pretf", os.path.join(NETS["burgers"], "model.msgpack")]
    for side in ("port", "jax"):
        for seed in range(2):
            jax_bgen.main(["-o", str(tmp_path / side / "hires"), "-r", "32", "-t", "6",
                           "--seed", str(seed)])
    got = torch_cli.main(["burgers-train", "--train", str(tmp_path / "port" / "hires"),
                          "--tf", str(tmp_path / "port" / "tf"), *argv, "--device", "cpu"])
    want = jax_btrain.main(["--train", str(tmp_path / "jax" / "hires"),
                            "--tf", str(tmp_path / "jax" / "tf"), *argv])
    stats = _check_against_jax(tmp_path, got, want)
    assert stats["leaky_alpha"] == 0.01


def test_pretf_starts_from_the_pre_weights(tmp_path):
    """With no epoch the model.msgpack written is the PRE net's own."""
    _write_hires_scenes(str(tmp_path / "hires"))
    pretf = os.path.join(NETS["karman"], "model.msgpack")
    torch_cli.main(["karman-train", "--train", str(tmp_path / "hires"), "--tf",
                    str(tmp_path / "tf"), "-t", "4", "-m", "2", "-n", "2", "-b", "2", "-e", "0",
                    "--pretf", pretf, "--device", "cpu"])
    a, b = build_model("mars_moon"), build_model("mars_moon")
    tckpt.load_model_weights(a, pretf, "mars_moon")
    tckpt.load_model_weights(b, str(tmp_path / "tf" / "model.msgpack"), "mars_moon")
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
