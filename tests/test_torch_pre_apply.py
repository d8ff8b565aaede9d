"""The port's PRE rollouts (`karman-pre-apply`, `burgers-pre-apply`) with the
repository's trained PRE nets against the JAX package's CLIs on the CPU, a
few steps: every frame within FRAME_REL_TOL of its max, under both conv
implementations, and the scenes they write."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.apps import burgers_gen as jax_bgen
from solver_in_the_loop_tpu.apps import burgers_pre_apply as jax_bpa
from solver_in_the_loop_tpu.apps import karman_pre_apply as jax_kpa

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.io import scene as torch_scene
from solver_in_the_loop_torch.models.features import Normalization

torch.set_num_threads(2)

ARTIFACTS = os.path.join(parity.REPO, "artifacts")
# six steps of the same float32 step and net (measured: at most 2e-6)
FRAME_REL_TOL = 1e-4


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("conv", ["library", "kernel"])
@pytest.mark.parametrize("net", ["k_pre_train", "k_presr_train"])
def test_karman_pre_apply_matches_jax(tmp_path, net, conv):
    argv = ["--model", os.path.join(ARTIFACTS, net, "model.msgpack"),
            "--stats", os.path.join(ARTIFACTS, net, "stats.json"), "-r", "16",
            "--re", "160000", "320000", "-t", "7"]
    want = jax_kpa.main(["-o", str(tmp_path / "jax"), *argv])
    got = torch_cli.main(["karman-pre-apply", "-o", str(tmp_path / "port"), *argv,
                          "--conv", conv, "--device", "cpu"])
    for k in ("dens", "u", "v", "corr_u", "corr_v"):
        assert _rel(got[k], want[k]) <= FRAME_REL_TOL, k
    files = sorted(os.listdir(tmp_path / "jax" / "sim_000001"))
    assert sorted(os.listdir(tmp_path / "port" / "sim_000001")) == sorted(
        files + ["params.json"] * ("params.json" not in files))
    a = torch_scene.read_array(str(tmp_path / "jax" / "sim_000001" / "corTf_000006.npz"))
    b = torch_scene.read_array(str(tmp_path / "port" / "sim_000001" / "corTf_000006.npz"))
    assert _rel(b, a) <= FRAME_REL_TOL


@pytest.fixture(scope="module")
def burgers_sim(tmp_path_factory):
    root = tmp_path_factory.mktemp("hires")
    jax_bgen.main(["-o", str(root), "-r", "64", "-l", "32", "--dt", "0.1", "-s", "5", "-t", "10",
                   "--seed", "3"])
    return root / "sim_000000"


def _burgers_nets(tmp_path):
    jm = parity.jupiter_checkpoint(str(tmp_path / "jm"))
    return {"b_pre_train": (os.path.join(ARTIFACTS, "b_pre_train", "model.msgpack"),
                            os.path.join(ARTIFACTS, "b_pre_train", "stats.json"), "mars_moon"),
            "jupiter": (jm["model"], jm["stats"], "jupiter_moon")}


@pytest.mark.parametrize("conv", ["library", "kernel"])
@pytest.mark.parametrize("net", ["b_pre_train", "jupiter"])
def test_burgers_pre_apply_matches_jax(tmp_path, burgers_sim, net, conv):
    """artifacts/b_pre_train (MarsMoon) and a JupiterMoon of seeded weights
    (artifacts/b_pre_jm predates the JAX package's JupiterMoon and loads in
    neither package: tests/test_torch_pre_train.py)."""
    model, stats, arch = _burgers_nets(tmp_path)[net]
    argv = ["--model", model, "--stats", stats, "--arch", arch, "-r", "16", "-t", "7",
            "--initvH", str(burgers_sim / "velo_000000.npz"),
            "--loadfH", str(burgers_sim / "forc_0*.npz")]
    want = jax_bpa.main(["-o", str(tmp_path / "jax"), *argv])
    got = torch_cli.main(["burgers-pre-apply", "-o", str(tmp_path / "port"), *argv,
                          "--conv", conv, "--device", "cpu"])
    for k in ("u", "v"):
        assert _rel(got[k], want[k]) <= FRAME_REL_TOL, k
    assert sorted(f for f in os.listdir(tmp_path / "port" / "sim_000000")
                  if f.endswith(".npz")) == [f"velTf_{i:06d}.npz" for i in range(7)]


def test_burgers_pre_apply_refuses_the_older_jupiter_checkpoint(tmp_path, burgers_sim):
    """artifacts/b_pre_jm with --arch jupiter_moon: both packages refuse it."""
    argv = ["--model", os.path.join(ARTIFACTS, "b_pre_jm", "model.msgpack"),
            "--stats", os.path.join(ARTIFACTS, "b_pre_jm", "stats.json"),
            "--arch", "jupiter_moon", "-r", "16", "-t", "3",
            "--initvH", str(burgers_sim / "velo_000000.npz"),
            "--loadfH", str(burgers_sim / "forc_0*.npz")]
    with pytest.raises(ValueError):
        jax_bpa.main(["-o", str(tmp_path / "jax"), *argv])
    with pytest.raises(KeyError, match="_ResBlock_0"):
        torch_cli.main(["burgers-pre-apply", "-o", str(tmp_path / "port"), *argv,
                        "--device", "cpu"])


def test_nozerocen_normalization_matches_jax(tmp_path, burgers_sim):
    """A stats.json with nozerocen: the features less in.mean, the output
    plus out.mean, as the JAX CLI applies them."""
    with open(os.path.join(ARTIFACTS, "b_pre_train", "stats.json")) as f:
        stats = json.load(f)
    stats.update({"nozerocen": True, "in.mean": [0.1, -0.2, 0.05, 0.02],
                  "out.mean": [0.003, -0.002]})
    path = tmp_path / "stats.json"
    path.write_text(json.dumps(stats))
    norm = Normalization.pre(stats)
    assert norm.in_means.tolist() == pytest.approx(stats["in.mean"])
    argv = ["--model", os.path.join(ARTIFACTS, "b_pre_train", "model.msgpack"),
            "--stats", str(path), "-r", "16", "-t", "5",
            "--initvH", str(burgers_sim / "velo_000000.npz"),
            "--loadfH", str(burgers_sim / "forc_0*.npz")]
    want = jax_bpa.main(["-o", str(tmp_path / "jax"), *argv])
    got = torch_cli.main(["burgers-pre-apply", "-o", str(tmp_path / "port"), *argv,
                          "--device", "cpu"])
    for k in ("u", "v"):
        assert _rel(got[k], want[k]) <= FRAME_REL_TOL, k


def test_cli_lists_every_jax_command(capsys):
    from solver_in_the_loop_tpu import __main__ as jax_cli

    from solver_in_the_loop_torch import __main__ as port_cli

    assert list(port_cli.COMMANDS) == list(jax_cli.COMMANDS)
    assert port_cli.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in jax_cli.COMMANDS)


@pytest.mark.parametrize("cmd", ["karman-pre-gen", "karman-pre-apply", "burgers-pre-gen",
                                 "burgers-pre-train", "karman-pre-train", "burgers-pre-apply"])
def test_pre_commands_need_cuda_unless_cpu(tmp_path, monkeypatch, cmd):
    """Every PRE command runs on the card by default and refuses without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"karman-pre-gen": ["-o", str(tmp_path)],
            "burgers-pre-gen": ["-o", str(tmp_path), "--loadfH", "x"],
            "karman-pre-train": ["-o", str(tmp_path), "x"],
            "burgers-pre-train": ["-o", str(tmp_path), "x"],
            "karman-pre-apply": ["-o", str(tmp_path), "--model", "m", "--stats", "s"],
            "burgers-pre-apply": ["-o", str(tmp_path), "--model", "m", "--stats", "s",
                                  "--initvH", "v", "--loadfH", "f"]}[cmd]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main([cmd, *args])
