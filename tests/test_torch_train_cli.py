"""The port's checkpoint writer and `karman-train` CLI against the JAX package
on the CPU.

* the msgpack writer emits the bytes `flax.serialization.to_bytes` emits for
  the same parameters, `flax.serialization.msgpack_restore` reads them back
  to the same arrays, and the port's reader inverts it;
* `karman-train --device cpu` end to end at a tiny size (-m 2 -e 1) and the
  JAX CLI on the same hi-res scenes: the same dataStats.json, the same first
  loss (with --init zero the first unroll is the pure solver's, whatever the
  hidden weights), finite losses, and a model.msgpack that both packages'
  karman-apply load and roll out alike;
* without `--device cpu` and without CUDA the CLI refuses to run, and every
  flag that is not ported raises NotImplementedError.

Tolerances: the dataset statistics are float64 sums of the same float32
frames (1e-6); the first loss is a float32 unroll with CG at tol 1e-5 on both
sides (1e-5); the rollouts from the same checkpoint follow
tests/test_torch_apply.py (1e-4 of each field's max).
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from solver_in_the_loop_tpu.apps import karman_apply as jax_apply
from solver_in_the_loop_tpu.apps import karman_train as jax_train
from solver_in_the_loop_tpu.io.scene import Scene as JScene
from solver_in_the_loop_tpu.physics import karman as jk

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch.apps import karman_train as torch_train
from solver_in_the_loop_torch.io.scene import Scene
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.train import checkpoint as tckpt

torch.set_num_threads(1)


def test_msgpack_writer_matches_flax_bytes(tmp_path):
    model = build_model("mars_moon", init="reference", generator=torch.Generator().manual_seed(3))
    tree = {"params": {"params": tckpt.params_to_jax(model, "mars_moon")}}
    assert tckpt.pack_msgpack(tree) == serialization.to_bytes(tree)
    path = tckpt.save_checkpoint(str(tmp_path), model, "mars_moon")
    with open(path, "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    back = dict(jax.tree_util.tree_leaves_with_path(restored))
    assert len(leaves) == len(back) == 24
    for key, arr in leaves:
        assert back[key].dtype == np.float32 and np.array_equal(back[key], arr)
    again = build_model("mars_moon")
    tckpt.load_model_weights(again, path, "mars_moon")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    assert tckpt.save_checkpoint(str(tmp_path), model, "mars_moon", epoch=10).endswith(
        "model_epoch0010.msgpack")


def test_msgpack_writer_mercury_and_long_fields():
    model = build_model("mercury", init="zero", generator=torch.Generator().manual_seed(0))
    tree = {"params": {"params": tckpt.params_to_jax(model, "mercury")}, "note": "x" * 40}
    assert tckpt.pack_msgpack(tree) == serialization.to_bytes(tree)


def _write_hires_scenes(parent, sims=2, frames=4):
    """Hi-res (64x32) karman-like frames: 4x downsampled they are res 8."""
    rng = np.random.RandomState(21)
    dom = jk.karman_domain(32)
    for s in range(sims):
        sc = JScene.create(parent)
        sc.write_params({"re": 160000.0 * 2 ** s})
        for f in range(frames):
            sc.write_centered("dens", f, rng.rand(1, dom.ny, dom.nx).astype(np.float32))
            sc.write_staggered(
                "velo", f, (0.2 * rng.randn(1, dom.ny, dom.nx + 1)).astype(np.float32),
                (1.0 + 0.2 * rng.randn(1, dom.ny + 1, dom.nx)).astype(np.float32))


def _train_args(data, out, *extra):
    return ["--train", str(data), "--tf", str(out), "-t", "4", "-m", "2", "-n", "2", "-b", "2",
            "-e", "1", "--lr", "1e-4", "--seed", "0", "--init", "zero", *extra]


def _apply_args(tf, out):
    return ["-o", str(out), "--model", str(tf / "model.msgpack"), "--stats",
            str(tf / "dataStats.json"), "-r", "8", "-t", "3", "--re", "240000"]


def test_karman_train_cli_cpu_matches_jax_cli(tmp_path):
    for side in ("port", "jax"):
        _write_hires_scenes(str(tmp_path / side / "hires"))
    got = torch_cli.main(["karman-train", *_train_args(tmp_path / "port" / "hires",
                                                       tmp_path / "port" / "tf",
                                                       "--device", "cpu")])
    want = jax_train.main(_train_args(tmp_path / "jax" / "hires", tmp_path / "jax" / "tf"))
    assert len(got.losses) == len(want.losses) == 2
    assert np.isfinite(got.losses).all() and got.notfinite == 0
    np.testing.assert_allclose(got.losses[0], want.losses[0], rtol=1e-5)
    assert len(got.iter_seconds) == 2 and len(got.cg_iters) == 2
    stats = [json.loads((tmp_path / s / "tf" / "dataStats.json").read_text())
             for s in ("port", "jax")]
    assert stats[0].keys() == stats[1].keys() and stats[0]["leaky_alpha"] == 0.3
    for key in stats[1]:
        np.testing.assert_allclose(stats[0][key], stats[1][key], rtol=1e-6)
    assert len(Scene.list(str(tmp_path / "port" / "hires"))[1].frames("ds_dens")) == 4
    assert (tmp_path / "port" / "tf" / "metrics.jsonl").stat().st_size > 0

    # the port's checkpoint runs in both packages' karman-apply
    tf = tmp_path / "port" / "tf"
    jax_apply.main(_apply_args(tf, tmp_path / "apply_jax"))
    frames = torch_cli.main(["karman-apply", *_apply_args(tf, tmp_path / "apply_port"),
                             "--device", "cpu"])
    ref = Scene(str(tmp_path / "apply_jax" / "sim_000000"))
    for a, b in zip(ref.read_staggered("velTf", 2), (frames["u"][1].numpy(),
                                                     frames["v"][1].numpy())):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


def test_karman_train_cli_refuses_cpu_without_device_flag(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main(["karman-train", *_train_args(tmp_path / "none", tmp_path / "tf")])
    assert not (tmp_path / "tf").exists()


@pytest.mark.parametrize("flag", [["--resume", "3"], ["--inittf", "m.msgpack"],
                                  ["--pretf", "p.msgpack"], ["--dp"], ["--bf16"],
                                  ["--profile", "trace"], ["--debug-nans"], ["--reg-loss"]])
def test_karman_train_cli_flags_not_ported_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        torch_cli.main(["karman-train", *_train_args(tmp_path / "none", tmp_path / "tf"),
                        "--device", "cpu", *flag])
    assert not (tmp_path / "tf").exists()


def test_karman_train_cli_maps_remat_none_to_pressure(tmp_path, monkeypatch):
    """The port never re-runs a solve in the backward pass, so the JAX
    package's `none` policy (a plain checkpoint that recomputes the solve)
    runs as `pressure`, which saves it."""
    _write_hires_scenes(str(tmp_path / "hires"))
    seen = []

    def stop(flow, model, optimizer, cfg):
        seen.append((cfg.remat, cfg.remat_policy))
        raise KeyboardInterrupt

    monkeypatch.setattr(torch_train, "make_karman_train_step", stop)
    for policy in ("none", "pressure+advect"):
        with pytest.raises(KeyboardInterrupt):
            torch_cli.main(["karman-train", *_train_args(tmp_path / "hires", tmp_path / "tf"),
                            "--device", "cpu", "--remat-policy", policy])
    assert seen == [(True, "pressure"), (True, "pressure+advect")]
