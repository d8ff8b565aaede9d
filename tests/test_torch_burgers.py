"""The Burgers data and serving paths of the PyTorch port against the JAX
package (CPU): random fields and forces, the solver step, the features, the
rollouts, the dataset loader, and the burgers-gen and burgers-apply CLIs.

Inputs come from numpy seeds and go through both packages. Tolerances: the
same float32 formulas on both sides, whose sin, sums and convolutions differ
in the last bits, ~1e-7 relative per step; 1e-6 for one step, 1e-5 for a
few, ROLLOUT_RTOL for rollouts through the trained net.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.apps import burgers_apply as jax_apply
from solver_in_the_loop_tpu.apps import burgers_gen as jax_gen
from solver_in_the_loop_tpu.core import random_fields as jrf
from solver_in_the_loop_tpu.models.features import Normalization as JNormalization
from solver_in_the_loop_tpu.models.features import burgers_features as jax_features
from solver_in_the_loop_tpu.models.networks import build_model as jax_build_model
from solver_in_the_loop_tpu.physics import burgers as jb
from solver_in_the_loop_tpu.train import dataset as jdataset
from solver_in_the_loop_tpu.train.rollout import burgers_rollout as jax_rollout

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch import parity
from solver_in_the_loop_torch.core import random_fields as trf
from solver_in_the_loop_torch.io import scene as torch_scene
from solver_in_the_loop_torch.models.features import Normalization, burgers_features
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.physics import burgers as tb
from solver_in_the_loop_torch.train import dataset as tdataset
from solver_in_the_loop_torch.train.checkpoint import params_to_jax
from solver_in_the_loop_torch.train.rollout import burgers_rollout

torch.set_num_threads(2)

ROLLOUT_RTOL = 1e-4
CKPT = parity.BURGERS_CKPT


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _both(res, batch, seed):
    """(JAX, port) initial velocities and forces from the same seed."""
    jd, td = jb.burgers_domain(res), tb.burgers_domain(res)
    jf = jb.random_forces(np.random.RandomState(seed), 5, batch=batch)
    tf = tb.random_forces(np.random.RandomState(seed), 5, batch=batch)
    jv = jrf.randfreq_staggered(np.random.RandomState(seed + 1), jd, batch)
    tv = trf.randfreq_staggered(np.random.RandomState(seed + 1), td, batch)
    return (jd, jf, jv), (td, tf, tv)


def test_random_fields_and_forces_match_jax():
    (jd, jf, jv), (td, tf, tv) = _both(16, 2, 3)
    np.testing.assert_array_equal(tv.u.numpy(), np.asarray(jv.u))
    np.testing.assert_array_equal(tv.v.numpy(), np.asarray(jv.v))
    for a, b in zip(jf, tf):
        for name in ("k", "amplitude", "phase", "omega"):
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)))
    for dt in (0.0, 0.7):
        js = jb.sample_force_sum([f.advance(dt) for f in jf], jd, 2)
        ts = tb.sample_force_sum([f.advance(dt) for f in tf], td, 2)
        assert _rel(ts.u.numpy(), js.u) <= 1e-6 and _rel(ts.v.numpy(), js.v) <= 1e-6


@pytest.mark.parametrize("advection", ["shift", "gather"])
def test_step_matches_jax(advection):
    (jd, jf, jv), (td, tf, tv) = _both(16, 2, 5)
    jflow = jb.BurgersFlow(jd, advection=advection)
    tflow = tb.BurgersFlow(td, advection=advection)
    jforce, tforce = jb.sample_force_sum(jf, jd, 2), tb.sample_force_sum(tf, td, 2)
    for j, t in ((jflow.step(jv, 0.1), tflow.step(tv, 0.1)),
                 (jflow.step_with_f(jv, jforce, 0.1), tflow.step_with_f(tv, tforce, 0.1))):
        assert _rel(t.u.numpy(), j.u) <= 1e-6 and _rel(t.v.numpy(), j.v) <= 1e-6


@pytest.mark.parametrize("with_force", [True, False])
def test_features_match_jax(with_force):
    (jd, jf, jv), (td, tf, tv) = _both(8, 2, 7)
    scales = [0.4, 0.38, 0.16, 0.15]
    jforce = jb.sample_force_sum(jf, jd, 2) if with_force else None
    tforce = tb.sample_force_sum(tf, td, 2) if with_force else None
    if with_force:
        jn, tn = JNormalization.burgers(*scales), Normalization.burgers(*scales)
    else:
        jn = JNormalization(jnp.asarray(scales[:2]), jnp.asarray(scales[:2]))
        tn = Normalization(torch.tensor(scales[:2]), torch.tensor(scales[:2]))
    got = burgers_features(tv, tforce, tn).numpy()
    assert got.shape == (2, 8, 8, 4 if with_force else 2)
    assert _rel(got, jax_features(jv, jforce, jn)) <= 1e-6


def _models(in_channels=4):
    """A fresh port MarsMoon and the same weights in the JAX package."""
    port = build_model("mars_moon", in_channels=in_channels, init="reference",
                       generator=torch.Generator().manual_seed(0))
    jmodel = jax_build_model("mars_moon", leaky_slope=0.3)
    return port, jmodel, {"params": params_to_jax(port, "mars_moon")}


@pytest.mark.parametrize("conv", ["library", "kernel"])
def test_rollouts_match_jax(conv):
    """rollout_analytic (no model, the generator's) and rollout_replay (with a
    net, the apply's) against the JAX package's."""
    (jd, jf, jv), (td, tf, tv) = _both(8, 2, 9)
    ja, jr = jax_rollout(jb.BurgersFlow(jd, advection="gather"), steps=5, dt=0.1)
    ta, tr = burgers_rollout(tb.BurgersFlow(td, advection="gather"), steps=5, dt=0.1)
    want = ja(None, jv, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jf))
    got = ta(tv, tf)
    for key in ("u", "v", "fu", "fv"):
        assert _rel(got[key].numpy(), want[key]) <= 1e-5, key

    port, jmodel, params = _models()
    port.conv_impl = conv
    scales = [0.4, 0.38, 0.16, 0.15]
    _, jr = jax_rollout(jb.BurgersFlow(jd, advection="shift"), steps=4,
                        model_apply=jmodel.apply, norm=JNormalization.burgers(*scales), dt=0.1)
    _, tr = burgers_rollout(tb.BurgersFlow(td, advection="shift"), steps=4, model=port.eval(),
                            norm=Normalization.burgers(*scales), dt=0.1)
    want = jr(params, jv, want["fu"][:4], want["fv"][:4])
    got = tr(tv, got["fu"][:4], got["fv"][:4])
    for key in ("u", "v"):
        assert _rel(got[key].numpy(), want[key]) <= ROLLOUT_RTOL, key


GEN_ARGS = ["-r", "32", "-l", "32", "--dt", "0.1", "-s", "3", "-t", "10", "--seed", "4"]


@pytest.mark.parametrize("extra", [[], ["--advect", "shift"], ["--noforce"]])
def test_gen_cli_matches_jax(tmp_path, extra):
    jax_gen.main(["-o", str(tmp_path / "jax"), *GEN_ARGS, *extra])
    torch_cli.main(["burgers-gen", "-o", str(tmp_path / "port"), *GEN_ARGS, *extra,
                    "--device", "cpu"])
    j, t = (torch_scene.Scene(str(tmp_path / d / "sim_000000")) for d in ("jax", "port"))
    assert t.frames("velo") == j.frames("velo") == list(range(10))
    assert t.frames("forc") == j.frames("forc")
    for name in ("velo", "forc"):
        for frame in (0, 9):
            for a, b in zip(t.read_staggered(name, frame), j.read_staggered(name, frame)):
                assert _rel(a, b) <= 1e-5, (name, frame)
    assert t.read_params()["seed"] == 4
    assert os.path.isfile(os.path.join(t.path, "run.log"))


def test_gen_cli_replay_matches_jax(tmp_path):
    """--initvH/--loadfH: a hi-res sim replayed at a quarter of its resolution."""
    jax_gen.main(["-o", str(tmp_path / "hi"), *GEN_ARGS])
    sim = tmp_path / "hi" / "sim_000000"
    replay = ["-r", "8", "-s", "0", "-t", "6", "-d", "4", "--initvH", str(sim / "velo_000000.npz"),
              "--loadfH", str(sim / "forc_0*.npz")]
    jax_gen.main(["-o", str(tmp_path / "jax"), *replay])
    torch_cli.main(["burgers-gen", "-o", str(tmp_path / "port"), *replay, "--device", "cpu"])
    j, t = (torch_scene.Scene(str(tmp_path / d / "sim_000000")) for d in ("jax", "port"))
    assert t.frames("velo") == j.frames("velo") == list(range(6))
    for a, b in zip(t.read_staggered("velo", 5), j.read_staggered("velo", 5)):
        assert _rel(a, b) <= 1e-5


def test_gen_writes_thumbnails(tmp_path):
    """--thumb writes the four fields' PNGs of every frame, frame 0 included
    (the JAX app's files and pixels: tests/test_torch_npz_thumbs.py)."""
    torch_cli.main(["burgers-gen", "-o", str(tmp_path), "-r", "8", "-t", "2", "--thumb",
                    "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "thumb" / "sim_000000")) == [
        f"{name}_{t:06d}.png" for name in ("frcU", "frcV", "velU", "velV") for t in (0, 1)]


def test_dataset_matches_jax(tmp_path):
    for seed in (0, 1):
        jax_gen.main(["-o", str(tmp_path), "-r", "32", "-t", "6", "--seed", str(seed)])
    got = tdataset.load_burgers_dataset(str(tmp_path), num_frames=6)
    want = jdataset.load_burgers_dataset(str(tmp_path), num_frames=6, skip_preprocessing=True)
    assert got.resolution == want.resolution == (8, 8) and got.num_sims == 2
    for key in ("u", "v", "fu", "fv"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert got.stats == want.stats


@pytest.mark.parametrize("conv", ["library", "kernel"])
@pytest.mark.parametrize("noforce", [False, True])
def test_apply_cli_matches_jax(tmp_path, conv, noforce):
    """The trained SOL-04 checkpoint through both CLIs for a few steps, from
    hi-res frames at 4x the rollout's resolution."""
    jax_gen.main(["-o", str(tmp_path / "hi"), *GEN_ARGS])
    sim = tmp_path / "hi" / "sim_000000"
    args = ["--model", os.path.join(CKPT, "model.msgpack"),
            "--stats", os.path.join(CKPT, "dataStats.json"),
            "--initvH", str(sim / "velo_000000.npz"), "--loadfH", str(sim / "forc_0*.npz"),
            "-d", "4", "-r", "8", "-t", "5"] + (["--noforce", "--no-model"] if noforce else [])
    want = jax_apply.main(["-o", str(tmp_path / "jax"), *args])
    got = torch_cli.main(["burgers-apply", "-o", str(tmp_path / "port"), *args, "--conv", conv,
                          "--device", "cpu"])
    for key in ("u", "v"):
        assert _rel(got[key].numpy(), want[key]) <= ROLLOUT_RTOL, key
    sc = torch_scene.Scene(str(tmp_path / "port" / "sim_000000"))
    assert sc.frames("velTf") == list(range(5))
    with open(os.path.join(sc.path, "params.json")) as f:
        assert json.load(f)["conv"] == conv


def test_apply_cli_needs_the_forces(tmp_path):
    inputs = parity.burgers_apply_inputs(str(tmp_path / "in"))
    inputs["loadfH"] = str(tmp_path / "in" / "missing_*.npz")
    with pytest.raises(ValueError, match="no force frames"):
        torch_cli.main(["burgers-apply", *parity.burgers_apply_argv(str(tmp_path / "out"), inputs),
                        "--device", "cpu"])
