"""Correction networks and checkpoints of the PyTorch port against flax (CPU).

* the port's own msgpack reader against `flax.serialization` on the trained
  SOL-32 checkpoint (same tree, same arrays, bit for bit), and against the
  msgpack package on the scalar and container types;
* MarsMoon (the a3_k_sol32 weights) and Mercury (random flax weights written
  with flax's serializer) against flax `apply`: atol 1e-5, float32 convs
  summed in another order;
* the karman features and the staggered correction (1e-6, elementwise).
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from solver_in_the_loop_tpu.core import grids as jg
from solver_in_the_loop_tpu.models import features as jf
from solver_in_the_loop_tpu.models.networks import build_model as jax_build_model
from solver_in_the_loop_tpu.train import checkpoint as jax_ckpt

from solver_in_the_loop_torch.core import grids as tg
from solver_in_the_loop_torch.models import features as tf
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

CKPT = Path(__file__).resolve().parents[1] / "artifacts" / "a3_k_sol32"


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def test_msgpack_reader_matches_flax_on_checkpoint():
    with open(CKPT / "model.msgpack", "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = tckpt.read_msgpack(str(CKPT / "model.msgpack"))
    want_leaves, got_leaves = dict(_leaves(want)), dict(_leaves(got))
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, arr in want_leaves.items():
        assert got_leaves[path].dtype == arr.dtype and got_leaves[path].shape == arr.shape
        np.testing.assert_array_equal(got_leaves[path], arr)


def test_msgpack_reader_scalar_and_container_types(tmp_path):
    obj = {"ints": [0, 127, 128, 255, 256, 65536, 2**33, -1, -32, -33, -200, -40000, -2**40],
           "floats": [0.5, -1.25e300], "str": "x" * 40, "long": "y" * 300, "none": None,
           "flags": [True, False], "bin": b"\x00\x01", "nested": {str(i): i for i in range(20)},
           "arr": list(range(20))}
    path = tmp_path / "obj.msgpack"
    path.write_bytes(msgpack.packb(obj, use_bin_type=True))
    assert tckpt.read_msgpack(str(path)) == obj


def _flax_params(arch, seed):
    model = jax_build_model(arch, leaky_slope=0.3)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 8, 3)))
    return model, params


@pytest.mark.parametrize("arch", ["mars_moon", "mercury"])
def test_network_matches_flax(tmp_path, arch):
    if arch == "mars_moon":  # the trained SOL-32 checkpoint
        model, params = _flax_params(arch, 0)
        path = CKPT / "model.msgpack"
        params, _ = jax_ckpt.load_checkpoint(str(path), params)
    else:  # random weights through flax's own serializer
        model, params = _flax_params(arch, 1)
        path = Path(jax_ckpt.save_checkpoint(str(tmp_path), params))
    net = build_model(arch, leaky_slope=0.3)
    tckpt.load_model_weights(net, str(path), arch)
    x = np.random.RandomState(2).randn(2, 16, 8, 3).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 8, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert tckpt.param_count(net) == sum(a.size for a in jax.tree_util.tree_leaves(params))


def test_checkpoint_name_map_rejects_foreign_leaves():
    net = build_model("mercury")
    with pytest.raises(KeyError, match="unexpected checkpoint leaf"):
        tckpt.params_from_jax({"Conv_9": {"kernel": np.zeros((5, 5, 3, 2), np.float32)}},
                              "mercury", net)


def test_features_and_correction():
    with open(CKPT / "dataStats.json") as f:
        stats = json.load(f)
    rng = np.random.RandomState(3)
    u = rng.randn(2, 16, 9).astype(np.float32)
    v = rng.randn(2, 17, 8).astype(np.float32)
    re = np.asarray([240000.0, 480000.0], np.float32)
    jdom = jg.Domain((16, 8), (32.0, 16.0))
    tdom = tg.Domain((16, 8), (32.0, 16.0))
    jnorm = jf.Normalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"])
    tnorm = tf.Normalization.karman(stats["std.v"], stats["std.u"], stats["ext.std"])
    want = jf.karman_features(jg.StaggeredGrid(jnp.asarray(u), jnp.asarray(v), jdom),
                              jnp.asarray(re), jnorm)
    got = tf.karman_features(tg.StaggeredGrid(torch.from_numpy(u), torch.from_numpy(v), tdom),
                             torch.from_numpy(re), tnorm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    out = rng.randn(2, 16, 8, 2).astype(np.float32)
    jc = jf.correction_to_staggered(jnp.asarray(out), jnorm, jdom)
    tc = tf.correction_to_staggered(torch.from_numpy(out), tnorm, tdom)
    np.testing.assert_allclose(tc.u.numpy(), np.asarray(jc.u), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), rtol=1e-6, atol=1e-6)
