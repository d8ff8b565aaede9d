"""Data parallelism of the port (parallel/mesh.py, `--dp`) against the JAX
package on the CPU.

The port's ranks are processes over gloo (tests/torch_dist_ranks.py); the
JAX side runs unsharded in this process, as the reference of
tests/test_parallel.py, whose cases these port:

* one karman SOL train step (`karman_domain(8)`, msteps 2, MarsMoon from
  JAX's PRNGKey(0) carried across by `params_from_jax`) at batch 8 on 2
  ranks, and batch 3 padded with zero-weighted rows to 4 on 2 ranks and on
  4 (the last rank holds only a padding row); one Burgers step at batch 4
  on 2 ranks and batch 3 on 4. Each against JAX's `make_*_train_step` on the
  whole batch: the loss and per-step losses within rtol 1e-4 and the
  parameters after one clipped Adam step within atol 1e-5 (the JAX tests'
  tolerances), and the gradient the optimizer was given within 1e-4 of each
  leaf's max: the sum over the ranks (a mean would be off by the rank
  count, which Adam's first step, lr * g / |g|, cannot show). The pressure
  solves run at CG tolerance 1e-7 (PTOL): each rank's solve stops on its
  own rows and JAX's on the whole batch, and at the CLI's 1e-5 those stops
  part the gradients by up to 1e-3 of a leaf's max (ROADMAP.md).
* every rank ends with the same loss, gradient and parameters;
* `batch_rows` is JAX's `batch_sharding` layout, `padded_batch` its padding;
* `move_rows` (the spatial step's halo exchange) moves rows and sums their
  gradients back to the ranks that hold them;
* `karman-train --dp` as a group of one equals the run without `--dp`, bit
  for bit (its losses and its model.msgpack).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from solver_in_the_loop_tpu.models.features import Normalization as JNormalization
from solver_in_the_loop_tpu.models.networks import build_model as jax_build_model
from solver_in_the_loop_tpu.parallel.mesh import batch_sharding, data_parallel_mesh as jax_mesh
from solver_in_the_loop_tpu.physics import burgers as jb
from solver_in_the_loop_tpu.physics import karman as jk
from solver_in_the_loop_tpu.train import trainer as jtrainer

import torch_dist_ranks as ranks
from test_torch_train_cli import _train_args, _write_hires_scenes

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch.models.networks import build_model
from solver_in_the_loop_torch.parallel import mesh as pmesh
from solver_in_the_loop_torch.train.checkpoint import params_from_jax

torch.set_num_threads(1)

LR = 1e-4
MSTEPS = 2
PTOL = 1e-7
KARMAN = {"family": "karman", "res": 8, "max_shift": 1, "ptol": PTOL, "pmaxiter": 1000,
          "in_channels": 3, "norm": ([1.0, 1.0, 1e6], [1.0, 1.0])}
BURGERS = {"family": "burgers", "res": 16, "max_shift": 2, "dt": 0.1, "in_channels": 4,
           "norm": ([0.4, 0.38, 0.16, 0.15], [0.4, 0.38])}


def _data(family: str, batch: int, seed: int):
    """The JAX tests' data, `batch` sims of 4 frames with every row at frame
    0, but for the karman velocities at 0.3 of their unit deviation: at that
    deviation and batch 8 JAX's jitted step parts from its own op-by-op run
    by 1.7e-3 of a leaf's max, which the port matches to 7e-7 (ROADMAP.md
    §C); at 0.3 all agree to 8e-7."""
    rng = np.random.RandomState(seed)
    if family == "karman":
        dom = jk.karman_domain(KARMAN["res"])
        data = {"dens": rng.rand(batch, 4, dom.ny, dom.nx),
                "u": 0.3 * rng.randn(batch, 4, dom.ny, dom.nx + 1),
                "v": 0.3 * rng.randn(batch, 4, dom.ny + 1, dom.nx),
                "re": 1.6e5 * 2 ** np.arange(batch)}
    else:
        n = BURGERS["res"]
        data = {"u": 0.5 * rng.randn(batch, 4, n, n + 1), "v": 0.5 * rng.randn(batch, 4, n + 1, n),
                "fu": 0.07 * rng.randn(batch, 4, n, n + 1),
                "fv": 0.07 * rng.randn(batch, 4, n + 1, n)}
    idx = np.stack([np.arange(batch), np.zeros(batch, np.int64)], 1)
    return {k: np.asarray(a, np.float32) for k, a in data.items()}, idx


@functools.lru_cache(maxsize=None)
def jax_step(family: str, batch: int, seed: int):
    """JAX's unsharded train step on the whole batch: (initial params, loss,
    step losses, raw gradients, params after the clipped Adam step), numpy."""
    spec = KARMAN if family == "karman" else BURGERS
    data, idx = _data(family, batch, seed)
    cfg = jtrainer.SolTrainConfig(msteps=MSTEPS, lr=LR, batch_size=batch, clip_grad=True,
                                  remat=True, dt=spec.get("dt", 1.0))
    model = jax_build_model("mars_moon", init="reference", leaky_slope=0.3)
    shape = (batch, 2 * spec["res"], spec["res"], 3) if family == "karman" else \
        (batch, spec["res"], spec["res"], 4)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros(shape))
    # the gradient as the optimizer receives it, kept in the first state
    capture = optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                                           lambda g, s, p=None: (g, g))
    optimizer = optax.chain(capture, jtrainer.make_optimizer(cfg))
    norm = JNormalization(jnp.asarray(spec["norm"][0]), jnp.asarray(spec["norm"][1]))
    if family == "karman":
        flow = jk.KarmanFlow(jk.karman_domain(spec["res"]), advection="shift",
                             max_shift=spec["max_shift"], pressure_tol=spec["ptol"],
                             pressure_max_iter=spec["pmaxiter"])
        step = jtrainer.make_karman_train_step(flow, model.apply, optimizer, cfg)
    else:
        flow = jb.BurgersFlow(jb.burgers_domain(spec["res"]), advection="shift",
                              max_shift=spec["max_shift"])
        step = jtrainer.make_burgers_train_step(flow, model.apply, optimizer, cfg)
    init = ranks.numpy_tree(jax.tree_util.tree_map(np.asarray, params))
    new, state, loss, step_losses = step(params, optimizer.init(params),
                                         {k: jnp.asarray(a) for k, a in data.items()}, norm,
                                         jnp.asarray(idx, jnp.int32))
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return init, float(loss), np.asarray(step_losses), as_np(state[0]), as_np(new)


def _as_port(spec, tree):
    model = build_model("mars_moon", in_channels=spec["in_channels"], leaky_slope=0.3)
    return {n: t.numpy() for n, t in params_from_jax(tree["params"], "mars_moon", model).items()}


@pytest.mark.parametrize("family,batch,world,seed", [
    ("karman", 8, 2, 0), ("karman", 3, 2, 1), ("karman", 3, 4, 1),
    ("burgers", 4, 2, 2), ("burgers", 3, 4, 3)])
def test_dp_train_step_matches_jax(family, batch, world, seed):
    spec = KARMAN if family == "karman" else BURGERS
    init, loss, step_losses, grads, new = jax_step(family, batch, seed)
    data, idx = _data(family, batch, seed)
    pad_to = None if batch % world == 0 else -(-batch // world) * world
    case = dict(spec, params=init["params"], data=data, idx=idx, pad_to=pad_to, msteps=MSTEPS,
                lr=LR)
    got = ranks.spawn(ranks.dp_train_step_rank, world, case)

    per = (pad_to or batch) // world
    for r, g in enumerate(got):
        assert g["rows"].shape == (per, 2) and g["applied"]
        if pad_to is not None:  # the ones, then the padding's zeros
            np.testing.assert_array_equal(g["weights"], (np.arange(per) + r * per < batch))
        for key in ("loss", "step_losses"):
            np.testing.assert_array_equal(g[key], got[0][key])
        for key in ("grad", "update"):
            for name, a in g[key].items():
                np.testing.assert_array_equal(a, got[0][key][name], err_msg=name)
    if pad_to == 4 and world == 4:
        assert np.array_equal(got[3]["rows"], idx[:1]) and got[3]["weights"].tolist() == [0.0]

    np.testing.assert_allclose(got[0]["loss"], loss, rtol=1e-4)
    np.testing.assert_allclose(got[0]["step_losses"], step_losses, rtol=1e-4)
    want_grad, want_new = _as_port(spec, grads), _as_port(spec, new)
    assert len(want_grad) == 24
    for name, w in want_grad.items():
        scale = np.abs(w).max()
        assert scale > 0, name
        assert np.abs(got[0]["grad"][name] - w).max() <= 1e-4 * scale, name
        np.testing.assert_allclose(got[0]["update"][name], want_new[name], rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_batch_rows_are_jax_batch_sharding(world):
    """Rank r's rows are the rows JAX's P('data') puts on device r."""
    mesh = jax_mesh(world)
    rows = np.arange(world * 3 * 2).reshape(world * 3, 2)
    shards = jax.device_put(jnp.asarray(rows), batch_sharding(mesh)).addressable_shards
    for r, shard in enumerate(sorted(shards, key=lambda s: s.device.id)):
        port = pmesh.Mesh(world, r, torch.device("cpu"), "gloo")
        np.testing.assert_array_equal(rows[pmesh.batch_rows(port, rows.shape[0])],
                                      np.asarray(shard.data))
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.batch_rows(pmesh.Mesh(world, 0, torch.device("cpu"), "gloo"), world + 1)


def test_padded_batch_is_the_jax_trainers_padding():
    """The rows and weights of solver_in_the_loop_tpu/train/trainer.py
    run_training's pad_batch_to (and of tests/test_parallel.py's batch 3 on
    8 devices)."""
    idx3 = np.stack([np.arange(3), np.array([4, 0, 2])], 1)
    idx8, wgt8 = pmesh.padded_batch(idx3, 8)
    np.testing.assert_array_equal(idx8, np.concatenate([idx3, np.repeat(idx3[:1], 5, 0)]))
    np.testing.assert_array_equal(wgt8, [1, 1, 1, 0, 0, 0, 0, 0])
    assert wgt8.dtype == np.float32
    same, none = pmesh.padded_batch(idx3, None)
    assert same is idx3 and none is None


@pytest.mark.parametrize("world", [2, 3])
def test_move_rows_moves_rows_and_sums_their_gradients(world):
    """A halo exchange (every rank its block and 2 rows each side) and a
    re-layout from blocks of 4 (the last one padding) to uneven blocks."""
    n = 4 * world - 1
    blocks = [(4 * r, min(4 * r + 4, n)) for r in range(world)]
    halo = [(max(lo - 2, 0), min(hi + 2, n)) for lo, hi in blocks]
    owner = {r: 1000.0 * r for r in range(world)}
    got = ranks.spawn(ranks.move_rows_rank, world, blocks, halo, 3)
    for r, (out, grad) in enumerate(got):
        lo, hi = halo[r]
        want = np.array([owner[j // 4] + j for j in range(lo, hi)], np.float32)
        np.testing.assert_array_equal(out, np.broadcast_to(want[None, :, None], out.shape))
        # each row's gradient: (row + 1) once per rank that received it, per column
        lo_b, hi_b = blocks[r]
        times = [sum(1 for a, b in halo if a <= j < b) for j in range(lo_b, hi_b)]
        want_g = np.array([(j + 1.0) * t for j, t in zip(range(lo_b, hi_b), times)], np.float32)
        np.testing.assert_array_equal(grad[:, :hi_b - lo_b],
                                      np.broadcast_to(want_g[None, :, None], (2, hi_b - lo_b, 3)))
    uneven = [(0, 1)] + [(1 + (n - 1) * r // (world - 1), 1 + (n - 1) * (r + 1) // (world - 1))
                         for r in range(world - 1)]
    got = ranks.spawn(ranks.move_rows_rank, world, blocks, uneven, 1)
    for r, (out, _) in enumerate(got):
        lo, hi = uneven[r]
        np.testing.assert_array_equal(out[0, :, 0], [owner[j // 4] + j for j in range(lo, hi)])


def test_move_rows_refuses_rows_nobody_holds():
    mesh = pmesh.Mesh(2, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="held once"):
        pmesh.move_rows(torch.zeros(1, 2, 1), [(0, 2), (2, 4)], [(0, 3), (2, 5)], mesh)


def test_group_of_one_equals_the_run_without_dp(tmp_path):
    """`karman-train --dp` without a launcher: a group of one whose
    all-reduces and broadcasts leave every value as it was."""
    _write_hires_scenes(str(tmp_path / "hires"))
    runs = {}
    for name, extra in (("plain", []), ("dp", ["--dp"])):
        runs[name] = torch_cli.main(["karman-train", *_train_args(
            tmp_path / "hires", tmp_path / name, "--device", "cpu", *extra)])
    assert runs["dp"].losses == runs["plain"].losses and len(runs["dp"].losses) == 2
    assert ((tmp_path / "dp" / "model.msgpack").read_bytes()
            == (tmp_path / "plain" / "model.msgpack").read_bytes())
    assert not torch.distributed.is_initialized()
