"""The port's training pieces against the JAX package on the CPU.

* `clip_by_leaf_norm`, `lr_schedule_step`, the warm-up epoch and the
  non-finite guard (`GuardedAdam`) against the JAX trainer's
  (tests/test_train.py shows the JAX cases);
* `EpochSchedule` index arrays equal to JAX's for three seeds;
* `load_karman_dataset` with and without the downsampling cache, on scenes
  the test writes, against the JAX loader;
* the init modes' moments.

Tolerances: the clip and Adam updates are float32 formulas in another order
(rtol 1e-6); the schedules and indices are exact; the downsampled frames are
2x2 means in float32 (1e-6); the init moments are sample statistics of
~25k-200k draws (a few percent).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.io.scene import Scene as JScene
from solver_in_the_loop_tpu.train import dataset as jdataset
from solver_in_the_loop_tpu.train import trainer as jtrainer

from solver_in_the_loop_torch.io.scene import Scene
from solver_in_the_loop_torch.models.networks import build_model, init_weights
from solver_in_the_loop_torch.train import dataset, trainer

torch.set_num_threads(1)


def test_clip_by_leaf_norm_matches_jax():
    rng = np.random.RandomState(0)
    grads = {"w": (10.0 * rng.randn(10)).astype(np.float32),
             "b": np.full((2,), 1e-6, np.float32),
             "z": np.zeros((3, 3), np.float32)}
    clip = jtrainer.clip_by_leaf_norm(0.001)
    want, _ = clip.update({k: jnp.asarray(v) for k, v in grads.items()}, clip.init(None))
    got = trainer.clip_by_leaf_norm([torch.from_numpy(v) for v in grads.values()], 0.001)
    for g, key in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[key]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(got[0].norm()), 0.001, rtol=1e-5)
    assert torch.equal(got[1], torch.from_numpy(grads["b"]))  # small grads untouched


def test_lr_schedule_matches_jax():
    lr_j = lr_t = 1e-3
    for epoch in range(30):
        lr_j, lr_t = jtrainer.lr_schedule_step(epoch, lr_j), trainer.lr_schedule_step(epoch, lr_t)
        assert lr_t == lr_j
    np.testing.assert_allclose(lr_t, 1e-3 * 1e-3 * 0.5, rtol=1e-12)


def test_warmup_epoch_scales_lr(monkeypatch):
    """Epochs below warmup_epochs run at lr * WARMUP_LR_SCALE, as JAX's run_training."""
    cfg = trainer.SolTrainConfig(lr=1e-4, epochs=3, warmup_epochs=1, msteps=1)
    opt = trainer.GuardedAdam([torch.nn.Parameter(torch.ones(2))], cfg)
    injected = []
    monkeypatch.setattr(opt, "set_learning_rate", injected.append)

    def fake_step(data, norm, idx):
        return torch.tensor(1.0), torch.ones(cfg.msteps), torch.ones(cfg.msteps), True

    sched = dataset.EpochSchedule(2, 4, 1, seed=0)
    result = trainer.run_training(fake_step, opt, {"u": torch.zeros(1)}, None, sched, cfg)
    np.testing.assert_allclose(injected, [1e-5, 1e-4, 1e-4], rtol=1e-6)
    assert len(result.losses) == len(result.iter_seconds) == 3 * sched.steps_per_epoch(1)


def _jax_guarded(lr):
    cfg = jtrainer.SolTrainConfig(lr=lr, clip_grad=True, guard_nonfinite=True)
    return jtrainer.make_optimizer(cfg)


def test_guard_and_adam_match_jax():
    """A NaN gradient skips the update (params and Adam moments untouched)
    and is counted; the finite updates around it match optax to rounding."""
    lr = 1e-3
    w0 = np.array([1.0, -2.0, 0.5], np.float32)
    seq = [np.array([0.3, -0.2, 0.1], np.float32), np.array([1.0, np.nan, 0.0], np.float32),
           np.array([-0.4, 0.25, 2.0], np.float32)]
    opt_j = _jax_guarded(lr)
    params_j = {"w": jnp.asarray(w0)}
    state = opt_j.init(params_j)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt_t = trainer.GuardedAdam([p], trainer.SolTrainConfig(lr=lr, clip_grad=True))
    for k, g in enumerate(seq):
        upd, state = opt_j.update({"w": jnp.asarray(g)}, state, params_j)
        params_j = {"w": params_j["w"] + upd["w"]}
        p.grad = torch.from_numpy(g.copy())
        applied = opt_t.step()
        assert applied == bool(np.isfinite(g).all())
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params_j["w"]), rtol=1e-6)
        assert opt_t.total_notfinite == jtrainer.notfinite_count(state) == (1 if k else 0)


def test_guard_applies_after_too_many_nonfinite_in_a_row():
    p = torch.nn.Parameter(torch.ones(2))
    opt = trainer.GuardedAdam([p], trainer.SolTrainConfig(lr=1e-3))
    for _ in range(trainer.MAX_CONSECUTIVE_ERRORS):
        p.grad = torch.tensor([float("nan"), 1.0])
        assert not opt.step()
    assert torch.equal(p.detach(), torch.ones(2)) and not opt.adam.state
    p.grad = torch.tensor([float("nan"), 1.0])
    assert opt.step()  # optax.apply_if_finite gives up and applies
    assert opt.total_notfinite == trainer.MAX_CONSECUTIVE_ERRORS + 1


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_epoch_schedule_matches_jax(seed):
    jsched = jdataset.EpochSchedule(6, 40, 3, seed=seed)
    tsched = dataset.EpochSchedule(6, 40, 3, seed=seed)
    for msteps in (32, 32, 4):
        want, got = jsched.epoch_indices(msteps), tsched.epoch_indices(msteps)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tsched.steps_per_epoch(32) == 16


def _write_hires(parent, sims=2, frames=4):
    rng = np.random.RandomState(3)
    for s in range(sims):
        sc = JScene.create(parent)
        sc.write_params({"re": 160000.0 * (s + 1)})
        for f in range(frames):
            sc.write_centered("dens", f, rng.rand(1, 32, 16).astype(np.float32))
            sc.write_staggered("velo", f, rng.randn(1, 32, 17).astype(np.float32),
                               rng.randn(1, 33, 16).astype(np.float32))


def test_load_karman_dataset_matches_jax(tmp_path):
    """The port downsamples the hi-res frames into ds_ files, reads them
    back, and computes the stats as the JAX loader does; --skip-ds reads the
    ds_ files alone."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _write_hires(port_dir)
    _write_hires(jax_dir)
    got = dataset.load_karman_dataset(port_dir, num_frames=3, num_sims=2, scale=4)
    want = jdataset.load_karman_dataset(jax_dir, num_frames=3, num_sims=2, scale=4)
    assert got.dens.shape == (2, 3, 8, 4) and got.u.shape == (2, 3, 8, 5)
    assert got.v.shape == (2, 3, 9, 4) and got.resolution == (8, 4)
    for key in ("dens", "u", "v", "re"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), rtol=1e-6, atol=1e-6)
    assert got.stats.keys() == want.stats.keys()
    for key, val in want.stats.items():
        np.testing.assert_allclose(got.stats[key], val, rtol=1e-6)
    # the cache alone: the JAX loader's ds_ files, read by the port
    cached = dataset.load_karman_dataset(jax_dir, num_frames=3, num_sims=2,
                                         skip_preprocessing=True)
    np.testing.assert_array_equal(cached.u, want.u)
    assert len(Scene.list(port_dir)[0].frames("ds_velo")) == 3
    with pytest.raises(ValueError, match="cached frames"):
        dataset.load_karman_dataset(jax_dir, num_frames=4, skip_preprocessing=True)
    with pytest.raises(ValueError, match="no sim_"):
        dataset.load_karman_dataset(str(tmp_path / "missing"), num_frames=3)


def test_init_modes_moments():
    gen = torch.Generator().manual_seed(0)
    ref = build_model("mars_moon", init="reference", generator=gen)
    zero = init_weights(build_model("mars_moon"), "zero", torch.Generator().manual_seed(0))
    for name, conv in ref.named_modules():
        if not isinstance(conv, torch.nn.Conv2d):
            continue
        w = conv.weight.detach()
        fan_in, fan_out = 25 * w.shape[1], 25 * w.shape[0]
        limit = np.sqrt(6.0 / (fan_in + fan_out))  # glorot_uniform
        assert float(w.abs().max()) <= limit
        np.testing.assert_allclose(float(w.std()), limit / np.sqrt(3.0), rtol=0.1)
        assert float(conv.bias.detach().abs().max()) == 0.0
        wz = zero.get_submodule(name).weight.detach()
        if name == "head":
            assert float(wz.abs().max()) == 0.0
        else:  # lecun_normal: truncated at 2 stddev, stddev sqrt(1/fan_in)
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert float(wz.abs().max()) <= 2.0 * std
            np.testing.assert_allclose(float(wz.std()), np.sqrt(1.0 / fan_in), rtol=0.1)
            assert abs(float(wz.mean())) < 0.1 * std
    again = build_model("mars_moon", init="reference", generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(ref.state_dict().values(),
                                                 again.state_dict().values()))
    with pytest.raises(KeyError):
        build_model("mars_moon", init="he")
