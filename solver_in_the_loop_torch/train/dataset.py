"""Karman and Burgers training data: scene frames, the 4x downsampling cache,
statistics, and the reference's epoch shuffle schedule.

Port of solver_in_the_loop_tpu/train/dataset.py. The
dataset is loaded into host numpy arrays; the trainer moves it to the device
once and gathers each iteration's window there. `EpochSchedule` keeps the
JAX package's `random.Random(seed)` shuffle, so both packages visit the same
(sim, frame) pairs in the same order.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random as _random
from typing import Dict, List, Optional

import numpy as np
import torch

from solver_in_the_loop_torch.core.resample import downsample_centered, downsample_staggered
from solver_in_the_loop_torch.io import scene as scene_io
from solver_in_the_loop_torch.io.scene import Scene
from solver_in_the_loop_torch.utils.stats import abs_std

log = logging.getLogger(__name__)


def write_ds_cache(sc: Scene, name: str, frames, scale: int, staggered: bool) -> None:
    """The `ds_` cache of frames `frames` of `name` (reference
    karman_train.py:258-259: a 'ds_'-prefixed file beside each hi-res one):
    the frames without one are read, downsampled by `scale` and written on
    the frame writer's pool."""
    todo = [f for f in frames if not os.path.isfile(sc.frame_path("ds_" + name, f))]
    if not todo:
        return
    hi = sc.read_batch(name, todo)
    if staggered:
        u, v = (torch.from_numpy(a) for a in scene_io.legacy_to_staggered(hi))
        u_lo, v_lo = downsample_staggered(u, v, scale)
        sc.write_staggered_batch("ds_" + name, todo, u_lo.numpy(), v_lo.numpy())
    else:
        lo = downsample_centered(torch.from_numpy(np.ascontiguousarray(hi[..., 0])), scale)
        sc.write_centered_batch("ds_" + name, todo, lo.numpy())


@dataclasses.dataclass
class KarmanDataset:
    """Preloaded karman training data (host numpy).

    dens (S, F, Y, X); u (S, F, Y, X+1); v (S, F, Y+1, X); re (S,)
    stats keys: 'std.dens', 'std.v', 'std.u', 'ext.std' (std of the Re
    values, reference karman_train.py:251-255).
    """

    dens: np.ndarray
    u: np.ndarray
    v: np.ndarray
    re: np.ndarray
    stats: Dict[str, float]

    @property
    def num_sims(self) -> int:
        return self.dens.shape[0]

    @property
    def num_frames(self) -> int:
        return self.dens.shape[1]

    @property
    def resolution(self):
        return self.dens.shape[2:4]

    def to_device(self, device) -> Dict[str, torch.Tensor]:
        """The arrays as float32 tensors on `device`, keyed as the trainer reads them."""
        return {k: torch.from_numpy(np.asarray(getattr(self, k), np.float32)).to(device)
                for k in ("dens", "u", "v", "re")}


def load_karman_dataset(dirpath: str, num_frames: int, num_sims: Optional[int] = None,
                        scale: int = 4, skip_preprocessing: bool = False) -> KarmanDataset:
    """Read the first `num_frames` frames of the first `num_sims` scenes.

    Unless `skip_preprocessing`, each hi-res `dens`/`velo` frame is first
    downsampled by `scale` into a `ds_` file beside it (kept as a cache);
    training always reads the `ds_` frames."""
    scenes = Scene.list(dirpath)[: num_sims or None]
    if not scenes:
        raise ValueError(f"no sim_* scenes under {dirpath}")

    if not skip_preprocessing:
        for sc in scenes:
            write_ds_cache(sc, "dens", sc.frames("dens")[:num_frames], scale, staggered=False)
            write_ds_cache(sc, "velo", sc.frames("velo")[:num_frames], scale, staggered=True)

    dens, us, vs, res = [], [], [], []
    for sc in scenes:
        d_frames = sc.frames("ds_dens")[:num_frames]
        v_frames = sc.frames("ds_velo")[:num_frames]
        if len(d_frames) < num_frames or len(v_frames) < num_frames:
            raise ValueError(f"{sc.path}: need {num_frames} cached frames, found "
                             f"{len(d_frames)} ds_dens and {len(v_frames)} ds_velo")
        dens.append(sc.read_batch("ds_dens", d_frames)[..., 0])
        u, v = scene_io.legacy_to_staggered(sc.read_batch("ds_velo", v_frames))
        us.append(u)
        vs.append(v)
        res.append(float(sc.read_params()["re"]))

    data = KarmanDataset(dens=np.stack(dens), u=np.stack(us), v=np.stack(vs),
                         re=np.asarray(res, np.float32), stats={})
    data.stats = {
        "std.dens": abs_std(data.dens),
        "std.v": abs_std(data.v),
        "std.u": abs_std(data.u),
        "ext.std": float(np.std(np.abs(data.re))),
    }
    log.info("karman dataset: %s sims x %s frames @ %s; stats=%s",
             data.num_sims, data.num_frames, data.resolution, data.stats)
    return data


@dataclasses.dataclass
class BurgersDataset:
    """Preloaded Burgers training data (host numpy): velocity u (S, F, Y, X+1),
    v (S, F, Y+1, X) and force fu, fv of the same shapes. stats keys:
    'std.v', 'std.u', 'std.fv', 'std.fu'."""

    u: np.ndarray
    v: np.ndarray
    fu: np.ndarray
    fv: np.ndarray
    stats: Dict[str, float]

    @property
    def num_sims(self) -> int:
        return self.u.shape[0]

    @property
    def num_frames(self) -> int:
        return self.u.shape[1]

    @property
    def resolution(self):
        return (self.v.shape[2] - 1, self.u.shape[3] - 1)

    def to_device(self, device) -> Dict[str, torch.Tensor]:
        """The arrays as float32 tensors on `device`, keyed as the trainer reads them."""
        return {k: torch.from_numpy(np.asarray(getattr(self, k), np.float32)).to(device)
                for k in ("u", "v", "fu", "fv")}


def load_burgers_dataset(dirpath: str, num_frames: int, num_sims: Optional[int] = None,
                         scale: int = 4, skip_preprocessing: bool = False) -> BurgersDataset:
    """Read the first `num_frames` velocity and force frames of the first
    `num_sims` scenes, through the `ds_` cache as load_karman_dataset does."""
    scenes = Scene.list(dirpath)[: num_sims or None]
    if not scenes:
        raise ValueError(f"no sim_* scenes under {dirpath}")

    if not skip_preprocessing:
        for sc in scenes:
            for name in ("velo", "forc"):
                write_ds_cache(sc, name, sc.frames(name)[:num_frames], scale, staggered=True)

    fields = {k: [] for k in ("u", "v", "fu", "fv")}
    for sc in scenes:
        for name, (ku, kv) in (("ds_velo", ("u", "v")), ("ds_forc", ("fu", "fv"))):
            frames = sc.frames(name)[:num_frames]
            if len(frames) < num_frames:
                raise ValueError(f"{sc.path}: need {num_frames} cached frames, found "
                                 f"{len(frames)} {name}")
            u, v = scene_io.legacy_to_staggered(sc.read_batch(name, frames))
            fields[ku].append(u)
            fields[kv].append(v)

    data = BurgersDataset(**{k: np.stack(v) for k, v in fields.items()}, stats={})
    data.stats = {
        "std.v": abs_std(data.v),
        "std.u": abs_std(data.u),
        "std.fv": abs_std(data.fv),
        "std.fu": abs_std(data.fu),
    }
    log.info("burgers dataset: %s sims x %s frames @ %s; stats=%s",
             data.num_sims, data.num_frames, data.resolution, data.stats)
    return data


class EpochSchedule:
    """Reference-equivalent (sim, frame) shuffle schedule.

    Per epoch: all pairs with frame < F - msteps are shuffled and partitioned
    into (num_sims) rows of (F - msteps) steps; iteration (batch ib, step i)
    consumes rows [ib*B .. ib*B+B) at column i (reference
    karman_train.py:267-313). Yields int32 index arrays of shape (iters, B, 2)
    for a whole epoch.
    """

    def __init__(self, num_sims: int, num_frames: int, batch_size: int, seed: int = 0):
        if num_sims % batch_size != 0:
            raise ValueError(f"num_sims {num_sims} is not a multiple of the batch {batch_size}")
        self.num_sims = num_sims
        self.num_frames = num_frames
        self.batch_size = batch_size
        self.num_batches = num_sims // batch_size
        self.rng = _random.Random(seed)

    def steps_per_epoch(self, msteps: int) -> int:
        return self.num_batches * (self.num_frames - msteps)

    def epoch_indices(self, msteps: int) -> np.ndarray:
        steps = self.num_frames - msteps
        pairs: List = [(s, f) for s in range(self.num_sims) for f in range(steps)]
        self.rng.shuffle(pairs)
        grid = np.asarray(pairs, np.int32).reshape(self.num_sims, steps, 2)
        out = []
        for ib in range(self.num_batches):
            rows = grid[ib * self.batch_size: (ib + 1) * self.batch_size]  # (B, steps, 2)
            out.append(np.transpose(rows, (1, 0, 2)))  # (steps, B, 2)
        return np.concatenate(out, axis=0)  # (iters, B, 2)
