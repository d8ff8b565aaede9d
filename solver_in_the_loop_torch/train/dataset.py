"""Karman training data: scene frames, the 4x downsampling cache, statistics,
and the reference's epoch shuffle schedule.

Port of the karman half of solver_in_the_loop_tpu/train/dataset.py. The
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


def _ds_path(path: str) -> str:
    """Downsampled-cache filename next to the original ('ds_' prefix,
    reference karman_train.py:258-259)."""
    d, b = os.path.split(path)
    return os.path.join(d, "ds_" + b)


def _downsample_centered_file(src: str, dst: str, scale: int) -> None:
    arr = scene_io.read_array(src)  # (1, Y, X, 1)
    lo = downsample_centered(torch.from_numpy(np.ascontiguousarray(arr[..., 0])), scale)
    scene_io.write_array(dst, lo.numpy()[..., None])


def _downsample_staggered_file(src: str, dst: str, scale: int) -> None:
    u, v = scene_io.legacy_to_staggered(scene_io.read_array(src))
    u_lo, v_lo = downsample_staggered(torch.from_numpy(u), torch.from_numpy(v), scale)
    scene_io.write_array(dst, scene_io.staggered_to_legacy(u_lo.numpy(), v_lo.numpy()))


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
            for frame in sc.frames("dens")[:num_frames]:
                src = sc.frame_path("dens", frame)
                if not os.path.isfile(_ds_path(src)):
                    _downsample_centered_file(src, _ds_path(src), scale)
            for frame in sc.frames("velo")[:num_frames]:
                src = sc.frame_path("velo", frame)
                if not os.path.isfile(_ds_path(src)):
                    _downsample_staggered_file(src, _ds_path(src), scale)

    dens, us, vs, res = [], [], [], []
    for sc in scenes:
        d_frames = sc.frames("ds_dens")[:num_frames]
        v_frames = sc.frames("ds_velo")[:num_frames]
        if len(d_frames) < num_frames or len(v_frames) < num_frames:
            raise ValueError(f"{sc.path}: need {num_frames} cached frames, found "
                             f"{len(d_frames)} ds_dens and {len(v_frames)} ds_velo")
        dens.append(np.stack([sc.read_centered("ds_dens", f)[0] for f in d_frames]))
        uv = [sc.read_staggered("ds_velo", f) for f in v_frames]
        us.append(np.stack([x[0][0] for x in uv]))
        vs.append(np.stack([x[1][0] for x in uv]))
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
