"""Scene on-disk I/O in the reference's legacy PhiFlow layout (numpy only).

A copy of the parts of solver_in_the_loop_tpu/io/scene.py that karman-apply
and karman-train use, with numpy's npz reader and writer in place of the
native ones:

  <parent>/sim_%06d/
      params.pickle, params.json   run parameters
      <name>_%06d.npz              one array under the npz default key

Legacy array conventions (kept HERE, nowhere else):
* centered field:  (1, Y, X, 1)
* staggered field: (1, Y+1, X+1, 2) with on-disk channel order [u, v];
  u occupies rows 0..Y-1 (top row zero-padded), v cols 0..X-1.
"""

from __future__ import annotations

import json
import os
import pickle
import re as _re
from typing import Tuple

import numpy as np


def staggered_to_legacy(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(B, Y, X+1), (B, Y+1, X) -> on-disk (B, Y+1, X+1, 2) with [...,0]=u, [...,1]=v."""
    b, y, _ = u.shape
    x = v.shape[2]
    out = np.zeros((b, y + 1, x + 1, 2), np.float32)
    out[:, :-1, :, 0] = u
    out[:, :, :-1, 1] = v
    return out


def legacy_to_staggered(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """on-disk (B, Y+1, X+1, 2) -> (u (B, Y, X+1), v (B, Y+1, X))."""
    return np.ascontiguousarray(arr[:, :-1, :, 0]), np.ascontiguousarray(arr[:, :, :-1, 1])


def centered_to_legacy(values: np.ndarray) -> np.ndarray:
    return values[..., None].astype(np.float32)


def legacy_to_centered(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr[..., 0])


def read_array(path: str) -> np.ndarray:
    """Load an npz frame in the legacy layout (batch dim guaranteed)."""
    with np.load(path) as f:
        arr = f[f.files[-1]]
    return arr[None] if arr.ndim < 4 else arr


def write_array(path: str, arr: np.ndarray) -> None:
    np.savez_compressed(path, np.asarray(arr, np.float32))


def _json_ok(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


class Scene:
    """A sim_%06d output directory of npz frames + params metadata."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    @classmethod
    def create(cls, parent: str) -> "Scene":
        os.makedirs(parent, exist_ok=True)
        existing = [int(m.group(1)) for d in os.listdir(parent)
                    if (m := _re.fullmatch(r"sim_(\d{6})", d))]
        return cls(os.path.join(parent, f"sim_{max(existing, default=-1) + 1:06d}"))

    @classmethod
    def list(cls, parent: str):
        """The sim_%06d scenes under `parent`, in order (none if it is missing)."""
        dirs = sorted(d for d in os.listdir(parent)
                      if _re.fullmatch(r"sim_\d{6}", d)) if os.path.isdir(parent) else []
        return [cls(os.path.join(parent, d)) for d in dirs]

    def write_params(self, params: dict) -> None:
        with open(os.path.join(self.path, "params.pickle"), "wb") as f:
            pickle.dump(params, f)
        with open(os.path.join(self.path, "params.json"), "w") as f:
            json.dump({k: v for k, v in params.items() if _json_ok(v)}, f, indent=1)

    def read_params(self) -> dict:
        """params.json, which the data generators write beside params.pickle;
        the pickle (the reference's own format) only where there is no json,
        since unpickling a file can run code."""
        p = os.path.join(self.path, "params.json")
        if os.path.isfile(p):
            with open(p) as f:
                return json.load(f)
        with open(os.path.join(self.path, "params.pickle"), "rb") as f:
            return pickle.load(f)

    def frame_path(self, name: str, frame: int) -> str:
        return os.path.join(self.path, f"{name}_{frame:06d}.npz")

    def write_centered(self, name: str, frame: int, values: np.ndarray) -> None:
        write_array(self.frame_path(name, frame), centered_to_legacy(np.asarray(values)))

    def write_staggered(self, name: str, frame: int, u: np.ndarray, v: np.ndarray) -> None:
        write_array(self.frame_path(name, frame), staggered_to_legacy(np.asarray(u), np.asarray(v)))

    def write_centered_batch(self, name: str, frame_ids, values: np.ndarray) -> None:
        """values (N, Y, X): one legacy frame (1, Y, X, 1) per frame id."""
        for f, fr in zip(frame_ids, values):
            self.write_centered(name, f, fr[None])

    def write_staggered_batch(self, name: str, frame_ids, u: np.ndarray, v: np.ndarray) -> None:
        """u (N, Y, X+1), v (N, Y+1, X): one legacy (1, Y+1, X+1, 2) frame per id."""
        for f, fu, fv in zip(frame_ids, u, v):
            self.write_staggered(name, f, fu[None], fv[None])

    def read_centered(self, name: str, frame: int) -> np.ndarray:
        return legacy_to_centered(read_array(self.frame_path(name, frame)))

    def read_staggered(self, name: str, frame: int) -> Tuple[np.ndarray, np.ndarray]:
        return legacy_to_staggered(read_array(self.frame_path(name, frame)))

    def frames(self, name: str):
        """Sorted frame numbers of the <name>_%06d.npz files of this scene."""
        pat = _re.compile(rf"{name}_(\d{{6}})\.npz")
        return sorted(int(m.group(1)) for fn in os.listdir(self.path)
                      if (m := pat.fullmatch(fn)))
