"""PNG thumbnails of scene frames (the generators' `--thumb`).

Port of solver_in_the_loop_tpu/io/thumbs.py without PIL, which the card's
machine lacks: the PNG is assembled with `zlib` and `struct`. The JAX
package hands PIL the field times `scale`, truncated toward zero to int32
(a PIL "I" image), and PIL writes that as a 16-bit grayscale PNG with every
value clipped to [0, 65535]; this writer stores the same pixels, so a
negative velocity is 0 and a value above 65535 / scale is 65535. The files
go to <parent>/thumb/<sim>/ beside the scene (`thumb_dir_for`), and
`save_thumbs` writes many on the frame writer's thread pool.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, Tuple

import numpy as np

from solver_in_the_loop_torch.io.npz_pool import pool_map

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def thumb_pixels(array2d: np.ndarray, scale: float) -> np.ndarray:
    """The pixels a thumbnail stores: trunc(array2d * scale) clipped to
    [0, 65535], as big-endian uint16."""
    ima = np.asarray(np.asarray(array2d, np.float64) * scale, dtype="i")
    return np.clip(ima, 0, 65535).astype(">u2")


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def png_bytes(pixels: np.ndarray) -> bytes:
    """A 16-bit grayscale PNG of `pixels` (H, W), every row unfiltered."""
    pixels = np.asarray(pixels, ">u2")
    h, w = pixels.shape
    rows = np.zeros((h, 1 + 2 * w), np.uint8)  # a filter byte 0 before each row
    rows[:, 1:] = pixels.view(np.uint8).reshape(h, 2 * w)
    header = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    return b"".join((_SIGNATURE, _chunk(b"IHDR", header),
                     _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)), _chunk(b"IEND", b"")))


def png_pixels(path: str) -> np.ndarray:
    """The pixels (H, W) of a thumbnail this module wrote: 16-bit grayscale,
    every row unfiltered."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            if data[8:13] != b"\x10\x00\x00\x00\x00":
                raise ValueError(f"{path} is not an unfiltered 16-bit grayscale PNG")
            size = struct.unpack(">II", data[:8])
        elif kind == b"IDAT":
            idat += data
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 2 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path} has filtered rows")
    return rows[:, 1:].copy().view(">u2")


def save_thumb(array2d: np.ndarray, scale: float, path: str) -> None:
    """Write the thumbnail of one 2-D field to `path` (its directory made)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    blob = png_bytes(thumb_pixels(array2d, scale))
    with open(path, "wb") as f:
        f.write(blob)


def save_thumbs(items: Iterable[Tuple[np.ndarray, float, str]]) -> int:
    """save_thumb(array2d, scale, path) for every item, on the pool; returns
    how many were written. Raises the first failure."""
    items = list(items)
    for d in {os.path.dirname(p) for _, _, p in items}:
        os.makedirs(d, exist_ok=True)
    pool_map(lambda item: save_thumb(*item), items)
    return len(items)


def thumb_dir_for(scene_path: str) -> str:
    """thumb/<sim_xxxxxx>/ next to the scene's parent."""
    parent, base = os.path.split(os.path.normpath(scene_path))
    return os.path.join(parent, "thumb", base)
