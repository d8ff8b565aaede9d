"""Scene frame files (npz: a zip of one deflated `.npy` member) written at
deflate level 1 and read back, over a pool of threads.

The port's counterpart of solver_in_the_loop_tpu/io/native_npz.py, whose
native library (native/sceneio.cpp) writes each frame at deflate level 1 on a
pool of min(16, cpu_count) threads. Here the zip container is assembled
with `struct` and compressed with `zlib`, which releases the GIL while it
deflates or inflates, so Python threads write and read frames in parallel
and nothing needs building. The files hold the member `arr_0.npy` (numpy's
default key), with the sizes in the local header and no data descriptor,
so `np.load` and the JAX package's native reader both read them. A failed
write raises; there is no other writer to fall back to.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Sequence

import numpy as np

LEVEL = 1
POOL_SIZE = min(16, os.cpu_count() or 1)  # as native_npz.py sizes its pool
MEMBER = b"arr_0.npy"
# general-purpose flag bits 1-2 of a deflated member record the level used,
# as Info-ZIP sets them: 4 ("fast") for level 1
_LEVEL_FLAG = 0x4
_DOS_DATE = 0x21  # 1980-01-01, the zip format's first day


def pool_map(fn: Callable, items: Sequence) -> list:
    """[fn(item) for item in items] on POOL_SIZE threads, in order; raises
    the first failure."""
    with ThreadPoolExecutor(max_workers=POOL_SIZE, thread_name_prefix="npz") as ex:
        return list(ex.map(fn, items))


def npy_bytes(arr: np.ndarray) -> bytes:
    """`arr` as a version-1.0 .npy file, as np.save writes it."""
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def npz_bytes(arr: np.ndarray) -> bytes:
    """The bytes of an npz file holding `arr` as arr_0.npy, deflated at LEVEL."""
    npy = npy_bytes(arr)
    comp = zlib.compressobj(LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS)
    data = comp.compress(npy) + comp.flush()
    if len(npy) > 0xFFFFFFFF or len(data) > 0xFFFFFFFF:
        raise ValueError(f"a frame of {len(npy)} bytes needs zip64, which this writer lacks")
    crc, flags, name = zlib.crc32(npy), _LEVEL_FLAG, MEMBER
    local = struct.pack("<IHHHHHIIIHH", 0x04034B50, 20, flags, 8, 0, _DOS_DATE, crc, len(data),
                        len(npy), len(name), 0) + name
    central = struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, 20, 20, flags, 8, 0, _DOS_DATE, crc,
                          len(data), len(npy), len(name), 0, 0, 0, 0, 0, 0) + name
    end = struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, 1, 1, len(central),
                      len(local) + len(data), 0)
    return b"".join((local, data, central, end))


def write_npz(path: str, arr: np.ndarray) -> None:
    """Write one frame file (float32)."""
    blob = npz_bytes(np.asarray(arr, np.float32))
    with open(path, "wb") as f:
        f.write(blob)


def write_npz_batch(paths: Sequence[str], arrays: Iterable[np.ndarray]) -> None:
    """Write arrays[i] to paths[i] on the pool; `arrays` may be one array
    whose leading axis runs over the files. Raises the first failure."""
    items = list(zip(paths, arrays))
    if len(items) != len(paths):
        raise ValueError(f"{len(paths)} paths for {len(items)} arrays")
    pool_map(lambda item: write_npz(*item), items)


def read_npz(path: str) -> np.ndarray:
    """The last array of an npz file (the one array of a frame file)."""
    with np.load(path) as f:
        return f[f.files[-1]]


def read_npz_batch(paths: Sequence[str]) -> List[np.ndarray]:
    """read_npz of every path, on the pool, in order."""
    return pool_map(read_npz, paths)
