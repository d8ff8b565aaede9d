"""The port's frame writer (io/npz_pool.py) and thumbnails (io/thumbs.py)
against the JAX package's readers and PIL.

* Frames written by the port's Scene, one at a time and in pooled batches,
  centered and staggered, load to bit-equal arrays under np.load and under
  the JAX package's read_array (its native reader where native/libsceneio.so
  is built), and are deflated at level 1: the zip header's level bits say so
  and re-deflating the member at level 1 gives its stored bytes.
* The port's PNGs decode under PIL to the pixels of the JAX package's
  save_thumb (PIL), on fields with negatives and values above 65535/scale;
  skipped where PIL is missing.
* The generators' --thumb write the files the JAX apps write (the same
  names), and each PNG holds the thumbnail rule applied to its frame.
"""

from __future__ import annotations

import os
import struct
import zipfile
import zlib

import numpy as np
import pytest
import torch

from solver_in_the_loop_tpu.apps import burgers_gen as jax_burgers_gen
from solver_in_the_loop_tpu.apps import karman_gen as jax_karman_gen
from solver_in_the_loop_tpu.io import native_npz as jax_native
from solver_in_the_loop_tpu.io import scene as jax_scene

from solver_in_the_loop_torch import __main__ as torch_cli
from solver_in_the_loop_torch.io import npz_pool, thumbs
from solver_in_the_loop_torch.io import scene as torch_scene

torch.set_num_threads(1)


def _fields(seed=0, n=3, y=6, x=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, y, x).astype(np.float32), rng.randn(n, y, x + 1).astype(np.float32),
            rng.randn(n, y + 1, x).astype(np.float32))


def _member(path):
    """(general-purpose flags, compression method, stored bytes, payload) of
    the one member of a frame file, read from its local header."""
    with open(path, "rb") as f:
        blob = f.read()
    sig, _, flags, method, _, _, _, csize, usize, nlen, elen = struct.unpack(
        "<IHHHHHIIIHH", blob[:30])
    assert sig == 0x04034B50
    data = blob[30 + nlen + elen:30 + nlen + elen + csize]
    payload = zlib.decompress(data, -zlib.MAX_WBITS)
    assert len(payload) == usize
    return flags, method, data, payload


@pytest.mark.parametrize("batched", [False, True])
def test_frames_load_bit_equal_and_deflate_at_level_1(tmp_path, batched):
    dens, u, v = _fields()
    sc = torch_scene.Scene(str(tmp_path / "sim_000000"))
    if batched:
        sc.write_centered_batch("dens", [1, 2, 3], dens)
        sc.write_staggered_batch("velo", [1, 2, 3], u, v)
    else:
        for t in range(3):
            sc.write_centered("dens", t + 1, dens[t:t + 1])
            sc.write_staggered("velo", t + 1, u[t:t + 1], v[t:t + 1])
    ref = jax_scene.Scene(sc.path)
    for t in range(3):
        for name, want in (("dens", dens[t][None, :, :, None]),
                           ("velo", torch_scene.staggered_to_legacy(u[t:t + 1], v[t:t + 1]))):
            path = sc.frame_path(name, t + 1)
            with np.load(path) as f:
                assert f.files == ["arr_0"]
                assert f["arr_0"].dtype == np.float32 and np.array_equal(f["arr_0"], want)
            assert np.array_equal(jax_scene.read_array(path), want)
            flags, method, data, payload = _member(path)
            assert method == 8 and flags & 0x6 == 0x4  # deflate, level 1 ("fast")
            comp = zlib.compressobj(1, zlib.DEFLATED, -zlib.MAX_WBITS)
            assert comp.compress(payload) + comp.flush() == data
        assert np.array_equal(ref.read_centered("dens", t + 1), dens[t:t + 1])
        for a, b in zip(ref.read_staggered("velo", t + 1), (u[t:t + 1], v[t:t + 1])):
            assert np.array_equal(a, b)


def test_jax_native_reader_reads_the_port_files(tmp_path):
    """Where the JAX package's native library is built, its reader (single
    and batched) takes the port's files."""
    if not jax_native.available():
        pytest.skip("native/libsceneio.so is not built")
    dens, u, v = _fields(seed=1, n=4)
    sc = torch_scene.Scene(str(tmp_path))
    sc.write_staggered_batch("velo", range(4), u, v)
    paths = [sc.frame_path("velo", t) for t in range(4)]
    want = torch_scene.staggered_to_legacy(u, v)[:, None]
    assert np.array_equal(jax_native.read_npz(paths[2]), want[2])
    assert np.array_equal(jax_native.read_npz_batch(paths, want.shape[1:]), want)


def test_batch_reader_and_pool_size(tmp_path):
    assert npz_pool.POOL_SIZE == min(16, os.cpu_count() or 1)
    arrays = [np.full((1, 3, 2, 1), t, np.float32) for t in range(20)]
    paths = [str(tmp_path / f"f_{t:06d}.npz") for t in range(20)]
    npz_pool.write_npz_batch(paths, arrays)
    got = npz_pool.read_npz_batch(paths)
    assert all(np.array_equal(g, a) for g, a in zip(got, arrays))
    assert np.array_equal(torch_scene.Scene(str(tmp_path)).read_batch("f", range(20)),
                          np.stack([a[0] for a in arrays]))
    with zipfile.ZipFile(paths[0]) as z:
        assert z.testzip() is None and z.namelist() == ["arr_0.npy"]


def test_writer_raises_instead_of_falling_back(tmp_path):
    with pytest.raises(OSError):
        npz_pool.write_npz_batch([str(tmp_path / "missing" / "f.npz")],
                                 np.zeros((1, 2, 2), np.float32))
    with pytest.raises(ValueError, match="paths"):
        npz_pool.write_npz_batch([str(tmp_path / "a.npz"), str(tmp_path / "b.npz")],
                                 np.zeros((1, 2, 2), np.float32))


@pytest.mark.parametrize("scale", [10000.0, 100000.0])
def test_thumbs_match_pil(tmp_path, scale):
    Image = pytest.importorskip("PIL.Image")
    from solver_in_the_loop_tpu.io import thumbs as jax_thumbs

    rng = np.random.RandomState(2)
    field = (rng.randn(17, 9) * 3.0 / scale * 65535.0).astype(np.float32)
    field[0, :8] = np.array([-70000, -1, 0, 1, 255, 256, 65535, 70000]) / scale
    field[1, :3] = [3e5 / scale, -3e5 / scale, 65536.0 / scale]
    jax_thumbs.save_thumb(field, scale, str(tmp_path / "jax.png"))
    thumbs.save_thumb(field, scale, str(tmp_path / "port.png"))
    with Image.open(tmp_path / "jax.png") as a, Image.open(tmp_path / "port.png") as b:
        assert a.mode == b.mode and a.size == b.size == (9, 17)
        pa, pb = np.asarray(a), np.asarray(b)
    assert np.array_equal(pa, pb)
    assert np.array_equal(pb, thumbs.thumb_pixels(field, scale).astype(np.int64))
    assert np.array_equal(thumbs.png_pixels(str(tmp_path / "port.png")), pb)
    assert pb[1, 0] == 65535 and pb[1, 1] == 0 and (pb < 65535).any() and (pb > 0).any()
    assert thumbs.thumb_dir_for(str(tmp_path / "set" / "sim_000003")) == \
        jax_thumbs.thumb_dir_for(str(tmp_path / "set" / "sim_000003"))


def _thumb_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(os.path.join(root, "thumb")) for f in files)


def test_karman_gen_thumbs_match_jax(tmp_path):
    argv = ["-r", "8", "-t", "4", "-s", "1", "--re", "100000", "200000", "--thumb"]
    jax_karman_gen.main(["-o", str(tmp_path / "jax"), *argv])
    frames = torch_cli.main(["karman-gen", "-o", str(tmp_path / "port"), *argv, "--device", "cpu"])
    port = _thumb_files(str(tmp_path / "port"))
    assert port == _thumb_files(str(tmp_path / "jax"))
    assert len(port) == frames["thumbs"] == 2 * 2 * 3  # 2 sims x frames 2, 3 x 3 fields
    sc = torch_scene.Scene(str(tmp_path / "port" / "sim_000001"))
    td = thumbs.thumb_dir_for(sc.path)
    u, v = sc.read_staggered("velo", 3)
    for name, field in (("dens", sc.read_centered("dens", 3)[0]), ("velU", u[0]), ("velV", v[0])):
        assert np.array_equal(thumbs.png_pixels(os.path.join(td, f"{name}_000003.png")),
                              thumbs.thumb_pixels(field, 10000.0))


def test_burgers_gen_thumbs_match_jax(tmp_path):
    argv = ["-r", "8", "-t", "3", "-s", "0", "--seed", "3", "--thumb"]
    jax_burgers_gen.main(["-o", str(tmp_path / "jax"), *argv])
    torch_cli.main(["burgers-gen", "-o", str(tmp_path / "port"), *argv, "--device", "cpu"])
    port = _thumb_files(str(tmp_path / "port"))
    assert port == _thumb_files(str(tmp_path / "jax"))
    assert len(port) == 3 * 4  # frames 0, 1, 2 x velU, velV, frcU, frcV
    sc = torch_scene.Scene(str(tmp_path / "port" / "sim_000000"))
    td = thumbs.thumb_dir_for(sc.path)
    fu, fv = sc.read_staggered("forc", 0)
    for name, field in (("frcU", fu[0]), ("frcV", fv[0])):
        assert np.array_equal(thumbs.png_pixels(os.path.join(td, f"{name}_000000.png")),
                              thumbs.thumb_pixels(field, 100000.0))
