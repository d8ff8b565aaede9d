"""Read and write the JAX package's checkpoints (`model.msgpack` +
`dataStats.json`).

The JAX package writes `flax.serialization.to_bytes({"params": params})`:
msgpack maps of maps whose leaves are ndarrays, each a msgpack ext value of
type 1 whose payload is itself a packed (shape, dtype_name, buffer) triple.
This module decodes and encodes that format with its own small msgpack
reader and writer (no flax, no msgpack package) and maps the flax parameter
tree onto the port's modules and back: HWIO conv kernels become OIHW, and
flax's construction-order names (`Conv_0`, `_ResBlock_k/Conv_1`, ...) become
module names. The writer emits the bytes flax's `to_bytes` emits for the same
tree (maps in insertion order, flax's construction order of the modules), so
a checkpoint of the port is one the JAX package reads
(solver_in_the_loop_tpu/train/checkpoint.py:23-73).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Minimal msgpack decoder (the subset flax's serializer emits, plus the
    rest of the scalar types)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode()
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in fixed:
            return fixed[t]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.unpack(scalars[t])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in sizes:
            raw = self.take(self.unpack(sizes[t]))
            return raw if t <= 0xC6 else raw.decode()
        if t in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        ext_sizes = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in ext_sizes:
            n = ext_sizes[t]
        elif t in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
        else:
            raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ext(code: int, payload: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, buf = _Reader(payload).value()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 checkpoint leaves are not supported")
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
    return arr if code == _EXT_NDARRAY else arr[()]


def read_msgpack(path: str) -> Any:
    """Decode a flax msgpack file into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack value")
    return tree


def _flax_names(arch: str, model: nn.Module) -> Dict[str, str]:
    """flax module path -> port module prefix."""
    if arch == "mercury":
        return {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "head"}
    if arch == "mars_moon":
        names = {"Conv_0": "stem", "Conv_1": "head"}
        for k in range(len(model.blocks)):
            names[f"_ResBlock_{k}/Conv_0"] = f"blocks.{k}.conv1"
            names[f"_ResBlock_{k}/Conv_1"] = f"blocks.{k}.conv2"
        return names
    raise KeyError(f"no flax name map for arch '{arch}'")


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flatten(v, path) if isinstance(v, dict) else {path: v})
    return out


def params_from_jax(params: dict, arch: str, model: nn.Module) -> Dict[str, torch.Tensor]:
    """flax params (the dict holding `Conv_0`, ...) -> the model's state_dict.
    Conv kernels are HWIO in flax and OIHW in PyTorch."""
    names = _flax_names(arch, model)
    flat = _flatten(params)
    state = {}
    for path, arr in flat.items():
        module_path, leaf = path.rsplit("/", 1)
        if module_path not in names or leaf not in ("kernel", "bias"):
            raise KeyError(f"unexpected checkpoint leaf '{path}' for arch '{arch}'")
        arr = np.asarray(arr, np.float32)
        if leaf == "kernel":
            state[f"{names[module_path]}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        else:
            state[f"{names[module_path]}.bias"] = torch.from_numpy(arr.copy())
    return state


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def params_to_jax(model: nn.Module, arch: str) -> dict:
    """The model's parameters as the flax params dict (`Conv_0`, ...): the
    inverse of params_from_jax, OIHW kernels back to HWIO, float32 numpy."""
    prefix_to_flax = {v: k for k, v in _flax_names(arch, model).items()}
    flat = {}
    for name, t in model.state_dict().items():
        prefix, leaf = name.rsplit(".", 1)
        arr = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            flat[f"{prefix_to_flax[prefix]}/kernel"] = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        else:
            flat[f"{prefix_to_flax[prefix]}/bias"] = arr
    return _nest(flat)


def _pack_len(out: bytearray, n: int, fix_base: Optional[int], fix_max: int, codes) -> None:
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
    elif n <= 0xFF and codes[0] is not None:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack(obj: Any, out: bytearray) -> None:
    """msgpack encoding of the subset flax's serializer emits (use_bin_type)."""
    if isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for key in obj:
            _pack(key, out)
            _pack(obj[key], out)
    elif isinstance(obj, np.ndarray):
        payload = bytearray()
        _pack((tuple(obj.shape), obj.dtype.name, obj.tobytes("C")), payload)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += payload
    elif isinstance(obj, (tuple, list)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, str):
        raw = obj.encode()
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, bool) or not isinstance(obj, int) or not 0 <= obj < 2 ** 32:
        raise TypeError(f"cannot pack {type(obj).__name__} {obj!r}")
    elif obj <= 0x7F:
        out.append(obj)
    else:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 2 ** 32)):
            if obj <= top:
                out.append(code)
                out += struct.pack(fmt, obj)
                break


def pack_msgpack(tree: Any) -> bytes:
    """flax.serialization.msgpack_serialize of a tree of dicts and ndarrays."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def save_checkpoint(ckpt_dir: str, model: nn.Module, arch: str,
                    epoch: Optional[int] = None) -> str:
    """Write the model's parameters as the JAX package's `model.msgpack`
    (`model_epoch%04d.msgpack` for an epoch), readable by both packages'
    karman-apply. The optimizer state is not written (its resume is not
    ported)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = "model.msgpack" if epoch is None else f"model_epoch{epoch:04d}.msgpack"
    path = os.path.join(ckpt_dir, name)
    with open(path, "wb") as f:
        f.write(pack_msgpack({"params": {"params": params_to_jax(model, arch)}}))
    return path


def save_stats(ckpt_dir: str, stats: Dict) -> None:
    """dataStats.json, written at train start (reference karman_train.py:474)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "dataStats.json"), "w") as f:
        json.dump(stats, f, indent=1)


def load_stats(ckpt_dir: str) -> Dict:
    with open(os.path.join(ckpt_dir, "dataStats.json")) as f:
        return json.load(f)


def load_model_weights(model: nn.Module, path: str, arch: str) -> nn.Module:
    """Load a JAX `model.msgpack` into `model` (every parameter must match)."""
    tree = read_msgpack(path)
    model.load_state_dict(params_from_jax(tree["params"]["params"], arch, model), strict=True)
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
