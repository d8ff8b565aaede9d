"""The benchmark's inputs, made or loaded here and handed the same to the
program and to the reference: the frozen karman set, the frozen
checkpoints (with this file's own msgpack reader), the Burgers sets made
from the seed, and the seeded orders in which a run visits them.
"""

from __future__ import annotations

import hashlib
import json
import lzma
import math
import random
import struct
from pathlib import Path
from typing import Dict, Iterator

import numpy as np
import torch

from silt_bench.reference.fluid import Burgers

DATA = Path(__file__).resolve().parent / "data"


# ------------------------------------------------------------ frozen files

def karman_set() -> Dict[str, np.ndarray]:
    """The frozen karman training set: dens (S, F, Y, X), u, v and re (S,).
    Each field is stored as its float32 bit patterns, differenced along the
    frames (modulo 2^32), split into byte planes and xz-compressed; the
    sha256 of each decoded field is checked against karman_set.json."""
    meta = json.loads((DATA / "karman_set.json").read_text())
    out = {"re": np.asarray(meta["re"], np.float32)}
    for name, spec in meta["fields"].items():
        planes = np.frombuffer(lzma.decompress((DATA / f"karman_set.{name}.xz").read_bytes()),
                               np.uint8).reshape(4, -1)
        delta = np.ascontiguousarray(planes.T).view("<u4").reshape(spec["shape"])
        field = np.cumsum(delta, axis=1, dtype=np.uint32).view("<f4")
        if hashlib.sha256(field.tobytes()).hexdigest() != spec["sha256"]:
            raise ValueError(f"karman_set.{name}.xz does not decode to the frozen field")
        out[name] = field
    return out


class _Msgpack:
    """The subset of msgpack that flax's `to_bytes` writes: maps, strings,
    bytes, integers, arrays and ndarrays as ext type 1 holding a packed
    (shape, dtype name, buffer) triple."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode()
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                0xD2: ">i", 0xD3: ">q"}
        if t in ints:
            return self.unpack(ints[t])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in sized:
            raw = self.take(self.unpack(sized[t]))
            return raw if t <= 0xC6 else raw.decode()
        if t in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            if self.unpack(">b") != 1:
                raise ValueError("unsupported msgpack ext type")
            shape, dtype, buf = _Msgpack(self.take(n)).value()
            return np.frombuffer(buf, np.dtype(dtype)).reshape(shape)
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        return {self.value(): self.value() for _ in range(n)}


def checkpoint(name: str, blocks: int) -> Dict[str, torch.Tensor]:
    """A frozen MarsMoon checkpoint (flax's HWIO `Conv_0`, `_ResBlock_k/Conv_j`,
    `Conv_1`) as float32 OIHW tensors keyed as the program's modules are."""
    tree = _Msgpack((DATA / f"{name}.msgpack").read_bytes()).value()["params"]["params"]
    names = {"Conv_0": "stem", "Conv_1": "head"}
    for k in range(blocks):
        names[f"_ResBlock_{k}"] = f"blocks.{k}"
    out = {}
    for flax_name, module in tree.items():
        subs = {"": module} if "kernel" in module else {f".conv{int(j[-1]) + 1}": m
                                                        for j, m in module.items()}
        for suffix, leaf in subs.items():
            key = names[flax_name] + suffix
            out[f"{key}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(leaf["kernel"], np.float32).transpose(3, 2, 0, 1)))
            out[f"{key}.bias"] = torch.from_numpy(np.asarray(leaf["bias"], np.float32).copy())
    return out


def stats(name: str) -> dict:
    return json.loads((DATA / f"{name}.stats.json").read_text())


# ------------------------------------------------------------ seeded orders

def epoch_rows(num_sims: int, num_frames: int, batch: int, msteps: int,
               seed: int) -> Iterator[np.ndarray]:
    """Training index rows (B, 2) of (sim, frame0), epoch after epoch: each
    epoch shuffles every pair with frame0 < F - msteps (Python's
    random.Random(seed)) and deals them into rows of B, as the program's
    trainer schedules an epoch."""
    rng = random.Random(seed)
    steps = num_frames - msteps
    while True:
        pairs = [(s, f) for s in range(num_sims) for f in range(steps)]
        rng.shuffle(pairs)
        grid = np.asarray(pairs, np.int64).reshape(num_sims, steps, 2)
        for ib in range(num_sims // batch):
            yield from np.transpose(grid[ib * batch:(ib + 1) * batch], (1, 0, 2))


def sub_seeds(seed: int, n: int) -> np.ndarray:
    """n 32-bit seeds drawn from any whole number."""
    return np.random.SeedSequence(abs(int(seed))).generate_state(n)


def cycled(n: int, seed: int) -> Iterator[int]:
    """0..n-1 in a new seeded order every n draws, so that every seed visits
    each item equally often."""
    rng = np.random.default_rng(sub_seeds(seed, 1)[0])
    while True:
        yield from (int(k) for k in rng.permutation(n))


# ---------------------------------------------------------------- Burgers

def _randfreq(rng: np.random.RandomState, shape, power: int = 8) -> np.ndarray:
    """A smooth random field: a complex gaussian spectrum shaped by
    (1/(|k|+1))^power * power * sqrt(mean(res)), inverse-FFT'd."""
    _, h, w = shape
    fft = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    k = np.sqrt(np.fft.fftfreq(h)[:, None] ** 2 + np.fft.fftfreq(w)[None, :] ** 2)
    fft = fft * ((1.0 / (k + 1.0)) ** power * power * math.sqrt(0.5 * (h + w)))[None]
    return np.real(np.fft.ifft2(fft, axes=(-2, -1))).astype(np.float32)


def _downsample(u, v, factor: int):
    """MAC downsampling: every second face along the normal, the mean of two
    along the tangent, repeated."""
    while factor > 1:
        u = 0.5 * (u[..., 0::2, ::2] + u[..., 1::2, ::2])
        v = 0.5 * (v[..., ::2, 0::2] + v[..., ::2, 1::2])
        factor //= 2
    return u, v


class _Forces:
    """Sums of `n` sine forces per sim, amplitude_c sin(k.x + phase + t dt
    omega), drawn as `burgers-gen` draws them: angle, |k|, amplitudes,
    phase and omega per force, in that order."""

    def __init__(self, rngs, n: int, res: int, length: float, device):
        draws = []
        for rng in rngs:
            sim = []
            for _ in range(n):
                angle = rng.random_sample() * np.pi
                mag = (rng.random_sample() + 1.0) * 0.8
                amp = (rng.random_sample(2) - 0.5) * 0.3
                sim.append([mag * np.sin(angle), mag * np.cos(angle), amp[0], amp[1],
                            rng.random_sample() * 2 * np.pi, rng.random_sample() * 0.8 - 0.4])
            draws.append(sim)
        p = torch.tensor(np.asarray(draws, np.float32), device=device)  # (B, n, 6)
        self.ky, self.kx, self.amp_v, self.amp_u, self.phase, self.omega = (
            p[..., i, None, None] for i in range(6))
        dx = length / res
        ys = (torch.arange(res, device=device) + 0.5) * dx
        xs = torch.arange(res + 1, device=device) * dx
        self.u_pos = torch.meshgrid(ys, xs, indexing="ij")
        self.v_pos = torch.meshgrid(torch.arange(res + 1, device=device) * dx,
                                    (torch.arange(res, device=device) + 0.5) * dx, indexing="ij")

    def at(self, t: int, dt: float):
        ph = self.phase + dt * self.omega * t
        fu = (self.amp_u * torch.sin(self.ky * self.u_pos[0] + self.kx * self.u_pos[1] + ph)).sum(1)
        fv = (self.amp_v * torch.sin(self.ky * self.v_pos[0] + self.kx * self.v_pos[1] + ph)).sum(1)
        return fu, fv


@torch.no_grad()
def burgers_sims(seeds, cfg: dict, frames: int, device) -> Dict[str, torch.Tensor]:
    """Hi-res forced Burgers runs (the Makefile's `burgers-gen -r 128 -l 32
    --dt 0.1 -s 30`), one per seed, all in one batch, with the benchmark's
    plain solver (gather advection, as the generator advects): frame f is
    the velocity after skip + f steps and the force of the step after it,
    both downsampled to cfg's resolution. Returns u, v, fu, fv (S, F, ...)."""
    gen = cfg["generator"]
    res, scale, dt = gen["res"], cfg["scale"], cfg["dt"]
    rngs = [np.random.RandomState(int(s)) for s in seeds]
    forces = _Forces(rngs, gen["forces"], res, cfg["len"], device)
    # the reference's call order: forces first, then the initial field (v, then u)
    v_list, u_list = [], []
    for r in rngs:
        v_list.append(_randfreq(r, (1, res + 1, res))[0] * 2.0)
        u_list.append(_randfreq(r, (1, res, res + 1))[0] * 2.0)
    u = torch.tensor(np.stack(u_list), device=device)
    v = torch.tensor(np.stack(v_list), device=device)
    flow = Burgers(res, cfg["len"], max_shift=0)
    out = {k: [] for k in ("u", "v", "fu", "fv")}
    skip = gen["skip"]
    for t in range(skip + frames - 1):
        fu, fv = forces.at(t, dt)
        u, v = flow.step(u, v, fu, fv, dt, advection="gather")
        if t + 1 >= skip:
            nu, nv = forces.at(t + 1, dt)
            for key, (a, b) in (("u", (u, v)), ("fu", (nu, nv))):
                lo = _downsample(a, b, scale)
                out[key].append(lo[0])
                out["v" if key == "u" else "fv"].append(lo[1])
    return {k: torch.stack(vals, dim=1).contiguous() for k, vals in out.items()}
