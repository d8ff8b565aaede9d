"""Channel-wise data statistics and (de)normalisation (numpy only).

A copy of solver_in_the_loop_tpu/utils/stats.py (per-channel mean, std, min
and max with optional nonzero masking, mean-std standardise and min-max
normalise with their inverses, and the SOL trainers' std of absolute
values) and of the PRE trainer's nonzero-masked channel statistics
(solver_in_the_loop_tpu/apps/pre_train.py `nonzero_channel_mean`,
`nonzero_channel_std`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def channel_stats(data: np.ndarray, nonzero_only: bool = False) -> Dict[str, np.ndarray]:
    """data (N, H, W, C) -> per-channel {'mean', 'std', 'min', 'max'};
    nonzero_only takes mean and std over each channel's nonzero entries."""
    c = data.shape[-1]
    flat = data.reshape(-1, c)
    if nonzero_only:
        mean = np.zeros(c, np.float64)
        std = np.zeros(c, np.float64)
        for i in range(c):
            col = flat[:, i]
            nz = col[col != 0]
            if nz.size == 0:
                mean[i], std[i] = 0.0, 1.0
            else:
                mean[i], std[i] = nz.mean(), nz.std()
    else:
        mean = flat.mean(axis=0)
        std = flat.std(axis=0)
    std = np.where(std == 0, 1.0, std)
    return {
        "mean": mean.astype(np.float32),
        "std": std.astype(np.float32),
        "min": flat.min(axis=0).astype(np.float32),
        "max": flat.max(axis=0).astype(np.float32),
    }


def abs_std(data: np.ndarray) -> float:
    """std of |data| in float64 — the SOL trainers' normalization statistic
    (reference karman_train.py:236-242)."""
    return float(np.std(np.abs(np.asarray(data, np.float64))))


def standardize(data, mean, std):
    return (data - mean) / std


def destandardize(data, mean, std):
    return data * std + mean


def normalize(data, vmin, vmax):
    rng = np.where((vmax - vmin) == 0, 1.0, vmax - vmin)
    return (data - vmin) / rng


def denormalize(data, vmin, vmax):
    return data * (vmax - vmin) + vmin


def stats_dict_to_lists(stats: Dict) -> Dict:
    """JSON-serializable copy (numpy -> lists)."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out[k] = stats_dict_to_lists(v)
        elif isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, (np.floating, np.integer)):
            out[k] = float(v)
        elif isinstance(v, (list, tuple)):
            out[k] = [float(x) if isinstance(x, (np.floating, np.integer)) else x for x in v]
        else:
            out[k] = v
    return out


def nonzero_channel_mean(data: np.ndarray) -> np.ndarray:
    """Mean over each channel's nonzero entries, float32 (0 for a channel
    that is all zero)."""
    out = []
    for i in range(data.shape[-1]):
        col = data[..., i][data[..., i] != 0]
        out.append(float(col.mean()) if col.size else 0.0)
    return np.asarray(out, np.float32)


def nonzero_channel_std(data: np.ndarray) -> np.ndarray:
    """Std over each channel's nonzero entries, float32; a constant (or
    empty) channel gets 1.0, as the JAX package guards a single Reynolds
    number's zero std."""
    out = []
    for i in range(data.shape[-1]):
        col = data[..., i][data[..., i] != 0]
        s = float(col.std()) if col.size else 0.0
        out.append(s if s > 0 else 1.0)
    return np.asarray(out, np.float32)
