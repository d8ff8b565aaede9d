"""Data statistics of the SOL trainers (numpy only).

A copy of `abs_std` from solver_in_the_loop_tpu/utils/stats.py.
"""

from __future__ import annotations

import numpy as np


def abs_std(data: np.ndarray) -> float:
    """std of |data| in float64 — the SOL trainers' normalization statistic
    (reference karman_train.py:236-242)."""
    return float(np.std(np.abs(np.asarray(data, np.float64))))
