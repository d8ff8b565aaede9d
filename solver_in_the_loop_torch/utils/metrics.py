"""Training metrics and logging set-up.

Port of solver_in_the_loop_tpu/utils/metrics.py: a JSONL scalar writer
(`metrics.jsonl` in the output directory), plus TensorBoard event files when
`torch.utils.tensorboard` can be imported, and the CLI's logging handlers.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

log = logging.getLogger(__name__)


class MetricsWriter:
    def __init__(self, out_dir: str, tensorboard: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self._f = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                log.info("tensorboard writer unavailable; JSONL only")
            else:
                self._tb = SummaryWriter(os.path.join(out_dir, "summary", "training"))

    def scalar(self, name: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"t": time.time(), "step": step, name: value}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)

    def flush(self) -> None:
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def setup_logging(log_file: Optional[str] = None, resume: int = -1) -> None:
    """stderr plus an optional file handler; a resumed run's file gets a
    _resume%04d suffix (reference karman_train.py:59-64)."""
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        root.addHandler(logging.StreamHandler())
    if log_file:
        if resume > 0:
            base, ext = os.path.splitext(log_file)
            log_file = f"{base}_resume{resume:04d}{ext}"
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        root.addHandler(logging.FileHandler(log_file))
