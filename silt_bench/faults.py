"""Faults planted in the program, for the check's own tests and for the
readings its limits are set from: each breaks the timed path in a way the
check has to see.

A train fault takes the program (systems/<system>.py `Program`) and breaks
it in place; an apply fault takes a rollout's frames as the program made
them and returns them broken.
"""

from __future__ import annotations

import torch

ALTERATION = 1e-2  # the relative change of an altered answer


def train_stale(program) -> None:
    """The optimizer step returns the state unchanged (and says it applied)."""
    program.optimizer.step = lambda: True


def train_half_batch(program) -> None:
    """Half of each batch left out, the loss taken as the mean over the rest
    (its rows weighted B / kept)."""
    step = program.train_step

    def half(rows, wgt=None):
        keep = (len(rows) + 1) // 2
        return step(rows[:keep], torch.full((keep,), len(rows) / keep, device=program.device))

    program.train_step = half


def train_altered(program) -> None:
    """The net's correction altered where it is produced."""
    forward = program.model.forward
    program.model.forward = lambda x: forward(x) * (1.0 + ALTERATION)


def _copy(frames):
    return {k: v.clone() for k, v in frames.items()}


def apply_stale(frames):
    """The middle step returns its state unchanged."""
    out, k = _copy(frames), frames["u"].shape[0] // 2
    for key in ("dens", "u", "v"):
        if key in out:
            out[key][k] = out[key][k - 1]
    return out


def apply_altered(frames):
    """The middle step's velocity altered where it is produced."""
    out, k = _copy(frames), frames["u"].shape[0] // 2
    out["u"][k] *= 1.0 + ALTERATION
    return out


FAULTS = {"train": {"stale": train_stale, "half_batch": train_half_batch,
                    "altered": train_altered},
          "apply": {"stale": apply_stale, "altered": apply_altered}}
