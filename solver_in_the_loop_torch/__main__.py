"""CLI of the PyTorch port.

    python -m solver_in_the_loop_torch <command> [args...]

The port covers the karman and Burgers data generation, training, serving
and evaluation paths so far; the PRE commands of `python -m
solver_in_the_loop_tpu` follow as their slices are ported.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "karman-gen": ("solver_in_the_loop_torch.apps.karman_gen", "karman data generation"),
    "karman-apply": ("solver_in_the_loop_torch.apps.karman_apply", "karman test rollout"),
    "karman-train": ("solver_in_the_loop_torch.apps.karman_train", "karman SOL/NON training"),
    "burgers-gen": ("solver_in_the_loop_torch.apps.burgers_gen", "burgers data generation"),
    "burgers-train": ("solver_in_the_loop_torch.apps.burgers_train", "burgers SOL/NON training"),
    "burgers-apply": ("solver_in_the_loop_torch.apps.burgers_apply", "burgers test rollout"),
    "evaluate": ("solver_in_the_loop_torch.apps.evaluate", "rollout MAE vs hi-res reference"),
}


def main(argv=None):
    """Run one command; returns what the command's main returns (the apply
    commands and karman-gen: their frames; the train commands: their
    TrainResult; burgers-gen: its Scene; evaluate: its JSON line as a dict),
    0 for --help and 2 for an unknown
    command."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        for name, (_mod, desc) in COMMANDS.items():
            print(f"  {name:20s} {desc}")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command '{cmd}'; run with --help", file=sys.stderr)
        return 2
    return importlib.import_module(COMMANDS[cmd][0]).main(rest)


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
