"""CLI of the PyTorch port.

    python -m solver_in_the_loop_torch <command> [args...]

Every command of `python -m solver_in_the_loop_tpu`, with its flags: the
karman and Burgers data generation, training, serving and evaluation paths
and the PRE workflow (data generation, supervised training and rollouts).
`karman-pre-train` and `burgers-pre-train` run the same module with the
scenario the command names. `karman-train --dp` and `burgers-train --dp`
train data-parallel over the ranks that

    python -m torch.distributed.run --nproc-per-node N -m solver_in_the_loop_torch ...

starts (one process, a group of one, without the launcher).
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "karman-gen": ("solver_in_the_loop_torch.apps.karman_gen", "karman data generation"),
    "karman-train": ("solver_in_the_loop_torch.apps.karman_train", "karman SOL/NON training"),
    "karman-apply": ("solver_in_the_loop_torch.apps.karman_apply", "karman test rollout"),
    "karman-pre-gen": ("solver_in_the_loop_torch.apps.karman_pre_gen",
                       "karman PRE data generation"),
    "karman-pre-train": ("solver_in_the_loop_torch.apps.pre_train",
                         "karman PRE supervised training"),
    "karman-pre-apply": ("solver_in_the_loop_torch.apps.karman_pre_apply", "karman PRE rollout"),
    "burgers-gen": ("solver_in_the_loop_torch.apps.burgers_gen", "burgers data generation"),
    "burgers-train": ("solver_in_the_loop_torch.apps.burgers_train", "burgers SOL/NON training"),
    "burgers-apply": ("solver_in_the_loop_torch.apps.burgers_apply", "burgers test rollout"),
    "burgers-pre-gen": ("solver_in_the_loop_torch.apps.burgers_pre_gen",
                        "burgers PRE data generation"),
    "burgers-pre-train": ("solver_in_the_loop_torch.apps.pre_train",
                          "burgers PRE supervised training"),
    "burgers-pre-apply": ("solver_in_the_loop_torch.apps.burgers_pre_apply",
                          "burgers PRE rollout"),
    "evaluate": ("solver_in_the_loop_torch.apps.evaluate", "rollout MAE vs hi-res reference"),
}


def main(argv=None):
    """Run one command; returns what the command's main returns (the apply
    commands and karman-gen: their frames; the train commands: their
    TrainResult; burgers-gen: its Scene; the PRE commands: their result
    dicts; evaluate: its JSON line as a dict), 0 for --help and 2 for an
    unknown command."""
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
    mod = importlib.import_module(COMMANDS[cmd][0])
    if cmd in ("karman-pre-train", "burgers-pre-train"):
        return mod.main(rest, scenario=cmd.split("-")[0])
    return mod.main(rest)


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
