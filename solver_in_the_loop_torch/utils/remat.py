"""Rematerialisation of an unrolled train step, its saved outputs named at
their call sites.

The port of the JAX package's `jax.checkpoint` with a names policy
(`save_only_these_names`): the ops a policy saves decide at their own call
sites whether their output is kept, and no other op of the step is looked at.
A call site is `site(op, *args)`, `op` an OpOverload (the pressure solve in
ops/poisson.py, the tap-sum in ops/interp.py, the convolutions in
models/networks.py).

`checkpoint(step, saves, params, *args)` runs `step(*args)` as one autograd
node:

* forward: the step under no_grad with a tape recording; each site whose op
  is in `saves` runs the op and keeps its output. The node keeps the step's
  inputs and the tape, nothing else.
* backward: the step re-run with grad enabled, inside a
  `silt.train.recompute` span, with the tape replaying; each saved site
  hands back its taped output without running its op, attached to autograd
  by a node whose backward is the op's own formula (`register`); then the
  gradient of the step's outputs into its inputs and `params`
  (`torch.autograd.grad`).

A replay that meets another op than the taped one, or tensors of another
shape or dtype, raises; so does a replay that leaves a taped output unused.
With no tape open on the thread (no remat step running: a rollout,
--no-remat, the PRE trainer) a site is one attribute test and the op.

Counters: `remat.taped` and `remat.replayed`, the sites one step taped and
replayed, once a step.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Sequence

import torch

from solver_in_the_loop_torch.utils import profiling


class _Local(threading.local):
    tape = None  # the Tape open on this thread


_local = _Local()

# op -> (setup_context, backward) of a replayed site's node
_FORMULAS: dict = {}


def register(op, setup: Callable, backward: Callable) -> None:
    """The autograd formula a replayed site of `op` runs, in the form of
    `register_autograd`: `setup(ctx, inputs, output)`, `backward(ctx,
    *grads)` returning a gradient (or None) per input."""
    _FORMULAS[op] = (setup, backward)


def _signature(args) -> tuple:
    return tuple((a.shape, a.dtype) for a in args if isinstance(a, torch.Tensor))


def _detached(out):
    return tuple(t.detach() for t in out) if isinstance(out, tuple) else out.detach()


class _Tape:
    """The saved sites' outputs of one unrolled step, in call order."""

    __slots__ = ("saves", "entries", "replaying", "taken")

    def __init__(self, saves: frozenset):
        self.saves, self.entries, self.replaying, self.taken = saves, [], False, 0

    @contextlib.contextmanager
    def open(self, replaying: bool):
        """Open the tape on this thread, recording or replaying from its start."""
        if _local.tape is not None:
            raise RuntimeError("a remat tape is already open on this thread")
        self.replaying, self.taken = replaying, 0
        _local.tape = self
        try:
            yield self
        finally:
            _local.tape = None

    def record(self, op, args):
        out = op(*args)
        # an alias: the step may return this very tensor (the solve's), and the
        # step's node and the replayed node each set a grad_fn on what they return
        self.entries.append((op, _signature(args), _detached(out)))
        return out

    def replay(self, op, args):
        k = self.taken
        if k == len(self.entries):
            raise RuntimeError(f"remat replay: {op} at site {k}, but {k} sites were taped")
        taped, signature, out = self.entries[k]
        if taped is not op:
            raise RuntimeError(f"remat replay: {op} at site {k}, where {taped} was taped")
        if _signature(args) != signature:
            raise RuntimeError(f"remat replay: {op} at site {k} takes {_signature(args)}, "
                               f"taped with {signature}")
        self.taken = k + 1
        setup, backward = _FORMULAS[op]
        return _Replayed.apply(*args, (out, setup, backward))


def site(op, *args):
    """`op(*args)`, its output taped (recording) or taken from the tape
    (replaying) where a remat step's tape is open on this thread and its
    policy saves `op`."""
    tape = _local.tape
    if tape is None or op not in tape.saves:
        return op(*args)
    return tape.replay(op, args) if tape.replaying else tape.record(op, args)


class _Replayed(torch.autograd.Function):
    """A taped output handed back as its op's output, with the op's own
    formula as backward. The last input carries (output, setup, backward),
    as the node torch.library makes for a custom op carries its metadata
    last; the formula sees the op's inputs alone."""

    @staticmethod
    def forward(ctx, *args):
        *inputs, (out, setup, backward) = args
        setup(ctx, tuple(inputs), out)
        ctx.formula = backward
        return out

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad
        ctx.needs_input_grad = needs[:-1]
        try:
            result = ctx.formula(ctx, *grads)
        finally:
            ctx.needs_input_grad = needs
        return (*result, None) if isinstance(result, tuple) else (result, None)


class _Step(torch.autograd.Function):
    """One unrolled step as one node (see the module doc). Inputs: the step,
    the saved ops, the number of the step's arguments, its arguments and
    the parameters it reads."""

    @staticmethod
    def forward(ctx, step, saves, nargs, *inputs):
        ctx.set_materialize_grads(False)
        tape = _Tape(saves)
        with tape.open(replaying=False):
            out = step(*inputs[:nargs])
        profiling.count("remat.taped", len(tape.entries))
        ctx.step, ctx.tape, ctx.params = step, tape, inputs[nargs:]
        ctx.save_for_backward(*inputs[:nargs])
        return out

    @staticmethod
    def backward(ctx, *grads):
        tape, ctx.tape = ctx.tape, None  # its outputs live on in the replayed nodes alone
        if tape is None:
            raise RuntimeError("a remat step's backward runs once (no retain_graph)")
        args = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        with profiling.span("silt.train.recompute"), torch.enable_grad(), \
                tape.open(replaying=True):
            out = ctx.step(*args)
        if tape.taken != len(tape.entries):
            raise RuntimeError(f"remat replay used {tape.taken} of {len(tape.entries)} taped "
                               "sites")
        profiling.count("remat.replayed", tape.taken)
        pairs = [(o, g) for o, g in zip(out, grads) if g is not None and o.requires_grad]
        wrt = [t for t in (*args, *ctx.params) if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True) if pairs else [None] * len(wrt))
        return (None, None, None) + tuple(next(got) if t.requires_grad else None
                                          for t in (*args, *ctx.params))


def checkpoint(step: Callable, saves: frozenset, params: Sequence[torch.Tensor], *args):
    """`step(*args)` as one remat node that keeps the outputs of the sites
    whose op is in `saves`; `params` are the parameters the step reads."""
    return _Step.apply(step, saves, len(args), *args, *params)
