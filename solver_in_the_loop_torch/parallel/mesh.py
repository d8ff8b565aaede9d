"""Process groups, the data-parallel layout and row exchanges over torch.distributed.

Counterpart of solver_in_the_loop_tpu/parallel/mesh.py. The JAX package puts
the devices of one process in a `jax.sharding.Mesh` with a 'data' axis and
lets XLA's partitioner insert the gradient psum. A PyTorch program runs one
process per rank, joined in a process group, and says where data moves:

* `data_parallel_mesh` forms or joins the group (JAX: `data_parallel_mesh`,
  a Mesh over every device) and returns a `Mesh` with the group's size, this
  process's rank and its device;
* `batch_rows` is the layout of `batch_sharding`, P('data') on the leading
  axis: rank r holds contiguous rows [r*b, (r+1)*b) of a batch of size*b
  (`shard_batch` is taking them), and `padded_batch` the JAX trainer's
  padding of a batch the ranks do not divide;
* `replicate` is the replicated sharding's `device_put`: a broadcast from
  rank 0, in place;
* `all_reduce_sum` is the psum that XLA inserts for a gradient or a loss;
* `move_rows` is the collective the SPMD partitioner inserts around a
  y-sharded stencil (parallel/spatial.py): each rank receives the rows it
  asks for from the ranks that hold them, and the gradient flows back to the
  owners, summed where several ranks asked for the same row.

The backend follows the topology: NCCL where every rank has a card of its
own, gloo on the CPU and where ranks share a card (a world larger than
`torch.cuda.device_count()`; NCCL refuses two ranks on one device). Gloo
moves a CUDA tensor through host memory, so such runs check correctness,
not speed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Rows = Tuple[int, int]  # global rows [lo, hi) of a row-partitioned field


@dataclasses.dataclass
class Mesh:
    """One process's place in the group: `size` ranks, this one `rank`, its
    `device`, the group's `backend`; `owns_group` when `data_parallel_mesh`
    formed the group, which `close` then destroys."""

    size: int
    rank: int
    device: torch.device
    backend: str
    owns_group: bool = False

    @property
    def is_main(self) -> bool:
        """Rank 0, the one rank that writes files."""
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier()

    def close(self) -> None:
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def _backend(device_type: str, world: int) -> str:
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def data_parallel_mesh(device: str = "cuda") -> Mesh:
    """Form or join the process group and return this rank's `Mesh`.

    A group already formed in this process is joined as it is. Else, under a
    launcher (`python -m torch.distributed.run`, which sets WORLD_SIZE, RANK,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT) the process joins the
    launcher's group; without one it forms a group of one. `device` ("cuda"
    or "cpu") is the device type of the ranks: a CUDA rank takes card
    LOCAL_RANK, modulo the cards there are, where ranks share them."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    owns = not dist.is_initialized()
    if owns:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        backend = _backend(device, world)
        kw = {}
        if device == "cuda":
            card = int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
            torch.cuda.set_device(card)
            if backend == "nccl":
                kw["device_id"] = torch.device("cuda", card)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://", **kw)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    size, rank = dist.get_world_size(), dist.get_rank()
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", str(rank)))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    else:
        dev = torch.device("cpu")
    return Mesh(size, rank, dev, dist.get_backend(), owns)


def _staged(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor a collective of this group takes for `t`: gloo's point to
    point calls take host tensors only, so a CUDA tensor goes through a host
    copy there."""
    return t.cpu() if (mesh.backend == "gloo" and t.is_cuda) else t


def all_reduce_(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce `t` in place over the group; returns it."""
    buf = _staged(t, mesh)
    dist.all_reduce(buf, op=op)
    if buf is not t:
        t.copy_(buf)
    return t


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The sums over the group of same-device tensors, in one flat
    all-reduce; new tensors of the given shapes."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    all_reduce_(flat, mesh)
    return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Broadcast each tensor from rank 0 to every rank, in place."""
    for t in tensors:
        dst = t.detach()
        buf = _staged(dst, mesh)
        dist.broadcast(buf, src=0)
        if buf is not dst:
            dst.copy_(buf)


def batch_rows(mesh: Mesh, batch: int) -> slice:
    """This rank's contiguous rows of a batch that the group's size divides."""
    if batch % mesh.size != 0:
        raise ValueError(f"batch {batch} is not divisible by the group's {mesh.size} ranks")
    per = batch // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def padded_batch(idx: np.ndarray, pad_to: Optional[int]):
    """The JAX trainer's padding of an iteration's (B, 2) index rows to
    `pad_to` rows: copies of row 0 after them, and the weights, ones then
    zeros (None without padding). The loss and gradient of the padded batch
    equal the unpadded one's; the padded rows' compute is wasted."""
    if pad_to is None:
        return idx, None
    extra = pad_to - idx.shape[0]
    wgt = np.concatenate([np.ones(idx.shape[0], np.float32), np.zeros(extra, np.float32)])
    return np.concatenate([idx, np.repeat(idx[:1], extra, axis=0)], 0), wgt


def _move(x: torch.Tensor, have: Sequence[Rows], want: Sequence[Rows], mesh: Mesh,
          accumulate: bool) -> torch.Tensor:
    """Rows of a field whose rank q holds global rows have[q] (x: this rank's,
    axis 1) to a (B, want[r] rows, ...) tensor on this rank r. Without
    `accumulate` every wanted row is held once; with it the received rows
    are summed (the adjoint, where several ranks held one row)."""
    r = mesh.rank
    lo, hi = want[r]
    out = x.new_zeros((x.shape[0], hi - lo) + tuple(x.shape[2:]))
    pending, received = [], []
    for q in range(mesh.size):
        a, b = max(have[r][0], want[q][0]), min(have[r][1], want[q][1])
        if a < b:
            piece = x[:, a - have[r][0]:b - have[r][0]]
            if q == r:
                if accumulate:
                    out[:, a - lo:b - lo] += piece
                else:
                    out[:, a - lo:b - lo] = piece
            else:
                buf = _staged(piece.contiguous(), mesh)
                pending.append((dist.isend(buf, q), buf))
        if q == r:
            continue
        a, b = max(have[q][0], lo), min(have[q][1], hi)
        if a < b:
            buf = torch.empty((x.shape[0], b - a) + tuple(x.shape[2:]), dtype=x.dtype,
                              device="cpu" if mesh.backend == "gloo" else x.device)
            pending.append((dist.irecv(buf, q), buf))
            received.append((a, b, buf))
    for req, _ in pending:
        req.wait()
    for a, b, buf in received:
        if accumulate:
            out[:, a - lo:b - lo] += buf.to(x.device)
        else:
            out[:, a - lo:b - lo] = buf.to(x.device)
    return out


class _MoveRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, have, want, mesh):
        ctx.have, ctx.want, ctx.mesh, ctx.rows = have, want, mesh, x.shape[1]
        return _move(x, have, want, mesh, accumulate=False)

    @staticmethod
    def backward(ctx, g):
        gx = _move(g.contiguous(), ctx.want, ctx.have, ctx.mesh, accumulate=True)
        # rows of x beyond its have range (a padded block's tail) get none
        pad = [0, 0] * (gx.dim() - 2) + [0, ctx.rows - gx.shape[1]]
        return torch.nn.functional.pad(gx, pad), None, None, None


def move_rows(x: torch.Tensor, have: Sequence[Rows], want: Sequence[Rows],
              mesh: Mesh) -> torch.Tensor:
    """Differentiable row exchange: rank q holds global rows have[q] of a
    field along axis 1 (x: this rank's) and gets global rows want[q]. Every
    rank passes the same lists. Each wanted row must be held by one rank;
    the rows of a have range beyond the field's (a padded block's tail) are
    never sent. The gradient of a row goes back to its holder, summed over
    the ranks that received it."""
    for q, (lo, hi) in enumerate(want):
        held = sum(max(0, min(h[1], hi) - max(h[0], lo)) for h in have)
        if held != hi - lo:
            raise ValueError(f"move_rows: rank {q} wants rows [{lo}, {hi}), of which "
                             f"{held} are held once (have {list(have)})")
    return _MoveRows.apply(x, tuple(have), tuple(want), mesh)
