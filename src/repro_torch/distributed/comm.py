"""The collectives of the sharded steps, and the bytes each one moves.

GSPMD inserts the reference's collectives from its shardings; the port
keeps every tensor a plain local tensor and calls these explicitly.  Each
takes a process group (``Mesh.group(axes)``); a group of None is this rank
alone and the call does nothing (so a mesh of size 1 runs without any
process group).

Plain collectives (no autograd): :func:`all_reduce` (sum, max or mean)
and :func:`all_gather` (along a dim).  In a model forward
each tensor is either *replicated* over the ``model`` axis (the same value
and the same gradient on every model rank) or *local* (each rank its own);
three autograd functions move between the two, as Megatron's regions do:

* :func:`enter` - replicated -> local: identity forward, its gradient
  summed over the group (the input of a column-split matmul or of a
  rank-specific slice);
* :func:`sum_partials` - local partial sums -> replicated: all-reduce
  forward, identity backward (a row-split matmul, a vocab-split gather);
* :func:`gather` - local shards of a dim -> replicated: all-gather
  forward, this rank's slice of the gradient backward.

Gloo takes ``all_reduce`` and ``all_gather`` on CUDA tensors.
``COUNTS`` holds, per collective, the calls, the tensors' bytes
(``payload``: the reduced tensor, or this rank's part of a gather) and
the bytes this rank moved (``wire``: ``2 (n - 1) / n`` of the tensor for
a ring all-reduce, ``n - 1`` parts received for an all-gather).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist


@dataclass
class Count:
    calls: int = 0
    payload: int = 0
    wire: float = 0.0


COUNTS: Dict[str, Count] = {}
# called as ``TALLY(op, payload, wire)`` beside each count where set (the
# dry run's per-call-site tally, ``launch/step_analysis.py``)
TALLY: Optional[Callable[[str, int, float], None]] = None


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> Dict[str, Dict[str, float]]:
    return {k: {"calls": c.calls, "payload_bytes": c.payload, "wire_bytes": c.wire}
            for k, c in COUNTS.items()}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _count(op: str, payload: int, wire: float) -> None:
    c = COUNTS.setdefault(op, Count())
    c.calls += 1
    c.payload += payload
    c.wire += wire
    if TALLY is not None:
        TALLY(op, payload, wire)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` (``op`` sum, max or
    mean; mean divides the sum by the group's size)."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    out = x.detach().clone()
    dist.all_reduce(out, op=_OPS["sum" if op == "mean" else op], group=group)
    _count("all_reduce", _nbytes(out), 2 * (n - 1) / n * _nbytes(out))
    return out / n if op == "mean" else out


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    _count("all_gather", _nbytes(x), (n - 1) * _nbytes(x))
    return out


def rank_in(group) -> int:
    return 0 if group is None else dist.get_group_rank(group, dist.get_rank())


# ---------------------------------------------------------------------------
# autograd regions
# ---------------------------------------------------------------------------
class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        start = rank_in(ctx.group) * ctx.size
        return g.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """Replicated -> local: ``x`` itself forward, the gradient summed over
    ``group``."""
    if group_size(group) == 1:
        return x
    return _Enter.apply(x, group)


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """Local partial sums -> their replicated sum (gradient passed as is)."""
    if group_size(group) == 1:
        return x
    return _SumPartials.apply(x, group)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Local shards along ``dim`` -> the replicated whole (gradient: this
    rank's slice)."""
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, group, dim % x.ndim)


class _MeanPassGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group, "mean")

    @staticmethod
    def backward(ctx, g):
        return g, None


def mean_keep_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The group's mean of ``x`` forward; the gradient reaches this rank's
    ``x`` as is (the data-parallel mean of the gradients that follows
    divides it by the group size once)."""
    if group_size(group) == 1:
        return x
    return _MeanPassGrad.apply(x, group)
