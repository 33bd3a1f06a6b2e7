"""Logical-axis sharding context; counterpart of ``repro/distributed/ctx.py``.

Model code annotates activations with *logical* axis names via
:func:`shard_hint`; a step installs a mapping from logical names to mesh
axes (or None) with :func:`logical_rules`.  Outside any context every
helper here returns its input object, so the same model code runs on one
card (serving, tests) and sharded (``distributed/steps.py``) - and the
one-card paths do not change by a bit.

Inside a context the port's tensors are plain local tensors, each laid
out as the step's specs give it: a weight split over ``model`` holds
fewer rows or columns than the config names, and that is how the model
code tells its shards (``layers.col_linear`` / ``row_linear``).  The
helpers below run the ``model``-axis collectives of ``comm.py`` on the
current mesh, and do nothing where the axis has size 1.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import comm
from .sharding import PartitionSpec

_state = threading.local()


def current():
    """(mesh, rules) of the innermost context, or None."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def logical_rules(mesh, rules: Dict[str, object]):
    """rules: logical axis name -> mesh axis name | tuple | None."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, dict(rules))
    try:
        yield
    finally:
        _state.ctx = prev


def bound(fn):
    """``fn`` run under the context current now, whichever thread later
    calls it (autograd runs a CUDA backward, and so a remat recompute, on
    its own device thread, where this thread's context is not set)."""
    cur = current()
    if cur is None:
        return fn

    def run(*args, **kwargs):
        with logical_rules(*cur):
            return fn(*args, **kwargs)
    return run


def to_pspec(logical: Sequence[Optional[str]], rules: Dict[str, object]) -> PartitionSpec:
    return PartitionSpec(*(rules.get(name) if name is not None else None
                           for name in logical))


def shard_hint(x: torch.Tensor, logical: Sequence[Optional[str]],
               full: Optional[Sequence[Optional[int]]] = None) -> torch.Tensor:
    """The layout the rules give ``x``'s logical axes (``x`` itself outside a
    context).  ``full`` names the global size of the dims whose local size
    can be a shard over ``model``; such a dim that the rules keep whole
    over ``model`` is gathered.  Every other layout is the one the local
    tensor already has (the step's specs and these rules agree on it)."""
    cur = current()
    if cur is None or full is None:
        return x
    mesh = cur[0]
    for dim, (name, n) in enumerate(zip(logical, full)):
        if n is None or x.shape[dim] == n:
            continue
        if not split_over_model(name):
            x = comm.gather(x, mesh.group("model"), dim)
            if x.shape[dim] != n:
                raise ValueError(f"gathered dim {dim} of {name!r} is {x.shape[dim]} wide, "
                                 f"not {n}")
    return x


# ---------------------------------------------------------------------------
# The model axis of the current context
# ---------------------------------------------------------------------------
def _group(axes):
    cur = current()
    return None if cur is None else cur[0].group(axes)


def model_index() -> Tuple[int, int]:
    """(this rank's ``model`` coordinate, the axis size); (0, 1) outside a
    context."""
    cur = current()
    if cur is None:
        return 0, 1
    mesh = cur[0]
    return mesh.coord("model"), mesh.shape["model"]


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor about to feed rank-specific work (a weight's
    column shard, a slice by this rank's coordinate): its gradient is
    summed over ``model``."""
    return comm.enter(x, _group("model"))


def sum_model(x: torch.Tensor) -> torch.Tensor:
    """Partial sums (a row shard's product, a masked gather) summed over
    ``model``."""
    return comm.sum_partials(x, _group("model"))


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's shard of ``dim`` -> the whole dim, gathered over ``model``."""
    return comm.gather(x, _group("model"), dim)


def max_model(x: torch.Tensor) -> torch.Tensor:
    """The element-wise max over ``model`` (no gradient)."""
    return comm.all_reduce(x.detach(), _group("model"), "max")


def split_over_model(name: Optional[str]) -> bool:
    """Whether the rules split logical axis ``name`` over ``model``."""
    cur = current()
    return cur is not None and "model" in cur[0].axes(cur[1].get(name))


def model_slice(x: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """This rank's ``n``-wide block of a replicated ``x`` along ``dim``."""
    r, _ = model_index()
    return enter_model(x).narrow(dim, r * n, n)


def batch_axes() -> Tuple[str, ...]:
    """The mesh axes the ``batch`` rule shards over (empty outside a
    context, or where the batch is replicated)."""
    cur = current()
    if cur is None:
        return ()
    mesh, rules = cur
    return mesh.axes(rules.get("batch"))


def mean_batch(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the batch's axes (``pmean``); the gradient
    reaches this rank's ``x`` as is."""
    axes = batch_axes()
    return comm.mean_keep_grad(x, _group(axes)) if axes else x


# ---------------------------------------------------------------------------
# Sequence splits: the query rows of sequence-parallel attention, and the
# KV cache's positions
# ---------------------------------------------------------------------------
def attn_seq_index() -> Tuple[int, int]:
    """(this rank's block, the blocks) of the query sequence where the rules
    split it (``attn_seq``: sequence-parallel attention); (0, 1) elsewhere."""
    cur = current()
    if cur is None:
        return 0, 1
    mesh, rules = cur
    ax = rules.get("attn_seq")
    return mesh.coord(ax), mesh.axis_size(ax)


def cache_block(n: int):
    """Where the step splits the KV cache's sequence dim (the context's
    ``cache_seq`` entry, the cache spec's sequence axes): (the first
    position of this rank's ``n``-long block, the process group of the
    ranks holding the other blocks, whether ``model`` is among the axes);
    None where the cache is whole."""
    cur = current()
    if cur is None:
        return None
    mesh, rules = cur
    ax = rules.get("cache_seq")
    if mesh.axis_size(ax) == 1:
        return None
    return mesh.coord(ax) * n, mesh.group(ax), "model" in mesh.axes(ax)
