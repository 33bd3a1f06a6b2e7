"""Turn parameters handed over as numpy into the port's.

The JAX package's trees reach the port as numpy (the caller does the
JAX -> numpy step; this module never sees JAX).  A tree is a nested dict
whose leaves are:

* a numpy array - a dense leaf, dtype kept (int32 words bit for bit);
* :class:`Bf16Array` - a bfloat16 leaf as its ``uint16`` bit pattern
  (numpy has no bfloat16);
* :class:`NestedArrays` - the fields of one ``NestedTensor`` (``w_base``,
  ``deltas``, ``scale``, ``shape``, ``bits``, ``block``, ``rung``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import tree
from .core.nesting import NestedTensor
from .device import resolve_device


@dataclass(frozen=True)
class Bf16Array:
    """A bfloat16 array as its raw 16-bit patterns."""
    bits16: np.ndarray            # uint16


@dataclass(frozen=True)
class NestedArrays:
    """One nested leaf's fields as numpy (``None`` = a paged-out delta)."""
    w_base: np.ndarray
    deltas: Sequence[Optional[np.ndarray]]
    scale: np.ndarray
    shape: Tuple[int, ...]
    bits: Tuple[int, ...]
    block: int
    rung: int


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A dense leaf, bit for bit, on ``device`` (default: the card)."""
    device = resolve_device(device)
    if isinstance(a, Bf16Array):
        raw = np.ascontiguousarray(a.bits16, dtype=np.uint16).view(np.int16)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16).to(device)
    a = np.asarray(a)
    if a.dtype == np.uint16:
        raise TypeError("a uint16 array is ambiguous; wrap bfloat16 bits in Bf16Array")
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def words_from_numpy(a, device=None) -> torch.Tensor:
    """Packed int32 words (weight or KV streams, int32 codes) bit for bit;
    any other dtype raises."""
    a = np.asarray(a)
    if a.dtype != np.int32:
        raise TypeError(f"packed words must be int32, got {a.dtype}")
    return tensor_from_numpy(a, device)


def nested_from_numpy(na: NestedArrays, device=None) -> NestedTensor:
    device = resolve_device(device)

    def words(a):
        return words_from_numpy(a, device)

    return NestedTensor(
        w_base=words(na.w_base),
        deltas=tuple(None if d is None else words(d) for d in na.deltas),
        scale=tensor_from_numpy(np.asarray(na.scale, np.float32), device),
        shape=tuple(na.shape), bits=tuple(na.bits), block=int(na.block),
        rung=int(na.rung))


def params_from_numpy(params, device=None):
    """A whole tree: every leaf converted, structure and keys kept."""
    device = resolve_device(device)

    def leaf(_, x):
        if isinstance(x, NestedArrays):
            return nested_from_numpy(x, device)
        return tensor_from_numpy(x, device)
    return tree.map_with_path(leaf, params)
