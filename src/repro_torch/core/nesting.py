"""NestQuant procedures (paper Algorithm 1) on a K-rung nesting ladder;
counterpart of ``repro/core/nesting.py``.

``nest_quantize`` nests one weight (..., K, N): INT-n quantization with a
per-output-channel scale, a top-down walk of the ladder keeping each
level's (gap+1)-bit compensated delta, and block-packing of the base and
every delta along K - the layout the matmul kernels read directly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from .. import tree
from . import packing
from .decompose import (chain_decompose, chain_recompose, delta_bits,
                        ladder_gaps, normalize_bits, recompose, split_high)
from .quantizer import dequantize, int_range
from .squant import adaptive_round


@dataclass
class NestedTensor:
    """Packed NestQuant ladder representation of one weight tensor.

    The logical weight has shape ``shape`` = (..., K, N); the scale is
    per output channel (axis N), the flip group is the reduction axis K.
    ``w_base`` holds the packed bits[0]-bit base codes and ``deltas[i]``
    the packed (gap_i+1)-bit delta that upgrades rung i to rung i+1, all
    block-packed along K.  ``rung`` selects how many streams (base +
    deltas[:rung]) the matmul dispatch reads.  A delta entry may be
    ``None``: a stream paged out to the store's pager (residency is
    always a prefix).  Byte accounting is computed from (shape, bits,
    block), never from the arrays, so it is exact for paged-out streams
    and for per-layer views alike.

    A per-layer view (:meth:`layer`) slices the leading stacked axis off
    every array but keeps the stacked ``shape``: the model loops over
    layers in Python and accounts bytes on the stacked leaf, as the
    reference does under ``lax.scan``.
    """
    w_base: torch.Tensor                          # int32 (..., rows, N)
    deltas: Tuple[Optional[torch.Tensor], ...]    # int32 delta streams, ascending
    scale: torch.Tensor                           # f32 (..., 1, N), top-rung scale
    shape: Tuple[int, ...]                        # logical (stacked) shape
    bits: Tuple[int, ...]                         # ascending rung bitwidths
    block: int = packing.DEFAULT_BLOCK            # pack block along K
    rung: int = -1                                # serving rung (-1 = top)

    def __post_init__(self):
        self.shape = tuple(int(d) for d in self.shape)
        self.bits = tuple(self.bits)
        self.deltas = tuple(self.deltas)
        self.rung = check_rung(self.rung, len(self.bits))

    def _replace(self, **kw) -> "NestedTensor":
        f = dict(w_base=self.w_base, deltas=self.deltas, scale=self.scale,
                 shape=self.shape, bits=self.bits, block=self.block,
                 rung=self.rung)
        f.update(kw)
        return NestedTensor(**f)

    # -- rung metadata -------------------------------------------------------
    @property
    def num_rungs(self) -> int:
        return len(self.bits)

    @property
    def top(self) -> int:
        return len(self.bits) - 1

    def with_rung(self, rung: int) -> "NestedTensor":
        rung = check_rung(rung, self.num_rungs)
        return self if rung == self.rung else self._replace(rung=rung)

    def with_mode(self, mode: str) -> "NestedTensor":
        """Two-level name: 'full' = top rung, 'part' = base rung."""
        return self.with_rung(mode_to_rung(mode, self.num_rungs))

    @property
    def resident_levels(self) -> int:
        """Leading delta streams actually present."""
        n = 0
        for d in self.deltas:
            if d is None:
                break
            n += 1
        return n

    def with_deltas(self, deltas) -> "NestedTensor":
        """Copy with a new delta tuple; the rung is clamped to residency so
        the dispatch can never be pointed at a paged-out stream."""
        nt = self._replace(deltas=tuple(deltas))
        return nt.with_rung(min(nt.rung, nt.resident_levels))

    @property
    def mode(self) -> str:
        return rung_to_mode(self.rung, self.num_rungs)

    @property
    def n(self) -> int:
        return self.bits[-1]

    @property
    def h(self) -> int:
        return self.bits[0]

    @property
    def l(self) -> int:  # noqa: E743 - the paper's name for n - h
        return self.n - self.h

    @property
    def gaps(self) -> Tuple[int, ...]:
        return ladder_gaps(self.bits)

    @property
    def K(self) -> int:
        return self.shape[-2]

    def _two_level(self, name: str) -> None:
        if len(self.deltas) != 1:
            raise ValueError(f"{name} is ambiguous on a {self.num_rungs}-rung ladder")

    @property
    def w_high(self) -> torch.Tensor:
        """Two-level name of the packed base stream."""
        return self.w_base

    @property
    def w_low(self) -> torch.Tensor:
        """Two-level name of a 2-rung tensor's one delta stream."""
        self._two_level("w_low")
        return self.deltas[0]

    @property
    def device(self) -> torch.device:
        return self.w_base.device

    def rung_scale(self, rung: int) -> torch.Tensor:
        """Per-rung dequant scale s * 2^(n - bits[rung]) (Eq. 10 per rung)."""
        return self.scale * (2.0 ** (self.bits[-1] - self.bits[rung]))

    @property
    def part_scale(self) -> torch.Tensor:
        """The part-bit (base rung) scale s * 2^l (Eq. 10)."""
        return self.rung_scale(0)

    # -- views and placement --------------------------------------------------
    def layer(self, i: int) -> "NestedTensor":
        """Layer ``i`` of a stacked leaf: 2-D word streams, (1, N) scale,
        the stacked ``shape`` kept for byte accounting."""
        return self._replace(
            w_base=self.w_base[i],
            deltas=tuple(None if d is None else d[i] for d in self.deltas),
            scale=self.scale[i])

    def to(self, device) -> "NestedTensor":
        return self._replace(
            w_base=self.w_base.to(device),
            deltas=tuple(None if d is None else d.to(device) for d in self.deltas),
            scale=self.scale.to(device))

    # -- byte accounting (metadata only) -------------------------------------
    def _rest(self) -> int:
        """Elements per K-slice: every dim except the packing axis K."""
        return math.prod(self.shape[:-2] + self.shape[-1:])

    def _stream_rows(self, width: int) -> int:
        return math.ceil(self.K / self.block) * packing.blocked_rows(self.block, width)

    def nbytes_base(self) -> int:
        return self._stream_rows(self.bits[0]) * self._rest() * 4

    def nbytes_delta(self, i: int) -> int:
        return self._stream_rows(delta_bits(self.bits)[i]) * self._rest() * 4

    def stream_nbytes(self) -> Tuple[int, ...]:
        """Per-stream packed bytes: (base, delta_0, ..., delta_{R-2})."""
        return (self.nbytes_base(),) + tuple(
            self.nbytes_delta(i) for i in range(len(self.deltas)))

    def nbytes_high(self) -> int:
        return self.nbytes_base()

    def nbytes_low(self) -> int:
        return sum(self.nbytes_delta(i) for i in range(len(self.deltas)))

    def nbytes_scales(self) -> int:
        return self._rest() * 4

    # -- materialization ------------------------------------------------------
    def codes_base(self) -> torch.Tensor:
        return packing.unpack_blocked(self.w_base, self.bits[0], self.K,
                                      self.block, axis=self.w_base.ndim - 2)

    def codes_delta(self, i: int) -> torch.Tensor:
        if self.deltas[i] is None:
            raise ValueError(
                f"delta stream {i} is not resident (paged out to the "
                "store's pager); fetch it via NestQuantStore before use")
        return packing.unpack_blocked(self.deltas[i], delta_bits(self.bits)[i],
                                      self.K, self.block,
                                      axis=self.deltas[i].ndim - 2)

    def codes_at(self, rung: int) -> torch.Tensor:
        """INT-bits[rung] codes, climbed from the base (exact at every rung)."""
        rung = check_rung(rung, self.num_rungs)
        return chain_recompose(self.codes_base(),
                               [self.codes_delta(i) for i in range(rung)],
                               self.bits, rung)

    def codes_high(self) -> torch.Tensor:
        return self.codes_base()

    def codes_low(self) -> torch.Tensor:
        self._two_level("codes_low")
        return self.codes_delta(0)

    def codes_full(self) -> torch.Tensor:
        return self.codes_at(self.top)

    def rung_weight(self, rung: int, dtype=torch.bfloat16) -> torch.Tensor:
        """Dequantized rung-``rung`` weight: s * 2^(n-b_r) * codes_at(r)."""
        rung = check_rung(rung, self.num_rungs)
        return dequantize(self.codes_at(rung), self.rung_scale(rung), dtype)

    def part_bit(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Dequantized base-rung weight: s * 2^l * base codes (Eq. 10)."""
        return self.rung_weight(0, dtype)

    def full_bit(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Dequantized top-rung weight (every delta stream resident)."""
        return self.rung_weight(self.top, dtype)

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Dequantized weight at the stamped serving rung."""
        return self.rung_weight(self.rung, dtype)

    def gather_rows(self, idx: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        """Dequantized logical rows ``idx`` along the packed K axis, read
        straight from the packed words (the embedding gather).  Returns
        (*idx.shape, N) in ``dtype`` at the stamped rung."""
        if self.w_base.ndim != 2:
            raise ValueError("row gather expects a 2-D weight")
        flat = idx.reshape(-1)
        widths = delta_bits(self.bits)
        codes = packing.gather_block_rows(self.w_base, self.bits[0], self.block, flat)
        for i in range(self.rung):
            d = packing.gather_block_rows(self.deltas[i], widths[i], self.block, flat)
            codes = recompose(codes, d, self.bits[i + 1], self.bits[i])
        out = dequantize(codes, self.rung_scale(self.rung), dtype)
        return out.reshape(tuple(idx.shape) + (self.shape[-1],))


def check_rung(rung: int, num_rungs: int) -> int:
    """Validate a rung index (negatives allowed: -1 = top); out-of-range
    indices raise instead of wrapping."""
    if not -num_rungs <= rung < num_rungs:
        raise ValueError(f"rung {rung} out of range for a {num_rungs}-rung ladder")
    return rung % num_rungs


def mode_to_rung(mode, num_rungs: int) -> int:
    """'part' -> 0, 'full' -> top, 'rungK' -> K, ints pass through."""
    if isinstance(mode, int):
        return check_rung(mode, num_rungs)
    if mode == "full":
        return num_rungs - 1
    if mode == "part":
        return 0
    if isinstance(mode, str) and mode.startswith("rung"):
        return check_rung(int(mode[4:]), num_rungs)
    raise ValueError(f"unknown mode {mode!r}")


def rung_to_mode(rung: int, num_rungs: int) -> str:
    if rung == num_rungs - 1:
        return "full"
    if rung == 0:
        return "part"
    return f"rung{rung}"


def critical_nested_bits(model_size_mb: float, n: int = 8) -> int:
    """Eq. 12: the critical nested combination rule of thumb."""
    if model_size_mb < 3e1:
        return n // 2 + 1
    if model_size_mb < 3e2:
        return n // 2
    return n // 2 - 1


# ---------------------------------------------------------------------------
# Algorithm 1 on one (K, N) (or stacked (..., K, N)) weight
# ---------------------------------------------------------------------------
def _split_level(cur: torch.Tensor, b_hi: int, b_lo: int, rounding: str,
                 group_size: Optional[int]) -> torch.Tensor:
    """INT-b_lo quantization of INT-b_hi codes / 2^gap; the adaptive flip
    group is the reduction axis K (axis -2)."""
    gap = b_hi - b_lo
    if rounding == "adaptive":
        vt = (cur.float() / (2 ** gap)).transpose(-1, -2)
        lo, hi = int_range(b_lo)
        q = torch.clamp(adaptive_round(vt, b_lo, group_size=group_size), lo, hi)
        return q.transpose(-1, -2).to(torch.int32)
    return split_high(cur, b_hi, b_lo, method=rounding)


# Largest 2-D weight nested in one piece (elements); above it, column slices
SLICE_ELEMS = 1 << 27


def nest_quantize(w: torch.Tensor, n: int = 8, h: Optional[int] = None,
                  rounding: str = "adaptive",
                  group_size: Optional[int] = None,
                  block: Optional[int] = None,
                  bits: Optional[Sequence[int]] = None,
                  validate: bool = True) -> NestedTensor:
    """Algorithm 1, ladder-generalized.  ``bits`` (any order) selects the
    rung chain; otherwise the two-level ``(n, h)`` nesting (``h=None`` ->
    Eq. 12).

    A stacked weight (L, ..., K, N) is nested one leading slice at a time,
    and a 2-D weight of more than ``SLICE_ELEMS`` elements (an LM head or
    embedding at a 100k vocabulary) in slices of columns: scales, flip
    groups and packing never cross either, so the result equals nesting
    the whole tensor at once while the float intermediates stay one slice
    large."""
    if w.ndim < 2:
        raise ValueError("nest_quantize expects a matmul weight (..., K, N)")
    if bits is None:
        if h is None:
            h = critical_nested_bits(w.numel() * 4 / 1e6, n)
        bits = (h, n)
    bits = normalize_bits(bits)
    if block is None:
        block = packing.choose_block(w.shape[-2])
    if w.ndim > 2:
        parts = [nest_quantize(w[i], rounding=rounding, group_size=group_size,
                               block=block, bits=bits, validate=validate)
                 for i in range(w.shape[0])]
        return NestedTensor(
            w_base=torch.stack([p.w_base for p in parts]),
            deltas=tuple(torch.stack([p.deltas[j] for p in parts])
                         for j in range(len(bits) - 1)),
            scale=torch.stack([p.scale for p in parts]),
            shape=tuple(w.shape), bits=bits, block=block)

    if w.numel() > SLICE_ELEMS and w.shape[-1] > 1:
        step = max(1, SLICE_ELEMS // w.shape[-2])
        parts = [nest_quantize(w[:, j:j + step], rounding=rounding, group_size=group_size,
                               block=block, bits=bits, validate=validate)
                 for j in range(0, w.shape[-1], step)]
        return NestedTensor(
            w_base=torch.cat([p.w_base for p in parts], dim=-1),
            deltas=tuple(torch.cat([p.deltas[j] for p in parts], dim=-1)
                         for j in range(len(bits) - 1)),
            scale=torch.cat([p.scale for p in parts], dim=-1),
            shape=tuple(w.shape), bits=bits, block=block)

    n = bits[-1]
    w = w.float()
    # step 1: INT-n, per-output-channel scale, CASE flips over K
    qmax = 2 ** (n - 1) - 1
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / qmax
    v = w / scale
    if rounding == "adaptive":
        w_int = adaptive_round(v.transpose(-1, -2), n,
                               group_size=group_size).transpose(-1, -2)
    else:
        lo, hi = int_range(n)
        w_int = torch.clamp(torch.round(v), lo, hi).to(torch.int32)

    # step 2: walk the ladder top-down, keeping each compensated delta
    cur, deltas = chain_decompose(
        w_int, bits,
        split_fn=lambda c, b_hi, b_lo: _split_level(c, b_hi, b_lo,
                                                    rounding, group_size),
        validate=validate)

    # step 3: block-pack the base and every delta along K
    widths = delta_bits(bits)
    return NestedTensor(
        w_base=packing.pack_blocked(cur, bits[0], block, axis=0),
        deltas=tuple(packing.pack_blocked(d, widths[i], block, axis=0)
                     for i, d in enumerate(deltas)),
        scale=scale,
        shape=tuple(w.shape),
        bits=bits,
        block=block,
    )


# ---------------------------------------------------------------------------
# Whole-model helpers
# ---------------------------------------------------------------------------
def default_predicate(path: str, leaf: Any, min_dim: int = 64) -> bool:
    """Nest matmul weights; keep norms/bias/SSM-scalars/conv in FP.  Screens
    the STACKED shape, as the reference does."""
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if leaf.shape[-1] < min_dim or leaf.shape[-2] < min_dim:
        return False
    if not leaf.is_floating_point():
        return False
    lowered = path.lower()
    return not any(kw in lowered for kw in ("norm", "bias", "conv", "a_log", "router"))


def nest_quantize_tree(params, n: int = 8, h: Optional[int] = None,
                       rounding: str = "adaptive",
                       predicate: Callable[[str, Any], bool] = default_predicate,
                       group_size: Optional[int] = None,
                       block: Optional[int] = None,
                       bits: Optional[Sequence[int]] = None, device="cuda"):
    """Apply Algorithm 1 across a parameter tree (on ``device``).

    DEPRECATED keyword-soup shim, as in the reference: build a declarative
    :class:`repro_torch.core.recipe.QuantRecipe` and call
    ``repro_torch.api.quantize(params, recipe)`` instead.

    ``bits`` selects a K-rung ladder (e.g. ``(8, 6, 4)``); otherwise
    ``h=None`` selects the critical nested combination per model via
    Eq. 12 (model size in MB, 4 bytes per element of every leaf)."""
    import warnings

    from .recipe import QuantRecipe, quantize
    warnings.warn(
        "nest_quantize_tree is a compatibility shim; prefer "
        "repro_torch.api.quantize(params, QuantRecipe(...)) (DESIGN.md Sec. 9)",
        DeprecationWarning, stacklevel=2)
    if bits is None:
        if h is None:
            size_mb = sum(x.numel() * 4 / 1e6 for x in tree.leaves(params)
                          if hasattr(x, "numel"))
            h = critical_nested_bits(size_mb, n)
        bits = (h, n)
    recipe = QuantRecipe(bits=normalize_bits(bits), rounding=rounding,
                         block=block, group_size=group_size, predicate=predicate)
    return quantize(params, recipe, device=device)


def _is_nested(x) -> bool:
    return isinstance(x, NestedTensor)


def materialize(nested_params, mode="full", dtype=torch.bfloat16):
    """Dequantize a nested tree to dense weights (off the serving path)."""
    return tree.map_with_path(
        lambda _, x: x.rung_weight(mode_to_rung(mode, x.num_rungs), dtype)
        if _is_nested(x) else x, nested_params)


def tree_num_rungs(nested_params) -> int:
    """Ladder depth of a nested tree (max over nested leaves; 1 if none)."""
    return max([1] + [x.num_rungs for x in tree.leaves(nested_params) if _is_nested(x)])


def set_tree_rung(nested_params, rung):
    """Stamp the serving rung on every nested leaf: an int (clamped to each
    leaf's ladder top) or a ``{keystr: rung}`` map (unmapped leaves keep
    their stamp).  A metadata flip: no array is touched."""
    depth = tree_num_rungs(nested_params)
    if isinstance(rung, int):
        r = check_rung(rung, depth)
        return tree.map_with_path(
            lambda _, x: x.with_rung(min(r, x.top)) if _is_nested(x) else x,
            nested_params)

    def stamp(path, x):
        if _is_nested(x) and path in rung:
            return x.with_rung(min(check_rung(rung[path], depth), x.top))
        return x
    return tree.map_with_path(stamp, nested_params)


def set_tree_mode(nested_params, mode: str):
    """Two-level name of :func:`set_tree_rung`: 'full' stamps each leaf's
    top rung, 'part' its base rung."""
    return tree.map_with_path(
        lambda _, x: x.with_mode(mode) if _is_nested(x) else x, nested_params)


def _fp_nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def tree_bytes(nested_params) -> Dict[str, int]:
    """Byte accounting over a nested tree (packed sizes + FP leftovers)."""
    acc = {"high": 0, "low": 0, "scales": 0, "fp": 0}
    for leaf in tree.leaves(nested_params):
        if _is_nested(leaf):
            acc["high"] += leaf.nbytes_high()
            acc["low"] += leaf.nbytes_low()
            acc["scales"] += leaf.nbytes_scales()
        else:
            acc["fp"] += _fp_nbytes(leaf)
    acc["total"] = sum(acc.values())
    return acc


def tree_ladder_bytes(nested_params) -> Dict[str, Any]:
    """Per-rung byte accounting: ``deltas[i]`` is exactly what an upgrade
    from rung i to rung i+1 pages in."""
    depth = tree_num_rungs(nested_params)
    acc = {"base": 0, "deltas": [0] * max(depth - 1, 0), "scales": 0, "fp": 0}
    for leaf in tree.leaves(nested_params):
        if _is_nested(leaf):
            acc["base"] += leaf.nbytes_base()
            for i in range(len(leaf.deltas)):
                acc["deltas"][i] += leaf.nbytes_delta(i)
            acc["scales"] += leaf.nbytes_scales()
        else:
            acc["fp"] += _fp_nbytes(leaf)
    acc["total"] = acc["base"] + sum(acc["deltas"]) + acc["scales"] + acc["fp"]
    return acc
