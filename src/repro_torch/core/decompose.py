"""Integer weight decomposition + nesting recomposition (paper Sec. 3.2);
counterpart of ``repro/core/decompose.py``.

    w_int = w_high * 2^l + w_low            (Eq. 6)
    w_high ~ Clip(round(w_int / 2^l), ...)  (Eq. 7, method-dependent rounding)
    w_low  = Clip(w_int - w_high * 2^l, ...) (Eq. 11)

With the paper's extra 1-bit compensation the lower part is stored with
(l+1) bits and recomposition is exact.  The bitshift split is a floor
division (``rounding_mode="floor"``), as an arithmetic shift is.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .quantizer import int_range
from .squant import adaptive_round, is_floor_ceil

ROUNDINGS = ("bitshift", "rtn", "adaptive")


def split_high(w_int: torch.Tensor, n: int, h: int, method: str = "adaptive",
               group_size: Optional[int] = None) -> torch.Tensor:
    """Derive the higher-bit weight w_high (INT-h codes) from w_int (INT-n)."""
    if not 0 < h < n:
        raise ValueError(f"need 0 < h < n, got n={n} h={h}")
    l = n - h
    lo, hi = int_range(h)
    w_int = w_int.to(torch.int32)
    if method == "bitshift":
        w_high = torch.div(w_int, 2 ** l, rounding_mode="floor")
    elif method == "rtn":
        w_high = torch.round(w_int.float() / (2 ** l)).to(torch.int32)
    elif method == "adaptive":
        w_high = adaptive_round(w_int.float() / (2 ** l), h, group_size=group_size)
    else:
        raise ValueError(f"unknown rounding {method!r}")
    return torch.clamp(w_high, lo, hi).to(torch.int32)


def split_low(w_int: torch.Tensor, w_high: torch.Tensor, n: int, h: int,
              compensate: bool = True) -> torch.Tensor:
    """Lower-bit weight w_low (Eq. 11); (l+1) bits and exact with
    compensation, clipped to signed l bits (lossy) without."""
    l = n - h
    w_low = w_int.to(torch.int32) - w_high.to(torch.int32) * (2 ** l)
    lo, hi = int_range(l + 1 if compensate else l)
    return torch.clamp(w_low, lo, hi).to(torch.int32)


def recompose(w_high: torch.Tensor, w_low: torch.Tensor, n: int, h: int) -> torch.Tensor:
    """Eq. 6: LeftShift(w_high, l) + w_low, clipped to INT-n."""
    l = n - h
    lo, hi = int_range(n)
    w = w_high.to(torch.int32) * (2 ** l) + w_low.to(torch.int32)
    return torch.clamp(w, lo, hi).to(torch.int32)


def decompose(w_int: torch.Tensor, n: int, h: int, method: str = "adaptive",
              compensate: bool = True, group_size: Optional[int] = None):
    """Full decomposition -> (w_high, w_low)."""
    w_high = split_high(w_int, n, h, method=method, group_size=group_size)
    return w_high, split_low(w_int, w_high, n, h, compensate=compensate)


# ---------------------------------------------------------------------------
# K-rung nesting ladder: INT-b_{R-1} > ... > INT-b_1 > INT-b_0
# ---------------------------------------------------------------------------
def normalize_bits(bits: Sequence[int]) -> Tuple[int, ...]:
    """Canonical ascending rung bitwidths, e.g. (8, 6, 4) -> (4, 6, 8).
    Bitwidths must be distinct, >= 2, and <= 32."""
    b = tuple(sorted(int(x) for x in bits))
    if len(b) < 2:
        raise ValueError(f"a ladder needs >= 2 rungs, got {bits!r}")
    if len(set(b)) != len(b):
        raise ValueError(f"duplicate bitwidths in {bits!r}")
    if b[0] < 2 or b[-1] > 32:
        raise ValueError(f"bitwidths must lie in [2, 32], got {bits!r}")
    return b


def ladder_gaps(bits: Sequence[int]) -> Tuple[int, ...]:
    """Per-level shift widths: gaps[i] = bits[i+1] - bits[i] (ascending)."""
    b = normalize_bits(bits)
    return tuple(b[i + 1] - b[i] for i in range(len(b) - 1))


def delta_bits(bits: Sequence[int]) -> Tuple[int, ...]:
    """Stored width of each delta stream: gap + 1 (per-level compensation)."""
    return tuple(g + 1 for g in ladder_gaps(bits))


def _validate_split(cur: torch.Tensor, hi: torch.Tensor, delta: torch.Tensor,
                    b_hi: int, b_lo: int) -> None:
    """The nesting exactness invariant, checked at the splitter: every code
    in the {floor, ceil} pair of its target cur/2^gap, the raw residual
    inside the (gap+1)-bit delta range, and hi*2^gap + delta == cur."""
    gap = b_hi - b_lo
    member = is_floor_ceil(cur.float() / (2 ** gap), hi)
    if not bool(member.all()):
        bad = int((~member).sum())
        raise AssertionError(
            f"split {b_hi}->{b_lo}: {bad} code(s) left the {{floor, ceil}} "
            "pair of their target - adaptive rounding may flip each element "
            "at most once, or the 1-bit compensation is no longer lossless")
    raw = cur.to(torch.int32) - hi.to(torch.int32) * (2 ** gap)
    dlo, dhi = int_range(gap + 1)
    if not (int(raw.min()) >= dlo and int(raw.max()) <= dhi):
        raise AssertionError(
            f"split {b_hi}->{b_lo}: residual range "
            f"[{int(raw.min())}, {int(raw.max())}] exceeds the compensated "
            f"(gap+1)={gap + 1}-bit delta range [{dlo}, {dhi}]")
    if not bool((hi.to(torch.int32) * (2 ** gap) + delta == cur).all()):
        raise AssertionError(
            f"split {b_hi}->{b_lo}: recomposition is not bit-exact "
            "(delta was clipped - rung upgrades would be lossy)")


def chain_decompose(w_int: torch.Tensor, bits: Sequence[int],
                    method: str = "adaptive",
                    group_size: Optional[int] = None,
                    split_fn=None,
                    validate: bool = True,
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Recursive Eq. 6/Eq. 11 down the ladder.  Returns ``(w_base,
    deltas)`` with ``w_{i+1} = w_i * 2^gaps[i] + deltas[i]`` exactly.
    ``split_fn(cur, b_hi, b_lo)`` overrides the per-level quantization."""
    b = normalize_bits(bits)
    if split_fn is None:
        def split_fn(cur, b_hi, b_lo):
            return split_high(cur, b_hi, b_lo, method=method, group_size=group_size)
    cur = w_int.to(torch.int32)
    deltas_desc = []
    for b_hi, b_lo in zip(reversed(b[1:]), reversed(b[:-1])):
        hi = split_fn(cur, b_hi, b_lo)
        delta = split_low(cur, hi, b_hi, b_lo, compensate=True)
        if validate:
            _validate_split(cur, hi, delta, b_hi, b_lo)
        deltas_desc.append(delta)
        cur = hi
    return cur, deltas_desc[::-1]


def chain_recompose(w_base: torch.Tensor, deltas: Sequence[torch.Tensor],
                    bits: Sequence[int], rung: Optional[int] = None) -> torch.Tensor:
    """Climb the ladder from the base codes (Eq. 6 per resident delta);
    returns INT-bits[rung] codes (``rung=None`` = top)."""
    b = normalize_bits(bits)
    if rung is None:
        rung = len(b) - 1
    if not 0 <= rung < len(b) or len(deltas) < rung:
        raise ValueError(f"rung {rung} needs {rung} deltas of a {len(b)}-rung "
                         f"ladder, got {len(deltas)}")
    cur = w_base.to(torch.int32)
    for i in range(rung):
        cur = recompose(cur, deltas[i], b[i + 1], b[i])
    return cur


def recompose_error(w_int: torch.Tensor, n: int, h: int, method: str,
                    compensate: bool) -> torch.Tensor:
    """Numerical error w_int - recompose(decompose(w_int)) (paper Table 7)."""
    w_high, w_low = decompose(w_int, n, h, method=method, compensate=compensate)
    return w_int.to(torch.int32) - recompose(w_high, w_low, n, h)


def numerical_error_table(n: int = 8, methods=("bitshift", "rtn", "adaptive")):
    """Paper Table 7 over all signed INT-n numbers:
    ``{method: {h: {'nonzero': int, 'range': (lo, hi)}}}``."""
    lo, hi = int_range(n)
    codes = torch.arange(lo, hi + 1, dtype=torch.int32)
    out = {}
    for method in methods:
        per_h = {}
        for h in range(n - 1, 2, -1):
            err = recompose_error(codes, n, h, method, compensate=False)
            per_h[h] = {"nonzero": int((err != 0).sum()),
                        "range": (int(err.min()), int(err.max()))}
        out[method] = per_h
    return out
