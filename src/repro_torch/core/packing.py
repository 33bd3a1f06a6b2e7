"""Packed-bit tensors (counterpart of ``repro/core/packing.py``; the words
are bit-identical).  Two layouts:

* :func:`pack` / :func:`unpack`: flat slot-major over the whole axis.
  With R = ceil(K / (32 // k)) word rows, word r holds elements r, r + R,
  r + 2R, ...; exact for k in {1, 2, 4, 8}, up to 32 % k bits of a word
  unused otherwise.
* :func:`pack_blocked` / :func:`unpack_blocked`: the blocked exact-bit
  layout the matmul kernels read.

In the blocked layout, K is tiled into blocks of ``block`` elements.
Within a block the k-bit field is split into power-of-two-width
components (7 = 4+2+1), widest first; each component of width w is
packed slot-major: with R = ceil(block / (32 // w)) word rows, element p
of the block sits in row ``off_c + p % R`` at bit offset ``(p // R) * w``.
A block that is a multiple of 32 therefore stores exactly k bits per
element.

torch has no uint32 arithmetic, and its ``>>`` on int32 is arithmetic.
Every word is therefore widened to int64 and masked to its low 32 bits
before any shift, and words are assembled in int64 and narrowed to int32
by two's-complement wrap (a 1-bit component with 32 slots sets bit 31).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

WORD_BITS = 32

# Largest block size pack_blocked defaults to; kernels tile K by it.
DEFAULT_BLOCK = 512

_LOW32 = (1 << 32) - 1


def per_word(k: int) -> int:
    if not 1 <= k <= WORD_BITS:
        raise ValueError(f"field width {k} not in [1, {WORD_BITS}]")
    return WORD_BITS // k


def packed_rows(K: int, k: int) -> int:
    return math.ceil(K / per_word(k))


def packed_nbytes(shape: Tuple[int, ...], k: int, axis: int = 0) -> int:
    """Bytes of the flat packed representation of an int tensor of ``shape``."""
    rest = math.prod(shape) // shape[axis]
    return packed_rows(shape[axis], k) * rest * 4


def bit_components(k: int) -> Tuple[int, ...]:
    """Power-of-two width split of a k-bit field, widest first (5 -> (4, 1))."""
    if k < 1:
        raise ValueError(f"field width {k} < 1")
    return tuple(1 << i for i in reversed(range(k.bit_length())) if (k >> i) & 1)


def blocked_rows(block: int, k: int) -> int:
    """int32 word rows one block of ``block`` k-bit elements occupies."""
    return sum(math.ceil(block / per_word(w)) for w in bit_components(k))


def choose_block(K: int, preferred: int = DEFAULT_BLOCK) -> int:
    """Largest power-of-two block <= preferred that divides K (else K)."""
    b = preferred
    while b >= 32:
        if K % b == 0:
            return b
        b //= 2
    return K


# ---------------------------------------------------------------------------
# word codecs (int64 inside, int32 words outside)
# ---------------------------------------------------------------------------
def _as_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding the unsigned 32-bit value."""
    return words.to(torch.int64) & _LOW32


def _to_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2^32) -> int32 by two's-complement wrap."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def _sign_extend(u: torch.Tensor, k: int) -> torch.Tensor:
    return torch.where(u >= (1 << (k - 1)), u - (1 << k), u).to(torch.int32)


def _pack_words(fields: torch.Tensor, k: int) -> torch.Tensor:
    """(K, ...) int64 fields (< 2^k) -> (R, ...) int32 words, slot-major
    along axis 0.  Pads the leading axis up to pw*R with zeros."""
    pw = per_word(k)
    K = fields.shape[0]
    R = packed_rows(K, k)
    pad = R * pw - K
    if pad:
        fields = torch.cat([fields, fields.new_zeros((pad,) + fields.shape[1:])])
    slots = fields.reshape((pw, R) + tuple(fields.shape[1:]))
    word = torch.zeros((R,) + tuple(fields.shape[1:]), dtype=torch.int64,
                       device=fields.device)
    for j in range(pw):
        word |= slots[j] << (j * k)
    return _to_i32(word)


def _fields(u: torch.Tensor, k: int, count: int) -> torch.Tensor:
    """(R, ...) unsigned int64 words -> (count, ...) int64 fields."""
    mask = (1 << k) - 1
    parts = [(u >> (j * k)) & mask for j in range(per_word(k))]
    return torch.cat(parts, dim=0)[:count]


def unpack_words(words: torch.Tensor, k: int, count: int,
                 signed: bool = True) -> torch.Tensor:
    """Slot-major shift/mask unpack along axis 0: (R, ...) int32 words ->
    (count, ...) int32 codes, sign-extended when ``signed``; count <= R *
    per_word(k).  (Unsigned fields of 32 bits wrap to int32, as the
    reference's uint32 fields cast to int32 do.)"""
    u = _fields(_as_u32(words), k, count)
    return _sign_extend(u, k) if signed else _to_i32(u)


def pack_block_words(x: torch.Tensor, k: int) -> torch.Tensor:
    """One block: (block, ...) signed k-bit codes -> (blocked_rows, ...)
    int32 words, component-major (widest field first) along axis 0."""
    u = x.to(torch.int64) & ((1 << k) - 1)
    comps, shift = [], 0
    for w in bit_components(k):
        comps.append(_pack_words((u >> shift) & ((1 << w) - 1), w))
        shift += w
    return torch.cat(comps, dim=0)


def unpack_block_words(words: torch.Tensor, k: int, block: int) -> torch.Tensor:
    """Inverse of :func:`pack_block_words`: (blocked_rows, ...) int32 words
    of ONE block -> (block, ...) int32 sign-extended codes."""
    u_words = _as_u32(words)
    off, shift, u = 0, 0, None
    for w in bit_components(k):
        rows = packed_rows(block, w)
        comp = _fields(u_words[off:off + rows], w, block)
        u = comp << shift if u is None else u | (comp << shift)
        off += rows
        shift += w
    return _sign_extend(u, k)


def gather_block_rows(words: torch.Tensor, k: int, block: int,
                      idx: torch.Tensor) -> torch.Tensor:
    """Gather logical elements ``idx`` along the blocked-packed axis 0
    without unpacking the whole tensor (the packed embedding gather).

    words: (nb * blocked_rows, ...) int32; idx: (T,) int.  Element (b, p)
    lives, per component, in word row ``b*rows_pb + off_c + p % R_c`` at
    bit offset ``(p // R_c) * w_c``: one word row read per component per
    element.  Returns (T, ...) int32 sign-extended codes."""
    idx = idx.to(torch.int64)
    rows_pb = blocked_rows(block, k)
    base = (idx // block) * rows_pb
    p = idx % block
    off, shift, u = 0, 0, None
    for w in bit_components(k):
        R = packed_rows(block, w)
        rows = _as_u32(words.index_select(0, base + off + p % R))
        sh = ((p // R) * w).reshape((-1,) + (1,) * (rows.ndim - 1))
        field = (rows >> sh) & ((1 << w) - 1)
        u = field << shift if u is None else u | (field << shift)
        off += R
        shift += w
    return _sign_extend(u, k)


# ---------------------------------------------------------------------------
# flat slot-major layout
# ---------------------------------------------------------------------------
def pack(x: torch.Tensor, k: int, axis: int = 0) -> torch.Tensor:
    """Pack signed k-bit codes into int32 words along ``axis`` (slot-major)."""
    u = torch.movedim(x, axis, 0).to(torch.int64) & ((1 << k) - 1)
    return torch.movedim(_pack_words(u, k), 0, axis).contiguous()


def unpack(words: torch.Tensor, k: int, K: int, axis: int = 0,
           dtype=torch.int32) -> torch.Tensor:
    """Inverse of :func:`pack`; returns sign-extended codes."""
    x = unpack_words(torch.movedim(words, axis, 0), k, K)
    return torch.movedim(x, 0, axis).to(dtype)


# ---------------------------------------------------------------------------
# blocked exact-bit layout (the kernels' storage contract)
# ---------------------------------------------------------------------------
def pack_blocked(x: torch.Tensor, k: int, block: int, axis: int = 0) -> torch.Tensor:
    """Pack component-split slot-major WITHIN blocks of ``block`` elements
    along ``axis``.  K pads up to a block multiple."""
    x = torch.movedim(x, axis, 0)
    K = x.shape[0]
    pad = (-K) % block
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    nb = x.shape[0] // block
    rest = tuple(x.shape[1:])
    xb = torch.movedim(x.reshape((nb, block) + rest), 1, 0)   # (block, nb, ...)
    words = pack_block_words(xb, k)                            # (rows_pb, nb, ...)
    words = torch.movedim(words, 1, 0).reshape((nb * blocked_rows(block, k),) + rest)
    return torch.movedim(words, 0, axis).contiguous()


def unpack_blocked(words: torch.Tensor, k: int, K: int, block: int,
                   axis: int = 0, dtype=torch.int32) -> torch.Tensor:
    w = torch.movedim(words, axis, 0)
    rows_pb = blocked_rows(block, k)
    nb = w.shape[0] // rows_pb
    rest = tuple(w.shape[1:])
    wb = torch.movedim(w.reshape((nb, rows_pb) + rest), 1, 0)  # (rows_pb, nb, ...)
    x = unpack_block_words(wb, k, block)                       # (block, nb, ...)
    x = torch.movedim(x, 1, 0).reshape((nb * block,) + rest)[:K]
    return torch.movedim(x, 0, axis).to(dtype)
