"""Plain PyTorch versions for the nested-attention kernel (K4), mirroring
``repro/kernels/nested_attention/ref.py``: the same integer arithmetic
(unpack, chain-recompose, int32 contraction) as plain tensor code."""
from __future__ import annotations

import math

import torch

from ...core import packing
from ...core.decompose import chain_recompose, delta_bits


def resident_bits(bits) -> tuple:
    """Resident-prefix bitwidths: ascending, distinct; one entry (rung 0,
    the base stream alone) is allowed."""
    b = tuple(int(x) for x in bits)
    if not b or b != tuple(sorted(set(b))):
        raise ValueError(f"resident bits must be ascending and distinct, got {bits}")
    return b


def unpack_k_codes(streams, *, bits, page: int) -> torch.Tensor:
    """Packed K/V streams -> (BH, S, D) int32 codes at the resident rung.
    streams: (BH, npages * rows_i, D) int32, base first, packed along
    axis 1 with block == page; bits: the resident bitwidths."""
    bits = resident_bits(bits)
    if len(streams) != len(bits):
        raise ValueError(f"{len(streams)} streams for resident bits {bits}")
    S = streams[0].shape[1] // packing.blocked_rows(page, bits[0]) * page
    base = packing.unpack_blocked(streams[0], bits[0], S, page, axis=1)
    if len(bits) == 1:
        return base
    widths = delta_bits(bits)
    return chain_recompose(
        base,
        [packing.unpack_blocked(streams[i], widths[i - 1], S, page, axis=1)
         for i in range(1, len(streams))],
        bits)


def nested_qk_ref(q_codes, streams, *, bits, page: int) -> torch.Tensor:
    """(BH, M, S) raw int32 scores, bit-identical to the kernel.

    torch has no integer matmul on CUDA, so the contraction is not an int32
    einsum: the products are formed in int64 and summed in int64, whose
    wrap-around keeps the low 32 bits exact, and the sum is narrowed to
    int32 by two's-complement wrap - exactly JAX's int32 dot_general."""
    kc = unpack_k_codes(streams, bits=bits, page=page)
    prod = q_codes.to(torch.int64)[:, :, None, :] * kc.to(torch.int64)[:, None, :, :]
    low = prod.sum(dim=-1) & 0xFFFFFFFF
    return torch.where(low >= 2 ** 31, low - 2 ** 32, low).to(torch.int32)


def dense_attention_ref(q, k, v) -> torch.Tensor:
    """The dense-cache oracle: f32 softmax(QK^T / sqrt(D)) @ V over the
    whole (unmasked) key set."""
    q, k, v = (x.float() for x in (q, k, v))
    scores = torch.einsum("bmd,bsd->bms", q, k) / math.sqrt(q.shape[-1])
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bms,bsd->bmd", probs, v)
