"""The card's published rates and the work of each hand-written kernel.

One copy of both, read by the abstract route of every kernel wrapper
(``dispatch.launch_abstract``), the dry run's roofline
(``launch/step_analysis.py``) and the bound column of ``chip_smoke.py``.

The rates are NVIDIA's data sheet for the H100 80GB HBM3 (SXM5) at its
700 W limit, dense (no sparsity).  A card set below 700 W runs slower
under load; every time kept beside a bound names the card's power limit.

Each cost function gives ``(bytes, operations)`` of one launch: every
input read once and every output written once, and the multiply-adds
(two operations each) the kernel does on its inputs.  Where the work
depends on the data (K5's causal mask), the count is what this launch's
rows need.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

# H100 80GB HBM3 (SXM5) data sheet, 700 W: HBM3 bandwidth, dense tensor-core
# peaks (bf16; f32 without TF32 on the CUDA cores; int8), and NVLink 4's
# 900 GB/s total, 450 GB/s in each direction, between the 8 cards of a node
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OPS = 1979e12
NVLINK_BYTES_PER_S = 450e9
NODE_CARDS = 8
# streaming multiprocessors of the H100 SXM5 (the data sheet's 132): the
# dry run sizes the short-prefill body's partials, which its plan spreads
# over the SMs, as on this card
SMS = 132

Cost = Tuple[float, float]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def matmul_cost(x: torch.Tensor, streams: Sequence[torch.Tensor], N: int,
                out_dtype: torch.dtype) -> Cost:
    """One K1-K3 launch: x (M, K), the int32 word streams it reads and the
    f32 scale read once, the (M, N) output written once; 2 M N K."""
    M, K = x.shape
    out_size = torch.empty((), dtype=out_dtype, device="meta").element_size()
    return (_nbytes(x) + sum(s.numel() * 4 for s in streams) + N * 4 + M * N * out_size,
            2.0 * M * N * K)


def qk_cost(q_codes: torch.Tensor, streams: Sequence[torch.Tensor], S: int) -> Cost:
    """One K4 launch: the int32 query codes (BH, M, D) and K streams read,
    the (BH, M, S) int32 scores written; 2 BH M S D."""
    BH, M, D = q_codes.shape
    return (q_codes.numel() * 4 + sum(s.numel() * 4 for s in streams) + BH * M * S * 4,
            2.0 * BH * M * S * D)


def flash_cost(q: torch.Tensor, k: torch.Tensor, q_offset: int = 0,
               stats: bool = False) -> Cost:
    """One K5 launch of q (B, Sq, Hq, hd), query row i at key position
    ``q_offset + i``, against k/v (B, Skv, Hkv, hd): q read and o written,
    k and v read up to the last row's position, the f32 (m, l) row
    statistics written where asked; QK^T and PV over the keys each row
    sees under the causal mask (row i sees q_offset + i + 1 of them)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    keys = Sq * q_offset + Sq * (Sq + 1) // 2
    nbytes = (2 * q.numel() + 2 * B * (q_offset + Sq) * Hkv * hd) * q.element_size()
    if stats:
        nbytes += 2 * B * Hq * Sq * 4
    return nbytes, 4.0 * B * Hq * hd * keys


def recompose_cost(words_high: torch.Tensor, words_low: torch.Tensor, K: int) -> Cost:
    """One K6 launch: both int32 streams read, the (K, N) int8 codes
    written; one shift-add per code."""
    N = words_high.shape[-1]
    return (words_high.numel() + words_low.numel()) * 4 + K * N, float(K * N)
