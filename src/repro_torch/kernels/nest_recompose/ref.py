"""Plain PyTorch version of the fused nest-recompose kernel (K6),
mirroring ``repro/kernels/nest_recompose/ref.py``."""
from __future__ import annotations

import torch

from ...core import packing
from ...core.decompose import recompose


def recompose_ref(words_high, words_low, *, n: int, h: int, K: int,
                  block_k: int) -> torch.Tensor:
    """Block-packed w_high (h-bit) + w_low ((n-h+1)-bit) -> int8 INT-n codes."""
    wh = packing.unpack_blocked(words_high, h, K, block_k, axis=0)
    wl = packing.unpack_blocked(words_low, n - h + 1, K, block_k, axis=0)
    return recompose(wh, wl, n, h).to(torch.int8)
