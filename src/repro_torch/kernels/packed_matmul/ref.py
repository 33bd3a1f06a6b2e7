"""Plain PyTorch version of the packed dequant-matmul (K1), mirroring
``repro/kernels/packed_matmul/ref.py``."""
from __future__ import annotations

from ...core import packing


def packed_matmul_ref(x, words, scale, *, k: int, K: int, block_k: int,
                      out_dtype=None):
    """y = x @ (unpack(words) * scale), in f32, cast to ``out_dtype``."""
    codes = packing.unpack_blocked(words, k, K, block_k, axis=0)
    w = codes.float() * scale
    return (x.float() @ w).to(out_dtype or x.dtype)
