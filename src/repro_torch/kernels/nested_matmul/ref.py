"""Plain PyTorch versions of the nested dequant-matmuls (K2 dual stream,
K3 ladder), mirroring ``repro/kernels/nested_matmul/ref.py``."""
from __future__ import annotations

from ...core import packing
from ...core.decompose import chain_recompose, delta_bits, normalize_bits, recompose


def nested_matmul_ref(x, words_high, words_low, scale, *, n: int, h: int,
                      K: int, block_k: int, out_dtype=None):
    """y = x @ (recompose(unpack(w_high), unpack(w_low)) * scale)."""
    wh = packing.unpack_blocked(words_high, h, K, block_k, axis=0)
    wl = packing.unpack_blocked(words_low, n - h + 1, K, block_k, axis=0)
    w = recompose(wh, wl, n, h).float() * scale
    return (x.float() @ w).to(out_dtype or x.dtype)


def ladder_matmul_ref(x, streams, scale, *, bits, K: int, block_k: int,
                      out_dtype=None):
    """y = x @ (chain-recompose(streams) * scale); streams = (base,
    delta_0, ...), bits the ascending RESIDENT bitwidths, one per stream."""
    bits = normalize_bits(bits)
    if len(streams) != len(bits):
        raise ValueError(f"{len(streams)} streams for bits {bits}")
    widths = delta_bits(bits)
    codes = chain_recompose(
        packing.unpack_blocked(streams[0], bits[0], K, block_k, axis=0),
        [packing.unpack_blocked(streams[i], widths[i - 1], K, block_k, axis=0)
         for i in range(1, len(streams))],
        bits)
    w = codes.float() * scale
    return (x.float() @ w).to(out_dtype or x.dtype)
