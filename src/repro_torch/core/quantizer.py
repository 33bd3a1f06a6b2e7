"""Symmetric linear quantization (paper Sec. 3.1, Eqs. 2-4); counterpart of
``repro/core/quantizer.py``.

Signed INT-n, symmetric, zero-point-free:
    w_int = Clip(round(w / s), -2^(n-1), 2^(n-1) - 1)
    w_hat = s * w_int
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch


def int_range(n_bits: int):
    """[min, max] of signed INT-n (paper's clip thresholds)."""
    return -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1


def dequantize(w_int: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Eq. 3: w_hat = s * w_int."""
    return (w_int.float() * scale).to(dtype)
