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


def sqnr_db(w: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    """Signal-to-quantization-noise ratio in dB (a quality proxy), in f32
    on the tensors' device."""
    w = w.float()
    err = w - w_hat.float()
    return 10.0 * torch.log10(torch.sum(w * w) / torch.clamp(torch.sum(err * err), min=1e-30))
