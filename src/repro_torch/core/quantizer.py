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


def compute_scale(w: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Per-tensor max-abs symmetric scale, as the reference computes it
    under ``jax.jit``: XLA turns the division by the constant qmax into a
    multiply by its f32 reciprocal (one ulp away from the division for
    some inputs)."""
    qmax = 2 ** (n_bits - 1) - 1
    amax = torch.clamp(w.float().abs().amax(), min=1e-12)
    return amax * torch.tensor(1.0 / qmax, dtype=torch.float32)


def quantize_rtn(w: torch.Tensor, scale: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Round-to-nearest quantization (Eq. 2). Returns int32 codes."""
    lo, hi = int_range(n_bits)
    return torch.clamp(torch.round(w.float() / scale), lo, hi).to(torch.int32)


def dequantize(w_int: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Eq. 3: w_hat = s * w_int."""
    return (w_int.float() * scale).to(dtype)


def perturbation(w: torch.Tensor, w_int: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Eq. 4: delta_w = w/s - w_int."""
    return w.float() / scale - w_int.float()


def sqnr_db(w: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    """Signal-to-quantization-noise ratio in dB (a quality proxy), in f32
    on the tensors' device."""
    w = w.float()
    err = w - w_hat.float()
    return 10.0 * torch.log10(torch.sum(w * w) / torch.clamp(torch.sum(err * err), min=1e-30))
