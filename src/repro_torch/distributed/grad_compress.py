"""Quantized gradient all-reduce with error feedback; counterpart of
``repro/distributed/grad_compress.py``.

Gradients are symmetrically quantized to INT8 before the data-parallel
all-reduce, with an error-feedback residual [Seide et al. 2014;
Karimireddy et al. 2019] carried across steps so the compression bias
vanishes.  The reference calls ``compress_decompress`` inside a
``shard_map`` with an explicit ``psum``; here each rank calls it on its
own gradient with a process group, and the sums are ``all_reduce``s of
the int32 codes, the scale and a count of one (``comm.py`` counts their
bytes).  The arithmetic is the reference's as XLA compiles it (the
reference runs only under ``jit``): the scale times the f32 reciprocal
of 127, the residual one fused multiply-subtract, and
``summed * (scale_sum / n) / n``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import tree
from ..core.quantizer import compute_scale, quantize_rtn
from . import comm


def compress_decompress(g: torch.Tensor, residual: torch.Tensor,
                        group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce of one gradient tensor over
    ``group`` (None: this rank alone) -> (averaged gradient, new residual)."""
    g32 = g.float() + residual
    scale = compute_scale(g32, 8)
    codes = quantize_rtn(g32, scale, 8)
    # the reference's g32 - dequantize(codes, scale) compiles to one fused
    # multiply-subtract: the exact product, rounded once with the difference
    new_residual = (g32.double() - codes.double() * scale.double()).float()
    summed = comm.all_reduce(codes, group)                 # int8-width transport
    scale_sum = comm.all_reduce(scale, group)
    n = comm.all_reduce(torch.ones((), dtype=torch.float32, device=g.device), group)
    g_avg = summed.float() * (scale_sum / n) / n
    return g_avg, new_residual


def compressed_mean_tree(grads, residuals, group):
    """Tree-wise error-feedback compressed mean across ``group``."""
    pairs = [compress_decompress(g, r, group)
             for g, r in zip(tree.leaves(grads), tree.leaves(residuals))]
    return (tree.unflatten(grads, [p[0] for p in pairs]),
            tree.unflatten(grads, [p[1] for p in pairs]))


def init_residuals(params):
    return tree.map_with_path(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
