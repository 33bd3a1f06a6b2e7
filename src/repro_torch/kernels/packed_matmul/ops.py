"""Public wrapper of the packed matmul (K1): device dispatch + weight
preparation; counterpart of ``repro/kernels/packed_matmul/ops.py``."""
from __future__ import annotations

from typing import Tuple

import torch

from ...core import packing
from ...core.nesting import NestedTensor
from .. import dispatch
from . import kernel, ref

DEFAULT_BLOCK_K = 512
COUNTER = dispatch.counter("packed_matmul")


def prepare(nt: NestedTensor, mode: str = "full",
            block_k: int = DEFAULT_BLOCK_K) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """NestedTensor -> (block-packed words, scale, k, K) for one stream:
    'full' re-packs the recomposed top-rung codes as one n-bit stream,
    'part' the base codes with the inflated scale s*2^(n-h) (Eq. 10).
    K pads up to a ``block_k`` multiple."""
    if len(nt.shape) != 2:
        raise ValueError("prepare expects a 2-D weight")
    if mode == "full":
        codes, k, scale = nt.codes_at(nt.top), nt.n, nt.scale
    else:
        codes, k, scale = nt.codes_base(), nt.h, nt.rung_scale(0)
    pad = (-nt.K) % block_k
    if pad:
        codes = torch.cat([codes, codes.new_zeros((pad,) + tuple(codes.shape[1:]))])
    words = packing.pack_blocked(codes, k, block_k, axis=0)
    return words, scale.reshape(1, -1), k, codes.shape[0]


def packed_matmul(x, words, scale, *, k: int, K: int,
                  block_k: int = DEFAULT_BLOCK_K, out_dtype=None, route=None):
    """y = x @ dequant(words), x (..., K).  A CUDA tensor launches the K1
    kernel (or raises on operands it does not take) on the body
    ``dispatch.kernel_route`` picks - by M and dtype, or ``route`` where
    the chip check, a test or the decode phase (``DECODE``) names
    one; a CPU tensor runs the plain version; an abstract tensor
    (``dispatch.is_abstract``) counts the launches the card would make."""
    out_dtype = out_dtype or x.dtype
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1])
    if dispatch.is_abstract(x2):
        route = dispatch.abstract_route(x2, route)
        dispatch.check_operands(x2, (words,), (k,), scale, K=K, block=block_k,
                                out_dtype=out_dtype)
        y = dispatch.launch_abstract(x2, words.shape[1], out_dtype, route, COUNTER,
                                     (words,), (k,), block_k)
    elif dispatch.takes_kernel(x2):
        route = dispatch.kernel_route(x2, route)
        dispatch.check_operands(x2, (words,), (k,), scale, K=K, block=block_k,
                                out_dtype=out_dtype)
        y = dispatch.launch_matmul(
            x2, words.shape[1], out_dtype, route, COUNTER,
            lambda xs, out, body: kernel.packed_matmul(
                xs, words, scale, k=k, K=K, block_k=block_k, out_dtype=out_dtype,
                body=body, out=out), streams=1)
    else:
        y = ref.packed_matmul_ref(x2, words, scale, k=k, K=K, block_k=block_k,
                                  out_dtype=out_dtype)
        COUNTER.plain_launches += 1
    return y.reshape(lead + (y.shape[-1],))
