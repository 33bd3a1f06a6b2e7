"""Public wrapper of the page-in upgrade recompose (K6): device dispatch;
counterpart of ``repro/kernels/nest_recompose/ops.py``."""
from __future__ import annotations

import torch

from .. import costs, dispatch
from . import kernel, ref

COUNTER = dispatch.counter("nest_recompose")


def nest_recompose(words_high, words_low, *, n: int, h: int, K: int,
                   block_k: int = 512) -> torch.Tensor:
    """clip(w_high * 2^(n-h) + w_low) -> (K, N) int8 INT-n codes.  A CUDA
    tensor launches K6 (or raises); a CPU tensor runs the plain version; an
    abstract tensor counts the launch the card would make."""
    if dispatch.is_abstract(words_high):
        dispatch.check_recompose_operands(words_high, words_low, n=n, h=h, K=K,
                                          block_k=block_k)
        dispatch.count_abstract(COUNTER, "cuda",
                                costs.recompose_cost(words_high, words_low, K))
        return torch.empty((K, words_high.shape[1]), dtype=torch.int8,
                           device=words_high.device)
    if dispatch.takes_kernel(words_high):
        dispatch.check_recompose_operands(words_high, words_low, n=n, h=h, K=K,
                                            block_k=block_k)
        out = kernel.nest_recompose(words_high, words_low, n=n, h=h, K=K, block_k=block_k)
        COUNTER.launches += 1
        return out
    COUNTER.plain_launches += 1
    return ref.recompose_ref(words_high, words_low, n=n, h=h, K=K, block_k=block_k)
