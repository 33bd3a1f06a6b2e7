"""Binding of the K6 CUDA kernel (``csrc/nest_recompose.cu``
``nq_nest_recompose``), which replaces the TPU kernel
``repro/kernels/nest_recompose/kernel.py:28 nest_recompose``.

Bound by bytes: (h + l + 1) / 8 read and 1 written per weight; see the
note at the top of the CUDA source.  Operands are checked by the wrapper
in ``ops.py``.
"""
from __future__ import annotations

import torch

from .. import build

SOURCE = "nest_recompose.cu"


def nest_recompose(words_high: torch.Tensor, words_low: torch.Tensor, *, n: int,
                   h: int, K: int, block_k: int) -> torch.Tensor:
    N = words_high.shape[1]
    out = torch.empty((K, N), dtype=torch.int8, device=words_high.device)
    err = build.library(SOURCE).nq_nest_recompose(
        build.ptr(words_high), build.ptr(words_low), build.ptr(out), n, h, K, N,
        block_k, torch.cuda.current_stream(words_high.device).cuda_stream)
    build.check(err, "nest_recompose")
    return out
