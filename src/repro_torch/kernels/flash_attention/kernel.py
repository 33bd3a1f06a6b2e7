"""Binding of the K5 CUDA kernel (``csrc/flash_attention.cu``
``nq_flash_attention``), which replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py:60 flash_attention``.

Bound by the tensor cores' bf16 rate at long S; see the note at the top of
the CUDA source.  Operands are checked by the wrapper in ``ops.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import build

SOURCE = "flash_attention.cu"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    stats: Optional[torch.Tensor] = None, q_offset: int = 0) -> torch.Tensor:
    """o like q; q (B, Sq, Hq, hd) holds the query rows at key positions
    ``q_offset`` .. ``q_offset + Sq - 1`` of k/v (B, Skv, Hkv, hd).  With
    ``stats`` (a contiguous f32 (2, B, Hq, Sq) tensor) the kernel also
    writes each row's running max m and denominator l there."""
    B, Sq, Hq, hd = q.shape
    o = torch.empty_like(q)
    err = build.library(SOURCE).nq_flash_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o), build.ptr(stats),
        int(q.dtype == torch.bfloat16), B, Sq, k.shape[1], q_offset, Hq, k.shape[2], hd,
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    return o
