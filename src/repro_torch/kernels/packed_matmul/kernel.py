"""Binding of the K1 CUDA kernel (``csrc/nest_matmul.cu``
``nq_packed_matmul``), which replaces the TPU kernel
``repro/kernels/packed_matmul/kernel.py:48 packed_matmul``.

Five bodies, picked by the caller (``body``, ``dispatch.BODY``): the
decode body (M <= 8, bound by the packed words' bytes and in practice by
the unpack's integer instructions), the short-prefill body (bf16 at M
9-63, ``csrc/nest_matmul_mid.cu``, bound likewise), the tensor-core body
(bf16 at prefill M, bound by the tensor cores' bf16 rate), the f32 body
(f32 above M 8, ``csrc/nest_matmul_f32.cu``, bound by the f32 FMAs) and
the CUDA-core body (reached only by name: the "before" of the chip
check's rows); see the note at the top of each CUDA source for what each
design does about its bound.  Operands are checked
by the wrapper in ``ops.py`` before this is called.
"""
from __future__ import annotations

import torch

from .. import build

SOURCE = "nest_matmul.cu"


def packed_matmul(x: torch.Tensor, words: torch.Tensor, scale: torch.Tensor, *,
                  k: int, K: int, block_k: int, out_dtype, body: int,
                  out=None) -> torch.Tensor:
    if body in build.STREAMS_ENTRY:
        return build.streams_matmul(x, (words,), (k,), scale, K=K, block=block_k,
                                    out_dtype=out_dtype, body=body, out=out,
                                    what="packed_matmul")
    N = words.shape[1]
    out, partial, counters, stream = build.stream_matmul_buffers(
        x, N, K, block_k, out_dtype, body, (k,), out)
    err = build.library(SOURCE).nq_packed_matmul(
        build.ptr(x), int(x.dtype == torch.bfloat16), build.ptr(words), k,
        build.ptr(scale), build.ptr(out), int(out_dtype == torch.float32),
        build.ptr(partial), build.numel(partial),
        build.ptr(counters), build.numel(counters), x.shape[0], N, K,
        block_k, body, stream)
    build.check(err, "packed_matmul")
    return out
