"""Bindings of the K2 and K3 CUDA kernels (``csrc/nest_matmul.cu``):

* ``nq_nested_matmul`` replaces ``repro/kernels/nested_matmul/kernel.py:61
  nested_matmul`` (dual stream: base + one delta);
* ``nq_ladder_matmul`` replaces ``repro/kernels/nested_matmul/kernel.py:125
  ladder_matmul`` (base + R resident deltas, 2..4 streams in all).

Five bodies, picked by the caller (``body``, ``dispatch.BODY``): the
decode body (M <= 8), the short-prefill body (bf16 at M 9-63,
``csrc/nest_matmul_mid.cu``), the tensor-core body (bf16 at prefill M),
the f32 body (f32 above M 8, ``csrc/nest_matmul_f32.cu``) and the
CUDA-core body (reached only by name); what bounds each and what its design
does about it is in the note at the top of each CUDA source.  Operands
are checked by the wrappers in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

SOURCE = "nest_matmul.cu"


def nested_matmul(x, words_high, words_low, scale, *, n: int, h: int, K: int,
                  block_k: int, out_dtype, body: int, out=None) -> torch.Tensor:
    if body in build.STREAMS_ENTRY:
        return build.streams_matmul(x, (words_high, words_low), (h, n), scale, K=K,
                                    block=block_k, out_dtype=out_dtype, body=body, out=out,
                                    what="nested_matmul")
    N = words_high.shape[1]
    out, partial, counters, stream = build.stream_matmul_buffers(
        x, N, K, block_k, out_dtype, body, (h, n), out)
    err = build.library(SOURCE).nq_nested_matmul(
        build.ptr(x), int(x.dtype == torch.bfloat16), build.ptr(words_high),
        build.ptr(words_low), n, h, build.ptr(scale), build.ptr(out),
        int(out_dtype == torch.float32), build.ptr(partial), build.numel(partial),
        build.ptr(counters), build.numel(counters), x.shape[0], N, K, block_k, body, stream)
    build.check(err, "nested_matmul")
    return out


def ladder_matmul(x, streams, scale, *, bits, K: int, block_k: int,
                  out_dtype, body: int, out=None) -> torch.Tensor:
    if body in build.STREAMS_ENTRY:
        return build.streams_matmul(x, streams, bits, scale, K=K, block=block_k,
                                    out_dtype=out_dtype, body=body, out=out,
                                    what="ladder_matmul")
    N = streams[0].shape[1]
    out, partial, counters, stream = build.stream_matmul_buffers(
        x, N, K, block_k, out_dtype, body, bits, out)
    ptrs = (ctypes.c_void_p * len(streams))(*[s.data_ptr() for s in streams])
    bit_arr = (ctypes.c_int * len(bits))(*bits)
    err = build.library(SOURCE).nq_ladder_matmul(
        build.ptr(x), int(x.dtype == torch.bfloat16), ctypes.addressof(ptrs),
        ctypes.addressof(bit_arr), len(streams), build.ptr(scale), build.ptr(out),
        int(out_dtype == torch.float32), build.ptr(partial), build.numel(partial),
        build.ptr(counters), build.numel(counters), x.shape[0], N, K, block_k, body, stream)
    build.check(err, "ladder_matmul")
    return out
