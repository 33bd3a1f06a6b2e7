"""Bindings of the K2 and K3 CUDA kernels (``csrc/nest_matmul.cu``):

* ``nq_nested_matmul`` replaces ``repro/kernels/nested_matmul/kernel.py:61
  nested_matmul`` (dual stream: base + one delta);
* ``nq_ladder_matmul`` replaces ``repro/kernels/nested_matmul/kernel.py:125
  ladder_matmul`` (base + R resident deltas, 2..4 streams in all).

Bound by the packed words' bytes at decode shapes and by the tensor cores'
bf16 rate at prefill M (``tensor_cores=True``, the second body); see the
note at the top of the CUDA source.  Operands are checked by the wrappers in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

SOURCE = "nest_matmul.cu"


def nested_matmul(x, words_high, words_low, scale, *, n: int, h: int, K: int,
                  block_k: int, out_dtype, tensor_cores: bool) -> torch.Tensor:
    N = words_high.shape[1]
    out, partial, stream = build.stream_matmul_buffers(x, N, K, block_k, out_dtype,
                                                       tensor_cores)
    err = build.library(SOURCE).nq_nested_matmul(
        build.ptr(x), int(x.dtype == torch.bfloat16), build.ptr(words_high),
        build.ptr(words_low), n, h, build.ptr(scale), build.ptr(out),
        int(out_dtype == torch.float32), build.ptr(partial), x.shape[0], N, K,
        block_k, int(tensor_cores), stream)
    build.check(err, "nested_matmul")
    return out


def ladder_matmul(x, streams, scale, *, bits, K: int, block_k: int,
                  out_dtype, tensor_cores: bool) -> torch.Tensor:
    N = streams[0].shape[1]
    out, partial, stream = build.stream_matmul_buffers(x, N, K, block_k, out_dtype,
                                                       tensor_cores)
    ptrs = (ctypes.c_void_p * len(streams))(*[s.data_ptr() for s in streams])
    bit_arr = (ctypes.c_int * len(bits))(*bits)
    err = build.library(SOURCE).nq_ladder_matmul(
        build.ptr(x), int(x.dtype == torch.bfloat16), ctypes.addressof(ptrs),
        ctypes.addressof(bit_arr), len(streams), build.ptr(scale), build.ptr(out),
        int(out_dtype == torch.float32), build.ptr(partial), x.shape[0], N, K,
        block_k, int(tensor_cores), stream)
    build.check(err, "ladder_matmul")
    return out
