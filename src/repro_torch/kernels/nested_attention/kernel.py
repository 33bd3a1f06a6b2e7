"""Binding of the K4 CUDA kernel (``csrc/nested_qk.cu`` ``nq_nested_qk``),
which replaces the TPU kernel
``repro/kernels/nested_attention/kernel.py:69 nested_qk``.

Bound by the bytes of the packed K streams, queries and scores; see the
note at the top of the CUDA source.  Operands are checked by the wrapper
in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.packing import blocked_rows
from .. import build

SOURCE = "nested_qk.cu"


def nested_qk(q_codes: torch.Tensor, streams, *, bits, page: int) -> torch.Tensor:
    BH, M, D = q_codes.shape
    npages = streams[0].shape[1] // blocked_rows(page, bits[0])
    out = torch.empty((BH, M, npages * page), dtype=torch.int32, device=q_codes.device)
    ptrs = (ctypes.c_void_p * len(streams))(*[s.data_ptr() for s in streams])
    bit_arr = (ctypes.c_int * len(bits))(*bits)
    err = build.library(SOURCE).nq_nested_qk(
        build.ptr(q_codes), ctypes.addressof(ptrs), ctypes.addressof(bit_arr),
        len(streams), build.ptr(out), BH, M, D, npages, page,
        torch.cuda.current_stream(q_codes.device).cuda_stream)
    build.check(err, "nested_qk")
    return out

