"""Ops over the nested-attention kernel (K4); counterpart of
``repro/kernels/nested_attention/ops.py``:

* :func:`quantize_q` - per-query symmetric INT quantization (amax over
  the head dim), the activation half of the integer score path;
* :func:`ladder_qk_scores` - raw int32 QK^T: a CUDA tensor launches K4
  (or raises), a CPU tensor runs the plain version - the same integer
  arithmetic either way;
* :func:`nested_attention` - the whole op: integer scores, then the
  scales, the rung shift, the softmax and PV as plain f32 tensor code
  outside the kernel, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.packing import blocked_rows
from ...core.quantizer import int_range
from .. import costs, dispatch
from . import kernel, ref

COUNTER = dispatch.counter("nested_qk")


def quantize_q(q, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, M, D) float queries -> (codes int32, scale (BH, M, 1) f32),
    a per-query symmetric INT-n scale (amax over D), which factors out of
    the contraction like the per-position K scale."""
    lo, hi = int_range(n)
    x = q.float()
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / hi
    codes = torch.clamp(torch.round(x / scale), lo, hi).to(torch.int32)
    return codes, scale


def ladder_qk_scores(q_codes, streams, *, bits, page: int) -> torch.Tensor:
    """Raw int32 scores (BH, M, npages * page) over packed nested K pages.
    A CUDA tensor launches K4 (or raises); a CPU tensor runs the plain
    version; an abstract tensor counts the launch the card would make."""
    streams, bits = tuple(streams), ref.resident_bits(bits)
    if dispatch.is_abstract(q_codes):
        dispatch.check_qk_operands(q_codes, streams, bits, page)
        BH, M, _ = q_codes.shape
        S = streams[0].shape[1] // blocked_rows(page, bits[0]) * page
        dispatch.count_abstract(COUNTER, "cuda", costs.qk_cost(q_codes, streams, S))
        return torch.empty((BH, M, S), dtype=torch.int32, device=q_codes.device)
    if dispatch.takes_kernel(q_codes):
        dispatch.check_qk_operands(q_codes, streams, bits, page)
        out = kernel.nested_qk(q_codes, streams, bits=bits, page=page)
        COUNTER.launches += 1
        return out
    COUNTER.plain_launches += 1
    return ref.nested_qk_ref(q_codes, streams, bits=bits, page=page)


def nested_attention(q, k_streams, k_scale, v_streams, v_scale, *, bits,
                     page: int, rung: int) -> torch.Tensor:
    """Nested-KV attention at ``rung``.

    q: (BH, M, D) float queries; k_streams/v_streams: the resident streams
    (base + deltas[:rung]), each (BH, npages * rows_i, D) packed int32;
    k_scale/v_scale: (BH, S, 1) f32 per-position scales; bits: the FULL
    ladder (the resident prefix is bits[:rung + 1]).  Integer QK^T, then
    in f32: scores * q_scale * k_scale * 2^(top - bits[rung]) / sqrt(D),
    softmax, and probs @ dequant(V).  Returns (BH, M, D) f32."""
    bits = tuple(int(b) for b in bits)
    resident = bits[:1 + rung]
    shift = 2.0 ** (bits[-1] - bits[rung])
    qc, q_scale = quantize_q(q, bits[-1])
    raw = ladder_qk_scores(qc, k_streams, bits=resident, page=page)
    scores = (raw.float() * q_scale * k_scale.transpose(1, 2) * shift
              / torch.sqrt(torch.tensor(float(q.shape[-1]), device=q.device)))
    probs = torch.softmax(scores, dim=-1)
    vc = ref.unpack_k_codes(tuple(v_streams), bits=resident, page=page)
    v = vc.float() * v_scale * shift
    return torch.einsum("bms,bsd->bmd", probs, v)
