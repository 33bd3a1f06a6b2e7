"""Public wrapper of the flash-attention kernel (K5): device dispatch;
counterpart of ``repro/kernels/flash_attention/ops.py``.

The reference sends an S that is not a multiple of its block to
``attention_ref``; here a CUDA tensor launches K5 at any S (the kernel
masks a ragged tail itself) or raises, and a CPU tensor runs the plain
version, the model's ``blockwise_forward`` (as the reference model's
long prefill does).  Where a gradient is asked for, the op runs the
model's differentiable ``blockwise_attention`` instead, whose forward
launches K5 through :func:`flash_attention_stats`.  ``ref.attention_ref``
is the tests' oracle."""
from __future__ import annotations

import torch

from ...models.attention import blockwise_attention, blockwise_forward
from .. import costs, dispatch
from . import kernel

COUNTER = dispatch.counter("flash_attention")


def flash_attention(q, k, v, kv_block: int = 512, q_offset: int = 0):
    """Causal GQA attention: q (B,Sq,Hq,hd), k/v (B,Skv,Hkv,hd) -> (B,Sq,Hq,hd)
    in q's dtype, query row i at key position ``q_offset + i`` (a
    sequence-parallel rank's block of rows; 0 with Sq = Skv for the whole
    sequence).  With grad enabled and an input that requires it, the
    differentiable ``blockwise_attention`` (K5 with its row statistics on
    the card, the blockwise backward).  Otherwise a CUDA tensor launches
    K5 (or raises), an abstract tensor counts that launch
    (``dispatch.is_abstract``) and a CPU tensor runs the plain blockwise version with
    ``kv_block`` keys per block (a Skv that is no multiple of it runs
    direct attention)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return blockwise_attention(q, k, v, True, kv_block, q_offset)
    if dispatch.is_abstract(q):
        return _abstract(q, k, v, q_offset)[0]
    if dispatch.takes_kernel(q):
        dispatch.check_flash_operands(q, k, v, q_offset)
        o = kernel.flash_attention(q, k, v, q_offset=q_offset)
        COUNTER.launches += 1
        return o
    COUNTER.plain_launches += 1
    return blockwise_forward(q, k, v, True, kv_block, q_offset)


def flash_attention_stats(q, k, v, q_offset: int = 0):
    """K5 on the card with its row statistics: (o, m, l), m and l f32
    (B, Hkv, G, Sq), the layout of the plain forward's.  The training
    forward's launch; it is counted like the served one.  An abstract
    tensor counts the launch the card would make."""
    if dispatch.is_abstract(q):
        return _abstract(q, k, v, q_offset, stats=True)
    dispatch.check_flash_operands(q, k, v, q_offset)
    B, Sq, Hq, _ = q.shape
    Hkv = k.shape[2]
    stats = torch.empty((2, B, Hq, Sq), dtype=torch.float32, device=q.device)
    o = kernel.flash_attention(q, k, v, stats, q_offset)
    COUNTER.launches += 1
    m, l = (t.view(B, Hkv, Hq // Hkv, Sq) for t in stats.unbind(0))
    return o, m, l


def _abstract(q, k, v, q_offset: int, stats: bool = False):
    """K5 on abstract tensors: its checks, its outputs (o; with ``stats``
    also m and l, views of one (2, B, Hq, Sq) f32 buffer as on the card)
    and the launch counted with its work."""
    dispatch.check_flash_operands(q, k, v, q_offset)
    B, Sq, Hq, _ = q.shape
    Hkv = k.shape[2]
    o = torch.empty_like(q)
    dispatch.count_abstract(COUNTER, "cuda", costs.flash_cost(q, k, q_offset, stats))
    if not stats:
        return o, None, None
    buf = torch.empty((2, B, Hq, Sq), dtype=torch.float32, device=q.device)
    m, l = (t.view(B, Hkv, Hq // Hkv, Sq) for t in buf.unbind(0))
    return o, m, l
