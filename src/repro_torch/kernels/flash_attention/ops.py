"""Public wrapper of the flash-attention kernel (K5): device dispatch;
counterpart of ``repro/kernels/flash_attention/ops.py``.

The reference sends an S that is not a multiple of its block to
``attention_ref``; here a CUDA tensor launches K5 at any S (the kernel
masks a ragged tail itself) or raises, and a CPU tensor runs the plain
version, the model's ``blockwise_attention`` (as the reference model's
long prefill does).  ``ref.attention_ref`` is the tests' oracle."""
from __future__ import annotations

from ...models.attention import blockwise_attention
from .. import dispatch
from . import kernel

COUNTER = dispatch.counter("flash_attention")


def flash_attention(q, k, v, kv_block: int = 512):
    """Causal GQA attention, forward: q (B,S,Hq,hd), k/v (B,S,Hkv,hd) ->
    (B,S,Hq,hd) in q's dtype.  A CUDA tensor launches K5 (or raises); a
    CPU tensor runs the plain blockwise version with ``kv_block`` keys per
    block (an S that is no multiple of it runs direct attention)."""
    if dispatch.takes_kernel(q):
        dispatch.check_flash_operands(q, k, v)
        o = kernel.flash_attention(q, k, v)
        COUNTER.launches += 1
        return o
    COUNTER.plain_launches += 1
    return blockwise_attention(q, k, v, True, kv_block)
