"""Plain PyTorch version of the flash-attention kernel (K5), mirroring
``repro/kernels/flash_attention/ref.py``: causal GQA attention, the same
math as ``models/attention.py``."""
from __future__ import annotations

from ...models.attention import full_attention


def attention_ref(q, k, v):
    """q: (B,S,Hq,hd), k/v: (B,S,Hkv,hd) -> (B,S,Hq,hd), causal."""
    return full_attention(q, k, v, causal=True)
