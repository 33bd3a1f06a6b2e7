"""Attention: GQA + RoPE, direct attention for short prefill and decode,
and the forward of the blockwise (flash-semantics) path used for long
prefill; counterpart of ``repro/models/attention.py``.

This is plain tensor code, as in the reference.  A prompt over 1024
tokens goes from ``models/model.py::attn_seq`` to the flash-attention op
(``kernels/flash_attention``): on the card it launches the hand-written
kernel K5, and ``blockwise_attention`` is the op's plain version (CPU
tensors and ``reference_pass``).  Scores and the softmax are
f32; the probabilities are cast to v's dtype before the PV product.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _gqa_scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """qg: (B,Sq,Hkv,G,hd), k: (B,Skv,Hkv,hd) -> (B,Hkv,G,Sq,Skv) f32.
    Widening bf16 inputs is exact, so this is the f32-accumulated product."""
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())


def full_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                   kv_len: Optional[int] = None) -> torch.Tensor:
    """Direct attention. q: (B,Sq,Hq,hd), k/v: (B,Skv,Hkv,hd)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    s = _gqa_scores(q.reshape(B, Sq, Hkv, G, hd), k) / math.sqrt(hd)
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Skv, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    if kv_len is not None:
        valid = torch.arange(Skv, device=q.device) < kv_len
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(B, Sq, Hq, hd)


def blockwise_attention(q, k, v, causal: bool = True,
                        kv_block: int = 512) -> torch.Tensor:
    """Forward of flash-semantics attention: KV blocks with running
    (max, denom, acc) so the S x S score matrix is never formed.
    q: (B,S,Hq,hd), k/v: (B,S,Hkv,hd)."""
    B, S, Hq, hd = q.shape
    if S % kv_block != 0:
        return full_attention(q, k, v, causal=causal)
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, S, hd), dtype=torch.float32, device=q.device)
    for j in range(S // kv_block):
        kj = k[:, j * kv_block:(j + 1) * kv_block]
        vj = v[:, j * kv_block:(j + 1) * kv_block]
        s = _gqa_scores(qg, kj) * scale
        if causal:
            kpos = j * kv_block + torch.arange(kv_block, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vj.dtype).float(), vj.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return torch.movedim(o, -2, 1).reshape(B, S, Hq, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos: int) -> torch.Tensor:
    """One-token attention. q: (B,1,Hq,hd); caches (B,S,Hkv,hd); entries at
    positions <= pos are valid."""
    return full_attention(q, k_cache, v_cache, causal=False, kv_len=pos + 1)
