"""Attention: GQA + RoPE, direct attention for short prefill and decode,
and the blockwise (flash-semantics) path used for long prefill, with its
backward; counterpart of ``repro/models/attention.py``.

A prompt over 1024 tokens goes from ``models/model.py::attn_seq`` to the
flash-attention op (``kernels/flash_attention``).  Served (no gradient),
the op launches the hand-written kernel K5 on the card and
``blockwise_forward`` is its plain version (CPU tensors and
``reference_pass``).  In training the op runs :class:`BlockwiseAttention`,
the reference's ``custom_vjp``: K5 (or the plain forward) also gives the
row statistics (m, l), and the backward is the reference's blockwise
``_flash_bwd``, plain PyTorch on both devices (the JAX package has no
backward kernel).  Scores and the softmax are f32; the probabilities are
cast to v's dtype before the PV product.

Each takes a block of query rows at an offset into the keys
(``q_offset``): a sequence-parallel rank's rows of the causal prefill,
where the reference lets GSPMD split the query sequence.  A decode step
against a KV cache whose sequence dim is split over ranks combines the
blocks' softmax pieces across them (:func:`decode_attention_block`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..distributed import comm
from ..kernels import dispatch

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


def _flash_fwd_inner(q, k, v, causal: bool, kv_block: int, q_offset: int = 0):
    """Plain forward over KV blocks with running (max, denom, acc), so the
    Sq x Skv score matrix is never formed; Skv a multiple of ``kv_block``,
    query row i at key position ``q_offset + i``.  Under ``causal`` the
    blocks wholly past the last row are skipped (their p is exactly 0).
    Returns (o in q's dtype, m, l), m and l the f32 row statistics
    (B, Hkv, G, Sq) the backward recomputes the probabilities from."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, hd), dtype=torch.float32, device=q.device)
    end = min(Skv, q_offset + Sq) if causal else Skv
    for j in range(-(-end // kv_block)):
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
    return torch.movedim(o, -2, 1).reshape(B, Sq, Hq, hd).to(q.dtype), m, l


def blockwise_forward(q, k, v, causal: bool = True, kv_block: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """The plain forward alone (no row statistics, nothing saved): the
    served path's plain version of K5.  A Skv that is no multiple of
    ``kv_block`` runs direct attention, as the reference does."""
    if k.shape[1] % kv_block != 0:
        return full_attention(q, k, v, causal=causal, q_offset=q_offset)
    return _flash_fwd_inner(q, k, v, causal, kv_block, q_offset)[0]


def _flash_bwd(q, k, v, o, m, l, do, causal: bool, kv_block: int, q_offset: int = 0):
    """The reference's ``_flash_bwd``: D = sum dO * O, then per KV block
    recompute p = exp(s - m) / l from the saved row statistics and form
    dv, dp, ds = p (dp - D) scale, dq, and dk and dv summed over each GQA
    group - every product in f32, the Sq x Skv matrix never formed at once.
    A ragged last block is as wide as what is left of Skv.  Under
    ``causal`` the query rows before a block's first key see none of its
    keys (their p is exactly 0 there), so each block's products start at
    that row, and the blocks past the last row (dk = dv = 0) are skipped."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    dog = do.reshape(B, Sq, Hkv, G, hd).float()
    og = o.reshape(B, Sq, Hkv, G, hd).float()
    delta = torch.movedim((dog * og).sum(dim=-1), 1, -1)          # (B,Hkv,G,Sq)
    linv = 1.0 / torch.clamp(l, min=1e-30)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    dq = torch.zeros_like(qg)
    dk = torch.zeros((B, Skv, Hkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    end = min(Skv, q_offset + Sq) if causal else Skv
    for j0 in range(0, end, kv_block):
        j1 = min(j0 + kv_block, Skv)
        r0 = max(j0 - q_offset, 0) if causal else 0
        kj, vj = k[:, j0:j1].float(), v[:, j0:j1].float()
        qr, dor = qg[:, r0:], dog[:, r0:]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qr, kj) * scale
        if causal:
            kpos = torch.arange(j0, j1, device=q.device)
            s = torch.where(kpos[None, :] <= qpos[r0:, None], s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - m[..., r0:, None]) * linv[..., r0:, None]
        dv[:, j0:j1] = torch.einsum("bhgqk,bqhgd->bkhd", p, dor)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dor, vj)
        ds = p * (dp - delta[..., r0:, None]) * scale
        del s, p, dp
        dq[:, r0:] += torch.einsum("bhgqk,bkhd->bqhgd", ds, kj)
        dk[:, j0:j1] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qr)
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class BlockwiseAttention(torch.autograd.Function):
    """Flash-semantics attention with a blockwise backward: the counterpart
    of the reference's ``custom_vjp`` pair ``_flash_fwd`` / ``_flash_bwd``.

    Forward: a CUDA tensor launches K5 with its row statistics (or raises),
    as an abstract tensor counts that launch (``dispatch.is_abstract``);
    a CPU tensor, or any tensor inside ``dispatch.reference_pass``, runs
    the plain blockwise forward.  Either way o and the f32 (m, l) are
    saved.  A Skv that is no multiple of ``kv_block`` takes direct
    attention on the plain path and saves no statistics; its backward is
    then direct attention's own, as the reference differentiates
    ``full_attention`` there (K5 masks a ragged Skv itself and writes the
    statistics, so the blockwise backward takes a ragged last block)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kv_block: int, q_offset: int = 0):
        if dispatch.is_abstract(q) or dispatch.takes_kernel(q):
            if not causal:
                raise ValueError("K5 is causal attention; a non-causal call on the card "
                                 "has no kernel")
            from ..kernels.flash_attention import ops

            o, m, l = ops.flash_attention_stats(q, k, v, q_offset)
        else:
            dispatch.counter("flash_attention").plain_launches += 1
            if k.shape[1] % kv_block != 0:
                o = full_attention(q, k, v, causal=causal, q_offset=q_offset)
                m = l = None
            else:
                o, m, l = _flash_fwd_inner(q, k, v, causal, kv_block, q_offset)
        ctx.causal, ctx.kv_block, ctx.q_offset = causal, kv_block, q_offset
        ctx.save_for_backward(q, k, v, o, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        if m is None:
            with torch.enable_grad():
                leaves = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
                out = full_attention(*leaves, causal=ctx.causal, q_offset=ctx.q_offset)
                grads = torch.autograd.grad(out, leaves, do)
        else:
            grads = _flash_bwd(q, k, v, o, m, l, do, ctx.causal, ctx.kv_block, ctx.q_offset)
        return grads + (None, None, None)


def blockwise_attention(q, k, v, causal: bool = True, kv_block: int = 512,
                        q_offset: int = 0) -> torch.Tensor:
    """Flash-semantics attention, differentiable (:class:`BlockwiseAttention`).
    q: (B,Sq,Hq,hd), k/v: (B,Skv,Hkv,hd), query row i at key position
    ``q_offset + i``."""
    return BlockwiseAttention.apply(q, k, v, causal, kv_block, q_offset)


def decode_attention(q, k_cache, v_cache, pos: int) -> torch.Tensor:
    """One-token attention. q: (B,1,Hq,hd); caches (B,S,Hkv,hd); entries at
    positions <= pos are valid."""
    return full_attention(q, k_cache, v_cache, causal=False, kv_len=pos + 1)


def _gather_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """Every cache block's ``x``, stacked on a new leading dim (one
    all-gather over the ranks that hold the blocks)."""
    return comm.all_gather(x[None], group, 0)


def decode_attention_block(q, k_blk, v_blk, pos: int, start: int, group) -> torch.Tensor:
    """One-token attention against this rank's block of a KV cache whose
    sequence dim is split over ``group``: k/v (B,Sb,Hkv,hd) hold positions
    ``start`` .. ``start + Sb - 1``, those <= pos valid.  Each block gives
    its row max m, its sum of exponentials l = sum exp(s - m) and its f32
    product o = exp(s - m) v (the probabilities rounded to v's dtype, as
    the reference rounds its softmax); one all-gather brings every block's
    (m, l, o), and the softmax over the whole cache is sum_r exp(m_r - M)
    o_r / sum_r exp(m_r - M) l_r, M the largest m_r (a block holding no
    valid position weighs exp(-1e30 - M) = 0)."""
    B, _, Hq, hd = q.shape
    Sb, Hkv = k_blk.shape[1], k_blk.shape[2]
    G = Hq // Hkv
    s = _gqa_scores(q.reshape(B, 1, Hkv, G, hd), k_blk) / math.sqrt(hd)    # (B,Hkv,G,1,Sb)
    valid = start + torch.arange(Sb, device=q.device) <= pos
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    o = torch.einsum("bhgqk,bkhd->bhgqd", e.to(v_blk.dtype).float(), v_blk.float())
    blocks = _gather_blocks(torch.cat([m, e.sum(dim=-1, keepdim=True), o], dim=-1), group)
    m, l, o = blocks[..., :1], blocks[..., 1:2], blocks[..., 2:]
    w = torch.exp(m - m.amax(dim=0))
    o = (w * o).sum(dim=0) / (w * l).sum(dim=0)                            # (B,Hkv,G,1,hd)
    return torch.movedim(o, -2, 1).reshape(B, 1, Hq, hd).to(v_blk.dtype)
