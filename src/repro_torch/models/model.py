"""LM assembly for every family the JAX package builds - dense and MoE
transformers, pure SSM stacks (mamba2) and the Zamba2 hybrid (a Mamba2
trunk and one shared attention/MLP block applied every N layers);
counterpart of ``repro/models/model.py``.

Parameters keep the reference's layout: a nested dict with layer weights
stacked on a leading L axis, so keystr paths, the recipe predicate (which
screens the stacked shape), per-(L, 1, N) scales and byte accounting all
match.  Where the reference scans layers with ``lax.scan``, the port
loops over them in Python with a per-layer view of every leaf
(:meth:`NestedTensor.layer` for nested ones).

Public surface, built by :func:`make_model` (fields of :class:`Model` in
the reference's order; take them by name):
  init(seed)                          -> params
  loss_fn(params, batch)              -> scalar f32 loss: next-token cross
                                         entropy + 0.01 * the MoE aux loss
  prefill(params, inputs)             -> (last_logits f32, cache)
  decode_step(params, inputs, cache)  -> (logits f32, cache)  (cache updated in place)
  decode_chunk(params, inputs, cache) -> (logits f32 (B,S,V), cache)  (the same;
                                         None for the ssm and hybrid families)
  make_cache(batch_size, max_len)     -> cache

``inputs`` holds ``tokens`` (B,S) or, for a config with
``input_kind="embeddings"`` (the stubbed vision and audio frontends),
``embeddings`` (B,S,d), which are cast to the compute dtype.

A MoE layer's FFN is ``models/moe.py::moe_ffn``: each expert with rows
runs its three matmuls through ``packed_linear`` on its 2-D view.  Runs
that build a cache (prefill) and every decode run route droplessly, as
the reference's do; ``loss_fn`` keeps the capacity-dropped dispatch and
sums the layers' Switch aux losses.

Training: ``loss_fn`` is differentiable in every dense leaf with
``torch.autograd``.  A long sequence's attention is the differentiable
``attention.blockwise_attention`` (K5 with its row statistics forward on
the card, the reference's blockwise backward).  With ``cfg.remat`` each
layer body (and the hybrid's shared block) runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` while a
gradient is being recorded: only the layer inputs are kept and the body
is recomputed in the backward, as ``jax.checkpoint(..., nothing_saveable)``
does.  On a nested tree ``loss_fn`` reads the packed words as serving
does (K1-K3 for every matmul, a row gather for the embedding).  A Mamba2 layer is ``models/mamba2.py``: only its
``in_proj`` and ``out_proj`` are matmuls; the hybrid's shared block runs
attention and a gelu MLP on concat(hidden, first embedding), 2d wide.

The decode phase (``decode_step`` and the speculative verify pass
``decode_chunk``) names the K1-K3 route ``dispatch.DECODE`` at every
batch, expert groups included: the decode body in groups of at most 8
rows, whose rows do not depend on how many rows a launch holds (so a
decode step above batch 8 runs one launch per 8-row group, not the
CUDA-core or tensor-core body that M alone would pick).  ``decode_chunk``
computes everything else (norms, attention, a MoE layer's router product,
softmax and top-k) through the very calls a decode step makes, one
position at a time, so position j of a chunk has bit for bit the logits
j sequential decode steps give it (the verify contract of
``repro/models/model.py``); expert rows are combined in one fixed order.
Prefill's expert groups take the route their M picks.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.nesting import NestedTensor
from ..device import resolve_device, torch_dtype
from ..distributed import ctx
from ..distributed.ctx import shard_hint
from ..kernels import dispatch
from ..kernels.flash_attention import ops as flash_ops
from . import mamba2
from .attention import decode_attention, decode_attention_block, full_attention
from .layers import (apply_rope, col_linear, in_width, linear, mlp, norm, out_width,
                     packed_linear, pdot, row_linear)
from .moe import moe_ffn


# ===========================================================================
# Initialization (random; torch.Generator draws, not jax.random's)
# ===========================================================================
def _dense_init(gen, shape, dtype, scale=None):
    """Scaled normal draws from ``gen``; with no generator, a meta tensor
    (shapes and dtypes only)."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
    device = gen.device if gen is not None else torch.device("meta")
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                generator: Optional[torch.Generator] = None) -> Dict:
    """Random parameters of ``cfg``, drawn on ``device`` from a seeded
    ``torch.Generator`` (or the one given), in the reference's layout (a
    MoE layer: ``blocks.moe.router.w`` (L, d, E) f32,
    ``blocks.moe.experts.{w_gate,w_up,w_down}.w`` (L, E, d, ff) / (L, E,
    ff, d); a Mamba2 layer: ``blocks.{in_proj,out_proj}.w``, the conv, the
    SSM scalars and its gated norm; the hybrid's unstacked ``shared``
    block with 2d-wide q/k/v and MLP input).  No embed table where the
    inputs are embeddings.  ``device="meta"`` gives the shapes and dtypes
    alone (the reference's ``jax.eval_shape`` of its init)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = None
    else:
        gen = generator or torch.Generator(device=dev).manual_seed(seed)
    dt = torch_dtype(cfg.dtype)
    L, d = cfg.num_layers, cfg.d_model
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def norm_init(shape):
        p = {"scale": torch.ones(shape, dtype=torch.float32, device=dev)}
        if cfg.norm == "layernorm":
            p["bias"] = torch.zeros(shape, dtype=torch.float32, device=dev)
        return p

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def attn_init(lead, in_dim, bias):
        p = {name: {"w": _dense_init(gen, lead + shape, dt)}
             for name, shape in (("q", (in_dim, qd)), ("k", (in_dim, kvd)),
                                 ("v", (in_dim, kvd)), ("o", (qd, d)))}
        if bias:
            for name, width in (("q", qd), ("k", kvd), ("v", kvd)):
                p[name]["b"] = zeros(*lead, width)
        return p

    def mlp_init(lead, in_dim):
        p = {"w_up": {"w": _dense_init(gen, lead + (in_dim, cfg.d_ff), dt)},
             "w_down": {"w": _dense_init(gen, lead + (cfg.d_ff, d), dt)}}
        if cfg.act == "swiglu":
            p["w_gate"] = {"w": _dense_init(gen, lead + (in_dim, cfg.d_ff), dt)}
        return p

    params: Dict[str, Any] = {}
    if cfg.family in ("dense", "moe"):
        blocks = {"attn_norm": norm_init((L, d)), "mlp_norm": norm_init((L, d))}
        blocks.update(attn_init((L,), d, cfg.qkv_bias))
        if cfg.family == "moe":
            E = cfg.num_experts
            blocks["moe"] = {
                "router": {"w": _dense_init(gen, (L, d, E), torch.float32)},
                "experts": {name: {"w": _dense_init(gen, (L, E) + shape, dt)}
                            for name, shape in (("w_gate", (d, cfg.d_ff)),
                                                ("w_up", (d, cfg.d_ff)),
                                                ("w_down", (cfg.d_ff, d)))}}
        else:
            blocks["mlp"] = mlp_init((L,), d)
    elif cfg.family in ("ssm", "hybrid"):
        din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = din + 2 * N
        blocks = {"norm": norm_init((L, d)),
                  "in_proj": {"w": _dense_init(gen, (L, d, 2 * din + 2 * N + H), dt)},
                  "conv": {"w": _dense_init(gen, (L, cfg.ssm_conv_width, conv_dim),
                                            torch.float32, scale=0.5),
                           "b": zeros(L, conv_dim)},
                  "dt_bias": zeros(L, H),
                  "A_log": zeros(L, H),                         # A = -1
                  "D": torch.ones((L, H), dtype=torch.float32, device=dev),
                  "ssm_norm": {"scale": torch.ones((L, din), dtype=torch.float32,
                                                   device=dev)},
                  "out_proj": {"w": _dense_init(gen, (L, din, d), dt)}}
        if cfg.family == "hybrid":
            shared = {"attn_norm": norm_init((2 * d,)), "mlp_norm": norm_init((2 * d,))}
            shared.update(attn_init((), 2 * d, bias=False))
            shared["mlp"] = mlp_init((), 2 * d)           # w_down maps d_ff -> d
            params["shared"] = shared
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    params["blocks"] = blocks
    if cfg.input_kind == "tokens":
        params["embed"] = {"table": _dense_init(gen, (cfg.vocab_size, d), dt, scale=0.02)}
    params["final_norm"] = norm_init((d,))
    params["lm_head"] = {"w": _dense_init(gen, (d, cfg.vocab_size), dt, scale=0.02)}
    return params


def layer_params(blocks, i: int):
    """Layer ``i`` of the stacked block parameters (views, no copies)."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    if isinstance(blocks, NestedTensor):
        return blocks.layer(i)
    return blocks[i]


# ===========================================================================
# Attention sub-block
# ===========================================================================
def _qkv(x, lp, cfg, route=None, whole_q: bool = False):
    """q, k, v (B,S,heads,hd).  Sharded, q holds this rank's heads: a
    projection split over ``model`` by columns gives them directly.  A
    column block whose heads the rules keep whole over ``model`` (a block
    may cut a head), and q's where ``whole_q`` asks for every head, is
    gathered; the blocks to gather go in one all-gather.
    :func:`_local_kv` gives this rank's q heads their kv heads."""
    hd = cfg.head_dim
    xs = ctx.enter_model(x)
    full = {"q": cfg.num_heads * hd, "k": cfg.num_kv_heads * hd, "v": cfg.num_kv_heads * hd}
    held = {"q": not whole_q and ctx.split_over_model("heads"),
            "k": ctx.split_over_model("kv_heads"), "v": ctx.split_over_model("kv_heads")}
    out = {n: col_linear(x, lp[n]["w"], lp[n].get("b"), full[n], route, xs) for n in full}
    cut = [n for n in out if out[n].shape[-1] < full[n] and not held[n]]
    if cut:
        widths = [out[n].shape[-1] for n in cut]
        whole = ctx.gather_model(torch.cat([out[n] for n in cut], dim=-1), -1)
        parts = whole.unflatten(-1, (-1, sum(widths))).split(widths, dim=-1)
        for n, t in zip(cut, parts):
            out[n] = t.flatten(-2)
            if out[n].shape[-1] != full[n]:
                raise ValueError(f"gathered {n} is {out[n].shape[-1]} wide, not {full[n]}")
    B, S = x.shape[:2]
    return tuple(out[n].reshape(B, S, -1, hd) for n in ("q", "k", "v"))


def _local_kv(k, v, hq: int, cfg):
    """The kv heads this rank's ``hq`` q heads read, where q holds a block
    of the heads and k/v hold all of them: q head j of model rank r is
    global head r * hq + j, which reads kv head (r * hq + j) // G.  Kept
    grouped (each kv head once) where the block's heads fall into equal
    runs, else one kv head per q head."""
    if hq == cfg.num_heads or k.shape[2] != cfg.num_kv_heads:
        return k, v
    r, _ = ctx.model_index()
    G = cfg.num_heads // cfg.num_kv_heads
    need = [(r * hq + j) // G for j in range(hq)]
    uniq = sorted(set(need))
    if hq % len(uniq) == 0 and need == [u for u in uniq for _ in range(hq // len(uniq))]:
        need = uniq
    idx = torch.tensor(need, device=k.device)
    return (ctx.enter_model(k).index_select(2, idx),
            ctx.enter_model(v).index_select(2, idx))


def _causal_attention(q, k, v, S: int, kv_block: int, q_offset: int = 0):
    """Causal attention of q's rows (at key positions ``q_offset`` on) over
    k/v, routed by the whole sequence's length S: over 1024 tokens the
    flash-attention op (K5 on a CUDA tensor, or raises; its plain blockwise
    version on a CPU tensor or inside ``reference_pass``; with a gradient
    recorded, the differentiable ``blockwise_attention``, K5 writing its
    row statistics on the card), else direct attention."""
    if S > 1024:
        return flash_ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                         kv_block=kv_block, q_offset=q_offset)
    return full_attention(q, k, v, causal=True, q_offset=q_offset)


def attn_seq(x, lp, cfg, kv_block: int = 512):
    """Full-sequence causal attention. Returns (out, (k, v)), k/v holding
    the kv heads the cache keeps.  Where the rules split the query
    sequence (``attn_seq``), :func:`_attn_seq_parallel`."""
    block, blocks = ctx.attn_seq_index()
    if blocks > 1:
        return _attn_seq_parallel(x, lp, cfg, kv_block, block, blocks)
    B, S = x.shape[:2]
    q, k, v = _qkv(x, lp, cfg)
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    q = shard_hint(q, ("batch", "attn_seq", "heads", None))
    o = _causal_attention(q, *_local_kv(k, v, q.shape[2], cfg), S, kv_block)
    o = shard_hint(o, ("batch", "attn_seq", "heads", None))
    o = o.reshape(B, S, -1)
    return row_linear(o, lp["o"]["w"], cfg.num_heads * cfg.head_dim), (k, v)


def _entered(w):
    """A replicated weight (or bias) feeding this rank's own rows: its
    gradient summed over ``model``.  A nested leaf (no gradient) as is."""
    return ctx.enter_model(w) if isinstance(w, torch.Tensor) else w


def _kv_grad_sum(t):
    """k or v of sequence-parallel attention, computed whole on every model
    rank: the same value forward; its gradient, each rank's query block's
    part, summed over ``model``."""
    return ctx.enter_model(t)


def _attn_seq_parallel(x, lp, cfg, kv_block: int, block: int, blocks: int):
    """Sequence-parallel attention: the heads do not divide ``model``, so
    the q/k/v/o weights are replicated over it and each model rank takes a
    block of ceil(S / blocks) query rows (the last block may be shorter).
    It projects q for its rows only and k/v for the whole sequence,
    attends at the block's offset (K5 over 1024 tokens, routed by the
    whole S as the reference's whole-sequence attention is), projects its
    rows through o, and the rows are gathered over ``model`` (the
    reference's ``("batch", None, None)`` hint on h).  Every replicated
    weight's gradient, and k/v's, is this rank's rows' part: each is summed
    over ``model`` (:func:`_entered`, :func:`_kv_grad_sum`)."""
    B, S = x.shape[:2]
    n = -(-S // blocks)
    if (blocks - 1) * n >= S:
        raise ValueError(f"a sequence of {S} does not split into {blocks} query blocks "
                         f"of {n}")
    start = block * n
    rows = min(n, S - start)
    hd = cfg.head_dim
    q = linear(ctx.enter_model(x).narrow(1, start, rows), _entered(lp["q"]["w"]),
               _entered(lp["q"].get("b")))
    k, v = (_kv_grad_sum(linear(x, lp[name]["w"], lp[name].get("b"))) for name in ("k", "v"))
    q = q.reshape(B, rows, cfg.num_heads, hd)
    k, v = (t.reshape(B, S, cfg.num_kv_heads, hd) for t in (k, v))
    q = apply_rope(q, start + torch.arange(rows, device=x.device), cfg.rope_theta)
    k = apply_rope(k, torch.arange(S, device=x.device), cfg.rope_theta)
    o = _causal_attention(q, k, v, S, kv_block, q_offset=start)
    o = linear(o.reshape(B, rows, -1), _entered(lp["o"]["w"]))
    if rows < n:
        o = torch.nn.functional.pad(o, (0, 0, 0, n - rows))
    return ctx.gather_model(o, 1).narrow(1, 0, S), (k, v)


def attn_decode(x, lp, cfg, k_cache, v_cache, pos: int):
    """One-token attention against the cache, x: (B,1,d).  The new K/V
    are written into ``k_cache``/``v_cache`` (B,Smax,Hkv,hd) IN PLACE at
    ``pos`` - where the reference returns updated copies.  A cache whose
    sequence dim the step splits (``ctx.cache_block``) is this rank's
    block of positions: only the rank that holds ``pos`` writes it, and
    the softmax is combined over the blocks
    (``attention.decode_attention_block``); where ``model`` is among the
    split axes the ranks of a block hold every kv head, and q is gathered
    to every head."""
    B = x.shape[0]
    route = dispatch.DECODE
    blk = ctx.cache_block(k_cache.shape[1])
    q, k, v = _qkv(x, lp, cfg, route, whole_q=blk is not None and blk[2])
    p = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, p, cfg.rope_theta)
    k = apply_rope(k, p, cfg.rope_theta)
    if blk is None:
        k_cache[:, pos:pos + 1] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + 1] = v.to(v_cache.dtype)
        o = decode_attention(q, k_cache, v_cache, pos)
    else:
        start, group, _ = blk
        at = pos - start
        if 0 <= at < k_cache.shape[1]:
            k_cache[:, at:at + 1] = k.to(k_cache.dtype)
            v_cache[:, at:at + 1] = v.to(v_cache.dtype)
        o = decode_attention_block(q, k_cache, v_cache, pos, start, group)
    o = shard_hint(o, ("batch", None, "heads", None))
    o = o.reshape(B, 1, -1)
    return row_linear(o, lp["o"]["w"], cfg.num_heads * cfg.head_dim, route=route)


def _per_position(fn, h):
    """``fn`` on each position's (B, 1, ...) slice of h (B, S, ...), as a
    decode step calls it, concatenated along S: a reduction over a row
    (a norm, a softmax) then runs on the launch a decode step runs."""
    return torch.cat([fn(h[:, j:j + 1].contiguous()) for j in range(h.shape[1])], dim=1)


def attn_decode_chunk(x, lp, cfg, k_cache, v_cache, pos: int):
    """S-token attention against the cache (the speculative verify pass),
    x: (B,S,d).  The chunk's K/V are written into the cache IN PLACE at
    ``pos``..``pos + S - 1`` first; query row j then attends through the
    decode step's own call (``decode_attention`` at ``pos + j``), whose
    mask gives every later position an exact zero weight, so row j equals
    the decode step at that position bit for bit."""
    B, S = x.shape[:2]
    route = dispatch.DECODE
    q, k, v = _qkv(x, lp, cfg, route)
    k, v = _local_kv(k, v, q.shape[2], cfg)
    positions = torch.arange(pos, pos + S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k_cache[:, pos:pos + S] = k.to(k_cache.dtype)
    v_cache[:, pos:pos + S] = v.to(v_cache.dtype)
    o = torch.cat([decode_attention(q[:, j:j + 1].contiguous(), k_cache, v_cache, pos + j)
                   for j in range(S)], dim=1)
    o = o.reshape(B, S, -1)
    return row_linear(o, lp["o"]["w"], cfg.num_heads * cfg.head_dim, route=route)


# ===========================================================================
# Transformer forward (dense / moe)
# ===========================================================================
def _ffn(h, lp, cfg, dropless: bool = False, route=None, per_position: bool = False,
         want_aux: bool = False):
    """The layer's FFN -> (y, aux): the MLP (aux 0.0), or for the MoE family
    ``moe_ffn``, whose Switch aux loss is computed only with ``want_aux``
    (training; eager PyTorch would otherwise compute it on every serving
    call).  ``per_position``: route a MoE layer's tokens position by
    position (the decode chunk)."""
    if cfg.family == "moe":
        y, aux = moe_ffn(h, lp["moe"], num_experts=cfg.num_experts, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, act=cfg.act,
                         dropless=dropless, route=route, per_position=per_position,
                         want_aux=want_aux)
        return y, (aux if want_aux else 0.0)
    y = mlp(h, lp["mlp"], cfg.act, cfg.d_ff, route=route)
    return shard_hint(y, ("batch", None, None)), 0.0


def _remat(body, cfg, want_cache: bool):
    """``body`` under activation checkpointing on a training run (no cache)
    when ``cfg.remat`` asks for it and a gradient is being recorded (the
    reference's ``jax.checkpoint`` with ``nothing_saveable``); else
    ``body`` itself, so the served path runs as it did.  The recompute
    runs in the backward, on autograd's device thread for a CUDA tensor,
    so the body carries the sharding context it ran under
    (``ctx.bound``)."""
    if want_cache or not (cfg.remat and torch.is_grad_enabled()):
        return body
    return lambda *args: checkpoint(ctx.bound(body), *args, use_reentrant=False)


def _tf_layer_seq(h, lp, cfg, dropless: bool):
    """One transformer layer over the sequence -> (h, (k, v), aux)."""
    a, kv = attn_seq(norm(h, lp["attn_norm"], cfg.norm), lp, cfg)
    h = h + a
    y, aux = _ffn(norm(h, lp["mlp_norm"], cfg.norm), lp, cfg, dropless=dropless,
                  want_aux=not dropless)
    return h + y, kv, aux


def transformer_seq(params, x, cfg, want_cache: bool):
    """x: (B,S,d) embedded input. Returns (h, cache or None, aux sum).  A
    run that builds a cache (prefill) routes MoE layers droplessly, so the
    cached decode reproduces it; training (``want_cache=False``) keeps the
    capacity-dropped dispatch and sums the layers' aux losses in layer
    order."""
    body = _remat(_tf_layer_seq, cfg, want_cache)
    h, aux = x, 0.0
    ks, vs = [], []
    for i in range(cfg.num_layers):
        h, (k, v), aux_l = body(h, layer_params(params["blocks"], i), cfg, want_cache)
        aux = aux + aux_l
        if want_cache:
            ks.append(k)
            vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if want_cache else None
    return h, cache, aux


def transformer_decode(params, x, cfg, cache, pos: int):
    """One decode step over every layer; ``cache`` (L,B,Smax,Hkv,hd) is
    updated in place."""
    h = x
    for i in range(cfg.num_layers):
        lp = layer_params(params["blocks"], i)
        h = h + attn_decode(norm(h, lp["attn_norm"], cfg.norm), lp, cfg,
                            cache["k"][i], cache["v"][i], pos)
        h = h + _ffn(norm(h, lp["mlp_norm"], cfg.norm), lp, cfg, dropless=True,
                     route=dispatch.DECODE)[0]
    return h


def transformer_decode_chunk(params, x, cfg, cache, pos: int):
    """S decode positions in one pass over every layer (x: (B,S,d)): each
    weight matmul streams its words once per 8-row group where S decode
    steps would stream them S times; ``cache`` is updated in place."""
    h = x
    for i in range(cfg.num_layers):
        lp = layer_params(params["blocks"], i)
        a = _per_position(lambda t: norm(t, lp["attn_norm"], cfg.norm), h)
        h = h + attn_decode_chunk(a, lp, cfg, cache["k"][i], cache["v"][i], pos)
        m = _per_position(lambda t: norm(t, lp["mlp_norm"], cfg.norm), h)
        h = h + _ffn(m, lp, cfg, dropless=True, route=dispatch.DECODE, per_position=True)[0]
    return h


# ===========================================================================
# SSM / hybrid forward
# ===========================================================================
def _check_groups(cfg) -> None:
    """The hybrid runs whole groups: one shared-block application, then
    ``hybrid_attn_every`` Mamba2 layers."""
    every = cfg.hybrid_attn_every
    if every and cfg.num_layers % every:
        raise ValueError(f"hybrid_attn_every={every} must divide num_layers="
                         f"{cfg.num_layers}")


def _check_prompt(cfg, S: int) -> None:
    """A Mamba2 decode reads the last ``ssm_conv_width - 1`` inputs from the
    conv buffer prefill leaves; a shorter prompt leaves fewer, which the
    JAX package's decode step cannot take (its ``conv_step`` einsum fails).
    The port refuses such a prompt up front."""
    need = cfg.ssm_conv_width - 1
    if S < need:
        raise ValueError(f"family {cfg.family!r} needs a prompt of at least "
                         f"ssm_conv_width - 1 = {need} tokens (the decode conv buffer "
                         f"holds the last {need} inputs); got {S}")


def _shared_block_seq(h, emb0, sp, cfg):
    """The hybrid's shared attention/MLP block over concat(h, emb0), 2d
    wide; returns (h, (k, v))."""
    a, kv = attn_seq(norm(torch.cat([h, emb0], dim=-1), sp["attn_norm"], cfg.norm), sp, cfg)
    h = h + a
    m = mlp(norm(torch.cat([h, emb0], dim=-1), sp["mlp_norm"], cfg.norm), sp["mlp"], cfg.act,
            cfg.d_ff)
    return h + m, kv


def ssm_seq(params, x, cfg, want_cache: bool):
    """Mamba2 trunk over x (B,S,d), with the hybrid's groups: one shared
    block application, then ``hybrid_attn_every`` Mamba2 layers.  Returns
    (h, cache or None, aux 0.0): state (L,B,H,P,N) f32, conv_buf
    (L,B,W-1,C) and, for the hybrid, k/v (napps,B,S,Hkv,hd) in the compute
    dtype.  Under remat the Mamba2 block and the shared block are each
    recomputed in the backward, as the reference wraps them."""
    every = cfg.hybrid_attn_every
    emb0, h = x, x
    block = _remat(mamba2.mamba_block, cfg, want_cache)
    shared = _remat(_shared_block_seq, cfg, want_cache)
    states, bufs, ks, vs = [], [], [], []
    for i in range(cfg.num_layers):
        if every and i % every == 0:
            h, (k, v) = shared(h, emb0, params["shared"], cfg)
            if want_cache:
                ks.append(k)
                vs.append(v)
        lp = layer_params(params["blocks"], i)
        y, mc = block(norm(h, lp["norm"], cfg.norm), lp, cfg)
        h = h + y
        if want_cache:
            states.append(mc["state"])
            bufs.append(mc["conv_buf"])
    if not want_cache:
        return h, None, 0.0
    cache = {"state": torch.stack(states), "conv_buf": torch.stack(bufs)}
    if every:
        cdt = torch_dtype(cfg.compute_dtype)
        cache["k"], cache["v"] = torch.stack(ks).to(cdt), torch.stack(vs).to(cdt)
    return h, cache, 0.0


def ssm_decode(params, x, cfg, cache, pos: int):
    """One decode step over the trunk (x: (B,1,d)), in the groups of
    :func:`ssm_seq`; the state, the conv buffer and the hybrid's k/v
    (napps,B,Smax,Hkv,hd) are updated in place."""
    every = cfg.hybrid_attn_every
    emb0, h = x, x
    route = dispatch.DECODE
    for i in range(cfg.num_layers):
        if every and i % every == 0:
            sp, a = params["shared"], i // every
            u = norm(torch.cat([h, emb0], dim=-1), sp["attn_norm"], cfg.norm)
            h = h + attn_decode(u, sp, cfg, cache["k"][a], cache["v"][a], pos)
            u = norm(torch.cat([h, emb0], dim=-1), sp["mlp_norm"], cfg.norm)
            h = h + mlp(u, sp["mlp"], cfg.act, cfg.d_ff, route=route)
        lp = layer_params(params["blocks"], i)
        y, mc = mamba2.mamba_decode_step(
            norm(h, lp["norm"], cfg.norm), lp,
            {"state": cache["state"][i], "conv_buf": cache["conv_buf"][i]}, cfg)
        cache["state"][i] = mc["state"]
        cache["conv_buf"][i] = mc["conv_buf"]
        h = h + y
    return h


# ===========================================================================
# Embedding / head
# ===========================================================================
def embed_inputs(params, inputs, cfg):
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.input_kind != "tokens":
        return inputs["embeddings"].to(cdt)
    tok = inputs["tokens"]
    table = params["embed"]["table"]
    rows = in_width(table)
    inside = None
    if rows < cfg.vocab_size:
        # this rank's block of the vocab: its rows gathered, zeros for the
        # other tokens, summed over model
        tok, inside = _block_index(tok, rows)
    if isinstance(table, NestedTensor):
        # row gather straight from the packed words
        h = table.gather_rows(tok, cdt)
    else:
        h = table[tok].to(cdt)
    if inside is not None:
        h = ctx.sum_model(torch.where(inside[..., None], h, torch.zeros_like(h)))
    h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(h.dtype)
    return shard_hint(h, ("batch", None, None))


def lm_logits(params, h, cfg, route=None):
    """Logits in f32 (``route``: as in ``layers.packed_linear``); sharded,
    this rank's block of the vocab where the head is split over ``model``."""
    w = params["lm_head"]["w"]
    if out_width(w) < cfg.vocab_size:
        h = ctx.enter_model(h)
    if isinstance(w, NestedTensor):
        logits = packed_linear(h, w, out_dtype=torch.float32, route=route)
    else:
        logits = pdot(h, w.to(h.dtype), preferred=torch.float32)
    return shard_hint(logits, ("batch", None, "vocab"))


def xent_loss(logits, labels, vocab: int = 0) -> torch.Tensor:
    """Mean next-token cross entropy in f32: logsumexp minus the gold
    logit, averaged over every position.  Logits narrower than ``vocab``
    are this rank's block of a vocab split over ``model``: the logsumexp
    from the max and the sum of exponentials over ``model``, the gold
    logit from the rank that holds it."""
    logits = logits.float()
    labels = labels[..., None].long()
    if not vocab or logits.shape[-1] == vocab:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels)[..., 0]
        return (logz - gold).mean()
    m = ctx.max_model(logits.amax(dim=-1))
    logz = torch.log(ctx.sum_model(torch.exp(logits - m[..., None]).sum(dim=-1))) + m
    labels, inside = _block_index(labels, logits.shape[-1])
    gold = torch.gather(logits, -1, labels)
    gold = ctx.sum_model(torch.where(inside, gold, torch.zeros_like(gold))[..., 0])
    return (logz - gold).mean()


def _block_index(idx, n: int):
    """Indices into a dim split over ``model`` against this rank's n-wide
    block: (the index within the block, 0 outside it; the inside mask)."""
    idx = idx - ctx.model_index()[0] * n
    inside = (idx >= 0) & (idx < n)
    return torch.where(inside, idx, torch.zeros_like(idx)), inside


def _forward_seq(params, inputs, cfg, want_cache: bool):
    """Embed, run every layer, final norm -> (h, cache or None, aux sum)."""
    h = embed_inputs(params, inputs, cfg)
    if cfg.family in ("dense", "moe"):
        h, cache, aux = transformer_seq(params, h, cfg, want_cache)
    else:
        if want_cache:
            _check_prompt(cfg, h.shape[1])
        h, cache, aux = ssm_seq(params, h, cfg, want_cache)
    return norm(h, params["final_norm"], cfg.norm), cache, aux


# ===========================================================================
# Public model surface
# ===========================================================================
class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable
    decode_chunk: Callable


def make_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model of ``cfg`` (any family) on ``device``."""
    dev = resolve_device(device)
    transformer = cfg.family in ("dense", "moe")
    if not transformer:
        _check_groups(cfg)

    def init(seed: int = 0):
        return init_params(cfg, seed=seed, device=dev)

    def loss_fn(params, batch):
        """Next-token cross entropy of ``batch`` (``tokens`` or
        ``embeddings``, and ``labels`` (B,S)) + 0.01 * the MoE aux loss."""
        h, _, aux = _forward_seq(params, batch, cfg, want_cache=False)
        return (xent_loss(lm_logits(params, h, cfg), batch["labels"], cfg.vocab_size)
                + 0.01 * aux)

    def prefill(params, inputs):
        h, cache, _ = _forward_seq(params, inputs, cfg, want_cache=True)
        last = lm_logits(params, h[:, -1:, :], cfg)
        cache["pos"] = h.shape[1]
        return last, cache

    def decode_step(params, inputs, cache):
        pos = int(cache["pos"])
        h = embed_inputs(params, inputs, cfg)
        if transformer:
            h = transformer_decode(params, h, cfg, cache, pos)
        else:
            h = ssm_decode(params, h, cfg, cache, pos)
        h = norm(h, params["final_norm"], cfg.norm)
        logits = lm_logits(params, h, cfg, route=dispatch.DECODE)
        cache["pos"] = pos + 1
        return logits, cache

    def decode_chunk(params, inputs, cache):
        """Decode inputs['tokens'] (B,S) in one cached pass -> (logits
        (B,S,V) f32, cache).  Position j's logits are bit for bit those
        of j sequential ``decode_step`` calls at that position; the cache
        is written in place and ``pos`` advances by S."""
        pos = int(cache["pos"])
        h = embed_inputs(params, inputs, cfg)
        h = transformer_decode_chunk(params, h, cfg, cache, pos)
        h = _per_position(lambda t: norm(t, params["final_norm"], cfg.norm), h)
        logits = lm_logits(params, h, cfg, route=dispatch.DECODE)
        cache["pos"] = pos + inputs["tokens"].shape[1]
        return logits, cache

    def make_cache(batch_size: int, max_len: int, dtype=None):
        dt = torch_dtype(dtype or cfg.compute_dtype)
        L = cfg.num_layers
        cache: Dict[str, Any] = {"pos": 0}
        if transformer:
            kv_layers = L
        else:
            H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
            cache["state"] = torch.zeros((L, batch_size, H, P, N), dtype=torch.float32,
                                         device=dev)
            cache["conv_buf"] = torch.zeros(
                (L, batch_size, cfg.ssm_conv_width - 1, cfg.d_inner + 2 * N), dtype=dt,
                device=dev)
            every = cfg.hybrid_attn_every
            kv_layers = -(-L // every) if every else 0
        if kv_layers:
            shp = (kv_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
            cache["k"] = torch.zeros(shp, dtype=dt, device=dev)
            cache["v"] = torch.zeros(shp, dtype=dt, device=dev)
        return cache

    # a state recurrence has no cached multi-token re-score path; the
    # speculative decoder refuses these families, as the reference's does
    return Model(cfg=cfg, init=init, loss_fn=loss_fn, prefill=prefill,
                 decode_step=decode_step, make_cache=make_cache,
                 decode_chunk=decode_chunk if transformer else None)
