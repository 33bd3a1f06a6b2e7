"""Sharded step builders: train_step / prefill_step / serve(decode)_step;
counterpart of ``repro/distributed/steps.py``.

Each builder returns ``(step, specs)`` with the reference's keys
(``model``, ``params``, ``opt``, ``batch``, ``cache``, ``rules``,
``abstract_params``).  The step runs on this rank's LOCAL shards: every
parameter, optimizer, batch and cache leaf is the block its spec gives
this rank (``sharding.shard_tree`` cuts it from a whole tree,
``sharding.gather_tree`` puts a whole tree back together).  Where GSPMD
inserts the reference's collectives from its shardings, the port calls
them explicitly (``comm.py``) and every tensor stays a plain local tensor:

* a weight split on its output dim over ``model`` gives this rank's
  features (heads); a weight in ``_REDUCE_FIRST`` split on dim -2 sums its
  f32 partial products over ``model``; a vocab-split embedding is a masked
  local gather summed over ``model``; vocab-split logits give the loss
  through a logsumexp over ``model``, and the serving steps return whole
  logits, gathered over ``model`` (the batch dim stays this data rank's);
  a ``shard_hint`` whose rule keeps whole a dim held as a shard gathers it
  (``models/model.py``, ``layers.py``, ``moe.py``, ``ctx.py``);
* a weight dim split over a data axis (FSDP, ``shard_2d`` configs), and
  any split dim of a leaf that is no matmul weight (a layernorm's bias),
  is gathered at the start of the step, and its gradient cut back;
* data-parallel gradients are averaged over the data axes; the optimizer
  state lives on the parameters' shards, its global gradient norm summed
  over the axes each leaf is split on;
* sequence-parallel attention (``attn_seq = "model"``: the heads do not
  divide ``model``): each model rank attends its block of query rows,
  at their offset, against the whole k/v, and the rows are gathered
  (``models/model.py::_attn_seq_parallel``);
* a KV cache split on its sequence dim (``cache_pspecs``' ``seq_ax``):
  the prefill step returns each rank's block of the prompt's positions;
  a decode step writes the new k/v on the rank whose block holds ``pos``
  and combines the blocks' softmax pieces over the split axes
  (``attention.decode_attention_block``); :func:`fill_decode_cache` moves
  a prefill cache into a longer decode cache;
* the ssm and hybrid families: each model rank runs its block of the SSM
  heads and conv channels (``models/mamba2.py``).

Executed here: every family on every layout the rules give, but a single
dim split over data and model at once (:func:`_whole_dims` raises
``NotImplementedError``: ROADMAP queue 1).  A sequence or cache length
that its split does not divide raises ``ValueError`` at build time (the
reference pads there).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from .. import tree
from ..configs.base import ModelConfig, ShapeConfig
from ..core.nesting import NestedTensor
from ..models.model import Model, init_params, make_model
from ..optim import adamw
from . import comm
from . import sharding as shd
from .ctx import logical_rules as rules_ctx
from .sharding import PartitionSpec as P

_QUEUED = "queued in ROADMAP.md (queue 1)"


# ---------------------------------------------------------------------------
# Abstract inputs (meta tensors): no allocation
# ---------------------------------------------------------------------------
def abstract_params(cfg: ModelConfig):
    """The parameter tree of ``cfg`` as meta tensors (``jax.eval_shape`` of
    the reference's init)."""
    return init_params(cfg, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                model: Optional[Model] = None) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    cdt = getattr(torch, cfg.compute_dtype)

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind == "train":
        out = {"labels": meta((B, S), torch.int64)}
        if cfg.input_kind == "tokens":
            out["tokens"] = meta((B, S), torch.int64)
        else:
            out["embeddings"] = meta((B, S, cfg.d_model), cdt)
        return out
    if shape.kind == "prefill":
        if cfg.input_kind == "tokens":
            return {"tokens": meta((B, S), torch.int64)}
        return {"embeddings": meta((B, S, cfg.d_model), cdt)}
    # decode: one new token + cache of length S
    model = model or make_model(cfg, device="meta")
    cache = model.make_cache(B, S)
    if cfg.input_kind == "tokens":
        inp = {"tokens": meta((B, 1), torch.int64)}
    else:
        inp = {"embeddings": meta((B, 1, cfg.d_model), cdt)}
    return {"inputs": inp, "cache": cache}


def _whole_dims(key: str, spec, mesh):
    """[(dim, axes)] of a parameter that the step makes whole before the
    forward: every dim split over data-parallel axes (FSDP), and, for a
    leaf the model code does not read as a block (anything but a matmul
    weight ``w`` or the embedding ``table``: a layernorm's (L, d) bias,
    which the rules split over ``model``), every split dim."""
    kept = isinstance(spec, NestedTensor) or key.endswith(("['w']", "['table']"))
    if isinstance(spec, NestedTensor):
        spec = spec.w_base
    dp = shd.dp_axes(mesh)
    out = []
    for dim, ax in enumerate(spec):
        if ax is None or mesh.axis_size(ax) == 1:
            continue
        on_dp = [a in dp for a in mesh.axes(ax)]
        if any(on_dp) and not all(on_dp):
            raise NotImplementedError(f"a dim split over {ax!r} (data and model at "
                                      f"once) is {_QUEUED}")
        if all(on_dp) or not kept:
            out.append((dim, ax))
    return out


def _make_whole(params, dims, mesh):
    """``params`` with the dims of :func:`_whole_dims` gathered."""
    def gather(x, cut):
        for dim, ax in cut:
            x = comm.all_gather(x, mesh.group(ax), dim)
        return x

    def leaf(x, cut):
        if not cut:
            return x
        if not isinstance(x, NestedTensor):
            return gather(x, cut)
        shape = list(x.shape)
        for dim, ax in cut:
            shape[dim] *= mesh.axis_size(ax)
        return x._replace(w_base=gather(x.w_base, cut),
                          deltas=tuple(None if d is None else gather(d, cut)
                                       for d in x.deltas),
                          scale=gather(x.scale, cut), shape=tuple(shape))

    return tree.unflatten(params, [leaf(x, cut) for x, cut in
                                   zip(tree.leaves(params), tree.leaves(dims))])


def _cut_back(g: torch.Tensor, cut, mesh) -> torch.Tensor:
    """This rank's block of a whole leaf's gradient."""
    for dim, ax in cut:
        size = g.shape[dim] // mesh.axis_size(ax)
        g = g.narrow(dim, mesh.coord(ax) * size, size).contiguous()
    return g


def _whole_dims_tree(pspec, mesh):
    return tree.map_with_path(lambda key, spec: _whole_dims(key, spec, mesh), pspec)


def _check_executable(cfg: ModelConfig, shape: ShapeConfig, rules: Dict, mesh,
                      cspec=None) -> None:
    """Raise ``ValueError`` on a split the port does not pad: SSM heads or
    conv channels that ``model`` does not divide, a sequence that does not
    split into sequence-parallel query blocks, a KV cache length that its
    sequence axes do not divide.  (A dim split over data and model at
    once raises in :func:`_whole_dims`.)"""
    if mesh.size == 1:
        return
    m = mesh.shape["model"]
    if cfg.family in ("ssm", "hybrid") and m > 1:
        width = cfg.d_inner + 2 * cfg.ssm_state
        if cfg.ssm_heads % m or width % m:
            raise ValueError(f"{cfg.ssm_heads} SSM heads and {width} conv channels must "
                             f"split over model = {m}")
    blocks = mesh.axis_size(rules.get("attn_seq"))
    if shape.kind != "decode" and blocks > 1:
        n = -(-shape.seq_len // blocks)
        if (blocks - 1) * n >= shape.seq_len:
            raise ValueError(f"a sequence of {shape.seq_len} does not split into "
                             f"{blocks} query blocks of {n}")
    if cspec is not None and "k" in cspec:
        seq = cspec["k"][2]
        n = mesh.axis_size(seq)
        if shape.seq_len % n:
            raise ValueError(f"a KV cache of {shape.seq_len} positions does not split over "
                             f"{seq!r} ({n} ranks)")


def _cache_seq(cspec):
    """The mesh axes a cache spec splits the k/v sequence dim over."""
    return cspec["k"][2] if "k" in cspec else None


def _whole_vocab(logits: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    if logits.shape[-1] < cfg.vocab_size:
        logits = comm.all_gather(logits, mesh.group("model"), -1)
    return logits


# ---------------------------------------------------------------------------
# Train step (gradient accumulation over microbatches)
# ---------------------------------------------------------------------------
def _grad_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of the whole gradient from this rank's blocks: each
    leaf's f32 sum of squares, summed over the axes its spec splits."""
    by_axes: Dict[tuple, torch.Tensor] = {}
    for g, spec in zip(tree.leaves(grads), tree.leaves(specs)):
        key = tuple(a for a in mesh.axis_names if a in shd.spec_axes(spec)
                    and mesh.shape[a] > 1)
        sq = torch.sum(torch.square(g.float()))
        by_axes[key] = by_axes[key] + sq if key in by_axes else sq
    total = 0
    for key, sq in by_axes.items():
        total = total + (comm.all_reduce(sq, mesh.group(key)) if key else sq)
    return torch.sqrt(total)


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     peak_lr: float = 3e-4, total_steps: int = 10_000):
    """Returns (step, specs).  ``step(params, opt_state, batch, step) ->
    (params, opt_state, metrics)`` on local shards.

    Mixed precision: bf16 live params + f32 master weights and Adam moments
    in the optimizer state.  The local batch's rows split into
    ``shape.num_microbatches`` microbatches; f32 gradients are summed over
    them, divided by their count, averaged over the data axes; the loss is
    the mean over microbatches and data ranks."""
    train_cfg = dataclasses.replace(cfg, dtype="bfloat16")
    rules = shd.logical_rules(train_cfg, shape, mesh)
    _check_executable(train_cfg, shape, rules, mesh)
    model = make_model(train_cfg, device=mesh.device)
    nm = shape.num_microbatches
    abstract = abstract_params(train_cfg)
    pspec = shd.param_pspecs(train_cfg, abstract, mesh)
    ospec = shd.opt_pspecs(pspec)
    bspec = shd.batch_pspecs(train_cfg, shape, mesh, with_labels=True)
    dp = shd.dp_axes(mesh)
    dp_group = mesh.group(dp) if dp else None
    whole_dims = _whole_dims_tree(pspec, mesh)

    def train_step(params, opt_state, batch, step):
        with rules_ctx(mesh, rules):
            whole = _make_whole(params, whole_dims, mesh)
            leaves = [p.detach().requires_grad_(True) for p in tree.leaves(whole)]
            live = tree.unflatten(params, leaves)
            rows = next(iter(batch.values())).shape[0]
            if rows % nm:
                raise ValueError(f"{rows} local rows do not split into {nm} microbatches")
            mb = rows // nm
            gsum, lsum = None, 0.0
            for i in range(nm):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss = model.loss_fn(live, micro)
                g = torch.autograd.grad(loss, leaves)
                gsum = ([x.float() for x in g] if gsum is None
                        else [a + b.float() for a, b in zip(gsum, g)])
                lsum = lsum + loss.detach()
            grads = [g / nm for g in gsum]
            grads = [comm.all_reduce(g, dp_group, "mean") for g in grads]
            grads = [_cut_back(g, cut, mesh) for g, cut in zip(grads, tree.leaves(whole_dims))]
            grads = tree.unflatten(params, grads)
            lr = adamw.warmup_cosine(step, peak_lr=peak_lr, warmup=100, total=total_steps)
            params, opt_state, metrics = adamw.apply_update(
                params, grads, opt_state, lr=lr, grad_norm=_grad_norm(grads, pspec, mesh))
            metrics["loss"] = comm.all_reduce(lsum / nm, dp_group, "mean")
            return params, opt_state, metrics

    specs = {"model": model, "params": pspec, "opt": ospec, "batch": bspec,
             "rules": rules, "abstract_params": abstract}
    return train_step, specs


# ---------------------------------------------------------------------------
# Prefill / decode steps
# ---------------------------------------------------------------------------
def _serve_fsdp(cfg: ModelConfig) -> Optional[str]:
    # serving: TP-only weights (no FSDP gathers in the latency path);
    # 2D sharding stays available for archs whose weights exceed memory.
    return "data" if cfg.param_count() * 2 / 16 > 12e9 else None


def _serve_params(cfg, mesh, quant, attn_cols: bool):
    abstract = abstract_params(cfg)
    pspec = shd.param_pspecs(cfg, abstract, mesh, fsdp=_serve_fsdp(cfg),
                             attn_cols=attn_cols)
    if quant == "nested":
        abstract = quantize_abstract(cfg)
        pspec = _nested_pspecs(abstract, pspec)
    elif quant is not None:
        raise ValueError(f"quant must be None or 'nested', got {quant!r}")
    return abstract, pspec


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       quant: Optional[str] = None):
    """Returns (step, specs).  ``step(params, inputs) -> (last logits
    (B_local, 1, V) f32, cache)`` on local shards, the cache laid out as
    ``specs["cache"]`` (k/v: this rank's block of the prompt's positions
    where the spec splits them).  ``quant="nested"``: the params are a
    nested tree laid out as ``build_decode_step``'s (the port's addition:
    the reference's prefill takes dense weights)."""
    rules = shd.logical_rules(cfg, shape, mesh)
    cspec = shd.cache_pspecs(cfg, shape, mesh)
    _check_executable(cfg, shape, rules, mesh, cspec)
    model = make_model(cfg, device=mesh.device)
    abstract, pspec = _serve_params(cfg, mesh, quant, attn_cols=False)
    bspec = shd.batch_pspecs(cfg, shape, mesh, with_labels=False)
    whole_dims = _whole_dims_tree(pspec, mesh)

    @torch.no_grad()
    def prefill_step(params, inputs):
        with rules_ctx(mesh, rules):
            logits, cache = model.prefill(_make_whole(params, whole_dims, mesh), inputs)
            seq = _cache_seq(cspec)
            for key in ("k", "v") if mesh.axis_size(seq) > 1 else ():
                cache[key] = shd.local_shard(cache[key], P(None, None, seq), mesh)
            return _whole_vocab(logits, cfg, mesh), cache

    return prefill_step, {"model": model, "params": pspec, "batch": bspec,
                          "cache": cspec, "rules": rules, "abstract_params": abstract}


def _nested_pspecs(nested_abs, dense_pspecs):
    """PartitionSpecs for a NestQuant-packed parameter tree: packed words
    and scales shard the output-channel dim like the dense weight; the
    packed K dim stays unsharded (word rows are not evenly divisible)."""
    dense = dict(tree.flatten_with_path(dense_pspecs))

    def f(key, leaf):
        spec = dense[key]
        if isinstance(leaf, NestedTensor):
            nd = leaf.w_base.ndim
            out_ax = spec[-1] if len(spec) else None
            packed = P(*([None] * (nd - 1)), out_ax)
            return NestedTensor(w_base=packed,
                                deltas=tuple(packed for _ in leaf.deltas),
                                scale=packed, shape=leaf.shape,
                                bits=leaf.bits, block=leaf.block,
                                rung=leaf.rung)
        return spec

    return tree.map_with_path(f, nested_abs)


def _abstract_nested(shape, bits, block: int) -> NestedTensor:
    from ..core import packing
    from ..core.decompose import delta_bits

    *lead, K, N = shape
    rows = lambda w: math.ceil(K / block) * packing.blocked_rows(block, w)  # noqa: E731

    def meta(r, dt):
        return torch.empty(tuple(lead) + (r, N), dtype=dt, device="meta")

    return NestedTensor(w_base=meta(rows(bits[0]), torch.int32),
                        deltas=tuple(meta(rows(w), torch.int32) for w in delta_bits(bits)),
                        scale=meta(1, torch.float32), shape=tuple(shape), bits=bits,
                        block=block)


def quantize_abstract(cfg: ModelConfig, n: int = 8, h: int = 4):
    """Abstract NestQuant-packed parameter tree (meta tensors, no compute).

    The embedding table stays dense (token gather from packed rows is not a
    matmul; production serving keeps it int8/bf16 row-addressable)."""
    from ..core import packing
    from ..core.nesting import default_predicate
    from ..core.recipe import QuantRecipe

    def pred(path, leaf):
        return "embed" not in path.lower() and default_predicate(path, leaf)

    recipe = QuantRecipe(bits=(h, n), rounding="rtn", predicate=pred)

    def leaf_fn(path, leaf):
        spec = recipe.resolve(path, leaf)
        if spec is None:
            return leaf
        return _abstract_nested(tuple(leaf.shape), spec.bits,
                                spec.block or packing.choose_block(leaf.shape[-2]))

    return tree.map_with_path(leaf_fn, abstract_params(cfg))


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      quant: Optional[str] = None):
    """quant: None (dense weights) | 'nested' (packed NestQuant weights laid
    out as ``_nested_pspecs``, read by K1-K3 on the card).  ``step(params,
    inputs, cache) -> (logits (B_local, 1, V) f32, cache)`` on local
    shards; the cache is updated in place."""
    rules = shd.logical_rules(cfg, shape, mesh)
    cspec = shd.cache_pspecs(cfg, shape, mesh)
    _check_executable(cfg, shape, rules, mesh, cspec)
    model = make_model(cfg, device=mesh.device)
    abstract, pspec = _serve_params(cfg, mesh, quant, attn_cols=True)
    bspec = shd.batch_pspecs(cfg, shape, mesh, with_labels=False)
    bspec = {k: P(v[0], *([None] * (len(v) - 1))) for k, v in bspec.items()}
    whole_dims = _whole_dims_tree(pspec, mesh)

    step_rules = dict(rules, cache_seq=_cache_seq(cspec))

    @torch.no_grad()
    def serve_step(params, inputs, cache):
        with rules_ctx(mesh, step_rules):
            logits, cache = model.decode_step(_make_whole(params, whole_dims, mesh),
                                              inputs, cache)
            return _whole_vocab(logits, cfg, mesh), cache

    return serve_step, {"model": model, "params": pspec, "batch": bspec,
                        "cache": cspec, "rules": rules, "abstract_params": abstract}


@torch.no_grad()
def fill_decode_cache(cache, prefill_cache, mesh, prefill_cspec, cspec):
    """``cache`` (this rank's blocks of a decode cache, laid out as
    ``cspec``) holding the prefill's cache (laid out as ``prefill_cspec``,
    a prompt no longer than the decode cache) at positions 0 on, and its
    ``pos``: k/v gathered over the prefill's sequence axes and this rank's
    block of positions copied in; the SSM state and conv buffer (laid out
    alike in both) copied as they are."""
    for key in ("k", "v"):
        if key not in prefill_cache:
            continue
        whole = shd.gather_leaf(prefill_cache[key], P(None, None, prefill_cspec[key][2]), mesh)
        blk = cache[key]
        n = blk.shape[2]
        start = mesh.coord(cspec[key][2]) * n
        stop = min(whole.shape[2], start + n)
        if stop > start:
            blk[:, :, :stop - start] = whole[:, :, start:stop]
    for key in ("state", "conv_buf"):
        if key in prefill_cache:
            cache[key].copy_(prefill_cache[key])
    cache["pos"] = prefill_cache["pos"]
    return cache
