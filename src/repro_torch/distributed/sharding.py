"""Sharding rules: logical axes -> mesh axes for every arch x shape cell;
counterpart of ``repro/distributed/sharding.py``, giving the same specs
entry for entry.

Policy (DESIGN.md Sec. 4):
  * TP on the ``model`` axis: FFN hidden, attention projections, MoE expert
    dim (EP), vocab.
  * DP on ``data`` (+ ``pod`` multi-pod): batch; FSDP-style 2D weight
    sharding (``shard_2d``) additionally shards a weight dim over ``data``
    for the large archs so params/optimizer state fit memory.
  * SP: long-context / decode KV caches shard the sequence dim when batch
    or kv-head counts are too small to cover the mesh.
  * Head dims shard over ``model`` only when the head count reaches the
    axis size; uneven shards of activation dims >= 4096 are allowed in a
    layout rule (``_ok``), otherwise the dim stays replicated.

Every function here is a pure function of the config, the shape and the
mesh's ``shape``/``axis_names`` (a :class:`~repro_torch.launch.mesh.MeshShape`
will do).  Parameter trees are the port's nested dicts (``tree.py``),
whose leaves need only a ``.shape`` (meta tensors: ``steps.abstract_params``).
:func:`local_shard` cuts this rank's slice of a full array by its spec,
:func:`shard_tree` this rank's blocks of a whole tree, and
:func:`gather_tree` (the one function here that communicates) puts the
whole tree back together from every rank's blocks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import tree
from ..configs.base import ModelConfig, ShapeConfig
from ..core.nesting import NestedTensor
from . import comm


class PartitionSpec(tuple):
    """A tuple with one entry per array dim: a mesh axis name, a tuple of
    axis names, or None (replicated); ``P()`` is replicated in every dim
    (the stand-in for ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _ok(dim: int, size: int) -> bool:
    """Accept sharding if divisible, or big enough that padding is cheap.
    (Lenient rule: only for activation layouts.)"""
    return dim % size == 0 or dim >= 4096


def _axis_size(axis, mesh) -> int:
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= mesh.shape[a]
    return size


def _maybe(axis: Optional[str], dim: int, mesh) -> Optional[str]:
    """Strict divisibility - required for parameters and inputs."""
    if axis is None:
        return None
    return axis if dim % _axis_size(axis, mesh) == 0 else None


# ---------------------------------------------------------------------------
# Parameter PartitionSpecs (pattern-matched on the param tree path)
# ---------------------------------------------------------------------------
_REDUCE_FIRST = ("o", "w_down", "out_proj")    # weights whose dim -2 is sharded on model


def _path_names(key: str) -> Tuple[str, ...]:
    """``"['blocks']['q']['w']"`` -> ``('blocks', 'q', 'w')``."""
    return tuple(part.strip("'\"") for part in key[1:-1].split("]["))


def param_pspecs(cfg: ModelConfig, abstract_params, mesh,
                 fsdp: Optional[str] = "data", attn_cols: bool = False):
    """abstract_params: a tree whose leaves have ``.shape`` (meta tensors).

    attn_cols: for DECODE, non-head-divisible attention weights are
    column-sharded over ``model`` (activation regathers are ~B*qd bytes at
    S=1, while replicated weights cost GB/step of memory reads)."""
    fsdp = fsdp if cfg.shard_2d else None
    msz = mesh.shape["model"]
    head_tp = (bool(cfg.num_heads) and cfg.num_heads % msz == 0) or attn_cols

    def spec(key, leaf) -> PartitionSpec:
        names = _path_names(key)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd <= 1:
            return P()
        name = names[-2] if names[-1] in ("w", "b", "scale", "table") else names[-1]
        if names[-1] == "b" or "norm" in name or name in ("dt_bias",):
            return P()
        if name == "embed" or "embed" in names[:-1] or names[-1] == "table":
            return P(_maybe("model", shape[0], mesh), _maybe(fsdp, shape[1], mesh))
        if name == "lm_head":
            return P(_maybe(fsdp, shape[0], mesh), _maybe("model", shape[1], mesh))
        if name == "router":
            return P(*([None] * nd))
        if name == "conv":
            return P(*([None] * (nd - 1)), _maybe("model", shape[-1], mesh))
        if nd == 4:  # stacked MoE experts (L, E, d, ff) / (L, E, ff, d)
            if name == "w_down":
                return P(None, _maybe("model", shape[1], mesh),
                         _maybe(fsdp, shape[2], mesh), None)
            return P(None, _maybe("model", shape[1], mesh), None,
                     _maybe(fsdp, shape[3], mesh))
        if name in ("q", "k", "v", "o") and not head_tp:
            # sequence-parallel attention: weights replicated over model
            # (activations shard the sequence dim instead)
            return P(*([None] * (nd - 2)),
                     _maybe(fsdp, shape[-2], mesh) if name != "o" else None,
                     None if name != "o" else _maybe(fsdp, shape[-1], mesh))
        if name in _REDUCE_FIRST:
            return P(*([None] * (nd - 2)),
                     _maybe("model", shape[-2], mesh),
                     _maybe(fsdp, shape[-1], mesh))
        # default: shard output dim on model, input dim on fsdp
        return P(*([None] * (nd - 2)),
                 _maybe(fsdp, shape[-2], mesh),
                 _maybe("model", shape[-1], mesh))

    return tree.map_with_path(spec, abstract_params)


# ---------------------------------------------------------------------------
# Activation logical rules (consumed by distributed.ctx.shard_hint)
# ---------------------------------------------------------------------------
def logical_rules(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict:
    dp = dp_axes(mesh)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    msz = mesh.shape["model"]
    batch_ax = dp
    dpsz = 1
    for a in (dp if isinstance(dp, tuple) else ((dp,) if dp else ())):
        dpsz *= mesh.shape[a]
    local_b = shape.microbatch if shape.kind == "train" and shape.microbatch \
        else shape.global_batch
    if local_b < dpsz:
        batch_ax = "data" if local_b >= mesh.shape["data"] else None
    # attention mode: clean head-TP when head count divides the model axis;
    # otherwise sequence-parallel attention (replicated small attn weights,
    # seq-sharded activations) - see DESIGN.md Sec. 4.
    head_tp = bool(cfg.num_heads) and cfg.num_heads % msz == 0
    seq_attn = bool(cfg.num_heads) and not head_tp
    return {
        "batch": batch_ax,
        "heads": "model" if head_tp else None,
        "kv_heads": ("model" if (head_tp and cfg.num_kv_heads
                                 and cfg.num_kv_heads % msz == 0) else None),
        "attn_seq": "model" if seq_attn else None,
        "vocab": "model" if _ok(cfg.vocab_size, msz) else None,
        "experts": "model" if cfg.num_experts and _ok(cfg.num_experts, msz) else None,
        "expert_cap": batch_ax,     # MoE capacity shards with the tokens
        "seq": None,
    }


# ---------------------------------------------------------------------------
# Batch / cache / optimizer specs
# ---------------------------------------------------------------------------
def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 with_labels: bool) -> Dict[str, PartitionSpec]:
    rules = logical_rules(cfg, shape, mesh)
    b = rules["batch"]
    out: Dict[str, PartitionSpec] = {}
    if cfg.input_kind == "tokens":
        out["tokens"] = P(b, None)
    else:
        out["embeddings"] = P(b, None, None)
    if with_labels:
        out["labels"] = P(b, None)
    return out


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    """KV / SSM cache specs for decode cells.

    Dense caches are (L, B, S, Hkv, hd). kv-heads shard over ``model`` when
    wide enough, else the sequence dim takes ``model`` (SP).  Batch shards
    over dp when it covers the axis, else sequence takes ``data`` too
    (long-context, batch=1).
    """
    rules = logical_rules(cfg, shape, mesh)
    b = rules["batch"]
    kvh = rules["kv_heads"]
    out: Dict[str, Any] = {"pos": P()}
    if cfg.family in ("dense", "moe", "hybrid"):
        seq_ax = None
        if kvh is None:
            seq_ax = "model"
        if b is None:
            seq_ax = ("data", "model") if kvh is None else "data"
        out["k"] = P(None, b, seq_ax, kvh, None)
        out["v"] = P(None, b, seq_ax, kvh, None)
    if cfg.family in ("ssm", "hybrid"):
        h_ax = "model" if cfg.ssm_heads >= mesh.shape["model"] else None
        out["state"] = P(None, b, h_ax, None, None)
        out["conv_buf"] = P(None, b, None, "model")
    return out


def opt_pspecs(param_specs):
    from ..optim.adamw import AdamWState
    return AdamWState(step=P(), m=param_specs, v=param_specs, master=param_specs)


# ---------------------------------------------------------------------------
# This rank's slice
# ---------------------------------------------------------------------------
def spec_axes(spec: PartitionSpec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over, in dim order."""
    out = []
    for ax in spec:
        out.extend(ax if isinstance(ax, tuple) else (() if ax is None else (ax,)))
    return tuple(out)


def local_shard(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of the full array ``x`` under ``spec`` (a
    contiguous copy where a dim is cut; ``x`` itself where none is)."""
    out = x
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n = mesh.axis_size(ax)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {ax!r} "
                             f"({n} ranks)")
        size = x.shape[dim] // n
        out = out.narrow(dim, mesh.coord(ax) * size, size)
    return out if out is x else out.contiguous()


# ---------------------------------------------------------------------------
# Local shards of whole trees, and back
# ---------------------------------------------------------------------------
def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields") and not is_spec(t)


def _walk(t, spec, leaf_fn, nested_fn):
    if isinstance(t, dict):
        return {k: _walk(v, spec[k], leaf_fn, nested_fn) for k, v in t.items()}
    if _is_namedtuple(t):
        return type(t)(*(_walk(getattr(t, f), getattr(spec, f), leaf_fn, nested_fn)
                         for f in t._fields))
    if isinstance(t, NestedTensor):
        return nested_fn(t, spec)
    if isinstance(t, torch.Tensor):
        return leaf_fn(t, spec)
    return t


def _nested_shape(nt: NestedTensor, spec: NestedTensor, mesh, whole: bool):
    """The logical shape of a nested leaf's block (``whole=False``) or of
    the whole leaf its block belongs to."""
    shape = list(nt.shape)
    for d, ax in enumerate(spec.w_base):
        if ax is None or d == len(shape) - 2:
            continue
        n = mesh.axis_size(ax)
        shape[d] = shape[d] * n if whole else shape[d] // n
    return tuple(shape)


def shard_tree(t, specs, mesh):
    """This rank's block of every leaf of the whole tree ``t``
    (``specs``: the tree of PartitionSpecs; a NestedTensor's spec is a
    NestedTensor of specs, as ``_nested_pspecs`` gives it)."""
    def nested(nt, spec):
        if any(ax is not None for ax in spec.w_base[-2:-1]):
            raise ValueError("the packed K dim of a nested leaf cannot be split")
        return nt._replace(
            w_base=local_shard(nt.w_base, spec.w_base, mesh),
            deltas=tuple(None if d is None else local_shard(d, s, mesh)
                         for d, s in zip(nt.deltas, spec.deltas)),
            scale=local_shard(nt.scale, spec.scale, mesh),
            shape=_nested_shape(nt, spec, mesh, whole=False))

    return _walk(t, specs, lambda x, s: local_shard(x, s, mesh), nested)


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole array whose block under ``spec`` is this rank's ``x``."""
    for dim, ax in enumerate(spec):
        if ax is not None and mesh.axis_size(ax) > 1:
            x = comm.all_gather(x, mesh.group(ax), dim)
    return x


def gather_tree(t, specs, mesh):
    """The whole tree from this rank's blocks (every rank gets it)."""
    def nested(nt, spec):
        return nt._replace(
            w_base=gather_leaf(nt.w_base, spec.w_base, mesh),
            deltas=tuple(None if d is None else gather_leaf(d, s, mesh)
                         for d, s in zip(nt.deltas, spec.deltas)),
            scale=gather_leaf(nt.scale, spec.scale, mesh),
            shape=_nested_shape(nt, spec, mesh, whole=True))

    return _walk(t, specs, lambda x, s: gather_leaf(x, s, mesh), nested)
