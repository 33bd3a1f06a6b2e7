"""Shared neural building blocks (norms, activations, RoPE, linear);
counterpart of ``repro/models/layers.py``.

Inside a sharding context (``distributed/ctx.py``) a weight may be this
rank's block of a matmul split over the ``model`` axis: it then holds
fewer output columns (:func:`col_linear`) or input rows (:func:`row_linear`)
than the config names.  Outside a context, or with every weight whole,
both are :func:`linear`."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.nesting import NestedTensor
from ..distributed import ctx
from ..kernels.nested_matmul import ops as nested_ops
from ..kernels.packed_matmul import ops as packed_ops


def pdot(x: torch.Tensor, w: torch.Tensor, preferred=None) -> torch.Tensor:
    """Matmul in the input dtype; with ``preferred`` (f32) the inputs are
    widened first, which is exact for bf16, so the product is the f32-
    accumulated one the reference asks XLA for."""
    if preferred is not None and preferred != x.dtype:
        return torch.matmul(x.to(preferred), w.to(preferred))
    return torch.matmul(x, w)


def packed_linear(x: torch.Tensor, nt: NestedTensor, out_dtype=None,
                  route=None) -> torch.Tensor:
    """Matmul straight from the packed words, dispatched on the stamped
    rung: rung 0 -> packed_matmul on the base stream with the inflated
    scale s*2^(n-h); rung 1 -> the dual-stream nested_matmul; deeper rungs
    -> the ladder_matmul.  ``route`` names the kernel route on the card
    (the decode phase's ``dispatch.DECODE``; None: by M and dtype).
    Takes one 2-D weight (a per-layer or per-expert view); a leaf with
    stacked leading dims raises rather than leaving the kernels."""
    if nt.w_base.ndim != 2:
        raise NotImplementedError(
            f"packed_linear takes a 2-D weight, got a stacked leaf of shape {nt.shape}; "
            "expert stacks go through models/moe.py one expert view at a time")
    x = x.contiguous()
    r = nt.rung
    rung_scale = nt.rung_scale(r).reshape(1, -1)
    if r == 0:
        return packed_ops.packed_matmul(x, nt.w_base, rung_scale, k=nt.bits[0],
                                        K=nt.K, block_k=nt.block, out_dtype=out_dtype,
                                        route=route)
    if r == 1:
        return nested_ops.nested_matmul(x, nt.w_base, nt.deltas[0], rung_scale,
                                        n=nt.bits[1], h=nt.bits[0], K=nt.K,
                                        block_k=nt.block, out_dtype=out_dtype, route=route)
    return nested_ops.ladder_matmul(x, (nt.w_base,) + nt.deltas[:r], rung_scale,
                                    bits=nt.bits[:r + 1], K=nt.K,
                                    block_k=nt.block, out_dtype=out_dtype, route=route)


def linear(x: torch.Tensor, w, b=None, route=None, out_dtype=None) -> torch.Tensor:
    """y = x @ w (+ b): the matmul in x's dtype, the bias added in the
    matmul's output dtype, the sum cast to x's dtype (the reference's
    cast order).  ``route``: as in :func:`packed_linear`.  ``out_dtype``
    (f32): the product accumulated and returned in it instead."""
    if isinstance(w, NestedTensor):
        y = packed_linear(x, w, out_dtype=out_dtype, route=route)
    else:
        y = pdot(x, w.to(x.dtype), preferred=out_dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(out_dtype or x.dtype)


def out_width(w) -> int:
    """Output columns this rank holds of a (dense or nested) weight."""
    return w.scale.shape[-1] if isinstance(w, NestedTensor) else w.shape[-1]


def in_width(w) -> int:
    """Input rows (K) this rank holds of a (dense or nested) weight."""
    return w.K if isinstance(w, NestedTensor) else w.shape[-2]


def col_linear(x, w, b=None, full: int = 0, route=None, xs=None) -> torch.Tensor:
    """:func:`linear` of a weight whose ``full`` output columns may be split
    over ``model``: a column block reads ``xs``, ``x`` entered into the
    model axis (``ctx.enter_model``; pass it to share one entry between
    projections), and this rank's block of the bias; the output is this
    rank's columns."""
    n = out_width(w)
    if n == full:
        return linear(x, w, b, route=route)
    if b is not None:
        b = ctx.model_slice(b, n)
    return linear(ctx.enter_model(x) if xs is None else xs, w, b, route=route)


def row_linear(x, w, full: int, route=None) -> torch.Tensor:
    """:func:`linear` (no bias) of a weight whose ``full`` input rows may be
    split over ``model``.  A row block takes this rank's columns of ``x``
    (cut from a whole ``x``) and its f32 partial products are summed over
    ``model``, then cast to x's dtype; a whole weight fed this rank's
    columns gathers them first."""
    k = in_width(w)
    if x.shape[-1] < k:
        x = ctx.gather_model(x, -1)
    elif x.shape[-1] > k:
        x = ctx.model_slice(x, k)
    if k == full:
        return linear(x, w, route=route)
    return ctx.sum_model(linear(x, w, route=route, out_dtype=torch.float32)).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm(x, params, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# RoPE (split halves)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp(x, params, act: str, d_ff: int, route=None):
    """The MLP, its ``d_ff``-wide hidden dim possibly split over ``model``
    (gate/up by columns, down by rows)."""
    xs = ctx.enter_model(x)

    def up(name):
        return col_linear(x, params[name]["w"], full=d_ff, route=route, xs=xs)

    h = silu(up("w_gate")) * up("w_up") if act == "swiglu" else gelu(up("w_up"))
    return row_linear(h, params["w_down"]["w"], d_ff, route=route)
