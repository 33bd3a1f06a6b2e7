"""AdamW + global-norm clipping + warmup-cosine schedule; counterpart of
``repro/optim/adamw.py``, with its arithmetic.

The first and second moments and an f32 master copy of every parameter are
kept in f32 whatever the parameter dtype (bf16 parameters train against an
f32 master); weight decay applies to matmul weights only (``p.ndim >= 2``);
clipping scales f32 copies of the gradients; the new master is cast to the
parameter's dtype.  The schedule is computed in f32 from the step, as the
reference computes it from ``step.astype(jnp.float32)``.

Trees are nested dicts of tensors (``tree.py``).  ``apply_update`` runs
under ``torch.no_grad()`` and updates the state's m, v and master tensors in
place, one leaf at a time (the reference returns new arrays; the numbers
are the same, and a full-width model does not hold two copies of its f32
state at once); it returns new parameter tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .. import tree


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    m: Any
    v: Any
    master: Any          # f32 master weights


def init_state(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=tree.leaves(params)[0].device),
        m=tree.map_with_path(lambda _, p: zeros(p), params),
        v=tree.map_with_path(lambda _, p: zeros(p), params),
        master=tree.map_with_path(lambda _, p: p.detach().to(torch.float32, copy=True),
                                  params))


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    to ``floor * peak_lr`` at ``total``: a 0-d f32 tensor."""
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    # the reference's scalar f32 cos is correctly rounded: take cos in f64
    # of the f32 argument and round once
    cos_f32 = torch.cos((math.pi * frac).to(torch.float64)).to(torch.float32)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + cos_f32))
    return torch.where(step < warmup, warm, cos)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's f32 sum
    of squares."""
    total = 0
    for g in tree.leaves(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.minimum(torch.ones((), device=gn.device),
                         max_norm / torch.maximum(gn, torch.full((), 1e-12, device=gn.device)))


def clip_by_global_norm(grads, max_norm: float):
    """(f32 gradients scaled to a global norm of at most ``max_norm``,
    the global norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree.map_with_path(lambda _, g: g.to(torch.float32) * scale, grads), gn


@torch.no_grad()
def apply_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 max_grad_norm: float = 1.0,
                 grad_norm: Optional[torch.Tensor] = None) -> Tuple[Any, AdamWState, Dict]:
    """One AdamW step -> (new params, state, {"grad_norm", "lr"}).  Each
    leaf's gradient is clipped to f32 as ``clip_by_global_norm`` clips it,
    one leaf at a time.  ``grad_norm``: the global norm, where ``grads``
    are one rank's blocks of a sharded gradient (``distributed/steps.py``
    sums it over the mesh); by default :func:`global_norm` of ``grads``."""
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = _clip_scale(gn, max_grad_norm)
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(_f32(b1, t.device), t)
    c2 = 1.0 - torch.pow(_f32(b2, t.device), t)
    lr = _f32(lr, t.device)

    def upd(p, g, m, v, w32):
        g = g.to(torch.float32) * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        delta = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay and p.ndim >= 2:            # decay matmul weights only
            delta = delta + weight_decay * w32
        w32.copy_(w32 - lr * delta)
        return w32.to(p.dtype, copy=True)

    new = [upd(*leaf) for leaf in zip(*(tree.leaves(t) for t in
                                        (params, grads, state.m, state.v, state.master)))]
    return tree.unflatten(params, new), AdamWState(step, state.m, state.v, state.master), \
        {"grad_norm": gn, "lr": lr}
