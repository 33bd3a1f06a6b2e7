"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch;
counterpart of ``repro/models/moe.py``, its per-data-shard dispatch
included.

Routing is the reference's: the router product in f32, an f32 softmax,
top-k with renormalised gates, the Switch aux loss, a stable sort of the
T*K assignments by expert that gives each its position within its expert,
and ``keep = pos < C`` (C from :func:`capacity`; ``dropless`` sizes it
for the worst case, so nothing is dropped).

The expert compute differs from the reference in mechanism only.  The
reference gathers a padded (E, C, d) tensor and multiplies it by the
dequantized expert stack.  Here each expert with at least one kept row,
in ascending order, gathers its rows into one contiguous (n_e, d) tensor
and runs gate/up, the activation and down through ``layers.linear`` on
the 2-D view of its weight (``NestedTensor.layer`` of the layer's
(E, K, N) slice, so K1-K3 read the packed words; a dense stack's slice
takes ``pdot``).  The reference's padded slots hold zero rows and add
exact zeros, so skipping them computes the same function.

The combine multiplies each expert's rows by their gates (cast to the
rows' dtype) and adds them into a zero (T, d) buffer one expert at a
time, in ascending expert order.  A token appears at most once per
expert, so each add touches distinct rows, and a token's sum is a left
fold from zero over its experts in ascending order: the reference's
expert-major slot order, on the card and on the CPU alike (one scatter of
all T*K rows would sum in atomic order on the card).

Sharded (a context of ``distributed/ctx.py``), as the reference's
``shard_map`` dispatch: where the ``batch`` rule names data axes, ``x``
is this data rank's tokens, so each data rank routes and dispatches its
own tokens with capacity ``capacity(T_local, ...)`` (in training, where
capacity drops tokens, per-shard capacity drops them differently from a
global dispatch: GShard's groups, the reference's semantics) and the aux
loss is averaged over the data axes.  Where the batch is replicated
(no data rule) every rank routes all tokens: the reference's global
path.  Where the ``experts`` rule names ``model``, model rank r computes
experts [r E / m, (r + 1) E / m) (from its shard of a split expert stack,
or its block of a whole one), the expert rows are gathered over
``model`` and every rank folds all of them in ascending expert order
(gathered rows, then the fold; never a sum of partial combines).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from ..core.nesting import NestedTensor
from ..distributed import ctx
from ..distributed.ctx import shard_hint
from ..kernels import dispatch
from .layers import gelu, linear, pdot, silu


def capacity(tokens: int, num_experts: int, top_k: int, factor: float,
             multiple: int = 8, dropless: bool = False) -> int:
    """Per-expert slot count C.  ``dropless=True`` sizes C for the worst
    case (every assignment lands on one expert), so no token is dropped:
    the serving paths' mode, in which a cached decode reproduces the full
    forward."""
    if dropless:
        c = tokens * top_k
    else:
        c = math.ceil(tokens * top_k * factor / num_experts)
    return max(multiple, math.ceil(c / multiple) * multiple)


class Routing(NamedTuple):
    """One dispatch: ``aux`` the Switch loss (None when not asked for), and
    ``groups``: for each
    expert with at least one kept row, ascending, (expert, token rows
    (n_e,) int64 ascending, their gates (n_e,) f32)."""
    aux: Optional[torch.Tensor]
    groups: Tuple[Tuple[int, torch.Tensor, torch.Tensor], ...]


def route_tokens(xf: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """xf (T, d) -> (probs (T, E) f32, gate_vals (T, K), expert_idx (T, K)).
    Top-k by a stable descending sort: equal probabilities keep the lower
    expert first, as ``lax.top_k`` does."""
    logits = pdot(xf, router_w.to(xf.dtype), preferred=torch.float32)
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :top_k], idx[:, :top_k]
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), expert_idx


def equal_shares(assignments: int, num_experts: int) -> List[int]:
    """Each expert's count of ``assignments`` where the routing is abstract
    (the dry run's fake tensors hold no expert choices): equal shares, the
    remainder to the first experts."""
    base, rem = divmod(assignments, num_experts)
    return [base + int(e < rem) for e in range(num_experts)]


def dry_owner_rows(tokens: int, top_k: int, num_experts: int, m: int,
                   cap: int) -> Tuple[int, ...]:
    """The expert rows each of ``m`` model ranks computes, the experts split
    over ``model`` in blocks of E/m, for an abstract dispatch of ``tokens``
    tokens (:func:`equal_shares`, each expert kept to ``cap`` rows): the
    first ranks compute more where the remainder falls unevenly."""
    per = num_experts // m
    kept = [min(n, cap) for n in equal_shares(tokens * top_k, num_experts)]
    return tuple(sum(kept[q * per:(q + 1) * per]) for q in range(m))


def _dispatch(probs, gate_vals, expert_idx, *, E: int, C: int,
              want_aux: bool = True) -> Routing:
    """Capacity dispatch of routed tokens (the reference's ``_dispatch``
    without the padded gather).  ``want_aux=False`` skips the aux loss,
    which eager PyTorch would otherwise compute on every serving call."""
    T, K = expert_idx.shape
    aux = None
    if want_aux:
        # load-balancing aux loss (Switch): E * sum_e f_e * p_e
        me = probs.mean(dim=0)
        ce = torch.nn.functional.one_hot(expert_idx, E).float().sum(dim=1).mean(dim=0)
        aux = E * (me * ce).sum()

    ef = expert_idx.reshape(T * K)
    tok = torch.arange(T, device=ef.device).repeat_interleave(K)
    order = torch.sort(ef, stable=True).indices
    st, sg = tok[order], gate_vals.reshape(T * K)[order]
    if dispatch.is_abstract(ef):
        counts = equal_shares(T * K, E)
    else:
        counts = torch.bincount(ef, minlength=E).tolist()
    # sorted by expert, each expert's assignments are one run in token
    # order; position-in-expert pos < C keeps the run's first C
    groups, start = [], 0
    for e, n in enumerate(counts):
        kept = min(n, C)
        if kept:
            groups.append((e, st[start:start + kept], sg[start:start + kept]))
        start += n
    return Routing(aux, tuple(groups))


def _expert_view(leaf, e: int):
    """Expert ``e`` of a layer's (E, K, N) slice: a 2-D view."""
    return leaf.layer(e) if isinstance(leaf, NestedTensor) else leaf[e]


def _expert_compute(x_e, experts: Dict, e: int, act: str, route):
    def lin(x, name):
        return linear(x, _expert_view(experts[name]["w"], e), route=route)

    if act == "swiglu":
        h = silu(lin(x_e, "w_gate")) * lin(x_e, "w_up")
    else:
        h = gelu(lin(x_e, "w_up"))
    return lin(h, "w_down")


def warm_decode_rows(params: Dict, dtype: torch.dtype, device) -> None:
    """Launch the decode route at every row count of the decode body's
    instantiations (``dispatch.DEC_ROWS``: 1, 2, 4, 8) on one expert view
    of each nested expert leaf of ``params``.  An expert group has as many
    rows as the routing gives it, so one decode step reaches only some
    instantiations, and each opts into large shared memory at its first
    launch (``dispatch.DEC_INSTANCES`` records the launched ones).  Does
    nothing on a model without experts, or off the card, where no
    instantiation exists."""
    if torch.device(device).type != "cuda":
        return
    experts = params.get("blocks", {}).get("moe", {}).get("experts", {})
    for leaf in experts.values():
        if isinstance(leaf["w"], NestedTensor):
            view = _expert_view(leaf["w"].layer(0), 0)
            for M in dispatch.DEC_ROWS:
                linear(torch.zeros((M, view.K), dtype=dtype, device=device), view,
                       route=dispatch.DECODE)


class GroupLog(NamedTuple):
    """One ``moe_ffn`` call: the K1-K3 route it named (None: by M), the
    rung stamped on its experts (None: a dense stack), its T tokens, the
    (expert, rows) groups this rank computed, in launch order (all of
    them unless experts are split over ``model``), its (T, K) expert
    choices and its per-expert capacity C."""
    route: Optional[str]
    rung: Optional[int]
    tokens: int
    groups: Tuple[Tuple[int, int], ...]
    expert_idx: torch.Tensor
    capacity: int


class _Hooks:
    log: Optional[list] = None
    forced: Optional[Iterator[torch.Tensor]] = None


_hooks = _Hooks()


@contextlib.contextmanager
def record_groups():
    """Inside this block every :func:`moe_ffn` call appends a
    :class:`GroupLog` to the list this yields: a forward of an L-layer
    model appends L of them, layer by layer."""
    before = _hooks.log
    _hooks.log = []
    try:
        yield _hooks.log
    finally:
        _hooks.log = before


@contextlib.contextmanager
def forced_routing(choices):
    """Inside this block the i-th :func:`moe_ffn` call sends its tokens to
    the experts ``choices[i]`` (T, K) names instead of its own top-k, with
    gates from its own probabilities at those experts, renormalised: a
    reference pass that replays another pass's expert choices, so a
    near-tie in the router cannot send a token elsewhere."""
    before = _hooks.forced
    _hooks.forced = iter(choices)
    try:
        yield
    finally:
        _hooks.forced = before


def moe_ffn(x: torch.Tensor, params: Dict, *, num_experts: int, top_k: int,
            capacity_factor: float, act: str = "swiglu", cap_multiple: int = 8,
            dropless: bool = False, route=None, per_position: bool = False,
            want_aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, d) -> (out, aux loss; None with ``want_aux=False``).

    ``route`` names the K1-K3 route of every expert matmul (the decode
    phase's ``dispatch.DECODE``; None: by each group's M).  With
    ``per_position`` the router product, softmax and top-k run on each
    position's (B, d) rows, the calls a decode step makes, so position j
    of a decode chunk routes on the decode step's products."""
    B, S, d = x.shape
    T, E, K = B * S, num_experts, top_k
    xf = x.reshape(T, d)
    rw = params["router"]["w"]
    if per_position:
        parts = [route_tokens(x[:, j].contiguous(), rw, K) for j in range(S)]
        probs, gate_vals, expert_idx = (torch.stack([p[i] for p in parts], dim=1)
                                        .reshape(T, -1) for i in range(3))
    else:
        probs, gate_vals, expert_idx = route_tokens(xf, rw, K)
    if _hooks.forced is not None:
        expert_idx = next(_hooks.forced).to(probs.device)
        gate_vals = probs.gather(1, expert_idx)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    C = capacity(T, E, K, capacity_factor, cap_multiple, dropless=dropless)
    r = _dispatch(probs, gate_vals, expert_idx, E=E, C=C, want_aux=want_aux)
    aux = None if r.aux is None else ctx.mean_batch(r.aux)
    experts = params["experts"]
    leaf = experts["w_up"]["w"]
    mine, ys = _expert_rows(xf, r.groups, experts, E, act, route)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for (e, rows, gates), y in zip(r.groups, ys):
        out[rows] = out[rows] + y * gates.to(y.dtype)[:, None]
    if _hooks.log is not None:
        _hooks.log.append(GroupLog(
            route, leaf.rung if isinstance(leaf, NestedTensor) else None, T,
            tuple((e, rows.numel()) for e, rows, _ in mine), expert_idx, C))
    return shard_hint(out.reshape(B, S, d), ("batch", None, None)), aux


def _expert_rows(xf, groups, experts, E: int, act: str, route):
    """(the groups this rank computes, every group's expert output rows).
    With experts split over ``model`` (the ``experts`` rule), rank r
    computes its block of experts on ``xf`` entered into the model axis;
    each rank's outputs, padded to the longest, are gathered over
    ``model`` and cut back into groups."""
    cur = ctx.current()
    r, m = ctx.model_index()
    if cur is None or m == 1 or "model" not in cur[0].axes(cur[1].get("experts")):
        return groups, [_expert_compute(xf[rows], experts, e, act, route)
                        for e, rows, _ in groups]
    per = E // m
    w = experts["w_up"]["w"]
    held = (w.w_base if isinstance(w, NestedTensor) else w).shape[0]
    first = 0 if held == E else r * per             # expert index of the leaf's row 0
    xs = ctx.enter_model(xf)
    owner = [e // per for e, _, _ in groups]
    mine = [g for g, o in zip(groups, owner) if o == r]
    ys = [_expert_compute(xs[rows], experts, e - first, act, route) for e, rows, _ in mine]
    counts = [sum(g[1].numel() for g, o in zip(groups, owner) if o == q) for q in range(m)]
    longest = max(counts)
    local = torch.cat(ys) if ys else xf.new_zeros((0, xf.shape[1]))
    local = torch.nn.functional.pad(local, (0, 0, 0, longest - local.shape[0]))
    every = ctx.gather_model(local, 0).reshape(m, longest, -1)
    out, taken = [], [0] * m
    for (e, rows, _), q in zip(groups, owner):
        n = rows.numel()
        out.append(every[q, taken[q]:taken[q] + n])
        taken[q] += n
    return mine, out
