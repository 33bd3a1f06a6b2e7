"""Data-free adaptive rounding (SQuant-style CASE flip); counterpart of
``repro/core/squant.py``.

After round-to-nearest, the signed error sum E of each flip group (a row
of the trailing axis) is driven to |E| <= 0.5 by flipping the k =
round(E) elements whose fractional error is largest toward the other
member of their {floor, ceil} pair.  Every code therefore stays in that
pair - the property that keeps the nesting compensation lossless.

Two things decide whether the port's codes equal the reference's:
ranks come from a STABLE double argsort (``jnp.argsort`` is stable,
``torch.argsort`` only with ``stable=True``), and the row sum E may
differ in its last bit when summed in another order, so ``round(E)`` can
differ on rows whose sum sits within an ulp of a .5 tie.
"""
from __future__ import annotations

from typing import Optional

import torch

from .quantizer import int_range


def _rank(key: torch.Tensor) -> torch.Tensor:
    """Position of each element in a stable ascending sort of its row."""
    order = torch.argsort(key, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _flip_rows(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """CASE flip over the last axis of v. Returns int32 codes."""
    v = v.float()
    q0 = torch.clamp(torch.round(v), lo, hi)
    e = v - q0
    E = e.sum(dim=-1, keepdim=True)
    k = torch.round(E)                           # signed flip count per row

    can_up = (e > 0) & (q0 + 1 <= hi)
    can_dn = (e < 0) & (q0 - 1 >= lo)
    inf = torch.tensor(float("inf"), device=v.device)

    up_rank = _rank(-torch.where(can_up, e, -inf))   # largest positive e first
    flip_up = (k > 0) & can_up & (up_rank < k)

    dn_rank = _rank(torch.where(can_dn, e, inf))     # most negative e first
    flip_dn = (k < 0) & can_dn & (dn_rank < -k)

    q = q0 + flip_up.float() - flip_dn.float()
    return torch.clamp(q, lo, hi).to(torch.int32)


def adaptive_round(v: torch.Tensor, n_bits: int,
                   group_size: Optional[int] = None) -> torch.Tensor:
    """SQuant-style adaptive rounding of real targets ``v`` to INT-n codes.
    The flip group is the trailing axis, optionally cut into
    ``group_size`` chunks."""
    lo, hi = int_range(n_bits)
    orig_shape = v.shape
    if v.ndim == 1:
        v = v[None, :]
    v2 = v.reshape(-1, v.shape[-1])
    if group_size and v2.shape[-1] % group_size == 0 and v2.shape[-1] > group_size:
        q = _flip_rows(v2.reshape(v2.shape[0], -1, group_size), lo, hi)
        q = q.reshape(v2.shape)
    else:
        q = _flip_rows(v2, lo, hi)
    return q.reshape(orig_shape)


def case_metric(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Constrained Absolute Sum of Error per row: |sum(v - q)| (a diagnostic)."""
    return torch.abs((v.float() - q.float()).sum(dim=-1))


def is_floor_ceil(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Elementwise: every code is floor(v) or ceil(v) of its target."""
    v = v.float()
    q = q.float()
    return (q == torch.floor(v)) | (q == torch.ceil(v))


def group_signed_error(v: torch.Tensor, q: torch.Tensor,
                       group_size: Optional[int] = None) -> torch.Tensor:
    """Per-flip-group signed error sum E = sum(v - q), grouped as
    :func:`adaptive_round` groups."""
    e = v.float() - q.float()
    e2 = e.reshape(-1, e.shape[-1]) if e.ndim > 1 else e.reshape(1, -1)
    if group_size and e2.shape[-1] % group_size == 0 and e2.shape[-1] > group_size:
        e2 = e2.reshape(e2.shape[0], -1, group_size)
    return e2.sum(dim=-1)
