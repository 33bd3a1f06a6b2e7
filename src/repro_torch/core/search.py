"""Calibration-driven recipe search; counterpart of ``repro/core/search.py``.

Per-layer rung sensitivity is measured and solved for, and the result is
emitted as the repo's own declarative artifact: a
:class:`~repro_torch.core.recipe.QuantRecipe` with one exact-path
:class:`~repro_torch.core.recipe.LayerOverride` per layer.

  1. **Score** - quantize every quantizable leaf once on the full candidate
     chain and score each rung on seeded synthetic calibration batches:
     SQNR (dB) of the rung's layer output against the FP output, and the
     Pearson correlation of the two.  The layer outputs are f32 products on
     the leaf's device; the scores are rounded to 6 (SQNR) and 9 (Pearson)
     digits, as the reference rounds them.
  2. **Assign** - every layer starts on the minimal 2-rung ladder; the
     single upgrade with the best marginal quality per byte anywhere in the
     model is applied until the budget is spent.  The upgrade order does
     not depend on the budget, so a larger budget takes a longer prefix of
     it and no layer's ladder gets shallower as the budget grows.
  3. **Emit** - the winning ladders as a ``QuantRecipe`` (JSON in the
     reference's format) plus serve-time :class:`RungAssignment`s for any
     byte budget (:meth:`SearchResult.assignment_for`).
"""
from __future__ import annotations

import heapq
import json
import warnings
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tree
from ..device import resolve_device
from .decompose import normalize_bits
from .nesting import default_predicate, nest_quantize
from .recipe import QuantRecipe, exact_override
from .similarity import quality_report
from .switching import RungAssignment

METRICS = ("sqnr", "pearson")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
def calibration_batch(path: str, K: int, batch_size: int = 32, seed: int = 0,
                      device=None) -> torch.Tensor:
    """Seeded synthetic calibration activations ``(batch_size, K)`` f32 on
    ``device`` (default: the card) for the layer at keystr ``path``: folded
    Gaussians |N(0, 1)| (nonzero mean, the regime of post-activation
    features) from numpy's ``default_rng`` seeded by ``seed`` mixed with the
    CRC-32 of the path, the reference's draw exactly."""
    s = (zlib.crc32(path.encode()) ^ (seed * 0x9E3779B1 & 0xFFFFFFFF))
    rng = np.random.default_rng(s & 0xFFFFFFFF)
    x = np.abs(rng.normal(size=(batch_size, K)))
    return torch.from_numpy(x.astype(np.float32)).to(resolve_device(device))


def default_calibration(batch_size: int = 32, seed: int = 0
                        ) -> Callable[[str, Any], torch.Tensor]:
    """The default ``calibration`` hook: seeded batches shaped to each
    layer's reduction dim, on the layer's device."""
    def calib(path: str, leaf: Any) -> torch.Tensor:
        return calibration_batch(path, int(leaf.shape[-2]), batch_size=batch_size,
                                 seed=seed, device=leaf.device)
    return calib


# ---------------------------------------------------------------------------
# sensitivity scoring
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RungScore:
    """Quality and byte coordinates of one rung of one layer's ladder."""
    rung: int
    bits: int
    sqnr_db: float
    pearson: float
    resident_bytes: int          # packed bytes resident serving this rung

    def metric(self, name: str) -> float:
        if name == "sqnr":
            return self.sqnr_db
        if name == "pearson":
            return self.pearson
        raise ValueError(f"metric {name!r} not in {METRICS}")


@dataclass(frozen=True)
class LayerSensitivity:
    """Per-rung calibration scores of one leaf on the candidate chain."""
    path: str
    shape: Tuple[int, ...]
    chain: Tuple[int, ...]               # ascending candidate bitwidths
    rungs: Tuple[RungScore, ...]         # one entry per chain rung

    def gain(self, rung: int, metric: str) -> float:
        """Marginal quality of upgrading ``rung-1 -> rung``."""
        return self.rungs[rung].metric(metric) - self.rungs[rung - 1].metric(metric)

    def cost(self, rung: int) -> int:
        """Marginal resident bytes of upgrading ``rung-1 -> rung``."""
        return self.rungs[rung].resident_bytes - self.rungs[rung - 1].resident_bytes


def _layer_out(x: torch.Tensor, w: torch.Tensor) -> np.ndarray:
    """f32 ``einsum('mk,bkn->bmn')`` on the leaf's device, as float64."""
    return torch.einsum("mk,bkn->bmn", x, w).cpu().numpy().astype(np.float64)


def score_layer(path: str, w: torch.Tensor, chain: Sequence[int],
                rounding: str = "adaptive", group_size: Optional[int] = None,
                calibration: Optional[Callable[[str, Any], torch.Tensor]] = None,
                ) -> LayerSensitivity:
    """Quantize ``w`` on the full ``chain`` and score every rung's layer
    output against the FP output on the calibration batch."""
    chain = normalize_bits(chain)
    if calibration is None:
        calibration = default_calibration()
    x = calibration(path, w).to(w.device, torch.float32)
    w = w.float()
    K, N = w.shape[-2], w.shape[-1]
    y_fp = _layer_out(x, w.reshape(-1, K, N))

    nt = nest_quantize(w, bits=chain, rounding=rounding, group_size=group_size)
    scores: List[RungScore] = []
    resident = nt.nbytes_base() + nt.nbytes_scales()
    for r in range(nt.num_rungs):
        if r > 0:
            resident += nt.nbytes_delta(r - 1)
        y_r = _layer_out(x, nt.rung_weight(r, torch.float32).reshape(-1, K, N))
        rep = quality_report(y_fp, y_r)
        scores.append(RungScore(rung=r, bits=chain[r], sqnr_db=round(rep["sqnr_db"], 6),
                                pearson=round(rep["pearson"], 9), resident_bytes=resident))
    return LayerSensitivity(path=path, shape=tuple(w.shape), chain=chain,
                            rungs=tuple(scores))


# ---------------------------------------------------------------------------
# byte-budgeted assignment (greedy marginal quality-per-byte ascent)
# ---------------------------------------------------------------------------
def _upgrade_sequence(layers: Sequence[LayerSensitivity], metric: str,
                      start_rung: int) -> List[Tuple[str, int, int, float]]:
    """The budget-independent global upgrade order ``[(path, target_rung,
    cost_bytes, gain), ...]``: repeatedly the best marginal quality per
    byte anywhere, a layer's rung t+1 never before its rung t."""
    by_path = {ls.path: ls for ls in layers}

    def entry(ls: LayerSensitivity, t: int):
        cost = max(ls.cost(t), 1)
        return (-ls.gain(t, metric) / cost, ls.path, t)

    heap = [entry(ls, start_rung + 1) for ls in layers if len(ls.rungs) > start_rung + 1]
    heapq.heapify(heap)
    seq: List[Tuple[str, int, int, float]] = []
    while heap:
        _, path, t = heapq.heappop(heap)
        ls = by_path[path]
        seq.append((path, t, ls.cost(t), ls.gain(t, metric)))
        if t + 1 < len(ls.rungs):
            heapq.heappush(heap, entry(ls, t + 1))
    return seq


@dataclass(frozen=True)
class SearchResult:
    """The emitted recipe, the sensitivity table it came from, and the
    byte accounting."""
    recipe: QuantRecipe
    layers: Tuple[LayerSensitivity, ...]
    tops: Tuple[Tuple[str, int], ...]    # (path, chosen top rung index)
    chain: Tuple[int, ...]
    rounding: str
    metric: str
    budget_bytes: Optional[int]
    spent_bytes: int                     # full-resident bytes of the choice
    fp_bytes: int                        # dense leaves, counted in spent

    @property
    def tops_map(self) -> Dict[str, int]:
        return dict(self.tops)

    def to_json(self) -> str:
        return json.dumps({
            "chain": list(self.chain), "rounding": self.rounding,
            "metric": self.metric, "budget_bytes": self.budget_bytes,
            "spent_bytes": self.spent_bytes, "fp_bytes": self.fp_bytes,
            "recipe": json.loads(self.recipe.to_json()),
            "layers": [{
                "path": ls.path, "shape": list(ls.shape),
                "chain": list(ls.chain), "top": self.tops_map[ls.path],
                "rungs": [{"rung": r.rung, "bits": r.bits, "sqnr_db": r.sqnr_db,
                           "pearson": r.pearson, "resident_bytes": r.resident_bytes}
                          for r in ls.rungs],
            } for ls in self.layers],
        }, indent=2)

    def table(self) -> str:
        """Per-layer ladder map with the scores that drove the choice."""
        lines = [f"budget={self.budget_bytes} spent={self.spent_bytes} "
                 f"(fp={self.fp_bytes}) metric={self.metric} rounding={self.rounding}"]
        for ls in self.layers:
            top = self.tops_map[ls.path]
            marks = " ".join(f"[{r.bits}b {r.sqnr_db:.1f}dB]" if r.rung <= top
                             else f"{r.bits}b {r.sqnr_db:.1f}dB" for r in ls.rungs)
            lines.append(f"  {ls.path}: bits={ls.chain[:top + 1]}  {marks}")
        return "\n".join(lines)

    def assignment_for(self, budget_bytes: Optional[int]) -> RungAssignment:
        """A serve-time per-leaf rung map for ``budget_bytes`` from the same
        table: every leaf at rung 0, then the fixed upgrade walk (clamped
        to each layer's searched top) while it fits.  Paths are exact
        keystrs, for ``NestQuantStore.apply``."""
        tops = self.tops_map
        rungs = {ls.path: 0 for ls in self.layers}
        spent = self.fp_bytes + sum(ls.rungs[0].resident_bytes for ls in self.layers)
        for path, t, cost, _ in _upgrade_sequence(self.layers, self.metric, start_rung=0):
            if t > tops[path]:
                continue
            if budget_bytes is not None and spent + cost > budget_bytes:
                break
            rungs[path] = t
            spent += cost
        return RungAssignment(default=0, exact=tuple(sorted(rungs.items())))


def search_recipe(params, budget_bytes: Optional[int] = None, *,
                  bits: Sequence[int] = (8, 6, 4), rounding: str = "adaptive",
                  metric: str = "sqnr", batch_size: int = 32, seed: int = 0,
                  group_size: Optional[int] = None,
                  calibration: Optional[Callable[[str, Any], torch.Tensor]] = None,
                  predicate: Callable[[str, Any], bool] = default_predicate,
                  ) -> SearchResult:
    """Sensitivity-searched per-layer ladders under a byte budget, scored on
    the device the parameters live on.

    ``budget_bytes`` caps the full-resident footprint (every chosen ladder
    at its top rung, plus scales and untouched FP leaves: the basis of
    ``NestQuantStore.rung_resident_bytes``); ``None`` keeps every layer on
    the full chain.  Layers the budget cannot afford keep the minimal
    2-rung ladder ``bits[:2]``."""
    chain = normalize_bits(bits)
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r} not in {METRICS}")
    if calibration is None:
        calibration = default_calibration(batch_size=batch_size, seed=seed)

    layers: List[LayerSensitivity] = []
    fp_bytes = 0
    for key, leaf in tree.flatten_with_path(params):
        if predicate(key, leaf):
            layers.append(score_layer(key, leaf, chain, rounding=rounding,
                                      group_size=group_size, calibration=calibration))
        elif hasattr(leaf, "nbytes"):
            fp_bytes += int(leaf.nbytes)
    layers.sort(key=lambda ls: ls.path)
    if not layers:
        raise ValueError("no quantizable leaves under the predicate - nothing to search")

    # minimal 2-rung ladders first, then the fixed-priority upgrade walk
    tops = {ls.path: 1 for ls in layers}
    spent = fp_bytes + sum(ls.rungs[1].resident_bytes for ls in layers)
    if budget_bytes is not None and spent > budget_bytes:
        warnings.warn(f"budget {budget_bytes} cannot fit even the minimal {chain[:2]} "
                      f"ladders ({spent} bytes); emitting the minimum", stacklevel=2)
    for path, t, cost, _ in _upgrade_sequence(layers, metric, start_rung=1):
        if budget_bytes is not None and spent + cost > budget_bytes:
            break
        tops[path] = t
        spent += cost

    overrides = tuple(exact_override(ls.path, bits=ls.chain[:tops[ls.path] + 1])
                      for ls in layers)
    recipe = QuantRecipe(bits=chain, rounding=rounding, group_size=group_size,
                         overrides=overrides, predicate=predicate)
    return SearchResult(recipe=recipe, layers=tuple(layers), tops=tuple(sorted(tops.items())),
                        chain=chain, rounding=rounding, metric=metric,
                        budget_bytes=budget_bytes, spent_bytes=spent, fp_bytes=fp_bytes)
