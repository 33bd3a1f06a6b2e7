"""Declarative quantization recipes; counterpart of ``repro/core/recipe.py``.

A :class:`QuantRecipe` is the default ladder plus an ordered list of
per-layer :class:`LayerOverride` rules matched (``re.search``, first match
wins) on each leaf's keystr path.  The JSON format is the reference's, so
one recipe file loads in both packages.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field, fields
from typing import Any, Callable, Optional, Tuple

from .. import tree
from ..device import resolve_device
from .decompose import ROUNDINGS, normalize_bits
from .nesting import default_predicate, nest_quantize


def _check_rounding(rounding: str) -> str:
    if rounding not in ROUNDINGS:
        raise ValueError(f"rounding {rounding!r} not in {ROUNDINGS}")
    return rounding


@dataclass(frozen=True)
class LayerOverride:
    """Leaves whose keystr matches ``pattern`` take these settings;
    ``dense=True`` keeps them in floating point; ``None`` inherits."""
    pattern: str
    bits: Optional[Tuple[int, ...]] = None
    rounding: Optional[str] = None
    block: Optional[int] = None
    group_size: Optional[int] = None
    dense: bool = False

    def __post_init__(self):
        re.compile(self.pattern)
        if self.bits is not None:
            object.__setattr__(self, "bits", normalize_bits(self.bits))
        if self.rounding is not None:
            _check_rounding(self.rounding)
        if self.dense and (self.bits or self.rounding or self.block
                           or self.group_size):
            raise ValueError(f"override {self.pattern!r}: dense=True takes "
                             "no quantization settings")

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


@dataclass(frozen=True)
class LeafSpec:
    """Resolved per-leaf quantization settings."""
    bits: Tuple[int, ...]
    rounding: str
    block: Optional[int]
    group_size: Optional[int]


@dataclass(frozen=True)
class QuantRecipe:
    """Whole-model nesting spec: default ladder + ordered overrides;
    ``predicate`` selects candidate leaves (default: matmul weights)."""
    bits: Tuple[int, ...] = (4, 8)
    rounding: str = "adaptive"
    block: Optional[int] = None
    group_size: Optional[int] = None
    overrides: Tuple[LayerOverride, ...] = ()
    predicate: Callable[[str, Any], bool] = field(
        default=default_predicate, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "bits", normalize_bits(self.bits))
        _check_rounding(self.rounding)
        object.__setattr__(self, "overrides", tuple(self.overrides))

    def resolve(self, path: str, leaf: Any = None) -> Optional[LeafSpec]:
        """Settings for the leaf at ``path``, or None to keep it dense."""
        if leaf is not None and not self.predicate(path, leaf):
            return None
        for ov in self.overrides:
            if ov.matches(path):
                if ov.dense:
                    return None
                return LeafSpec(
                    bits=ov.bits if ov.bits is not None else self.bits,
                    rounding=ov.rounding or self.rounding,
                    block=ov.block if ov.block is not None else self.block,
                    group_size=(ov.group_size if ov.group_size is not None
                                else self.group_size))
        return LeafSpec(self.bits, self.rounding, self.block, self.group_size)

    def to_json(self) -> str:
        ovs = []
        for ov in self.overrides:
            d = {"pattern": ov.pattern}
            if ov.dense:
                d["dense"] = True
            for k in ("bits", "rounding", "block", "group_size"):
                v = getattr(ov, k)
                if v is not None:
                    d[k] = list(v) if k == "bits" else v
            ovs.append(d)
        return json.dumps({"bits": list(self.bits), "rounding": self.rounding,
                           "block": self.block, "group_size": self.group_size,
                           "overrides": ovs}, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "QuantRecipe":
        d = json.loads(text)
        known = {f.name for f in fields(cls)} - {"overrides", "predicate"}
        bad = set(d) - known - {"overrides"}
        if bad:
            raise ValueError(f"unknown recipe fields {sorted(bad)}")
        ovs = tuple(
            LayerOverride(pattern=o["pattern"],
                          bits=tuple(o["bits"]) if o.get("bits") else None,
                          rounding=o.get("rounding"),
                          block=o.get("block"),
                          group_size=o.get("group_size"),
                          dense=o.get("dense", False))
            for o in d.get("overrides", ()))
        kw = {k: v for k, v in d.items() if k in known and v is not None}
        if "bits" in kw:
            kw["bits"] = tuple(kw["bits"])
        return cls(overrides=ovs, **kw)


def exact_override(path: str, **settings) -> LayerOverride:
    """A ``LayerOverride`` matching exactly one keystr path."""
    return LayerOverride(pattern="^" + re.escape(path) + "$", **settings)


def quantize(params, recipe: QuantRecipe, device="cuda"):
    """Run Algorithm 1 over a parameter tree as ``recipe`` describes, on
    ``device``.  Selected leaves become :class:`NestedTensor` ladders;
    every other leaf is moved to ``device`` untouched."""
    if not isinstance(recipe, QuantRecipe):
        raise TypeError(f"expected a QuantRecipe, got {type(recipe).__name__}")
    dev = resolve_device(device)

    def leaf_fn(path, leaf):
        spec = recipe.resolve(path, leaf)
        if spec is None:
            return leaf.to(dev) if hasattr(leaf, "to") else leaf
        return nest_quantize(leaf.to(dev), bits=spec.bits, rounding=spec.rounding,
                             block=spec.block, group_size=spec.group_size)
    return tree.map_with_path(leaf_fn, params)


def recipe_summary(nested_params) -> str:
    """Per-leaf ladder map of a quantized tree, one line per leaf."""
    from .nesting import NestedTensor

    lines = []
    for key, leaf in tree.flatten_with_path(nested_params):
        if isinstance(leaf, NestedTensor):
            lines.append(f"{key}: bits={leaf.bits} block={leaf.block}")
        else:
            lines.append(f"{key}: dense {tuple(getattr(leaf, 'shape', ()))}")
    return "\n".join(lines)
