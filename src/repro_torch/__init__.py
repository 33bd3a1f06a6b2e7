"""NestQuant on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

Subpackages mirror ``repro`` one to one (``core/packing.py`` answers to
``repro/core/packing.py`` and so on).  This package imports ``torch`` and
numpy, never ``jax`` and never ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.

The public surface is :mod:`repro_torch.api`; its names are re-exported
here lazily (PEP 562), as ``repro/__init__.py`` does, so ``import
repro_torch`` stays cheap and submodules import without pulling the whole
serving stack.
"""
from __future__ import annotations

from importlib import import_module

_API = (
    "QuantRecipe", "LayerOverride", "LeafSpec", "exact_override", "quantize",
    "recipe_summary", "search_recipe", "SearchResult", "LayerSensitivity",
    "RungScore", "NestedTensor", "nest_quantize", "nest_quantize_tree",
    "materialize", "set_tree_rung", "critical_nested_bits", "NestQuantStore",
    "RungAssignment", "SwitchLedger", "diverse_ladder_bytes", "RungPolicy",
    "BudgetPolicy", "HysteresisPolicy", "QualityFloorPolicy",
    "LoadAdaptivePolicy", "StaticRungPolicy", "FailureAwarePolicy",
    "ResourceSignal", "DeliveryHealth", "SignalTracker", "POLICIES",
    "make_policy", "simulate_policy", "ServeEngine", "Request", "EngineStats",
    "SpeculativeDecoder", "SpecConfig", "DecodeProfile", "resolve_draft_ok",
    "Scheduler", "SchedulerReport", "ScheduledRequest", "LoadGenerator",
    "ServiceModel", "calibrate_qps", "KVCacheConfig", "NestedKVCache",
    "kv_bytes_per_token", "dense_kv_bytes_per_token", "kv_stream_widths",
    "resolve_kv_decide", "save_artifact", "open_artifact", "load_store",
    "Artifact", "ArtifactError", "DeltaPager", "InMemoryPager", "FilePager",
    "ThrottledPager", "LinkBudget", "PagerError", "TransientPagerError",
    "CorruptStreamError", "ChaosPager", "Outage", "ResilientPager",
    "RetryPolicy", "StreamHealth", "VirtualClock", "WallClock", "ReplicaSpec",
    "ChaosProfile", "Replica", "build_replica", "DeltaDistribution",
    "EdgeClientPager", "FleetController", "BudgetEnvelope", "Fleet",
    "FleetReport", "build_fleet", "ARCHS", "get_config", "make_model",
)
__all__ = list(_API)


def __getattr__(name: str):
    if name in _API:
        return getattr(import_module("repro_torch.api"), name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_API))
