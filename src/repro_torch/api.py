"""The declarative public API of the port; counterpart of
``repro/api.py``, with the same 86 names.

One import gives the whole quantize -> store -> serve surface::

    from repro_torch.api import (QuantRecipe, LayerOverride, quantize,
                                 NestQuantStore, ServeEngine, HysteresisPolicy)

    recipe = QuantRecipe(bits=(8, 4), overrides=(
        LayerOverride(pattern=r"attn", bits=(8, 6, 4)),   # deeper ladder
        LayerOverride(pattern=r"embed", dense=True),       # keep dense
    ))
    nested = quantize(params, recipe)                      # on the card
    store = NestQuantStore(nested, mode="part")
    engine = ServeEngine(cfg, store, policy=HysteresisPolicy(dwell=4))
    engine.generate(requests, memory_budget_bytes=budget)

Everything here is re-exported lazily from the package root (``import
repro_torch; repro_torch.quantize``); submodule imports keep working for
code that wants the internals.  Entry points that place tensors take a
``device`` and default to ``"cuda"``.
"""
from __future__ import annotations

from .configs import ARCHS, get_config
from .core.nesting import (NestedTensor, critical_nested_bits, materialize,
                           nest_quantize, nest_quantize_tree, set_tree_rung)
from .core.recipe import (LayerOverride, LeafSpec, QuantRecipe,
                          exact_override, quantize, recipe_summary)
from .core.search import (LayerSensitivity, RungScore, SearchResult,
                          search_recipe)
from .core.switching import (NestQuantStore, RungAssignment, SwitchLedger,
                             diverse_ladder_bytes)
from .models import make_model
from .serving.engine import (DecodeProfile, EngineStats, Request, ServeEngine,
                             SpecConfig, SpeculativeDecoder)
from .serving.kv_cache import (KVCacheConfig, NestedKVCache,
                               dense_kv_bytes_per_token, kv_bytes_per_token,
                               kv_stream_widths)
from .serving.policies import (POLICIES, BudgetPolicy, DeliveryHealth,
                               FailureAwarePolicy, HysteresisPolicy,
                               LoadAdaptivePolicy, QualityFloorPolicy,
                               ResourceSignal, RungPolicy, SignalTracker,
                               StaticRungPolicy, make_policy,
                               resolve_draft_ok, resolve_kv_decide,
                               simulate_policy)
from .serving.scheduler import (LoadGenerator, ScheduledRequest, Scheduler,
                                SchedulerReport, ServiceModel, calibrate_qps)
from .fleet import (BudgetEnvelope, ChaosProfile, DeltaDistribution,
                    EdgeClientPager, Fleet, FleetController, FleetReport,
                    Replica, ReplicaSpec, build_fleet, build_replica)
from .storage import (Artifact, ArtifactError, ChaosPager, CorruptStreamError,
                      DeltaPager, FilePager, InMemoryPager, LinkBudget, Outage,
                      PagerError, ResilientPager, RetryPolicy, StreamHealth,
                      ThrottledPager, TransientPagerError, VirtualClock,
                      WallClock, load_store, open_artifact, save_artifact)

__all__ = [
    # recipes
    "QuantRecipe", "LayerOverride", "LeafSpec", "exact_override", "quantize",
    "recipe_summary",
    # calibration-driven recipe search (DESIGN.md Sec. 13)
    "search_recipe", "SearchResult", "LayerSensitivity", "RungScore",
    # quantization core
    "NestedTensor", "nest_quantize", "nest_quantize_tree", "materialize",
    "set_tree_rung", "critical_nested_bits",
    # switching store
    "NestQuantStore", "RungAssignment", "SwitchLedger",
    "diverse_ladder_bytes",
    # policies
    "RungPolicy", "BudgetPolicy", "HysteresisPolicy", "QualityFloorPolicy",
    "LoadAdaptivePolicy", "StaticRungPolicy", "FailureAwarePolicy",
    "ResourceSignal", "DeliveryHealth", "SignalTracker", "POLICIES",
    "make_policy", "simulate_policy",
    # serving
    "ServeEngine", "Request", "EngineStats",
    # self-speculative ladder decoding (DESIGN.md Sec. 15)
    "SpeculativeDecoder", "SpecConfig", "DecodeProfile", "resolve_draft_ok",
    # load-adaptive scheduling (DESIGN.md Sec. 11)
    "Scheduler", "SchedulerReport", "ScheduledRequest", "LoadGenerator",
    "ServiceModel", "calibrate_qps",
    # nested KV cache (DESIGN.md Sec. 16)
    "KVCacheConfig", "NestedKVCache", "kv_bytes_per_token",
    "dense_kv_bytes_per_token", "kv_stream_widths", "resolve_kv_decide",
    # storage tier (artifacts + pagers, DESIGN.md Sec. 10)
    "save_artifact", "open_artifact", "load_store", "Artifact",
    "ArtifactError", "DeltaPager", "InMemoryPager", "FilePager",
    "ThrottledPager", "LinkBudget",
    # fault tolerance (DESIGN.md Sec. 12)
    "PagerError", "TransientPagerError", "CorruptStreamError",
    "ChaosPager", "Outage", "ResilientPager", "RetryPolicy", "StreamHealth",
    "VirtualClock", "WallClock",
    # fleet orchestration (DESIGN.md Sec. 14)
    "ReplicaSpec", "ChaosProfile", "Replica", "build_replica",
    "DeltaDistribution", "EdgeClientPager", "FleetController",
    "BudgetEnvelope", "Fleet", "FleetReport", "build_fleet",
    # models/configs
    "ARCHS", "get_config", "make_model",
]
