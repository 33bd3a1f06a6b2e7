"""Serving stack of the port (counterparts of ``repro/serving``)."""
from .engine import EngineStats, Request, ServeEngine
from .kv_cache import (KVCacheConfig, KVPage, NestedKVCache, dense_kv_bytes_per_token,
                       kv_bytes_per_token, kv_stream_widths)
from .policies import (BudgetPolicy, DeliveryHealth, LoadAdaptivePolicy, ResourceSignal,
                       RungPolicy, SignalTracker, StaticRungPolicy, resolve_kv_decide)

__all__ = ["BudgetPolicy", "DeliveryHealth", "EngineStats", "KVCacheConfig", "KVPage",
           "LoadAdaptivePolicy", "NestedKVCache", "Request", "ResourceSignal",
           "RungPolicy", "ServeEngine", "SignalTracker", "StaticRungPolicy",
           "dense_kv_bytes_per_token", "kv_bytes_per_token", "kv_stream_widths",
           "resolve_kv_decide"]
