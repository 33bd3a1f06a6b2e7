"""Serving stack of the port (counterparts of ``repro/serving``)."""
from .engine import (DecodeProfile, EngineStats, Request, ServeEngine, SpecConfig,
                     SpeculativeDecoder)
from .kv_cache import (KVCacheConfig, KVPage, NestedKVCache, dense_kv_bytes_per_token,
                       kv_bytes_per_token, kv_stream_widths)
from .policies import (POLICIES, BudgetPolicy, DeliveryHealth, FailureAwarePolicy,
                       HysteresisPolicy, LoadAdaptivePolicy, QualityFloorPolicy,
                       ResourceSignal, RungPolicy, SignalTracker, StaticRungPolicy,
                       make_policy, resolve_draft_ok, resolve_kv_decide, simulate_policy)
from .scheduler import (TRACES, Arrival, LoadGenerator, RequestQueue, ScheduledRequest,
                        Scheduler, SchedulerReport, ServiceModel, calibrate_qps)

__all__ = ["POLICIES", "TRACES", "Arrival", "BudgetPolicy", "DecodeProfile",
           "DeliveryHealth", "EngineStats", "FailureAwarePolicy", "HysteresisPolicy",
           "KVCacheConfig", "KVPage", "LoadAdaptivePolicy", "LoadGenerator",
           "NestedKVCache", "QualityFloorPolicy", "Request", "RequestQueue",
           "ResourceSignal", "RungPolicy", "ScheduledRequest", "Scheduler",
           "SchedulerReport", "ServeEngine", "ServiceModel", "SignalTracker",
           "SpecConfig", "SpeculativeDecoder", "StaticRungPolicy", "calibrate_qps",
           "dense_kv_bytes_per_token", "kv_bytes_per_token", "kv_stream_widths",
           "make_policy", "resolve_draft_ok", "resolve_kv_decide", "simulate_policy"]
