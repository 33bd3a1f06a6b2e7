"""Serving stack of the port (counterparts of ``repro/serving``)."""
from .engine import EngineStats, Request, ServeEngine
from .kv_cache import (KVCacheConfig, KVPage, NestedKVCache, dense_kv_bytes_per_token,
                       kv_bytes_per_token, kv_stream_widths)
from .policies import (POLICIES, BudgetPolicy, DeliveryHealth, HysteresisPolicy,
                       LoadAdaptivePolicy, QualityFloorPolicy, ResourceSignal, RungPolicy,
                       SignalTracker, StaticRungPolicy, make_policy, resolve_kv_decide,
                       simulate_policy)
from .scheduler import (TRACES, Arrival, LoadGenerator, RequestQueue, ScheduledRequest,
                        Scheduler, SchedulerReport, ServiceModel, calibrate_qps)

__all__ = ["POLICIES", "TRACES", "Arrival", "BudgetPolicy", "DeliveryHealth",
           "EngineStats", "HysteresisPolicy", "KVCacheConfig", "KVPage",
           "LoadAdaptivePolicy", "LoadGenerator", "NestedKVCache", "QualityFloorPolicy",
           "Request", "RequestQueue", "ResourceSignal", "RungPolicy", "ScheduledRequest",
           "Scheduler", "SchedulerReport", "ServeEngine", "ServiceModel", "SignalTracker",
           "StaticRungPolicy", "calibrate_qps", "dense_kv_bytes_per_token",
           "kv_bytes_per_token", "kv_stream_widths", "make_policy", "resolve_kv_decide",
           "simulate_policy"]
