"""Serving stack of the port (counterparts of ``repro/serving``)."""
from .engine import EngineStats, Request, ServeEngine
from .policies import BudgetPolicy, DeliveryHealth, ResourceSignal, RungPolicy, SignalTracker

__all__ = ["BudgetPolicy", "DeliveryHealth", "EngineStats", "Request",
           "ResourceSignal", "RungPolicy", "ServeEngine", "SignalTracker"]
