"""Rung-selection policies; the part of ``repro/serving/policies.py`` the
serving path needs: :class:`ResourceSignal` (with the nested KV cache's
fields), :class:`DeliveryHealth`, the :class:`RungPolicy` protocol,
:class:`BudgetPolicy`, :class:`StaticRungPolicy`,
:class:`LoadAdaptivePolicy` (weight and KV rungs), :func:`resolve_kv_decide`
and :class:`SignalTracker`.

A policy turns a resource signal (device-memory budget, queue depth,
recent switch history) into a per-leaf
:class:`~repro_torch.core.switching.RungAssignment`; the engine applies it.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional, Protocol, Tuple, runtime_checkable

from ..core.switching import NestQuantStore, RungAssignment


@dataclass(frozen=True)
class DeliveryHealth:
    """How delta delivery has been behaving: failed switch attempts, the
    streak since the last committed move, and the pager's deliverable
    ceiling at decision time."""
    failures: int = 0
    consecutive_failures: int = 0
    last_failure_step: Optional[int] = None
    quarantined: int = 0
    available_rung: Optional[int] = None

    @property
    def healthy(self) -> bool:
        return self.consecutive_failures == 0 and self.quarantined == 0


@dataclass(frozen=True)
class ResourceSignal:
    """What the serving environment looks like at one decision point."""
    memory_budget_bytes: Optional[int] = None
    queue_depth: int = 0
    step: int = 0
    recent_switches: Tuple[int, ...] = ()
    backlog_age_s: float = 0.0
    delivery_health: DeliveryHealth = DeliveryHealth()
    # nested KV cache residency; the defaults mean "no nested cache"
    kv_rung: int = -1
    kv_num_rungs: int = 0
    kv_resident_bytes: int = 0


@runtime_checkable
class RungPolicy(Protocol):
    def decide(self, store: NestQuantStore,
               signal: ResourceSignal) -> RungAssignment:
        """Pick the target residency. Must not mutate the store."""
        ...


class BudgetPolicy:
    """The highest uniform rung fitting the memory budget (rung 0 is the
    floor - the base stream is always resident)."""

    def decide(self, store: NestQuantStore,
               signal: ResourceSignal) -> RungAssignment:
        return RungAssignment.uniform(store.best_rung_for(signal.memory_budget_bytes))


class StaticRungPolicy:
    """Pin one uniform rung forever (the fixed operating point the
    load-adaptive runs compare against)."""

    def __init__(self, rung: object = -1):
        self.rung = rung

    def decide(self, store: NestQuantStore,
               signal: ResourceSignal) -> RungAssignment:
        return RungAssignment.uniform(self.rung)


class LoadAdaptivePolicy:
    """Traffic pressure: one rung DOWN when the backlog builds
    (``queue_depth >= high_depth``, or a backlog older than ``max_age_s``),
    one rung back UP when it drains (``queue_depth <= low_depth``), hold
    in between.  Weight targets are capped by ``best_rung_for`` the
    budget; ``kv_decide`` moves the nested KV cache's rung the same way."""

    def __init__(self, high_depth: int = 8, low_depth: int = 0,
                 max_age_s: Optional[float] = None):
        if low_depth < 0 or high_depth <= low_depth:
            raise ValueError(f"need high_depth > low_depth >= 0, got "
                             f"high={high_depth} low={low_depth}")
        self.high_depth = high_depth
        self.low_depth = low_depth
        self.max_age_s = max_age_s

    def _pressured(self, signal: ResourceSignal) -> bool:
        return (signal.queue_depth >= self.high_depth
                or (self.max_age_s is not None
                    and signal.backlog_age_s >= self.max_age_s))

    def decide(self, store: NestQuantStore,
               signal: ResourceSignal) -> RungAssignment:
        cap = store.best_rung_for(signal.memory_budget_bytes)
        cur = min(store.rung, cap)      # store.rung = floor when mixed
        if self._pressured(signal):
            return RungAssignment.uniform(max(cur - 1, 0))
        if signal.queue_depth <= self.low_depth:
            return RungAssignment.uniform(min(cur + 1, cap))
        return RungAssignment.uniform(cur)

    def kv_decide(self, kv, signal: ResourceSignal) -> int:
        """The cache rung under the same pressure: one down when
        pressured, one up when drained.  ``kv`` is the read-only
        :class:`~repro_torch.serving.kv_cache.NestedKVCache`; the engine
        clamps the target to what the pager can deliver."""
        cur = kv.rung
        if self._pressured(signal):
            return max(cur - 1, 0)
        if signal.queue_depth <= self.low_depth:
            return min(cur + 1, kv.config.num_rungs - 1)
        return cur


def resolve_kv_decide(policy, kv, signal: ResourceSignal) -> Optional[int]:
    """The cache-rung verdict of the first policy in a wrapper chain
    (``.inner`` links, outside-in) that has a ``kv_decide``; None when
    none does (the engine then leaves the cache rung alone)."""
    seen = set()
    while policy is not None and id(policy) not in seen:
        seen.add(id(policy))
        fn = getattr(policy, "kv_decide", None)
        if callable(fn):
            return int(fn(kv, signal))
        policy = getattr(policy, "inner", None)
    return None


class SignalTracker:
    """Builds :class:`ResourceSignal`s with a monotone step counter, the
    recent-switch history and the delivery-failure record."""

    def __init__(self, history: int = 16):
        self.step = 0
        self.switch_steps: deque = deque(maxlen=history)
        self.delivery_failures = 0
        self.consecutive_failures = 0
        self.last_failure_step: Optional[int] = None

    def signal(self, memory_budget_bytes: Optional[int] = None,
               queue_depth: int = 0, backlog_age_s: float = 0.0,
               available_rung: Optional[int] = None,
               quarantined: int = 0, kv_rung: int = -1,
               kv_num_rungs: int = 0,
               kv_resident_bytes: int = 0) -> ResourceSignal:
        health = DeliveryHealth(
            failures=self.delivery_failures,
            consecutive_failures=self.consecutive_failures,
            last_failure_step=self.last_failure_step,
            quarantined=quarantined, available_rung=available_rung)
        return ResourceSignal(memory_budget_bytes=memory_budget_bytes,
                              queue_depth=queue_depth, step=self.step,
                              recent_switches=tuple(self.switch_steps),
                              backlog_age_s=backlog_age_s,
                              delivery_health=health, kv_rung=kv_rung,
                              kv_num_rungs=kv_num_rungs,
                              kv_resident_bytes=kv_resident_bytes)

    def note(self, moved: bool, failed: bool = False):
        """Advance one decision; only a COMMITTED move clears the
        consecutive-failure streak."""
        if failed:
            self.delivery_failures += 1
            self.consecutive_failures += 1
            self.last_failure_step = self.step
        elif moved:
            self.consecutive_failures = 0
            self.switch_steps.append(self.step)
        self.step += 1
