"""Rung-selection policies; the part of ``repro/serving/policies.py`` the
serving path needs: :class:`ResourceSignal`, :class:`DeliveryHealth`, the
:class:`RungPolicy` protocol, :class:`BudgetPolicy` and
:class:`SignalTracker`.

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
               quarantined: int = 0) -> ResourceSignal:
        health = DeliveryHealth(
            failures=self.delivery_failures,
            consecutive_failures=self.consecutive_failures,
            last_failure_step=self.last_failure_step,
            quarantined=quarantined, available_rung=available_rung)
        return ResourceSignal(memory_budget_bytes=memory_budget_bytes,
                              queue_depth=queue_depth, step=self.step,
                              recent_switches=tuple(self.switch_steps),
                              backlog_age_s=backlog_age_s,
                              delivery_health=health)

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
