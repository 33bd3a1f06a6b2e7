"""Rung-selection policies; counterpart of ``repro/serving/policies.py``.

A :class:`RungPolicy` turns a :class:`ResourceSignal` (memory budget,
queue depth, recent switch history) into a per-leaf
:class:`~repro_torch.core.switching.RungAssignment`; the engine (or
:func:`simulate_policy`) applies it and ledgers the page traffic.

* :class:`BudgetPolicy` - the highest uniform rung fitting the budget.
* :class:`HysteresisPolicy` - wraps any policy; within ``dwell`` decisions
  of the last residency change only downgrades pass.
* :class:`QualityFloorPolicy` - wraps any policy; raises leaves whose rung
  would fall below a quality floor (SQNR dB or Pearson correlation against
  the full-bit weight).
* :class:`LoadAdaptivePolicy` - one rung down when the backlog builds, one
  up when it drains (weight and nested KV cache rungs).
* :class:`StaticRungPolicy` - one rung forever.
* :class:`FailureAwarePolicy` - wraps any policy; never upgrades above the
  pager's deliverable rung, and holds upgrades for a cooldown after a
  delivery failure.
"""
from __future__ import annotations

import math
import warnings
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import torch

from ..core.quantizer import sqnr_db
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

    def draft_ok(self, signal: ResourceSignal) -> bool:
        """Whether a batch may draft speculatively: drafts spend extra
        dispatches per emitted token, which pays only on a drained queue;
        a deep or aging backlog wants plain batched decode."""
        return not self._pressured(signal) and signal.queue_depth <= self.low_depth


class HysteresisPolicy:
    """Dwell-window wrapper: after any residency change, upgrades are held
    for ``dwell`` further decisions while downgrades pass at once (a
    shrinking budget is a hard constraint; a recovering one can wait)."""

    def __init__(self, inner: Optional[RungPolicy] = None, dwell: int = 4):
        if dwell < 0:
            raise ValueError(f"dwell must be >= 0, got {dwell}")
        self.inner = inner if inner is not None else BudgetPolicy()
        self.dwell = dwell

    def decide(self, store: NestQuantStore,
               signal: ResourceSignal) -> RungAssignment:
        want = self.inner.decide(store, signal)
        cur = store.leaf_rungs()
        tgt = store.resolve_assignment(want)
        if tgt == cur:
            return want
        in_dwell = (signal.recent_switches
                    and signal.step - signal.recent_switches[-1] < self.dwell)
        if not in_dwell:
            return want
        held = {p: min(tgt[p], cur[p]) for p in cur}   # downgrades only
        return RungAssignment(default=store.rung, exact=tuple(held.items()))


def _pearson(x: torch.Tensor, y: torch.Tensor) -> float:
    """``core.similarity.pearson`` in float64 on the tensors' device."""
    x, y = x.double().reshape(-1), y.double().reshape(-1)
    xc, yc = x - x.mean(), y - y.mean()
    denom = math.sqrt(float((xc * xc).sum()) * float((yc * yc).sum()))
    return float((xc * yc).sum() / denom) if denom else 0.0


class QualityFloorPolicy:
    """Quality-floor wrapper: leaves whose rung would fall below the floor
    are raised to their lowest acceptable rung, whatever the inner policy
    asked for.

    ``metric='sqnr'`` floors the per-leaf SQNR in dB of the rung weight
    against the full-bit weight; ``'pearson'`` floors their Pearson
    correlation.  A leaf no rung of which meets the floor is pinned to its
    top rung.  The proxies are computed on the store's device, from
    :meth:`~repro_torch.core.switching.NestQuantStore.hydrated_leaves`
    (paged-out streams fetched transiently), once per store on the first
    decision, and cached; :meth:`floor_rungs` warms the cache up front."""

    METRICS = ("sqnr", "pearson")

    def __init__(self, inner: Optional[RungPolicy] = None,
                 floor: float = 20.0, metric: str = "sqnr"):
        if metric not in self.METRICS:
            raise ValueError(f"metric {metric!r} not in {self.METRICS}")
        self.inner = inner if inner is not None else BudgetPolicy()
        self.floor = floor
        self.metric = metric
        # id(store) -> (weakref guard, quality map, floor map); the guard
        # detects a recycled id, dead entries are swept on a miss
        self._cache: Dict[int, tuple] = {}

    def _entry(self, store: NestQuantStore) -> tuple:
        hit = self._cache.get(id(store))
        if hit is not None and hit[0]() is store:
            return hit
        self._cache = {k: v for k, v in self._cache.items() if v[0]() is not None}
        qual: Dict[str, Tuple[float, ...]] = {}
        for path, leaf in store.hydrated_leaves():
            full = leaf.full_bit(torch.float32)
            scores = []
            for r in range(leaf.num_rungs - 1):
                w = leaf.rung_weight(r, torch.float32)
                scores.append(float(sqnr_db(full, w)) if self.metric == "sqnr"
                              else _pearson(full, w))
            scores.append(float("inf") if self.metric == "sqnr" else 1.0)
            qual[path] = tuple(scores)
        floors = {path: next((r for r, q in enumerate(scores) if q >= self.floor),
                             len(scores) - 1)
                  for path, scores in qual.items()}
        entry = (weakref.ref(store), qual, floors)
        self._cache[id(store)] = entry
        return entry

    def leaf_quality(self, store: NestQuantStore) -> Dict[str, Tuple[float, ...]]:
        """Per-leaf quality proxy at every rung (the top rung is exact:
        +inf SQNR / 1.0 correlation)."""
        return self._entry(store)[1]

    def floor_rungs(self, store: NestQuantStore) -> Dict[str, int]:
        """Lowest acceptable rung per leaf (its top when even that misses)."""
        return self._entry(store)[2]

    def decide(self, store: NestQuantStore,
               signal: ResourceSignal) -> RungAssignment:
        want = self.inner.decide(store, signal)
        # floors are judged against the FULL ladder: while an artifact is
        # still being delivered, pass the inner decision through
        if store.max_available_rung() < store.num_rungs - 1:
            return want
        floors = self.floor_rungs(store)
        tgt = store.resolve_assignment(want)
        raised = {p: max(r, floors[p]) for p, r in tgt.items()}
        if raised == tgt:
            return want
        return RungAssignment(default=want.default, exact=tuple(raised.items()))


class FailureAwarePolicy:
    """Never upgrade into a link that is failing.  Two clamps on top of any
    inner policy; downgrades pass untouched (shedding needs no fetch):

    * availability - upgrade targets are capped at the pager's deliverable
      ceiling (``delivery_health.available_rung``, else
      ``store.max_available_rung()``); leaves already resident above it
      are held, not shed;
    * cooldown - after a delivery failure, upgrades hold for ``cooldown``
      further decisions, then re-probe one inner-policy step at a time."""

    def __init__(self, inner: Optional[RungPolicy] = None, cooldown: int = 8):
        if cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {cooldown}")
        self.inner = inner if inner is not None else LoadAdaptivePolicy()
        self.cooldown = cooldown

    def decide(self, store: NestQuantStore,
               signal: ResourceSignal) -> RungAssignment:
        want = self.inner.decide(store, signal)
        dh = signal.delivery_health
        cur = store.leaf_rungs()
        tgt = store.resolve_assignment(want)
        avail = (dh.available_rung if dh.available_rung is not None
                 else store.max_available_rung())
        in_cooldown = (dh.last_failure_step is not None
                       and signal.step - dh.last_failure_step < self.cooldown)
        out = {}
        for p, r in tgt.items():
            if r > cur[p]:                     # upgrade: clamp to health
                r = cur[p] if in_cooldown else min(r, max(avail, cur[p]))
            out[p] = r
        if out == tgt:
            return want
        return RungAssignment(default=store.rung, exact=tuple(out.items()))


def resolve_draft_ok(policy, signal: ResourceSignal) -> Optional[bool]:
    """The drafting verdict of the first policy in a wrapper chain
    (``.inner`` links, outside-in) that has a ``draft_ok``; None when none
    does (the Scheduler then drafts only on an empty backlog)."""
    seen = set()
    while policy is not None and id(policy) not in seen:
        seen.add(id(policy))
        fn = getattr(policy, "draft_ok", None)
        if callable(fn):
            return bool(fn(signal))
        policy = getattr(policy, "inner", None)
    return None


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


POLICIES = {"budget": BudgetPolicy, "hysteresis": HysteresisPolicy,
            "quality": QualityFloorPolicy, "load": LoadAdaptivePolicy,
            "static": StaticRungPolicy, "failure": FailureAwarePolicy}


def make_policy(name: str, **kwargs) -> RungPolicy:
    """CLI-facing factory: 'budget' | 'hysteresis' | 'quality' | 'load' |
    'static' | 'failure'."""
    if name not in POLICIES:
        raise ValueError(f"unknown policy {name!r}; pick from {sorted(POLICIES)}")
    return POLICIES[name](**kwargs)


def simulate_policy(policy: RungPolicy, store: NestQuantStore,
                    budgets: Sequence[Optional[int]]) -> Dict[str, object]:
    """Drive ``policy`` over a budget trace WITHOUT decoding (deprecated, as
    in the JAX package: a traffic-shaped run belongs to the
    :class:`~repro_torch.serving.scheduler.Scheduler`).  Returns
    {'switches', 'page_in', 'page_out', 'modes'}, 'switches' counting the
    decisions that moved residency."""
    warnings.warn(
        "simulate_policy is deprecated: use serving.scheduler.Scheduler "
        "for traffic-driven runs, or drive store.apply(policy.decide(...))"
        " directly for budget traces (removal: two minor releases after "
        "0.8)", DeprecationWarning, stacklevel=2)
    tracker = SignalTracker()
    in0, out0 = store.ledger.page_in_bytes, store.ledger.page_out_bytes
    switches = 0
    modes: List[str] = []
    for budget in budgets:
        report = store.apply(policy.decide(store, tracker.signal(
            memory_budget_bytes=budget)))
        moved = report["moves"] > 0
        switches += int(moved)
        tracker.note(moved)
        modes.append(store.mode)
    return {"switches": switches,
            "page_in": store.ledger.page_in_bytes - in0,
            "page_out": store.ledger.page_out_bytes - out0,
            "modes": modes}
