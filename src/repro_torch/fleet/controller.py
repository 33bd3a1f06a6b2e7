"""Fleet controller: global envelopes over local policies, plus the fleet
event loop and report; counterpart of ``repro/fleet/controller.py``.

Policy composes in two tiers.  The global tier, a :class:`FleetController`,
owns one fleet-wide memory budget and splits it into per-replica
envelopes, rebalanced by observed backlog: a replica whose queue is
burning is pinned to its base rung (its envelope shrinks to
``rung_resident_bytes(0)``), while cold replicas share the freed budget.
The local tier is untouched: each replica's policy keeps reacting to its
own queue within the envelope.  The contract is one value wide: the
controller writes ``scheduler.memory_budget_bytes``; the next local
decision reads it.  Neither tier bypasses the store's two-phase switch, so
every envelope change still pages exactly ``bytes(delta_k)``.

:class:`Fleet` interleaves N resumable
:class:`~repro_torch.serving.scheduler.Scheduler` steppers on one shared
:class:`~repro_torch.storage.pager.VirtualClock`: a heap keyed on each
replica's ``next_time()`` (ties broken by replica index) always runs the
earliest pending batch, so shared-clock state (chaos outages, multicast
windows, the WAN uplink) is seen in one deterministic global order.
Replicas run one after another on the caller's stream, as the
reference's event loop runs them.  Same seeds and specs give the same
:class:`FleetReport`.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.switching import diverse_ladder_bytes
from ..device import resolve_device
from ..models.model import make_model
from ..serving.scheduler import SchedulerReport, ServiceModel
from ..storage.pager import InMemoryPager, LinkBudget, VirtualClock
from .distribution import DeltaDistribution
from .replica import Replica, ReplicaSpec, build_replica

CONTROLLER_MODES = ("rebalance", "equal")


@dataclass(frozen=True)
class BudgetEnvelope:
    """One controller decision for one replica at one tick."""
    replica: str
    budget_bytes: Optional[int]
    reason: str = "equal"             # 'equal' | 'pinned-hot' | 'surplus'


class FleetController:
    """Split one fleet-wide memory budget into per-replica envelopes.

    ``mode='equal'``: ``total / N`` for every replica, forever.
    ``mode='rebalance'``: every ``interval_s`` of fleet virtual time,
    replicas whose backlog is at least ``hot_depth`` are pinned to their
    base rung's bytes and the others share the surplus equally (never
    below base-rung bytes)."""

    def __init__(self, total_budget_bytes: int, *, interval_s: float = 0.25,
                 mode: str = "rebalance", hot_depth: int = 4):
        if mode not in CONTROLLER_MODES:
            raise ValueError(f"mode {mode!r} not in {CONTROLLER_MODES}")
        if total_budget_bytes <= 0:
            raise ValueError("total_budget_bytes must be > 0")
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.total_budget_bytes = int(total_budget_bytes)
        self.interval_s = float(interval_s)
        self.mode = mode
        self.hot_depth = hot_depth
        self.ticks = 0

    def envelopes(self, replicas: Sequence[Replica]) -> List[BudgetEnvelope]:
        n = len(replicas)
        equal = self.total_budget_bytes // n
        if self.mode == "equal":
            return [BudgetEnvelope(r.name, equal) for r in replicas]
        hot = [r for r in replicas
               if not r.scheduler.done and r.scheduler.backlog_depth >= self.hot_depth]
        if not hot or len(hot) == n:
            # nobody (or everybody) is burning: nothing to shift between
            return [BudgetEnvelope(r.name, equal) for r in replicas]
        hot_names = {r.name for r in hot}
        pinned = {r.name: r.store.rung_resident_bytes(0) for r in hot}
        share = (self.total_budget_bytes - sum(pinned.values())) // (n - len(hot))
        out = []
        for r in replicas:
            if r.name in hot_names:
                out.append(BudgetEnvelope(r.name, pinned[r.name], "pinned-hot"))
            else:
                floor = r.store.rung_resident_bytes(0)
                out.append(BudgetEnvelope(r.name, max(share, floor), "surplus"))
        return out

    def apply(self, replicas: Sequence[Replica], now: float) -> List[BudgetEnvelope]:
        envs = self.envelopes(replicas)
        for env, rep in zip(envs, replicas):
            rep.set_envelope(env.budget_bytes, now)
        self.ticks += 1
        return envs


# ---------------------------------------------------------------------------
# the fleet report
# ---------------------------------------------------------------------------
@dataclass
class FleetReport:
    """Everything one fleet run observed: per-replica
    :class:`SchedulerReport`s, the distribution tier's byte accounting
    (``transport``) and the model-zoo baseline at equal served quality
    (``zoo``: every observed rung switch downloads the whole packed model
    of the target bitwidth over both hops)."""
    replicas: Dict[str, SchedulerReport]
    transport: Dict[str, object]
    zoo: Dict[str, object]
    envelopes: Dict[str, List[Tuple[float, Optional[int]]]]
    elapsed_s: float
    controller_mode: str = "none"

    @property
    def fleet_bytes(self) -> int:
        return int(self.transport["fleet_bytes"])

    @property
    def unicast_bytes(self) -> int:
        return int(self.transport["unicast_bytes"])

    @property
    def zoo_bytes(self) -> int:
        return int(self.zoo["zoo_bytes"])

    def pooled_latency(self, kind: str = "total") -> Dict[str, float]:
        """p50/p95/mean/max over every request the fleet served."""
        vals = np.array([getattr(r, f"{kind}_s") for rep in self.replicas.values()
                         for r in rep.requests])
        if vals.size == 0:
            return {"p50": 0.0, "p95": 0.0, "mean": 0.0, "max": 0.0}
        return {"p50": float(np.percentile(vals, 50)),
                "p95": float(np.percentile(vals, 95)),
                "mean": float(vals.mean()), "max": float(vals.max())}

    def verify_ledgers(self) -> int:
        """Raise ``AssertionError`` unless every switch of every replica
        observed exactly the metadata-computed ``bytes(delta_k)``; returns
        the records checked."""
        checked = 0
        for name, rep in self.replicas.items():
            for rec in rep.switch_records:
                for kind in ("in", "out"):
                    if rec[f"page_{kind}"] != rec[f"expected_{kind}"]:
                        raise AssertionError(
                            f"{name} step {rec['step']}: observed page_{kind} "
                            f"{rec[f'page_{kind}']} != computed {rec[f'expected_{kind}']}")
                checked += 1
        return checked

    def to_dict(self) -> Dict[str, object]:
        """The run as one JSON-able dict, identical across runs with the
        same seeds and specs."""
        return {
            "controller_mode": self.controller_mode,
            "elapsed_s": self.elapsed_s,
            "transport": dict(self.transport),
            "zoo": {"bits": list(self.zoo["bits"]), "models": list(self.zoo["models"]),
                    "zoo_bytes": self.zoo["zoo_bytes"], "downloads": self.zoo["downloads"]},
            "pooled": {k: self.pooled_latency(k) for k in ("queue", "service", "total")},
            "envelopes": {n: list(log) for n, log in self.envelopes.items()},
            "replicas": {
                name: {"summary": rep.summary(),
                       "switch_records": list(rep.switch_records),
                       "rung_occupancy": rep.rung_occupancy()}
                for name, rep in self.replicas.items()},
        }

    def summary(self) -> Dict[str, object]:
        lat = self.pooled_latency("total")
        return {"replicas": len(self.replicas),
                "requests": sum(len(r.requests) for r in self.replicas.values()),
                "elapsed_s": self.elapsed_s,
                "p50_ms": lat["p50"] * 1e3, "p95_ms": lat["p95"] * 1e3,
                "fleet_MB": self.fleet_bytes / 1e6,
                "unicast_MB": self.unicast_bytes / 1e6,
                "zoo_MB": self.zoo_bytes / 1e6,
                "dedup_hits": self.transport["dedup_hits"],
                "multicast_joins": self.transport["multicast_joins"],
                "switches": sum(len(r.switch_records) for r in self.replicas.values()),
                "controller_mode": self.controller_mode}

    def table(self) -> str:
        s = self.summary()
        return (f"{s['replicas']} replicas, {s['requests']} reqs in "
                f"{s['elapsed_s']:.2f}s virtual | pooled "
                f"p50={s['p50_ms']:.1f}ms p95={s['p95_ms']:.1f}ms | "
                f"wire: fleet={s['fleet_MB']:.2f}MB "
                f"unicast={s['unicast_MB']:.2f}MB zoo={s['zoo_MB']:.2f}MB "
                f"(dedup={s['dedup_hits']}, mcast={s['multicast_joins']}) | "
                f"{s['switches']} switches, controller={s['controller_mode']}")


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------
class Fleet:
    """N replicas, one distribution tier and optionally one controller,
    interleaved on one shared virtual clock."""

    def __init__(self, replicas: Sequence[Replica], distribution: DeltaDistribution,
                 clock: VirtualClock, controller: Optional[FleetController] = None):
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        self.replicas = list(replicas)
        self.distribution = distribution
        self.clock = clock
        self.controller = controller

    def _zoo_baseline(self) -> Dict[str, object]:
        """Model-zoo transmission at equal served quality: every observed
        rung switch downloads the whole target-bitwidth model over both
        hops, per replica."""
        store = self.replicas[0].store
        ladder = diverse_ladder_bytes(
            store.nested_params,
            sorted({b for bits in store.leaf_bits().values() for b in bits}))
        models = ladder["models"]
        downloads = total = 0
        for rep in self.replicas:
            for rec in rep.scheduler.report().switch_records:
                if rec["to_rung"] != rec["from_rung"]:
                    total += 2 * models[min(rec["to_rung"], len(models) - 1)]
                    downloads += 1
        return {"bits": ladder["bits"], "models": models, "zoo_bytes": total,
                "downloads": downloads}

    def run(self) -> FleetReport:
        for rep in self.replicas:
            rep.scheduler.start()
        if self.controller is not None:
            self.controller.apply(self.replicas, 0.0)   # tick 0: every replica enveloped
        heap: List[Tuple[float, int]] = []
        for i, rep in enumerate(self.replicas):
            t = rep.scheduler.next_time()
            if t is not None:
                heapq.heappush(heap, (t, i))
        next_tick = self.controller.interval_s if self.controller is not None else float("inf")
        while heap:
            t, i = heapq.heappop(heap)
            while t >= next_tick:
                self.controller.apply(self.replicas, next_tick)
                next_tick += self.controller.interval_s
            rep = self.replicas[i]
            rep.scheduler.step()
            nt = rep.scheduler.next_time()
            if nt is not None:
                heapq.heappush(heap, (nt, i))
        reports = {rep.name: rep.scheduler.report() for rep in self.replicas}
        return FleetReport(
            replicas=reports, transport=self.distribution.stats(),
            zoo=self._zoo_baseline(),
            envelopes={rep.name: list(rep.envelope_log) for rep in self.replicas},
            elapsed_s=max((r.elapsed_s for r in reports.values()), default=0.0),
            controller_mode=self.controller.mode if self.controller is not None else "none")


def build_fleet(specs: Sequence[ReplicaSpec], *, cfg, nested_params,
                controller: Optional[FleetController] = None,
                multicast_window_s: float = 0.05, uplink: Optional[LinkBudget] = None,
                service: Optional[ServiceModel] = None, device=None,
                dtype=None) -> Fleet:
    """Wire a whole fleet onto one shared nested tree on ``device``
    (default: the card): the origin holds pinned host copies of its delta
    streams, and every replica shares one model."""
    device = resolve_device(device)
    clock = VirtualClock()
    origin = InMemoryPager.from_tree(nested_params)
    dist = DeltaDistribution(origin, clock=clock, multicast_window_s=multicast_window_s,
                             uplink=uplink)
    model = make_model(cfg, device=device)
    replicas = [build_replica(spec, cfg=cfg, nested_params=nested_params, distribution=dist,
                              clock=clock, vocab_size=cfg.vocab_size, model=model,
                              service=service, device=device, dtype=dtype)
                for spec in specs]
    return Fleet(replicas, dist, clock, controller=controller)
