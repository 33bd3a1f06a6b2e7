"""Replica specs and wiring, one simulated device per spec; counterpart of
``repro/fleet/replica.py``.

A :class:`ReplicaSpec` is what makes one fleet member differ from the
next: its budget envelope, last-mile link speed, the traffic trace it
serves, its policy stack and, optionally, a :class:`ChaosProfile` of how
unreliable its delta link is.  :func:`build_replica` turns a spec into a
live :class:`Replica`: its own
:class:`~repro_torch.core.switching.NestQuantStore` over the shared nested
tree, its own pager chain ending at the fleet's
:class:`~repro_torch.fleet.distribution.DeltaDistribution`, its own
:class:`~repro_torch.serving.engine.ServeEngine` (every replica shares one
:class:`~repro_torch.models.model.Model`) and its own
:class:`~repro_torch.serving.scheduler.Scheduler` on the shared
:class:`~repro_torch.storage.pager.VirtualClock`.

The pager chain per replica is::

    EdgeClientPager -> [ChaosPager ->] [ResilientPager ->] store

so chaos and retry are per device while dedup and multicast accounting is
fleet-wide.  The last-mile link is charged where the scheduler already
charges byte movement: the replica's
:class:`~repro_torch.serving.scheduler.ServiceModel` gets ``page_gbps``
from ``link_mbps``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import torch

from ..core.switching import NestQuantStore
from ..device import resolve_device
from ..serving.engine import ServeEngine
from ..serving.policies import FailureAwarePolicy, HysteresisPolicy, make_policy
from ..serving.scheduler import LoadGenerator, Scheduler, ServiceModel, calibrate_qps
from ..storage.pager import ChaosPager, ResilientPager, RetryPolicy
from .distribution import DeltaDistribution


@dataclass(frozen=True)
class ChaosProfile:
    """Per-replica fault injection on the delta link.  ``seed`` is mixed
    with the replica index by the callers, so a storm on a subset of the
    replicas stays deterministic."""
    seed: int = 0
    p_transient: float = 0.2
    p_corrupt: float = 0.05
    p_stall: float = 0.05
    stall_s: float = 2e-4
    retry_attempts: int = 4
    backoff_base_s: float = 1e-4
    quarantine_s: float = 2e-3


@dataclass(frozen=True)
class ReplicaSpec:
    """One fleet member.  ``budget_bytes`` is its initial memory envelope
    (None = unconstrained; a
    :class:`~repro_torch.fleet.controller.FleetController` rewrites it at
    every tick); ``link_mbps`` its last-mile delta link; ``qps=None`` lets
    the builder calibrate the rate to the replica's own capacity."""
    name: str
    budget_bytes: Optional[int] = None
    link_mbps: float = 100.0
    trace: str = "poisson"
    qps: Optional[float] = None
    n_requests: int = 16
    seed: int = 0
    policy: str = "load"
    max_batch: int = 4
    new_tokens: int = 2
    chaos: Optional[ChaosProfile] = None

    def __post_init__(self):
        if self.link_mbps <= 0:
            raise ValueError(f"link_mbps must be > 0, got {self.link_mbps}")
        if self.n_requests <= 0:
            raise ValueError(f"n_requests must be > 0, got {self.n_requests}")


@dataclass
class Replica:
    """A live fleet member: its spec and the stack :func:`build_replica`
    wired."""
    spec: ReplicaSpec
    store: NestQuantStore
    engine: ServeEngine
    scheduler: Scheduler
    service: ServiceModel
    chaos: Optional[ChaosPager] = None
    resilient: Optional[ResilientPager] = None
    envelope_log: list = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.spec.name

    def set_envelope(self, budget_bytes: Optional[int], now: float) -> None:
        """Point the local policy at a new memory envelope: the next
        decision sees it."""
        self.scheduler.memory_budget_bytes = budget_bytes
        self.envelope_log.append((now, budget_bytes))


def build_policy(name: str, *, max_batch: int = 4, dwell: int = 2,
                 quality_floor: float = 20.0):
    """The serve CLI's policy composition, shared by the fleet builder:
    'load' wraps LoadAdaptivePolicy in hysteresis; 'failure' wraps that
    stack in FailureAwarePolicy."""
    if name == "failure":
        inner = HysteresisPolicy(make_policy("load", high_depth=max_batch), dwell=dwell)
        return FailureAwarePolicy(inner)
    kw = ({"dwell": dwell} if name == "hysteresis" else
          {"floor": quality_floor} if name == "quality" else
          {"high_depth": max_batch} if name == "load" else {})
    pol = make_policy(name, **kw)
    if name == "load":
        pol = HysteresisPolicy(pol, dwell=dwell)
    return pol


def build_replica(spec: ReplicaSpec, *, cfg, nested_params,
                  distribution: DeltaDistribution, clock, vocab_size: int,
                  model=None, service: Optional[ServiceModel] = None,
                  device=None, dtype=None) -> Replica:
    """Wire one replica onto the shared tree and distribution tier.

    ``nested_params`` is the fleet's one nested tree: each store takes its
    own leaf list over it (no store changes another's residency, and none
    changes the tree).  ``model`` is the fleet's one shared model;
    ``device`` defaults to the card, ``dtype`` (the store's dense dtype) to
    f32."""
    dtype = dtype if dtype is not None else torch.float32
    pager = distribution.client(spec.name)
    chaos = resilient = None
    if spec.chaos is not None:
        c = spec.chaos
        chaos = ChaosPager(pager, seed=c.seed, p_transient=c.p_transient,
                           p_corrupt=c.p_corrupt, p_stall=c.p_stall, stall_s=c.stall_s,
                           clock=clock)
        resilient = ResilientPager(
            chaos, RetryPolicy(max_attempts=c.retry_attempts,
                               backoff_base_s=c.backoff_base_s,
                               quarantine_s=c.quarantine_s),
            seed=c.seed + 1, clock=clock)
        pager = resilient
    store = NestQuantStore(nested_params, mode="part", pager=pager,
                           device=resolve_device(device), dtype=dtype)
    engine = ServeEngine(cfg, store, max_batch=spec.max_batch, max_len=64,
                         policy=build_policy(spec.policy, max_batch=spec.max_batch),
                         model=model)
    # the last-mile link: page_gbps from link_mbps (1 Mbit/s = 125e3 B/s)
    base = service if service is not None else ServiceModel()
    svc = replace(base, page_gbps=spec.link_mbps * 125e3 / 1e9)
    qps = spec.qps if spec.qps is not None else calibrate_qps(
        store, svc, steps=spec.new_tokens, max_batch=spec.max_batch, utilization=0.4)
    trace = LoadGenerator(spec.trace, qps=qps, n_requests=spec.n_requests,
                          vocab_size=vocab_size, seed=spec.seed, new_tokens=spec.new_tokens)
    sched = Scheduler(engine, trace, svc, max_batch=spec.max_batch,
                      memory_budget_bytes=spec.budget_bytes, clock=clock)
    return Replica(spec=spec, store=store, engine=engine, scheduler=sched,
                   service=svc, chaos=chaos, resilient=resilient)
