"""Load-adaptive serving: an admission-controlled continuous-batching
scheduler that drives rung switching (and speculative drafting) from real
traffic; counterpart of ``repro/serving/scheduler.py``.

A seeded :class:`LoadGenerator` produces an open-loop arrival trace on a
VIRTUAL clock, a :class:`RequestQueue` holds the backlog, and each
scheduler step runs

    admit -> signal -> decide -> page -> generate

admitting up to ``max_batch`` requests, reporting the leftover backlog
(depth, oldest-wait age) to the engine's policy, letting the store page
exactly the delta streams the decision moves, then decoding the batch for
real through ``engine.generate``.  Time is virtual: a deterministic
:class:`ServiceModel` charges each batch for streaming the resident rung's
weights and each switch for its ledgered page traffic, so latencies,
throughput and rung occupancy depend only on the trace and the store's
byte accounting - the same numbers as the JAX package's for the same
seeds and tree, on any device - while the tokens are decoded for real.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .engine import Request, ServeEngine, SpecConfig
from .policies import ResourceSignal, resolve_draft_ok

TRACES = ("poisson", "burst", "diurnal")


# ---------------------------------------------------------------------------
# open-loop arrival traces
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Arrival:
    """One request due to arrive at virtual time ``t``."""
    uid: int
    t: float
    prompt: np.ndarray
    max_new_tokens: int


class LoadGenerator:
    """Seeded open-loop arrival traces on the virtual clock: a Poisson
    process whose rate follows the trace shape (``poisson`` steady at
    ``qps``, ``burst`` at ``burst_qps`` for the middle ``burst_window``
    fraction of the requests, ``diurnal`` through one low-high-low cycle).
    The numpy draws are the JAX package's, so the same seed gives the same
    arrivals and prompts."""

    def __init__(self, kind: str = "poisson", *, qps: float, n_requests: int,
                 vocab_size: int, seed: int = 0, prompt_len: int = 6,
                 new_tokens: int = 2, burst_qps: Optional[float] = None,
                 burst_window: Tuple[float, float] = (1 / 3, 2 / 3),
                 diurnal_floor: float = 0.2):
        if kind not in TRACES:
            raise ValueError(f"unknown trace {kind!r}; pick from {TRACES}")
        if qps <= 0 or n_requests <= 0:
            raise ValueError(f"need qps > 0 and n_requests > 0, got "
                             f"qps={qps} n_requests={n_requests}")
        if not 0 <= burst_window[0] < burst_window[1] <= 1:
            raise ValueError(f"burst_window must be an ascending fraction "
                             f"pair in [0, 1], got {burst_window}")
        self.kind = kind
        self.qps = qps
        self.n_requests = n_requests
        self.vocab_size = vocab_size
        self.seed = seed
        self.prompt_len = prompt_len
        self.new_tokens = new_tokens
        self.burst_qps = burst_qps if burst_qps is not None else 4.0 * qps
        self.burst_window = burst_window
        self.diurnal_floor = diurnal_floor

    def rate_at(self, frac: float) -> float:
        """Arrival rate (requests/s of virtual time) at trace fraction
        ``frac`` in [0, 1]."""
        if self.kind == "burst":
            lo, hi = self.burst_window
            return self.burst_qps if lo <= frac < hi else self.qps
        if self.kind == "diurnal":
            f = self.diurnal_floor
            return self.qps * (f + (1 - f) * 0.5 * (1 - math.cos(2 * math.pi * frac)))
        return self.qps

    def arrivals(self) -> List[Arrival]:
        rng = np.random.default_rng(self.seed)
        t = 0.0
        out: List[Arrival] = []
        for i in range(self.n_requests):
            t += float(rng.exponential(1.0 / self.rate_at(i / self.n_requests)))
            prompt = rng.integers(0, self.vocab_size,
                                  size=self.prompt_len).astype(np.int32)
            out.append(Arrival(uid=i, t=t, prompt=prompt,
                               max_new_tokens=self.new_tokens))
        return out


# ---------------------------------------------------------------------------
# request queue
# ---------------------------------------------------------------------------
@dataclass
class ScheduledRequest:
    """A request's life on the virtual clock: arrive -> admit -> done;
    ``queue_s + service_s == done_s - arrival_s``."""
    request: Request
    arrival_s: float
    admit_s: float = -1.0
    done_s: float = -1.0
    rung: int = -1                # rung it was served at
    mode: str = ""

    @property
    def queue_s(self) -> float:
        return self.admit_s - self.arrival_s

    @property
    def service_s(self) -> float:
        return self.done_s - self.admit_s

    @property
    def total_s(self) -> float:
        return self.done_s - self.arrival_s


class RequestQueue:
    """FIFO backlog of arrived-but-unserved requests."""

    def __init__(self):
        self._pending: deque = deque()

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, sreq: ScheduledRequest):
        self._pending.append(sreq)

    def oldest_arrival_s(self) -> float:
        if not self._pending:
            raise IndexError("queue is empty")
        return self._pending[0].arrival_s

    def oldest_age_s(self, now: float) -> float:
        """How long the head of the queue has been waiting (0 if empty)."""
        return now - self._pending[0].arrival_s if self._pending else 0.0

    def admit(self, now: float, max_batch: int) -> List[ScheduledRequest]:
        """Pop up to ``max_batch`` requests FIFO, stamping admit time."""
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        batch = []
        while self._pending and len(batch) < max_batch:
            sreq = self._pending.popleft()
            sreq.admit_s = now
            batch.append(sreq)
        return batch


# ---------------------------------------------------------------------------
# virtual service-time model
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ServiceModel:
    """Deterministic virtual-clock costs.  Decode is memory-bandwidth
    bound: one decode step streams the resident rung's weight bytes once,
    whatever the batch size, so batching raises throughput and a lower
    rung serves faster.  A switch charges per-move latency plus its
    ledgered page traffic over the paging link.  These are model
    parameters, not measurements of any device."""
    weight_gbps: float = 1.0          # weight-streaming bandwidth
    page_gbps: float = 0.5            # delta page-in/out link
    batch_overhead_s: float = 5e-5    # per-batch fixed cost
    switch_latency_s: float = 1e-4    # per ledger move fixed cost

    def batch_seconds(self, resident_bytes: int, steps: int,
                      kv_bytes: int = 0) -> float:
        """Virtual seconds to serve one batch of ``steps`` decode steps with
        ``resident_bytes`` of weights resident; ``kv_bytes`` is the batch's
        KV-cache bytes, re-streamed every step by a kv-aware scheduler."""
        return (self.batch_overhead_s
                + steps * (resident_bytes + kv_bytes) / (self.weight_gbps * 1e9))

    def switch_seconds(self, page_bytes: int, moves: int) -> float:
        """Virtual seconds a residency change stalls the engine for."""
        if moves == 0:
            return 0.0
        return moves * self.switch_latency_s + page_bytes / (self.page_gbps * 1e9)

    def speculative_seconds(self, profile) -> float:
        """Virtual seconds of one speculatively decoded batch from the
        engine's :class:`~repro_torch.serving.engine.DecodeProfile` of what
        was dispatched: each draft step streams the draft rung's resident
        bytes, each verify pass (and each plain step) the full residency
        once.  No acceptance rate is assumed: a rejected round costs its
        drafts."""
        return (self.batch_overhead_s
                + (profile.draft_steps * profile.draft_bytes
                   + profile.verify_passes * profile.verify_bytes
                   + profile.steps * profile.verify_bytes)
                / (self.weight_gbps * 1e9))

    def capacity_rps(self, resident_bytes: int, steps: int,
                     max_batch: int) -> float:
        """Saturation throughput (requests/s) at full batches."""
        return max_batch / self.batch_seconds(resident_bytes, steps)


def calibrate_qps(store, service: ServiceModel, *, steps: int,
                  max_batch: int, rung: Optional[int] = None,
                  utilization: float = 0.6) -> float:
    """Arrival rate that loads rung ``rung`` (default: top) to
    ``utilization`` of its saturation throughput."""
    r = store.num_rungs - 1 if rung is None else rung
    return utilization * service.capacity_rps(
        store.rung_resident_bytes(r), steps, max_batch)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------
@dataclass
class SchedulerReport:
    """Everything one scheduler run observed (all times virtual seconds).

    ``switch_records`` holds one entry per DECISION that moved residency:
    from/to rung, ledger moves, observed page bytes, and the expected bytes
    recomputed from the per-leaf stream metadata (observed must equal
    expected).  ``kv_switch_records`` is the same over the nested KV
    cache's ledger."""
    requests: List[ScheduledRequest]
    steps: List[Dict[str, object]]
    switch_records: List[Dict[str, int]]
    elapsed_s: float
    trace_kind: str
    kv_switch_records: List[Dict[str, int]] = dc_field(default_factory=list)

    def latency(self, kind: str = "total") -> Dict[str, float]:
        """p50/p95/mean/max of 'queue' | 'service' | 'total' latency."""
        vals = np.array([getattr(r, f"{kind}_s") for r in self.requests])
        if vals.size == 0:
            return {"p50": 0.0, "p95": 0.0, "mean": 0.0, "max": 0.0}
        return {"p50": float(np.percentile(vals, 50)),
                "p95": float(np.percentile(vals, 95)),
                "mean": float(vals.mean()), "max": float(vals.max())}

    def rung_occupancy(self, weight: str = "requests") -> Dict[str, float]:
        """Fraction of serving at each mode, by requests served or by
        virtual busy time (``weight='time'``)."""
        if weight == "requests":
            counts: Dict[str, float] = {}
            for r in self.requests:
                counts[r.mode] = counts.get(r.mode, 0) + 1
            total = float(len(self.requests))
        elif weight == "time":
            counts = {}
            for s in self.steps:
                dt = s["switch_s"] + s["batch_s"]
                counts[s["mode"]] = counts.get(s["mode"], 0.0) + dt
            total = sum(counts.values())
        else:
            raise ValueError(f"weight must be 'requests' or 'time', "
                             f"got {weight!r}")
        return {m: c / max(total, 1e-12) for m, c in sorted(counts.items())}

    def mean_rung(self, weight: str = "requests") -> float:
        """Average rung served (same ``weight`` as :meth:`rung_occupancy`)."""
        if not self.requests:
            return 0.0
        if weight == "requests":
            return sum(r.rung for r in self.requests) / len(self.requests)
        if weight != "time":
            raise ValueError(f"weight must be 'requests' or 'time', "
                             f"got {weight!r}")
        num = sum(s["rung"] * (s["switch_s"] + s["batch_s"]) for s in self.steps)
        den = sum(s["switch_s"] + s["batch_s"] for s in self.steps)
        return num / max(den, 1e-12)

    @property
    def throughput_rps(self) -> float:
        return len(self.requests) / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def page_in_bytes(self) -> int:
        return sum(rec["page_in"] for rec in self.switch_records)

    @property
    def page_out_bytes(self) -> int:
        return sum(rec["page_out"] for rec in self.switch_records)

    @property
    def switch_failures(self) -> int:
        """Switch attempts that failed and rolled back during the run."""
        return sum(int(s.get("switch_failures", 0)) for s in self.steps)

    @property
    def fault_s(self) -> float:
        """Virtual seconds the fetch path spent in stalls and backoff (0.0
        unless the run was coupled to a pager clock)."""
        return sum(float(s.get("fault_s", 0.0)) for s in self.steps)

    @property
    def spec_steps(self) -> int:
        """Batches served speculatively (the rest took plain decode)."""
        return sum(1 for s in self.steps if s.get("speculative"))

    @property
    def spec_drafted(self) -> int:
        return sum(int(s.get("spec_drafted", 0)) for s in self.steps)

    @property
    def spec_accepted(self) -> int:
        return sum(int(s.get("spec_accepted", 0)) for s in self.steps)

    @property
    def spec_acceptance(self) -> float:
        d = self.spec_drafted
        return self.spec_accepted / d if d else 0.0

    def summary(self) -> Dict[str, object]:
        lat = self.latency("total")
        return {"trace": self.trace_kind, "requests": len(self.requests),
                "elapsed_s": self.elapsed_s,
                "throughput_rps": self.throughput_rps,
                "p50_ms": lat["p50"] * 1e3, "p95_ms": lat["p95"] * 1e3,
                "queue_p95_ms": self.latency("queue")["p95"] * 1e3,
                "mean_rung": self.mean_rung(),
                "mean_rung_time": self.mean_rung("time"),
                "rung_occupancy": self.rung_occupancy(),
                "switches": len(self.switch_records),
                "switch_moves": sum(int(r["moves"]) for r in self.switch_records),
                "page_in_mb": self.page_in_bytes / 1e6,
                "page_out_mb": self.page_out_bytes / 1e6,
                "switch_failures": self.switch_failures,
                "fault_s": self.fault_s,
                "spec_steps": self.spec_steps,
                "spec_drafted": self.spec_drafted,
                "spec_accepted": self.spec_accepted,
                "spec_acceptance": self.spec_acceptance}

    def table(self) -> str:
        """The p95 / rung-occupancy table, print-ready."""
        s = self.summary()
        occ = " ".join(f"{m}={f:.0%}" for m, f in s["rung_occupancy"].items())
        return (f"{s['requests']} reqs in {s['elapsed_s']:.2f}s virtual "
                f"({s['throughput_rps']:.0f} req/s) | "
                f"p50={s['p50_ms']:.1f}ms p95={s['p95_ms']:.1f}ms | "
                f"mean rung={s['mean_rung']:.2f} [{occ}] | "
                f"{s['switches']} switch decisions, "
                f"in={s['page_in_mb']:.2f}MB out={s['page_out_mb']:.2f}MB")


class Scheduler:
    """Admission-controlled continuous batching over a
    :class:`~repro_torch.serving.engine.ServeEngine`.

    Each step: ingest every arrival up to ``now`` (plus a bounded
    ``admit_wait_s`` coalescing window), admit up to ``max_batch``
    requests, report the LEFTOVER backlog and the optional memory budget
    to the engine, whose policy decides the rung once for the batch, and
    decode for real.  The virtual clock advances by the modeled switch and
    service time.

    ``bucket_batches`` pads partial batches to ``max_batch`` with
    throwaway clones of the last admitted request, so every batch has the
    shape ``ServeEngine.warmup`` ran (fillers are counted in
    ``stats.sched_filler``, never returned, and cost nothing on the virtual
    clock).  ``clock`` couples the virtual time to a pager's clock: each
    step sets it to ``now`` and charges what the fetch path slept back as
    ``fault_s``.  ``speculate`` (an int ``k`` or a
    :class:`~repro_torch.serving.engine.SpecConfig`) arms drafting: a batch
    drafts when the policy chain's ``draft_ok`` says so for its backlog (no
    policy with one: when the backlog is empty), and is charged what it
    dispatched.  ``kv_aware`` caps admission by the nested KV cache's
    bytes per sequence beside the weight residency and charges every
    decode step the batch's cache bytes."""

    def __init__(self, engine: ServeEngine, trace: LoadGenerator,
                 service: Optional[ServiceModel] = None,
                 max_batch: Optional[int] = None,
                 admit_wait_s: float = 0.01,
                 memory_budget_bytes: Optional[int] = None,
                 bucket_batches: bool = True, clock=None,
                 speculate=None, kv_aware: bool = False):
        if max_batch is None:
            max_batch = engine.max_batch
        if max_batch > engine.max_batch:
            raise ValueError(
                f"scheduler max_batch={max_batch} over-admits: the engine "
                f"only serves batches of {engine.max_batch}")
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        if admit_wait_s < 0:
            raise ValueError(f"admit_wait_s must be >= 0, got {admit_wait_s}")
        self.engine = engine
        self.trace = trace
        self.service = service if service is not None else ServiceModel()
        self.max_batch = max_batch
        self.admit_wait_s = admit_wait_s
        self.memory_budget_bytes = memory_budget_bytes
        self.bucket_batches = bucket_batches
        self.clock = clock
        if speculate is not None and not isinstance(speculate, SpecConfig):
            speculate = SpecConfig(k=int(speculate))
        self.speculate = speculate
        self.kv_aware = kv_aware
        self._started = False

    # -- resumable stepper -------------------------------------------------
    def start(self) -> None:
        """Reset the stepper: materialize the arrival trace, empty the
        queue, rewind the per-run virtual clock to 0."""
        # per-leaf stream sizes: every scheduled switch is checked against
        # the metadata-computed bytes, whatever mix of leaves it moved
        self._streams = self.engine.store.leaf_streams()
        self._arrivals = self.trace.arrivals()
        self._queue = RequestQueue()
        self._done: List[ScheduledRequest] = []
        self._steps: List[Dict[str, object]] = []
        self._switch_records: List[Dict[str, int]] = []
        self._kv_switch_records: List[Dict[str, int]] = []
        self._i = 0
        self._now = 0.0
        self._started = True

    @property
    def done(self) -> bool:
        """True once every arrival has been ingested AND served."""
        if not self._started:
            return False
        return self._i >= len(self._arrivals) and not len(self._queue)

    @property
    def now(self) -> float:
        """This scheduler's virtual time (seconds since its trace began)."""
        return self._now if self._started else 0.0

    @property
    def backlog_depth(self) -> int:
        """Requests waiting at ``now`` (ingested + due-but-uningested)."""
        if not self._started:
            return 0
        due = 0
        j = self._i
        while j < len(self._arrivals) and self._arrivals[j].t <= self._now:
            due += 1
            j += 1
        return len(self._queue) + due

    def next_time(self) -> Optional[float]:
        """Virtual time the next step() would begin at, or None when done."""
        if not self._started or self.done:
            return None
        if len(self._queue):
            return self._now
        return max(self._now, self._arrivals[self._i].t)

    def _ingest(self, a: Arrival) -> None:
        self._queue.push(ScheduledRequest(
            Request(a.uid, a.prompt, a.max_new_tokens), a.t))
        self._i += 1

    def step(self) -> Dict[str, object]:
        """Run ONE admit -> signal -> decide -> page -> generate batch and
        return its step record.  Requires start(); raises when done."""
        if not self._started:
            raise RuntimeError("call start() before step()")
        if self.done:
            raise RuntimeError("scheduler trace is exhausted")
        eng, store = self.engine, self.engine.store
        arrivals, queue, streams = self._arrivals, self._queue, self._streams
        now = self._now
        # -- admit ----------------------------------------------------------
        if not len(queue):
            now = max(now, arrivals[self._i].t)  # idle: jump to next arrival
        while self._i < len(arrivals) and arrivals[self._i].t <= now:
            self._ingest(arrivals[self._i])
        # coalesce: wait (bounded by the oldest waiter's patience) for
        # arrivals that would fill this batch
        while (len(queue) < self.max_batch and self._i < len(arrivals)
               and arrivals[self._i].t <= queue.oldest_arrival_s() + self.admit_wait_s):
            now = arrivals[self._i].t
            self._ingest(arrivals[self._i])
        admit_cap = self.max_batch
        if self.kv_aware:
            admit_cap = min(admit_cap, eng.kv_admissible_batch(self.memory_budget_bytes))
        batch = queue.admit(now, admit_cap)
        # -- signal ---------------------------------------------------------
        depth = len(queue)                   # backlog BEHIND this batch
        age = queue.oldest_age_s(now)
        reqs = [s.request for s in batch]
        n_filler = 0
        if self.bucket_batches and len(reqs) < self.max_batch:
            n_filler = self.max_batch - len(reqs)
            tpl = batch[-1]
            reqs = reqs + [Request(-1, tpl.request.prompt, tpl.request.max_new_tokens)
                           for _ in range(n_filler)]
        # -- decide + page + generate --------------------------------------
        ev0 = len(store.ledger.events)
        kv_ev0 = len(eng.kv.ledger.events) if eng.kv is not None else 0
        rungs_before = store.leaf_rungs()
        rung_before = store.rung
        failures0 = eng.stats.switch_failures
        fault_s = 0.0
        t0 = now
        if self.clock is not None:
            self.clock.set(now)
            t0 = self.clock.now()       # set() is monotone: may run ahead of now
        avail_rung = store.max_available_rung()
        # drafting on or off: the policy chain's verdict on this backlog
        spec = None
        if self.speculate is not None:
            ok = resolve_draft_ok(eng.policy, ResourceSignal(queue_depth=depth,
                                                             backlog_age_s=age))
            if ok if ok is not None else depth == 0:
                spec = self.speculate
        eng.generate(reqs, self.memory_budget_bytes, queue_depth=depth,
                     backlog_age_s=age, speculate=spec)
        profile = eng.last_profile
        speculative = bool(spec is not None and profile is not None and profile.speculative)
        if self.clock is not None:
            fault_s = self.clock.now() - t0
        failed = eng.stats.switch_failures - failures0
        moved = store.ledger.events[ev0:]
        page_in = sum(e[2] for e in moved)
        page_out = sum(e[3] for e in moved)
        if moved:
            # expected traffic of THIS decision from the per-leaf rung walk:
            # every page-in/out is a contiguous run of delta streams
            expect_in = expect_out = 0
            for path, r1 in store.leaf_rungs().items():
                r0 = rungs_before[path]
                if r1 > r0:
                    expect_in += sum(streams[path][1 + r0:1 + r1])
                elif r0 > r1:
                    expect_out += sum(streams[path][1 + r1:1 + r0])
            self._switch_records.append(
                {"step": len(self._steps), "from_rung": rung_before,
                 "to_rung": store.rung, "moves": len(moved),
                 "page_in": page_in, "page_out": page_out,
                 "expected_in": expect_in, "expected_out": expect_out})
        # nested KV cache rung moves this step: observed (ledger) beside the
        # metadata-computed bytes (expected_events)
        kv_page_in = kv_page_out = 0
        kv_moves = 0
        if eng.kv is not None:
            kv_moved = eng.kv.ledger.events[kv_ev0:]
            kv_moves = len(kv_moved)
            for (f, t, pin, pout), (_, _, ein, eout) in zip(
                    kv_moved, eng.kv.expected_events[kv_ev0:]):
                kv_page_in += pin
                kv_page_out += pout
                self._kv_switch_records.append(
                    {"step": len(self._steps), "from_rung": f,
                     "to_rung": t, "moves": 1,
                     "page_in": pin, "page_out": pout,
                     "expected_in": ein, "expected_out": eout})
        # -- advance the virtual clock -------------------------------------
        switch_s = self.service.switch_seconds(page_in + page_out, len(moved)) + fault_s
        if self.kv_aware:
            switch_s += self.service.switch_seconds(kv_page_in + kv_page_out, kv_moves)
        kv_bytes = eng.kv_bytes_per_seq() * len(batch) if self.kv_aware else 0
        if speculative:
            batch_s = self.service.speculative_seconds(profile)
        else:
            batch_s = self.service.batch_seconds(
                store.resident_bytes(), max(s.request.max_new_tokens for s in batch),
                kv_bytes=kv_bytes)
        now += switch_s + batch_s
        for s in batch:
            s.done_s = now
            s.rung = store.rung
            s.mode = store.mode
        self._done.extend(batch)
        eng.stats.sched_steps += 1
        eng.stats.sched_admitted += len(batch)
        eng.stats.sched_filler += n_filler
        rec = {"step": len(self._steps), "admit_s": batch[0].admit_s,
               "done_s": now, "batch": len(batch), "admit_cap": admit_cap,
               "kv_rung": eng.kv.rung if eng.kv is not None else -1,
               "filler": n_filler, "queue_depth": depth,
               "backlog_age_s": age, "mode": store.mode,
               "rung": store.rung, "page_in": page_in,
               "page_out": page_out, "switch_s": switch_s,
               "batch_s": batch_s, "fault_s": fault_s,
               "switch_failures": failed,
               "avail_rung": avail_rung, "clock_s": t0,
               "speculative": speculative,
               "spec_drafted": profile.drafted if speculative else 0,
               "spec_accepted": profile.accepted if speculative else 0,
               "spec_rounds": profile.verify_passes if speculative else 0}
        self._steps.append(rec)
        self._now = now
        return rec

    def report(self) -> SchedulerReport:
        """The run so far as a :class:`SchedulerReport` (complete once
        :attr:`done`)."""
        if not self._started:
            raise RuntimeError("call start() (or run()) before report()")
        return SchedulerReport(requests=self._done, steps=self._steps,
                               switch_records=self._switch_records,
                               elapsed_s=self._now, trace_kind=self.trace.kind,
                               kv_switch_records=self._kv_switch_records)

    def run(self) -> SchedulerReport:
        self.start()
        while not self.done:
            self.step()
        return self.report()
