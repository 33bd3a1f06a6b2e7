"""Delta pagers; counterpart of ``repro/storage/pager.py``.

A pager owns the NON-RESIDENT delta streams of one nested model: the
store calls ``fetch(path, level)`` on upgrade (the returned words, on the
store's device, are spliced into the serving tree) and ``evict(path,
level)`` on downgrade, and its ledger records the bytes observed to move,
asserted equal to the metadata-computed ``bytes(delta_k)``.

* :class:`InMemoryPager` - every stream held in host memory (the default
  for a store built from an in-memory tree).
* :class:`FilePager` - streams read on demand from a saved artifact
  (``storage/artifact.py``), CRC-checked per array.  A delta segment that
  is not on disk yet is simply not available: progressive delivery
  (``ServeEngine.poll_delivery``) upgrades as segments arrive.
* :class:`ThrottledPager` - wraps any pager with a simulated link
  (bandwidth + latency) on an injectable clock (:class:`VirtualClock`,
  :class:`WallClock`); a :class:`LinkBudget` shares one link between
  pagers.
* :class:`ChaosPager` - seeded fault injection over any pager (transient
  failures, one flipped bit, stalls, :class:`Outage` windows).
* :class:`ResilientPager` - the hardened fetch path: retries with seeded
  backoff, CRC-32 re-verification, per-attempt timeouts and quarantine
  (:class:`RetryPolicy`, per-stream :class:`StreamHealth`).
"""
from __future__ import annotations

import re
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from .. import tree
from ..device import resolve_device
from .artifact import ArtifactError


class PagerError(RuntimeError):
    """A delta stream could not be delivered."""


class TransientPagerError(PagerError):
    """Retryable delivery fault: the same fetch may succeed on retry."""


class CorruptStreamError(PagerError, ArtifactError):
    """The fetched bytes do not match their recorded CRC-32.  Also an
    :class:`~repro_torch.storage.artifact.ArtifactError`, as the JAX
    package's is, so callers catching that see it too."""


class VirtualClock:
    """Deterministic clock: ``now()`` reads, ``sleep()`` advances
    instantly, ``set()`` jumps forward (never backward); calling the clock
    is ``now()``.  :class:`WallClock` is the real-time drop-in."""

    def __init__(self, start_s: float = 0.0):
        self._now = float(start_s)
        self.slept_s = 0.0

    def now(self) -> float:
        return self._now

    __call__ = now

    def sleep(self, dt: float) -> None:
        dt = max(float(dt), 0.0)
        self._now += dt
        self.slept_s += dt

    def set(self, t: float) -> None:
        """Jump to absolute time ``t`` (monotone: never moves backward)."""
        self._now = max(self._now, float(t))


class WallClock:
    """Real time with the VirtualClock interface (``time.monotonic`` +
    ``time.sleep``)."""

    def __init__(self):
        self.slept_s = 0.0

    def now(self) -> float:
        return time.monotonic()

    __call__ = now

    def sleep(self, dt: float) -> None:
        dt = max(float(dt), 0.0)
        self.slept_s += dt
        if dt:
            time.sleep(dt)

    def set(self, t: float) -> None:
        pass                        # real time cannot be jumped


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@runtime_checkable
class DeltaPager(Protocol):
    """Owner of the non-resident delta streams of one nested model.
    ``path`` is a leaf's keystr, ``level`` the delta index (level k
    upgrades rung k to rung k+1)."""

    def fetch(self, path: str, level: int) -> torch.Tensor:
        """The packed int32 words of one delta stream, on the store's device."""
        ...

    def evict(self, path: str, level: int) -> None:
        """The store dropped its device copy of a fetched stream."""
        ...

    def resident_bytes(self) -> int:
        """Bytes the pager itself holds in host memory."""
        ...

    def available(self, path: str, level: int) -> bool:
        """Whether ``fetch(path, level)`` would succeed right now."""
        ...

    # Pagers MAY also provide ``expected_crc(path, level) -> Optional[int]``,
    # the CRC-32 the stream's packed bytes should hash to; it is not part of
    # the required protocol.


class InMemoryPager:
    """Every delta stream held in host memory; ``fetch`` copies to
    ``device`` (for a CPU store the very same tensor comes back)."""

    def __init__(self, streams: Optional[Dict[Tuple[str, int], torch.Tensor]] = None,
                 device="cpu"):
        self.device = torch.device(device)
        self._streams: Dict[Tuple[str, int], torch.Tensor] = dict(streams or {})
        self._crc: Dict[Tuple[str, int], int] = {}

    @classmethod
    def from_tree(cls, nested_params) -> "InMemoryPager":
        """Harvest a host copy of every present delta stream of a nested
        tree; fetches go back to the device the tree lives on.  Host
        copies of device streams are pinned so fetches copy at full rate."""
        from ..core.nesting import NestedTensor

        streams, device = {}, torch.device("cpu")
        for key, leaf in tree.flatten_with_path(nested_params):
            if not isinstance(leaf, NestedTensor):
                continue
            device = leaf.device
            for i, d in enumerate(leaf.deltas):
                if d is not None:
                    host = d.to("cpu")
                    streams[(key, i)] = host.pin_memory() if d.is_cuda else host
        return cls(streams, device=device)

    def fetch(self, path: str, level: int) -> torch.Tensor:
        try:
            host = self._streams[(path, level)]
        except KeyError:
            raise KeyError(f"no delta stream (level {level}) for {path!r} in "
                           "the in-memory pager") from None
        return host.to(self.device)

    def put(self, path: str, level: int, words: torch.Tensor) -> None:
        """Register a stream produced at run time (reference
        ``InMemoryPager.put``): the nested KV cache deposits each page's
        delta streams here, so later rung upgrades fetch them through the
        same protocol as weight deltas.  A device stream is kept as a
        pinned host copy, and fetches go back to its device."""
        if words.is_cuda:
            self.device = words.device
            words = words.to("cpu").pin_memory()
        self._streams[(path, level)] = words
        self._crc.pop((path, level), None)

    def discard(self, path: str, level: int) -> None:
        """Forget a stream entirely (page retirement; unlike ``evict``,
        which keeps the copy for a later fetch)."""
        self._streams.pop((path, level), None)
        self._crc.pop((path, level), None)

    def evict(self, path: str, level: int) -> None:
        pass                        # the host copy stays for later fetches

    def resident_bytes(self) -> int:
        return sum(_nbytes(a) for a in self._streams.values())

    def available(self, path: str, level: int) -> bool:
        return (path, level) in self._streams

    def expected_crc(self, path: str, level: int) -> Optional[int]:
        """CRC-32 of the host copy (computed once, cached)."""
        key = (path, level)
        if key not in self._streams:
            return None
        if key not in self._crc:
            words = self._streams[key].contiguous()
            self._crc[key] = zlib.crc32(words.reshape(-1).view(torch.uint8).numpy())
        return self._crc[key]


class FilePager:
    """Delta streams read on demand from a saved artifact directory.

    Each ``fetch`` reads exactly one array's byte range from its delta
    segment file (CRC-checked) into page-locked host memory when
    ``device`` is the card, and copies it there; a stacked (L, rows, N)
    leaf is one array, fetched whole.  ``resident_bytes`` counts the
    streams fetched and not yet evicted.  A segment file that does not
    exist yet is not available."""

    def __init__(self, artifact, verify: bool = True, device=None):
        from .artifact import Artifact, open_artifact
        self.artifact: Artifact = (artifact if isinstance(artifact, Artifact)
                                   else open_artifact(artifact))
        self.verify = verify
        self.device = resolve_device(device)
        self._resident: Dict[Tuple[str, int], int] = {}
        self._landed: set = set()       # segments seen on disk (they stay)

    def _spec(self, path: str, level: int) -> dict:
        entry = self.artifact.leaf(path)
        deltas = entry["arrays"].get("deltas", ())
        if not 0 <= level < len(deltas):
            raise KeyError(f"{path!r} has no delta level {level} "
                           f"({len(deltas)} streams in the artifact)")
        return deltas[level]

    def fetch(self, path: str, level: int) -> torch.Tensor:
        spec = self._spec(path, level)
        try:
            words = self.artifact.read_array(spec, verify=self.verify, device=self.device)
        except CorruptStreamError as e:
            # the artifact layer knows the byte range, this one whose stream
            raise CorruptStreamError(
                f"delta stream corrupted: leaf {path!r} level {level}: "
                f"{e}") from e
        self._resident[(path, level)] = spec["nbytes"]
        return words

    def expected_crc(self, path: str, level: int) -> Optional[int]:
        """The manifest's recorded CRC-32 for one delta stream."""
        try:
            return int(self._spec(path, level)["crc32"])
        except KeyError:
            return None

    def evict(self, path: str, level: int) -> None:
        self._resident.pop((path, level), None)

    def resident_bytes(self) -> int:
        return sum(self._resident.values())

    def available(self, path: str, level: int) -> bool:
        try:
            spec = self._spec(path, level)
        except KeyError:
            return False
        # availability is a property of the segment, and segments never
        # un-arrive: cache positives so a probe of every leaf stats once
        seg = spec["segment"]
        if seg in self._landed:
            return True
        if self.artifact.segment_available(seg):
            self._landed.add(seg)
            return True
        return False


class LinkBudget:
    """ONE physical link shared by any number of pagers: transfers
    serialize, each starting at ``max(now, busy_until)``.

    ``reserve(nbytes, now)`` books one transfer and returns ``(start_s,
    finish_s, total_s)``, ``total_s = finish_s - now`` being what the
    caller experienced (queueing + latency + transfer).  Aggregates:
    :attr:`bytes_moved`, :attr:`busy_s` (seconds the wire carried bits),
    :attr:`queued_s` (seconds callers waited behind other transfers)."""

    def __init__(self, bandwidth_bytes_per_s: float = 12.5e6,
                 latency_s: float = 0.0):
        if bandwidth_bytes_per_s <= 0:
            raise ValueError("bandwidth must be > 0")
        self.bandwidth_bytes_per_s = float(bandwidth_bytes_per_s)
        self.latency_s = float(latency_s)
        self.busy_until = 0.0
        self.bytes_moved = 0
        self.busy_s = 0.0
        self.queued_s = 0.0
        self.transfers = 0

    def reserve(self, nbytes: int, now: float) -> Tuple[float, float, float]:
        start = max(float(now), self.busy_until)
        hold = self.latency_s + nbytes / self.bandwidth_bytes_per_s
        finish = start + hold
        self.busy_until = finish
        self.bytes_moved += int(nbytes)
        self.busy_s += hold
        self.queued_s += start - float(now)
        self.transfers += 1
        return start, finish, finish - float(now)


class ThrottledPager:
    """Simulated-link wrapper: every fetch pays ``latency_s`` plus
    ``nbytes / bandwidth_bytes_per_s`` of simulated transfer time, recorded
    in :attr:`transfers` / :attr:`simulated_seconds` (and slept on the
    injected ``clock`` when ``sleep=True``).  Evictions are free.

    ``clock`` defaults to a :class:`WallClock`; a :class:`VirtualClock`
    makes the schedule deterministic.  ``link`` shares one
    :class:`LinkBudget` between pagers, so their fetches queue on one wire;
    without it every fetch is charged its standalone hold."""

    def __init__(self, inner: DeltaPager,
                 bandwidth_bytes_per_s: float = 12.5e6,   # 100 Mbit/s
                 latency_s: float = 0.0, sleep: bool = False, clock=None,
                 link: Optional[LinkBudget] = None):
        if link is not None:
            bandwidth_bytes_per_s = link.bandwidth_bytes_per_s
            latency_s = link.latency_s
        elif bandwidth_bytes_per_s <= 0:
            raise ValueError("bandwidth must be > 0")
        self.link = link
        self.inner = inner
        self.bandwidth_bytes_per_s = float(bandwidth_bytes_per_s)
        self.latency_s = float(latency_s)
        self.sleep = sleep
        self.clock = clock if clock is not None else WallClock()
        self.bytes_moved = 0
        self.simulated_seconds = 0.0
        # (path, level, nbytes, seconds) per fetch, arrival order
        self.transfers: List[Tuple[str, int, int, float]] = []

    def fetch(self, path: str, level: int) -> torch.Tensor:
        words = self.inner.fetch(path, level)
        nb = _nbytes(words)
        if self.link is not None:
            _, _, dt = self.link.reserve(nb, self.clock.now())
        else:
            dt = self.latency_s + nb / self.bandwidth_bytes_per_s
        self.bytes_moved += nb
        self.simulated_seconds += dt
        self.transfers.append((path, level, nb, dt))
        if self.sleep:
            self.clock.sleep(dt)
        return words

    def evict(self, path: str, level: int) -> None:
        self.inner.evict(path, level)

    def resident_bytes(self) -> int:
        return self.inner.resident_bytes()

    def available(self, path: str, level: int) -> bool:
        return self.inner.available(path, level)

    def expected_crc(self, path: str, level: int) -> Optional[int]:
        fn = getattr(self.inner, "expected_crc", None)
        return fn(path, level) if fn is not None else None


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Outage:
    """A window on the chaos clock, ``start_s <= now < end_s``, in which
    every matching (path, level) is unfetchable: ``available`` is False and
    ``fetch`` raises :class:`TransientPagerError`.  ``level=None`` matches
    every delta level; ``pattern`` is an ``re.search`` over the leaf path
    (empty: every leaf)."""
    start_s: float
    end_s: float
    level: Optional[int] = None
    pattern: str = ""

    def __post_init__(self):
        if not 0 <= self.start_s < self.end_s:
            raise ValueError(f"need 0 <= start_s < end_s, got "
                             f"[{self.start_s}, {self.end_s})")
        re.compile(self.pattern)

    def covers(self, path: str, level: int, now: float) -> bool:
        return (self.start_s <= now < self.end_s
                and (self.level is None or self.level == level)
                and (not self.pattern or re.search(self.pattern, path) is not None))


class ChaosPager:
    """Seeded, deterministic fault injection over any inner pager.  Every
    draw comes from ``numpy.random.default_rng(seed)`` in the JAX
    package's order (three per fetch that passes the outage check, then
    two per corruption), so a seed replays the same fault timeline in both
    packages; :attr:`faults` counts what fired.

    * ``p_transient`` - the fetch raises :class:`TransientPagerError`
      before touching the inner pager;
    * ``p_corrupt`` - one bit of a COPY of the returned words is flipped,
      on the words' device (the inner pager's copy stays pristine, so a
      retry heals);
    * ``p_stall`` - the fetch first sleeps ``stall_s`` on the chaos clock;
    * ``outages`` - :class:`Outage` windows.

    The clock defaults to a fresh :class:`VirtualClock`; share one with the
    Scheduler and the ResilientPager so outages and backoff live on one
    timeline."""

    def __init__(self, inner: DeltaPager, *, seed: int = 0,
                 p_transient: float = 0.0, p_corrupt: float = 0.0,
                 p_stall: float = 0.0, stall_s: float = 0.05,
                 outages: Tuple[Outage, ...] = (), clock=None):
        for name, p in (("p_transient", p_transient),
                        ("p_corrupt", p_corrupt), ("p_stall", p_stall)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        self.inner = inner
        self.p_transient = float(p_transient)
        self.p_corrupt = float(p_corrupt)
        self.p_stall = float(p_stall)
        self.stall_s = float(stall_s)
        self.outages = tuple(outages)
        self.clock = clock if clock is not None else VirtualClock()
        self._rng = np.random.default_rng(seed)
        self.fetches = 0
        self.faults: Dict[str, int] = {"transient": 0, "corrupt": 0,
                                       "stall": 0, "outage": 0}

    def _active_outage(self, path: str, level: int) -> Optional[Outage]:
        now = self.clock.now()
        for o in self.outages:
            if o.covers(path, level, now):
                return o
        return None

    def fetch(self, path: str, level: int) -> torch.Tensor:
        self.fetches += 1
        out = self._active_outage(path, level)
        if out is not None:
            self.faults["outage"] += 1
            raise TransientPagerError(
                f"injected outage: {path!r} delta {level} unavailable "
                f"until t={out.end_s:g}s (now t={self.clock.now():g}s)")
        # one 3-draw vector per fetch: the schedule depends only on the seed
        # and the fetch order, never on which faults fired
        stall, transient, corrupt = self._rng.random(3)
        if stall < self.p_stall:
            self.faults["stall"] += 1
            self.clock.sleep(self.stall_s)
        if transient < self.p_transient:
            self.faults["transient"] += 1
            raise TransientPagerError(
                f"injected transient fetch failure: {path!r} delta {level}")
        words = self.inner.fetch(path, level)
        if corrupt < self.p_corrupt:
            self.faults["corrupt"] += 1
            raw = words.clone()               # never corrupt the source
            flat = raw.reshape(-1).view(torch.uint8)
            i = int(self._rng.integers(flat.numel()))
            flat[i] ^= 1 << int(self._rng.integers(8))
            return raw
        return words

    def evict(self, path: str, level: int) -> None:
        self.inner.evict(path, level)

    def resident_bytes(self) -> int:
        return self.inner.resident_bytes()

    def available(self, path: str, level: int) -> bool:
        if self._active_outage(path, level) is not None:
            return False
        return self.inner.available(path, level)

    def expected_crc(self, path: str, level: int) -> Optional[int]:
        fn = getattr(self.inner, "expected_crc", None)
        return fn(path, level) if fn is not None else None


# ---------------------------------------------------------------------------
# hardened fetch path
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RetryPolicy:
    """How hard :class:`ResilientPager` tries before giving up on a stream.
    Backoff for attempt ``a`` (0-based) is ``backoff_base_s *
    backoff_factor**a``, jittered by a seeded ``+/- jitter`` fraction;
    ``fetch_timeout_s`` bounds one attempt on the clock, ``deadline_s`` the
    whole fetch call including backoff."""
    max_attempts: int = 4
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    jitter: float = 0.25
    fetch_timeout_s: Optional[float] = None
    deadline_s: Optional[float] = None
    verify_crc: bool = True
    quarantine_after: int = 3         # consecutive failures -> quarantine
    quarantine_s: float = 60.0        # cooldown before re-probing

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_base_s < 0 or self.backoff_factor < 1:
            raise ValueError("need backoff_base_s >= 0 and backoff_factor >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.quarantine_after < 1 or self.quarantine_s < 0:
            raise ValueError("need quarantine_after >= 1 and quarantine_s >= 0")


@dataclass
class StreamHealth:
    """Per-(path, level) delivery record kept by :class:`ResilientPager`."""
    attempts: int = 0
    failures: int = 0
    consecutive: int = 0              # failures since the last success
    corrupt: int = 0
    timeouts: int = 0
    quarantined_until: float = field(default=float("-inf"))
    last_error: str = ""


class ResilientPager:
    """Retry, verify and quarantine around any pager: the hardened fetch
    path.  Each fetch runs up to ``policy.max_attempts`` attempts with
    exponential backoff and seeded jitter (drawn in the JAX package's
    order), retries :class:`TransientPagerError` and
    :class:`CorruptStreamError`, re-verifies every fetched stream's CRC-32
    against the inner pager's ``expected_crc`` on a host copy (as
    :class:`FilePager` hashes), and turns an attempt that overruns
    ``fetch_timeout_s`` on the clock into a transient fault.  A stream
    whose consecutive failures reach ``quarantine_after`` is quarantined:
    ``available`` reads False for ``quarantine_s``, after which the next
    probe retries for real.  A failed attempt evicts whatever the inner
    pager delivered, so residency accounting survives every fault."""

    def __init__(self, inner: DeltaPager, policy: Optional[RetryPolicy] = None, *,
                 seed: int = 0, clock=None):
        self.inner = inner
        self.policy = policy if policy is not None else RetryPolicy()
        # the fault injector's timeline unless told otherwise: backoff
        # sleeps then move outage windows toward their end
        self.clock = (clock if clock is not None
                      else getattr(inner, "clock", None) or VirtualClock())
        self._rng = np.random.default_rng(seed)
        self.health: Dict[Tuple[str, int], StreamHealth] = {}
        self.retries = 0
        self.quarantines = 0

    def _health(self, path: str, level: int) -> StreamHealth:
        return self.health.setdefault((path, level), StreamHealth())

    def quarantined(self) -> Dict[Tuple[str, int], float]:
        """Streams in quarantine now -> the end of their cooldown."""
        now = self.clock.now()
        return {k: h.quarantined_until for k, h in self.health.items()
                if h.quarantined_until > now}

    def _verified(self, path: str, level: int, words: torch.Tensor) -> torch.Tensor:
        if not self.policy.verify_crc:
            return words
        fn = getattr(self.inner, "expected_crc", None)
        want = fn(path, level) if fn is not None else None
        if want is None:
            return words
        host = words.detach().contiguous().cpu()
        got = zlib.crc32(host.reshape(-1).view(torch.uint8).numpy())
        if got != want:
            raise CorruptStreamError(
                f"delta stream corrupted: leaf {path!r} level {level}: "
                f"CRC-32 re-verification failed (expected {want:#010x}, "
                f"observed {got:#010x})")
        return words

    def fetch(self, path: str, level: int) -> torch.Tensor:
        pol, h = self.policy, self._health(path, level)
        now = self.clock.now()
        if h.quarantined_until > now:
            raise TransientPagerError(
                f"{path!r} delta {level} quarantined until "
                f"t={h.quarantined_until:g}s (now t={now:g}s, "
                f"{h.consecutive} consecutive failures)")
        t_start = now
        last: Optional[PagerError] = None
        for attempt in range(pol.max_attempts):
            t0 = self.clock.now()
            h.attempts += 1
            try:
                words = self.inner.fetch(path, level)
                if (pol.fetch_timeout_s is not None
                        and self.clock.now() - t0 > pol.fetch_timeout_s):
                    h.timeouts += 1
                    self.inner.evict(path, level)
                    raise TransientPagerError(
                        f"fetch of {path!r} delta {level} took "
                        f"{self.clock.now() - t0:g}s > per-attempt timeout "
                        f"{pol.fetch_timeout_s:g}s")
                try:
                    words = self._verified(path, level, words)
                except CorruptStreamError:
                    self.inner.evict(path, level)
                    raise
                h.consecutive = 0
                return words
            except (TransientPagerError, CorruptStreamError) as e:
                h.failures += 1
                h.consecutive += 1
                h.last_error = str(e)
                if isinstance(e, CorruptStreamError):
                    h.corrupt += 1
                last = e
                if h.consecutive >= pol.quarantine_after:
                    h.quarantined_until = self.clock.now() + pol.quarantine_s
                    self.quarantines += 1
                    break             # a failing stream earns no more retries
                if attempt + 1 >= pol.max_attempts:
                    break
                back = (pol.backoff_base_s * pol.backoff_factor ** attempt
                        * (1.0 + pol.jitter * (2.0 * float(self._rng.random()) - 1.0)))
                if (pol.deadline_s is not None
                        and self.clock.now() + back - t_start > pol.deadline_s):
                    break             # the deadline outlaws another attempt
                self.retries += 1
                self.clock.sleep(back)
        raise last

    def evict(self, path: str, level: int) -> None:
        self.inner.evict(path, level)

    def resident_bytes(self) -> int:
        return self.inner.resident_bytes()

    def available(self, path: str, level: int) -> bool:
        h = self.health.get((path, level))
        if h is not None and h.quarantined_until > self.clock.now():
            return False
        return self.inner.available(path, level)

    def expected_crc(self, path: str, level: int) -> Optional[int]:
        fn = getattr(self.inner, "expected_crc", None)
        return fn(path, level) if fn is not None else None
