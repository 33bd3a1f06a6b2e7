"""Delta pagers; counterpart of ``repro/storage/pager.py`` without its
fault-injection tier (``ChaosPager``, ``ResilientPager``: ROADMAP.md
queue 1, item 11).

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
"""
from __future__ import annotations

import time
import zlib
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable

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
