"""Delta-distribution tier: origin -> edge cache -> N replica pagers;
counterpart of ``repro/fleet/distribution.py``.

One NestQuant artifact serves a fleet of devices, each paging delta
streams in and out as its own resources move.  When N replicas climb the
same ladder, a delta segment is shared content: the origin ships each
stream over the WAN once (the edge caches it for good: segments are
immutable), and the edge multicasts a stream that several replicas ask
for within ``multicast_window_s`` of shared virtual time.

* **origin -> edge (WAN)**: the first request for a stream anywhere in the
  fleet pays its bytes once (``origin_bytes``); every later request is a
  dedup hit.  An optional shared uplink
  :class:`~repro_torch.storage.pager.LinkBudget` serializes the WAN hop.
* **edge -> replica (local)**: each delivery pays the stream's bytes on the
  local hop (``edge_bytes``) unless another replica pulled the same stream
  within the window (``multicast_joins``).

The baseline is per-replica unicast: every fetch pays both hops
(``unicast_bytes``).  Replicas attach through :meth:`DeltaDistribution.client`,
an ordinary pager that the per-replica chaos and retry stack wraps.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..storage.pager import DeltaPager, LinkBudget, VirtualClock

Key = Tuple[str, int]                 # (leaf path, delta level)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeltaDistribution:
    """One origin and one edge cache serving delta segments to a fleet.

    ``origin`` is any pager holding the artifact's delta streams (the fleet
    builder harvests an :class:`~repro_torch.storage.pager.InMemoryPager`
    from the shared nested tree); ``clock`` is the fleet's shared
    :class:`~repro_torch.storage.pager.VirtualClock`, on whose timeline the
    multicast window and the optional WAN ``uplink`` live."""

    def __init__(self, origin: DeltaPager, *, clock: Optional[VirtualClock] = None,
                 multicast_window_s: float = 0.05,
                 uplink: Optional[LinkBudget] = None):
        if multicast_window_s < 0:
            raise ValueError(f"multicast_window_s must be >= 0, got {multicast_window_s}")
        self.origin = origin
        self.clock = clock if clock is not None else VirtualClock()
        self.multicast_window_s = float(multicast_window_s)
        self.uplink = uplink
        self._edge_cached: Dict[Key, int] = {}      # stream -> nbytes
        self._last_tx: Dict[Key, float] = {}        # last edge transmission
        self.origin_bytes = 0                       # WAN hop (deduplicated)
        self.edge_bytes = 0                         # local hop (multicast)
        self.unicast_bytes = 0                      # baseline: both hops per fetch
        self.origin_fetches = 0
        self.dedup_hits = 0
        self.multicast_joins = 0
        self.uplink_wait_s = 0.0
        self.fetch_log: List[Tuple[float, str, str, int, str]] = []
        self._fetch_counts: Dict[Key, int] = {}

    def client(self, replica: str) -> "EdgeClientPager":
        """A per-replica pager view onto this tier."""
        return EdgeClientPager(self, replica)

    def deliver(self, replica: str, path: str, level: int) -> torch.Tensor:
        """Serve one stream to one replica, accounting both hops."""
        now = self.clock.now()
        key = (path, level)
        arr = self.origin.fetch(path, level)
        nb = _nbytes(arr)
        self._fetch_counts[key] = self._fetch_counts.get(key, 0) + 1
        self.unicast_bytes += 2 * nb
        if key not in self._edge_cached:
            # cold at the edge: the WAN hop runs once, then the segment stays
            self._edge_cached[key] = nb
            self.origin_bytes += nb
            self.origin_fetches += 1
            hop = "origin"
            if self.uplink is not None:
                _, _, dt = self.uplink.reserve(nb, now)
                self.uplink_wait_s += dt
                self.clock.sleep(dt)    # the herd queues on the one wire
        else:
            self.dedup_hits += 1
            hop = "edge"
        last = self._last_tx.get(key)
        if last is not None and now - last <= self.multicast_window_s:
            # a transmission of this stream is still on the local wire
            self.multicast_joins += 1
            hop += "+multicast"
        else:
            self.edge_bytes += nb
            self._last_tx[key] = now
        self.fetch_log.append((now, replica, path, level, hop))
        return arr

    def fleet_bytes(self) -> int:
        """Bytes on the wire with the distribution tier (both hops)."""
        return self.origin_bytes + self.edge_bytes

    def hot_segments(self, top: int = 5) -> List[Tuple[str, int, int]]:
        """The ``top`` most-requested (path, level, count) streams."""
        ranked = sorted(self._fetch_counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return [(p, lvl, n) for (p, lvl), n in ranked[:top]]

    def stats(self) -> Dict[str, object]:
        return {"fleet_bytes": self.fleet_bytes(),
                "origin_bytes": self.origin_bytes,
                "edge_bytes": self.edge_bytes,
                "unicast_bytes": self.unicast_bytes,
                "origin_fetches": self.origin_fetches,
                "dedup_hits": self.dedup_hits,
                "multicast_joins": self.multicast_joins,
                "edge_cached_streams": len(self._edge_cached),
                "edge_cached_bytes": sum(self._edge_cached.values()),
                "uplink_wait_s": self.uplink_wait_s}


class EdgeClientPager:
    """One replica's pager view onto a :class:`DeltaDistribution`.

    ``fetch`` goes through the tier's dedup and multicast accounting;
    ``evict`` drops only this replica's residency (the edge cache keeps the
    segment, which is why a downshift and re-climb costs the fleet less
    than unicast); ``resident_bytes`` counts this replica's fetched and
    not evicted streams."""

    def __init__(self, distribution: DeltaDistribution, replica: str):
        self.distribution = distribution
        self.replica = replica
        self._resident: Dict[Key, int] = {}
        self.fetches = 0

    def fetch(self, path: str, level: int) -> torch.Tensor:
        arr = self.distribution.deliver(self.replica, path, level)
        self.fetches += 1
        self._resident[(path, level)] = _nbytes(arr)
        return arr

    def evict(self, path: str, level: int) -> None:
        self._resident.pop((path, level), None)

    def resident_bytes(self) -> int:
        return sum(self._resident.values())

    def available(self, path: str, level: int) -> bool:
        return self.distribution.origin.available(path, level)

    def expected_crc(self, path: str, level: int) -> Optional[int]:
        fn = getattr(self.distribution.origin, "expected_crc", None)
        return fn(path, level) if fn is not None else None
