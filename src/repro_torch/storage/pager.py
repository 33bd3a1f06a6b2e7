"""Delta pagers; the part of ``repro/storage/pager.py`` the serving path
needs: the :class:`PagerError` family, the :class:`DeltaPager` protocol and
:class:`InMemoryPager` (with ``put``/``discard``, through which the nested
KV cache deposits and retires its page deltas).

A pager owns the NON-RESIDENT delta streams of one nested model.  Here
they live in host memory; ``fetch`` copies a stream to the store's device
(the copy the store splices into the serving tree) and ``evict`` is the
store dropping that device copy - the host copy stays, so a page-out /
page-in round trip is bit-identical.  The store's ledger records the
bytes of each stream moved, asserted equal to the metadata-computed
``bytes(delta_k)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import torch

from .. import tree


class PagerError(RuntimeError):
    """A delta stream could not be delivered."""


class TransientPagerError(PagerError):
    """Retryable delivery fault: the same fetch may succeed on retry."""


class CorruptStreamError(PagerError):
    """The fetched bytes do not match their recorded checksum."""


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


class InMemoryPager:
    """Every delta stream held in host memory; ``fetch`` copies to
    ``device`` (for a CPU store the very same tensor comes back)."""

    def __init__(self, streams: Optional[Dict[Tuple[str, int], torch.Tensor]] = None,
                 device="cpu"):
        self.device = torch.device(device)
        self._streams: Dict[Tuple[str, int], torch.Tensor] = dict(streams or {})

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

    def discard(self, path: str, level: int) -> None:
        """Forget a stream entirely (page retirement; unlike ``evict``,
        which keeps the copy for a later fetch)."""
        self._streams.pop((path, level), None)

    def evict(self, path: str, level: int) -> None:
        pass                        # the host copy stays for later fetches

    def resident_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self._streams.values())

    def available(self, path: str, level: int) -> bool:
        return (path, level) in self._streams
