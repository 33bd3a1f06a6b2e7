"""Nested KV cache: ladder-quantized K/V pages with ledgered rung switches;
counterpart of ``repro/serving/kv_cache.py``.

K/V are quantized PER PAGE with the same ladder split as weights, so a
cache rung is a base code stream plus prefix-resident delta streams, and
a rung move pages exactly the delta streams of one step through the
pager, asserted against the metadata-computed ``bytes(delta_k)``.

* codes: a K (or V) slab ``(L, B, page, Hkv, hd)`` is quantized to
  INT-``bits[-1]`` with a per-position, per-head scale (amax over
  ``hd``).  That scale does not depend on the contraction index of QK^T,
  so the integer score kernel (``kernels/nested_attention``) can apply it
  after an int32 dot product.
* streams: ``chain_decompose`` of the codes, each stream
  ``pack_blocked`` along the position axis with ``block == page``.
* residency: rung ``r`` holds the base plus delta streams ``0..r-1`` of
  every page; every delta is deposited in the pager at ingest
  (``pager.put``), so an upgrade fetches through the same protocol as a
  weight delta.

Each page keeps its own contiguous copy of its streams, so a paged-out
delta really leaves the device.  Decode state is never the packed form:
the engine renders the paged prompt region into its dense cache at the
current rung.  The reference jits ``_quantize_kv``/``_render_kv`` and
counts traces (``KV_TRACES``); here they are plain tensor functions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..core import packing
from ..core.decompose import (ROUNDINGS, chain_decompose, chain_recompose,
                              delta_bits, normalize_bits)
from ..core.quantizer import int_range
from ..core.switching import SwitchLedger
from ..device import resolve_device
from ..storage.pager import InMemoryPager


def kv_stream_widths(bits) -> Tuple[int, ...]:
    """Stored widths of the KV streams: (base bits, *delta widths)."""
    b = normalize_bits(bits)
    return (b[0],) + delta_bits(b)


@dataclass(frozen=True)
class KVCacheConfig:
    """Ladder shape of the nested KV cache: ``bits`` (normalized
    ascending; rung 0 = base, top = the full-code cache), ``page``
    positions per page (a page spans all layers and the whole batch) and
    the per-level split ``rounding``."""
    bits: Tuple[int, ...] = (4, 8)
    page: int = 16
    rounding: str = "rtn"

    def __post_init__(self):
        object.__setattr__(self, "bits", normalize_bits(self.bits))
        if self.page < 1:
            raise ValueError(f"page must be >= 1, got {self.page}")
        if self.rounding not in ROUNDINGS:
            raise ValueError(f"rounding {self.rounding!r} not in {ROUNDINGS}")

    @property
    def num_rungs(self) -> int:
        return len(self.bits)

    @property
    def widths(self) -> Tuple[int, ...]:
        return kv_stream_widths(self.bits)


def _quantize_kv(slab: torch.Tensor, *, bits, page: int, rounding: str):
    """One K or V slab ``(L, B, S, Hkv, hd)`` -> (packed streams, scale
    ``(L, B, S, Hkv, 1)`` f32).  Codes at the top rung's bits, then the
    ladder split; ``S`` must be a page multiple.  The split is not
    re-validated here: the reference runs it under jit, where validation
    is off."""
    b = normalize_bits(bits)
    lo, hi = int_range(b[-1])
    x = slab.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    # the reference's jitted ``/ hi`` runs as a multiply by the f32
    # reciprocal of the constant (XLA's rewrite); the same here, bit for bit
    inv_hi = torch.tensor(1.0, dtype=torch.float32, device=x.device) / hi
    scale = torch.clamp(amax, min=1e-8) * inv_hi
    codes = torch.clamp(torch.round(x / scale), lo, hi).to(torch.int32)
    base, deltas = chain_decompose(codes, b, method=rounding, validate=False)
    streams = tuple(packing.pack_blocked(s, w, page, axis=2)
                    for s, w in zip((base, *deltas), kv_stream_widths(b)))
    return streams, scale


def _render_kv(streams, scale: torch.Tensor, *, bits, page: int,
               rung: int) -> torch.Tensor:
    """Packed streams (base + deltas[:rung]) -> dense f32 values at
    ``rung``: codes at rung r approximate the top codes shifted down by
    ``bits[-1] - bits[r]``, so the dequant multiplies back."""
    b = normalize_bits(bits)
    widths = kv_stream_widths(b)
    S = scale.shape[2]
    codes = [packing.unpack_blocked(w, widths[i], S, page, axis=2)
             for i, w in enumerate(streams)]
    c = chain_recompose(codes[0], codes[1:], b, rung=rung)
    return c.float() * scale * (2 ** (b[-1] - b[rung]))


def kv_bytes_per_token(config: KVCacheConfig, rung: int, num_layers: int,
                       num_kv_heads: int, head_dim: int) -> int:
    """Bytes ONE position costs at ``rung`` (K and V, all layers): the
    resident packed words plus the per-position scales (metadata only)."""
    widths = config.widths[:1 + rung]
    words = sum(packing.blocked_rows(config.page, w) for w in widths)
    stream = num_layers * num_kv_heads * head_dim * 4 * words // config.page
    scales = num_layers * num_kv_heads * 4
    return 2 * (stream + scales)


def dense_kv_bytes_per_token(num_layers: int, num_kv_heads: int,
                             head_dim: int, dtype_bytes: int = 2) -> int:
    """What the dense cache charges per position."""
    return 2 * num_layers * num_kv_heads * head_dim * dtype_bytes


@dataclass
class KVPage:
    """One quantized span of ``page`` positions (all layers, full batch);
    ``deltas[t][i]`` is delta stream i of tensor t when resident, None
    when paged out (the pager holds it either way)."""
    index: int
    start: int
    base: Dict[str, torch.Tensor]
    deltas: Dict[str, List[Optional[torch.Tensor]]]
    scales: Dict[str, torch.Tensor]


class NestedKVCache:
    """Paged, ladder-quantized KV cache with pager-backed rung state.

    ``to_rung`` walks one adjacent rung at a time, each step atomic over
    all pages: every fetch lands and is size-checked before anything is
    spliced, and the step is recorded in the cache's own
    :class:`~repro_torch.core.switching.SwitchLedger` with its
    metadata-computed bytes in ``expected_events``.  ``ingest`` retires
    the previous batch's pages and quantizes a new prompt region (cache
    lifecycle, not a switch: nothing is ledgered); ``render`` recomposes
    the paged region at a resident rung; ``rewind`` drops pages past a
    position without fetching anything.

    ``pager`` (default: a fresh :class:`InMemoryPager`) may be a wrapper
    (``ChaosPager``, ``ResilientPager``, ``ThrottledPager``): fetches go
    through it, deposits and retirements to the first pager down its
    ``.inner`` chain that has ``put``.  ``ledger`` and ``tag`` (the stream
    paths' prefix) let a caller share a ledger or a pager's namespace."""

    TENSORS = ("k", "v")

    def __init__(self, config: Optional[KVCacheConfig] = None, *,
                 pager=None, ledger: Optional[SwitchLedger] = None, tag: str = "kv"):
        self.config = config if config is not None else KVCacheConfig()
        self.pager = pager if pager is not None else InMemoryPager({})
        self.ledger = ledger if ledger is not None else SwitchLedger()
        self.tag = tag
        self.rung = self.config.num_rungs - 1
        self.pages: List[KVPage] = []
        self.rewound_pages = 0
        # one entry per ledger event, (from, to, expected_in, expected_out),
        # computed from metadata at switch time
        self.expected_events: List[Tuple[int, int, int, int]] = []
        self._gen = 0
        self._geom: Optional[Tuple[int, int, int, int]] = None  # L, B, Hkv, hd

    # -- pager plumbing ----------------------------------------------------
    def _backing(self):
        """The first pager down the ``.inner`` chain that has ``put`` (the
        wrappers delegate fetches but take no deposits)."""
        p, seen = self.pager, set()
        while p is not None and id(p) not in seen:
            seen.add(id(p))
            if hasattr(p, "put"):
                return p
            p = getattr(p, "inner", None)
        raise TypeError(
            f"pager {type(self.pager).__name__} (nor any .inner) exposes put(); the "
            "nested KV cache needs a deposit-capable backing pager such as InMemoryPager")

    def _path(self, page_index: int, tensor: str) -> str:
        return f"{self.tag}/g{self._gen}/p{page_index}/{tensor}"

    def _discard(self, pages) -> None:
        backing = self._backing()
        if not hasattr(backing, "discard"):
            return
        for pg in pages:
            for t in self.TENSORS:
                for i in range(self.config.num_rungs - 1):
                    backing.discard(self._path(pg.index, t), i)

    # -- byte metadata -----------------------------------------------------
    def stream_bytes(self, level: int) -> int:
        """Bytes of ONE stream (level 0 = base, 1 + i = delta i) of ONE
        tensor of ONE page."""
        assert self._geom is not None, "no pages ingested yet"
        L, B, H, D = self._geom
        w = self.config.widths[level]
        return packing.blocked_rows(self.config.page, w) * L * B * H * D * 4

    def delta_bytes(self, i: int) -> int:
        """Bytes the rung i -> i+1 move touches over the current pages
        (both tensors)."""
        if not 0 <= i < self.config.num_rungs - 1:
            raise ValueError(f"no delta stream {i} on a "
                             f"{self.config.num_rungs}-rung ladder")
        if not self.pages:
            return 0
        return 2 * len(self.pages) * self.stream_bytes(1 + i)

    def scale_bytes(self) -> int:
        if not self.pages:
            return 0
        L, B, H, _ = self._geom
        return 2 * len(self.pages) * L * B * self.config.page * H * 4

    def rung_resident_bytes(self, rung: int) -> int:
        """Resident bytes with ``rung`` resident (the same pages)."""
        if not self.pages:
            return 0
        per_tensor = sum(self.stream_bytes(l) for l in range(1 + rung))
        return 2 * len(self.pages) * per_tensor + self.scale_bytes()

    def resident_bytes(self) -> int:
        """Device bytes the packed cache holds right now."""
        return self.rung_resident_bytes(self.rung)

    # -- lifecycle ---------------------------------------------------------
    def clear(self) -> int:
        """Retire every page: resident streams dropped, backing copies
        forgotten.  Not a rung switch: nothing is ledgered."""
        n = len(self.pages)
        if self.pages:
            self._discard(self.pages)
        self.pages = []
        return n

    def ingest(self, k: torch.Tensor, v: torch.Tensor) -> int:
        """Quantize dense K/V slabs ``(L, B, S, Hkv, hd)`` into full pages (a partial tail page stays
        dense in the engine's cache), replacing the previous batch's
        pages.  Every delta is deposited in the pager; levels at or above
        the current rung are not resident.  Returns the pages made."""
        P = self.config.page
        L, B, S, H, D = k.shape
        n = S // P
        self.clear()
        self._gen += 1
        if n == 0:
            return 0
        self._geom = (L, B, H, D)
        span = n * P
        packed = {t: _quantize_kv(slab[:, :, :span], bits=self.config.bits, page=P,
                                  rounding=self.config.rounding)
                  for t, slab in (("k", k), ("v", v))}
        backing = self._backing()
        rpb = [packing.blocked_rows(P, w) for w in self.config.widths]
        for i in range(n):
            base, deltas, scales = {}, {}, {}
            for t in self.TENSORS:
                streams, scale = packed[t]
                base[t] = streams[0][:, :, i * rpb[0]:(i + 1) * rpb[0]].contiguous()
                scales[t] = scale[:, :, i * P:(i + 1) * P].contiguous()
                dl: List[Optional[torch.Tensor]] = []
                for d, words in enumerate(streams[1:]):
                    r = rpb[1 + d]
                    w = words[:, :, i * r:(i + 1) * r].contiguous()
                    backing.put(self._path(i, t), d, w)
                    dl.append(w if d < self.rung else None)
                deltas[t] = dl
            self.pages.append(KVPage(index=i, start=i * P, base=base,
                                     deltas=deltas, scales=scales))
        return n

    # -- rung state machine ------------------------------------------------
    def max_available_rung(self) -> int:
        """Highest rung the pager can deliver for every page right now."""
        for i in range(self.config.num_rungs - 1):
            for pg in self.pages:
                for t in self.TENSORS:
                    if (pg.deltas[t][i] is None
                            and not self.pager.available(self._path(pg.index, t), i)):
                        return i
        return self.config.num_rungs - 1

    def to_rung(self, target: int) -> int:
        """Walk to ``target`` one adjacent rung at a time; a failure in a
        step evicts what it staged and leaves residency, rung and ledger
        as they were."""
        target = max(0, min(int(target), self.config.num_rungs - 1))
        while self.rung < target:
            self._step(self.rung + 1)
        while self.rung > target:
            self._step(self.rung - 1)
        return self.rung

    def _step(self, to: int) -> None:
        frm = self.rung
        assert abs(to - frm) == 1, (frm, to)
        if not self.pages:          # no bytes move: the rung is metadata
            self.rung = to
            return
        lvl = min(frm, to)          # the delta index this step moves
        expect_each = self.stream_bytes(1 + lvl)
        expect = 2 * len(self.pages) * expect_each
        obs = 0
        if to > frm:
            staged = []
            try:
                for pg in self.pages:
                    for t in self.TENSORS:
                        path = self._path(pg.index, t)
                        words = self.pager.fetch(path, lvl)
                        staged.append((pg, t, path, words))
                        got = words.numel() * words.element_size()
                        if got != expect_each:
                            raise RuntimeError(
                                f"pager returned {got} bytes for {path} delta "
                                f"{lvl}; metadata says bytes(delta_{lvl}) = "
                                f"{expect_each}")
                        obs += got
            except BaseException:
                for _, _, path, _ in staged:
                    self.pager.evict(path, lvl)
                raise
            for pg, t, _, words in staged:
                pg.deltas[t][lvl] = words
            if obs != expect:
                raise RuntimeError(f"KV upgrade {frm}->{to} observed {obs} bytes; "
                                   f"metadata says {expect}")
            self.ledger.record(obs, 0, from_rung=frm, to_rung=to)
            self.expected_events.append((frm, to, expect, 0))
        else:
            for pg in self.pages:
                for t in self.TENSORS:
                    words = pg.deltas[t][lvl]
                    got = words.numel() * words.element_size()
                    if got != expect_each:
                        raise RuntimeError(
                            f"resident KV stream {lvl} of page {pg.index} holds "
                            f"{got} bytes; metadata says bytes(delta_{lvl}) = "
                            f"{expect_each}")
                    self.pager.evict(self._path(pg.index, t), lvl)
                    pg.deltas[t][lvl] = None
                    obs += got
            if obs != expect:
                raise RuntimeError(f"KV downgrade {frm}->{to} observed {obs} "
                                   f"bytes; metadata says {expect}")
            self.ledger.record(0, obs, from_rung=frm, to_rung=to)
            self.expected_events.append((frm, to, 0, expect))
        self.rung = to

    # -- speculative-decode hook -------------------------------------------
    def rewind(self, pos: int) -> int:
        """Retire every page at or past ``pos`` with ZERO pager fetches
        (paged-out deltas stay out).  Returns the pages dropped."""
        keep, drop = [], []
        for pg in self.pages:
            (drop if pg.start + self.config.page > pos else keep).append(pg)
        if drop:
            self._discard(drop)
            self.rewound_pages += len(drop)
        self.pages = keep
        return len(drop)

    # -- dense interop -----------------------------------------------------
    def streams(self, tensor: str, rung: Optional[int] = None):
        """The paged region of ``tensor`` as whole streams: (base,
        *deltas[:rung]) each ``(L, B, npages * rows, Hkv, hd)`` int32, and
        the scale ``(L, B, npages * page, Hkv, 1)`` f32."""
        r = self.rung if rung is None else int(rung)
        if not 0 <= r <= self.rung:
            raise ValueError(f"render rung {r} not resident (cache rung "
                             f"= {self.rung}; rendering never fetches)")
        out = [torch.cat([pg.base[tensor] for pg in self.pages], dim=2)]
        for i in range(r):
            out.append(torch.cat([pg.deltas[tensor][i] for pg in self.pages], dim=2))
        scale = torch.cat([pg.scales[tensor] for pg in self.pages], dim=2)
        return tuple(out), scale

    def render(self, rung: Optional[int] = None
               ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Recompose the paged region to dense f32 ``(k, v)`` at ``rung``
        (default: current; must be resident - rendering never fetches).
        None when there are no pages."""
        if not self.pages:
            return None
        r = self.rung if rung is None else int(rung)
        out = []
        for t in self.TENSORS:
            streams, scale = self.streams(t, r)
            out.append(_render_kv(streams, scale, bits=self.config.bits,
                                  page=self.config.page, rung=r))
        return out[0], out[1]

    def warm(self, num_layers: int, batch: int, positions: int,
             num_kv_heads: int, head_dim: int, rungs=None, device=None) -> int:
        """Run the quantize and the render of every rung once on throwaway
        buffers of this geometry on ``device`` (default: the card); pages,
        rung, ledger and pager are untouched.  The JAX package pre-traces
        its jitted versions here; these are plain tensor functions with
        nothing to trace, so the run brings the device's allocator pool to
        the sizes a first ingest and render take.  Returns the JAX
        package's call count."""
        P = self.config.page
        n = positions // P
        if n == 0:
            return 0
        slab = torch.zeros((num_layers, batch, n * P, num_kv_heads, head_dim),
                           dtype=torch.float32, device=resolve_device(device))
        streams, scale = _quantize_kv(slab, bits=self.config.bits, page=P,
                                      rounding=self.config.rounding)
        calls = 1
        rungs = range(self.config.num_rungs) if rungs is None else sorted(set(rungs))
        for r in rungs:
            _render_kv(tuple(streams[:1 + r]), scale, bits=self.config.bits,
                       page=P, rung=r)
            calls += 1
        return calls
