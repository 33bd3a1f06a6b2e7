"""Serving engine: batched requests, prefill/greedy decode, rung switching,
the nested KV cache, cold boot from an artifact with progressive delivery,
warm-up and self-speculative decoding; counterpart of
``repro/serving/engine.py``.

At every request boundary the policy sees the memory budget and the
recent switch history, and the store pages exactly the delta streams its
assignment moves.  The serving path never materializes a dense weight:
``store.params()`` is the packed tree, rung-stamped per leaf, and every
weight matmul goes through the packed/nested/ladder kernels.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.switching import NestQuantStore, RungAssignment
from ..device import resolve_device, torch_dtype
from ..models import moe
from ..models.model import Model, make_model
from ..storage.artifact import ArtifactError
from ..storage.pager import PagerError
from .kv_cache import (KVCacheConfig, NestedKVCache, dense_kv_bytes_per_token,
                       kv_bytes_per_token)
from .policies import (BudgetPolicy, QualityFloorPolicy, ResourceSignal, RungPolicy,
                       SignalTracker, resolve_kv_decide)

# a failed rung switch (a pager fault, an undelivered or corrupted
# segment) rolls back in the store, so the engine keeps serving at the rung
# it already has
SWITCH_FAILURES = (PagerError, ArtifactError)

MODE_HISTORY_CAP = 512


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)


@dataclass(frozen=True)
class SpecConfig:
    """Self-speculative decoding: ``k`` drafted tokens per round; ``draft``
    the draft rung - an int (one rung, clamped per leaf to what is
    resident), a ``{keystr: rung}`` map, a
    :class:`~repro_torch.core.switching.RungAssignment`, or ``'floor'``
    (the per-leaf floors of the :class:`QualityFloorPolicy` in the
    engine's policy chain).  A draft pages nothing in: it reads a prefix of
    the streams already resident for the verify rung."""
    k: int = 3
    draft: object = 0


@dataclass(frozen=True)
class DecodeProfile:
    """What one ``generate`` call dispatched, for
    :meth:`~repro_torch.serving.scheduler.ServiceModel.speculative_seconds`:
    drafts are charged at their resident-rung bytes, verify passes and
    plain steps at the full residency."""
    steps: int = 0                # sequential full-residency decode steps
    draft_steps: int = 0          # draft-rung decode steps
    verify_passes: int = 0        # chunked verify passes
    draft_bytes: int = 0          # resident bytes a draft step streams
    verify_bytes: int = 0         # resident bytes a verify pass streams
    drafted: int = 0              # tokens drafted (real requests only)
    accepted: int = 0             # drafted tokens accepted (real only)

    @property
    def speculative(self) -> bool:
        return self.verify_passes > 0

    @property
    def acceptance(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0


@dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    switches: int = 0
    switch_failures: int = 0
    last_failure: str = ""
    mode_history: deque = field(default_factory=lambda: deque(maxlen=MODE_HISTORY_CAP))
    mode_counts: Dict[str, int] = field(default_factory=dict)
    # scheduler: batches a Scheduler dispatched, real requests it admitted,
    # and the filler clones it padded batches with (served to no client)
    sched_steps: int = 0
    sched_admitted: int = 0
    sched_filler: int = 0
    # speculative decoding; token counts cover real requests only (filler
    # clones ride in the batch but must not dilute the acceptance rate)
    spec_rounds: int = 0          # draft/verify rounds (= verify passes)
    spec_draft_steps: int = 0     # draft-rung decode dispatches
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_rejected: int = 0
    # nested KV cache
    kv_switches: int = 0          # committed cache rung moves
    kv_switch_failures: int = 0   # cache switch attempts rolled back
    kv_pages: int = 0             # pages ingested over the engine's life

    @property
    def spec_acceptance(self) -> float:
        """Accepted fraction of drafted tokens (real requests only)."""
        return self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0

    def record_mode(self, mode: str):
        self.mode_history.append(mode)
        self.mode_counts[mode] = self.mode_counts.get(mode, 0) + 1


class ServeEngine:
    """Greedy batched serving of a nested model held by ``store``; runs
    on the store's device.  ``kv``: None keeps the dense cache alone; a
    :class:`KVCacheConfig` builds a fresh :class:`NestedKVCache`; an
    existing cache is adopted as it is."""

    def __init__(self, cfg: ModelConfig, store: NestQuantStore,
                 max_batch: int = 8, max_len: int = 128,
                 policy: Optional[RungPolicy] = None, *,
                 model: Optional[Model] = None, kv=None):
        if isinstance(kv, KVCacheConfig):
            kv = NestedKVCache(kv)
        if kv is not None and not isinstance(kv, NestedKVCache):
            raise TypeError(f"kv must be a KVCacheConfig or a NestedKVCache, "
                            f"got {type(kv).__name__}")
        self.kv: Optional[NestedKVCache] = kv
        self.cfg = cfg
        self.store = store
        self.device = store.device
        self.model = model if model is not None else make_model(cfg, device=self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.policy = policy if policy is not None else BudgetPolicy()
        self.stats = EngineStats()
        self.artifact = None          # set by from_artifact
        # what the last generate call dispatched (the scheduler's cost model)
        self.last_profile: Optional[DecodeProfile] = None
        self._tracker = SignalTracker()
        self._params = None
        self._kv_layer_count: Optional[int] = None

    # -- deployment --------------------------------------------------------
    @classmethod
    def from_artifact(cls, cfg: ModelConfig, path, *, pager=None,
                      policy: Optional[RungPolicy] = None, max_batch: int = 8,
                      max_len: int = 128, device=None,
                      verify: bool = True) -> "ServeEngine":
        """Cold-boot on ``device`` (default: the card) from a saved artifact:
        reads ONLY ``manifest.json`` and the base segment and serves at
        rung 0 at once; delta streams page in through ``pager`` (default:
        a :class:`~repro_torch.storage.pager.FilePager` over the same
        artifact, landing on ``device``) on a budget upgrade, or rung by
        rung through :meth:`poll_delivery` as delta segments arrive."""
        from ..storage.artifact import Artifact, open_artifact
        from ..storage.pager import FilePager
        device = resolve_device(device)
        art = path if isinstance(path, Artifact) else open_artifact(path)
        store = NestQuantStore(
            art.load_base_tree(device), mode="part", device=device,
            pager=pager if pager is not None else FilePager(art, verify=verify,
                                                            device=device))
        eng = cls(cfg, store, max_batch=max_batch, max_len=max_len, policy=policy)
        eng.artifact = art
        return eng

    def poll_delivery(self) -> Dict[str, object]:
        """Progressive delivery: climb one adjacent rung at a time while the
        pager has the next delta level available.  A climb step that fails
        rolls back in the store and ends this poll; the next poll
        re-probes.  Refreshes the cached serving params.  Returns
        {'from_rung', 'rung', 'modes', 'page_in', 'failed'} for this poll
        (page_in = observed, ledgered bytes)."""
        start = self.store.rung
        in0 = self.store.ledger.page_in_bytes
        reached: List[str] = []
        failed = ""
        while (self.store.rung < self.store.num_rungs - 1
               and self.store.max_available_rung() > self.store.rung):
            try:
                self.store.to_rung(self.store.rung + 1)
            except SWITCH_FAILURES as e:
                failed = str(e)
                self.stats.switch_failures += 1
                self.stats.last_failure = failed
                self._tracker.note(False, failed=True)
                break
            self.stats.switches += 1
            self.stats.record_mode(self.store.mode)
            reached.append(self.store.mode)
        if reached:
            self._params = self.store.params()
        return {"from_rung": start, "rung": self.store.rung, "modes": reached,
                "page_in": self.store.ledger.page_in_bytes - in0,
                "failed": failed}

    # -- warm-up -----------------------------------------------------------
    def warmup(self, prompt_len, *, batch: Optional[int] = None, rungs=None,
               spec: Optional[SpecConfig] = None) -> int:
        """Run every (rung, prompt length) the serve loop will dispatch once,
        on throwaway buffers, so a later serve builds nothing.

        The JAX package pre-traces its jitted steps here.  The card's
        equivalent: the first launch of a kernel builds and loads the
        kernel libraries, the first decode-body or short-prefill launch of a
        shape fills its plan (``kernels/build.py::dec_plan``, ``mid_plan``)
        and may grow the arrival counters both share
        (``build.dec_counters``), which would replace the buffer a captured
        graph holds, and the first launch of each decode-body instantiation
        (streams, rows) opts it into large shared memory.
        The counters are one buffer per (device, stream): warm-up sizes the
        buffer of the stream it runs on, so serve on that stream.  So this
        loads every kernel library (on the card), then runs the prefill of
        each prompt length and one decode step at each rung on
        :meth:`~repro_torch.core.switching.NestQuantStore.rung_view` trees,
        whose leaves match ``store.params()`` at that rung (no residency
        change, no ledger event); on a MoE model it also launches the
        decode route at every instantiation's row count on an expert view
        (:func:`~repro_torch.models.moe.warm_decode_rows`); with a nested
        KV cache it runs the cache's quantize and render for each prompt
        length.  ``prompt_len``
        is an int or the prompt lengths after left-padding; ``batch``
        defaults to ``max_batch`` (what a bucketing Scheduler dispatches);
        ``spec`` also runs a draft-stamped decode step and, where the family
        has one, a (k+1)-position verify chunk at each rung.  Returns the
        number of warm-up calls, as the JAX package counts them."""
        B = self.max_batch if batch is None else batch
        plens = ([prompt_len] if isinstance(prompt_len, int)
                 else sorted(set(prompt_len)))
        rungs = range(self.store.num_rungs) if rungs is None else sorted(set(rungs))
        if self.device.type == "cuda":
            from ..kernels import build
            for source in build.SIGNATURES:
                build.library(source)
        tok1 = torch.zeros((B, 1), dtype=torch.int64, device=self.device)
        calls = 0
        streams = self.store.leaf_streams()
        for r in rungs:
            params = self.store.rung_view(r)
            for S in plens:
                self.model.prefill(params, {"tokens": torch.zeros(
                    (B, S), dtype=torch.int64, device=self.device)})
                calls += 1
            stamps = [params]
            if spec is not None:
                draft = self._draft_rungs(spec, {p: min(r, len(s) - 1)
                                                 for p, s in streams.items()})
                stamps.append(self.store.rung_view(r, stamp=draft))
            for p in stamps:
                self.model.decode_step(p, {"tokens": tok1},
                                       self.model.make_cache(B, self.max_len))
                calls += 1
            if spec is not None and self.model.decode_chunk is not None:
                self.model.decode_chunk(
                    params, {"tokens": torch.zeros((B, spec.k + 1), dtype=torch.int64,
                                                   device=self.device)},
                    self.model.make_cache(B, self.max_len))
                calls += 1
            moe.warm_decode_rows(params, torch_dtype(self.cfg.compute_dtype), self.device)
        if self.kv is not None and self._kv_layers():
            for S in plens:
                calls += self.kv.warm(self._kv_layers(), B, S, self.cfg.num_kv_heads,
                                      self.cfg.head_dim, device=self.device)
        return calls

    # -- draft-rung selection ------------------------------------------------
    def _draft_rungs(self, spec: SpecConfig,
                     cur: Optional[Dict[str, int]] = None) -> Dict[str, int]:
        """Per-leaf draft rungs of ``spec``, clamped to the current
        residency (``cur``, default the store's): a draft never pages
        anything in."""
        if cur is None:
            cur = self.store.leaf_rungs()
        d = spec.draft
        if isinstance(d, str):
            if d != "floor":
                raise ValueError(f"unknown draft spec {d!r}; expected an int rung, a "
                                 "path map, a RungAssignment, or 'floor'")
            pol, floors, seen = self.policy, None, set()
            while pol is not None and id(pol) not in seen:
                seen.add(id(pol))
                if isinstance(pol, QualityFloorPolicy):
                    floors = pol.floor_rungs(self.store)
                    break
                pol = getattr(pol, "inner", None)
            if floors is None:
                raise ValueError("draft='floor' needs a QualityFloorPolicy in the "
                                 "engine's policy chain")
            want = floors
        elif isinstance(d, RungAssignment):
            want = self.store.resolve_assignment(d)
        elif isinstance(d, dict):
            want = {p: d.get(p, 0) for p in cur}
        else:
            want = {p: int(d) for p in cur}
        return {p: max(0, min(int(want[p]), cur[p])) for p in cur}

    def draft_resident_bytes(self, spec: SpecConfig) -> int:
        """Bytes one draft-rung decode step streams (what the ServiceModel
        charges a draft at)."""
        return self.store.assignment_resident_bytes(RungAssignment(
            default=0, exact=tuple(self._draft_rungs(spec).items())))

    # -- switching ---------------------------------------------------------
    def ensure_mode(self, memory_budget_bytes: Optional[int] = None,
                    queue_depth: int = 0, backlog_age_s: float = 0.0):
        """Let the policy pick the residency for the current signal and
        flip it; a switch that fails rolls back in the store and the
        engine keeps serving at the current residency.  The signal carries
        the pager's quarantined streams where it keeps any
        (``ResilientPager.quarantined``)."""
        quarantined = getattr(self.store.pager, "quarantined", None)
        signal = self._tracker.signal(
            memory_budget_bytes=memory_budget_bytes, queue_depth=queue_depth,
            backlog_age_s=backlog_age_s,
            available_rung=self.store.max_available_rung(),
            quarantined=len(quarantined()) if callable(quarantined) else 0,
            kv_rung=self.kv.rung if self.kv is not None else -1,
            kv_num_rungs=self.kv.config.num_rungs if self.kv is not None else 0,
            kv_resident_bytes=self.kv.resident_bytes() if self.kv is not None else 0)
        self._ensure_kv_rung(signal)
        try:
            report = self.store.apply(self.policy.decide(self.store, signal))
        except SWITCH_FAILURES as e:
            self.stats.switch_failures += 1
            self.stats.last_failure = str(e)
            self._tracker.note(False, failed=True)
            if self._params is None:
                self._params = self.store.params()
            self.stats.record_mode(self.store.mode)
            return self.store.mode
        changed = report["moves"] > 0
        self._tracker.note(changed)
        if changed:
            self.stats.switches += 1
        if changed or self._params is None:
            self._params = self.store.params()
        self.stats.record_mode(self.store.mode)
        return self.store.mode

    # -- nested KV cache ---------------------------------------------------
    def _ensure_kv_rung(self, signal: ResourceSignal) -> None:
        """The cache half of the joint rung choice: the policy chain's
        ``kv_decide``, clamped to what the pager can deliver, walked
        through the ledgered adjacent steps.  A failed walk rolls back in
        the cache; the dense decode cache is never touched."""
        if self.kv is None:
            return
        want = resolve_kv_decide(self.policy, self.kv, signal)
        if want is None:
            return
        want = min(max(int(want), 0), self.kv.max_available_rung())
        if want == self.kv.rung:
            return
        try:
            self.kv.to_rung(want)
        except SWITCH_FAILURES as e:
            self.stats.kv_switch_failures += 1
            self.stats.last_failure = str(e)
            return
        self.stats.kv_switches += 1

    def _kv_layers(self) -> int:
        """Attention layers whose K/V the cache holds, from one
        ``make_cache`` probe: ``num_layers`` for a transformer, the shared
        block's applications for the hybrid, 0 for a pure SSM stack."""
        if self._kv_layer_count is None:
            probe = self.model.make_cache(1, 1)
            self._kv_layer_count = probe["k"].shape[0] if "k" in probe else 0
        return self._kv_layer_count

    def kv_bytes_per_seq(self, rung: Optional[int] = None) -> int:
        """Cache bytes ONE sequence of ``max_len`` positions costs: the
        nested cost at ``rung`` (default: the cache's rung) with a nested
        cache, the dense compute-dtype cost otherwise (metadata only); 0
        where the cache holds no K/V."""
        L = self._kv_layers()
        if not L:
            return 0
        if self.kv is None:
            per_tok = dense_kv_bytes_per_token(
                L, self.cfg.num_kv_heads, self.cfg.head_dim,
                torch_dtype(self.cfg.compute_dtype).itemsize)
        else:
            per_tok = kv_bytes_per_token(
                self.kv.config, self.kv.rung if rung is None else int(rung),
                L, self.cfg.num_kv_heads, self.cfg.head_dim)
        return per_tok * self.max_len

    def kv_admissible_batch(self, memory_budget_bytes: Optional[int]) -> int:
        """Largest batch whose cache fits beside the current weight
        residency under the budget (at least 1; None = no constraint)."""
        if memory_budget_bytes is None:
            return self.max_batch
        per_seq = self.kv_bytes_per_seq()
        if per_seq <= 0:
            return self.max_batch
        free = memory_budget_bytes - self.store.resident_bytes()
        return max(1, min(self.max_batch, free // per_seq))

    def _kv_ingest(self, cache, S: int) -> None:
        """Quantize the prompt region of a re-homed cache into nested pages
        and render them back into it at the cache's rung (in place).  The
        partial tail page and every decode position stay dense."""
        if self.kv is None or "k" not in cache:
            return
        n = self.kv.ingest(cache["k"][:, :, :S], cache["v"][:, :, :S])
        if not n:
            return
        self.stats.kv_pages += n
        kq, vq = self.kv.render()
        span = kq.shape[2]
        cache["k"][:, :, :span] = kq.to(cache["k"].dtype)
        cache["v"][:, :, :span] = vq.to(cache["v"].dtype)

    def _kv_rewind(self, pos: int) -> None:
        """Retire the nested pages a rewind to ``pos`` invalidates, fetching
        nothing (no-op without a nested cache)."""
        if self.kv is not None:
            self.kv.rewind(pos)

    # -- serving -----------------------------------------------------------
    def generate(self, requests: List[Request],
                 memory_budget_bytes: Optional[int] = None, *,
                 queue_depth: Optional[int] = None,
                 backlog_age_s: float = 0.0,
                 speculate=None) -> List[Request]:
        """Greedy-decode a batch of requests at the rung the policy picks:
        left-padded prefill, the cache re-homed into a ``max_len`` buffer,
        then one decode step per new token (argmax).  ``speculate`` (an int
        ``k`` or a :class:`SpecConfig`) decodes self-speculatively instead
        (:class:`SpeculativeDecoder`), with the same output tokens.  Either
        way ``last_profile`` records what was dispatched."""
        if len(requests) > self.max_batch:
            raise ValueError(f"batch of {len(requests)} exceeds "
                             f"max_batch={self.max_batch}")
        spec = None
        if speculate:
            spec = (speculate if isinstance(speculate, SpecConfig)
                    else SpecConfig(k=int(speculate)))
            if spec.k < 1:
                raise ValueError(f"speculate needs k >= 1, got {spec.k}")
            if self.model.decode_chunk is None:
                raise NotImplementedError(
                    f"speculative decoding needs a chunked verify pass; "
                    f"family {self.cfg.family!r} has none")
        self.ensure_mode(memory_budget_bytes,
                         queue_depth=len(requests) if queue_depth is None else queue_depth,
                         backlog_age_s=backlog_age_s)
        params = self._params
        B = len(requests)
        S = max(len(r.prompt) for r in requests)
        n_steps = max(r.max_new_tokens for r in requests)
        if S + n_steps > self.max_len:
            raise ValueError(f"prompt {S} + {n_steps} new tokens exceeds "
                             f"max_len={self.max_len}")
        if spec is not None and S + n_steps + spec.k > self.max_len:
            raise ValueError(f"speculative decode can write up to prompt+new+k = "
                             f"{S + n_steps + spec.k} cache positions; max_len="
                             f"{self.max_len} is too small")
        toks = np.zeros((B, S), np.int64)
        for i, r in enumerate(requests):
            toks[i, S - len(r.prompt):] = r.prompt            # left-pad
        logits, cache = self.model.prefill(
            params, {"tokens": torch.from_numpy(toks).to(self.device)})
        self.stats.prefills += 1
        # re-home the prefill cache into a max_len buffer: K/V along their
        # position axis, a state and conv buffer as they are
        full = self.model.make_cache(B, self.max_len,
                                     dtype=torch_dtype(self.cfg.compute_dtype))
        for key, v in cache.items():
            if key in ("k", "v") and v.shape[-3] == S:
                full[key][:, :, :S] = v
            else:
                full[key] = v
        cache = full
        self._kv_ingest(cache, S)
        next_tok = logits[:, -1, :].argmax(dim=-1)[:, None]
        if spec is not None:
            SpeculativeDecoder(self, spec).decode(requests, params, cache, next_tok, pos=S)
            return requests
        for _ in range(n_steps):
            host = next_tok[:, 0].tolist()
            for i, r in enumerate(requests):
                if len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(int(host[i]))
            logits, cache = self.model.decode_step(params, {"tokens": next_tok}, cache)
            self.stats.decode_steps += 1
            next_tok = logits[:, -1, :].argmax(dim=-1)[:, None]
        self.last_profile = DecodeProfile(steps=n_steps,
                                          verify_bytes=self.store.resident_bytes())
        return requests


class SpeculativeDecoder:
    """Draft/verify rounds over the nesting ladder: the part-bit rung is a
    prefix of the streams resident for the full-bit rung, so the draft
    model costs no second model and no extra memory, and the one cache
    serves both phases (draft K/V at a drafted position is overwritten by
    the verify chunk before any later query reads it).

    One round from cache position ``pos`` with pending token ``t``:
    k greedy decode steps with the draft-stamped params give d_1..d_k;
    rewind to ``pos`` and score [t, d_1..d_k] in ONE verify chunk; per row
    the longest prefix of drafts matching the verify argmaxes, the batch
    taking the minimum m over live real rows; emit d_1..d_m and the verify
    argmax at m, and resume at ``pos + m + 1``.  The verify chunk gives
    every position bit for bit the logits of a sequential decode step
    (``Model.decode_chunk``), and every emitted token is a verify argmax or
    a draft equal to one, so the output is the plain greedy output."""

    def __init__(self, engine: ServeEngine, spec: SpecConfig):
        self.engine = engine
        self.spec = spec
        self.draft_rungs = engine._draft_rungs(spec)
        self.draft_params = engine.store.params_for(self.draft_rungs)
        self.draft_bytes = engine.store.assignment_resident_bytes(
            RungAssignment(default=0, exact=tuple(self.draft_rungs.items())))

    def decode(self, requests: List[Request], params, cache, first_tok,
               pos: int) -> None:
        eng, k = self.engine, self.spec.k
        model = eng.model
        verify_bytes = eng.store.resident_bytes()
        first = first_tok[:, 0].tolist()
        for i, r in enumerate(requests):
            if len(r.out_tokens) < r.max_new_tokens:
                r.out_tokens.append(int(first[i]))
        t_last = first_tok                       # emitted, not yet in the cache
        rounds = draft_steps = drafted = accepted = 0

        def live(r):
            return len(r.out_tokens) < r.max_new_tokens

        while any(live(r) for r in requests):
            # 1. draft: k greedy steps at the draft rung on the shared cache
            cur = t_last
            drafts = []
            for _ in range(k):
                logits, cache = model.decode_step(self.draft_params, {"tokens": cur}, cache)
                cur = logits[:, -1, :].argmax(dim=-1)[:, None]
                drafts.append(cur)
            draft_steps += k
            d = torch.cat(drafts, dim=1)                    # (B, k)
            # 2. verify: retire the nested pages past pos (fetching nothing),
            # rewind, and score [t, d_1..d_k] in one full-residency chunk
            eng._kv_rewind(pos)
            cache["pos"] = pos
            vlogits, cache = model.decode_chunk(
                params, {"tokens": torch.cat([t_last, d], dim=1)}, cache)
            rounds += 1
            vnext = vlogits.argmax(dim=-1)                  # (B, k+1)
            # 3. accept the longest matching prefix, the minimum over the
            # rows still generating
            dn, vn = d.cpu().numpy(), vnext.cpu().numpy()
            match = dn == vn[:, :k]
            m_row = np.where(match.all(axis=1), k, match.argmin(axis=1))
            rows = [i for i, r in enumerate(requests) if live(r)]
            m = int(min(m_row[i] for i in rows))
            n_real = sum(1 for i in rows if requests[i].uid >= 0)
            drafted += k * n_real
            accepted += m * n_real
            for i, r in enumerate(requests):
                for t in [*dn[i, :m], vn[i, m]]:
                    if live(r):
                        r.out_tokens.append(int(t))
            t_last = vnext[:, m:m + 1]
            pos += m + 1
            cache["pos"] = pos
        stats = eng.stats
        stats.spec_rounds += rounds
        stats.spec_draft_steps += draft_steps
        stats.spec_drafted += drafted
        stats.spec_accepted += accepted
        stats.spec_rejected += drafted - accepted
        eng.last_profile = DecodeProfile(
            draft_steps=draft_steps, verify_passes=rounds, draft_bytes=self.draft_bytes,
            verify_bytes=verify_bytes, drafted=drafted, accepted=accepted)
