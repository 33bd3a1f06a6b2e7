"""Serving engine: batched requests, prefill/greedy decode, rung switching;
the part of ``repro/serving/engine.py`` the main path runs (``Request``,
``EngineStats``, ``ServeEngine.__init__``/``ensure_mode``/``generate``).

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
from ..core.switching import NestQuantStore
from ..device import torch_dtype
from ..models.model import Model, make_model
from ..storage.pager import PagerError
from .policies import BudgetPolicy, RungPolicy, SignalTracker

# a failed rung switch rolls back in the store, so the engine keeps
# serving at the rung it already has
SWITCH_FAILURES = (PagerError,)

MODE_HISTORY_CAP = 512


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)


@dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    switches: int = 0
    switch_failures: int = 0
    last_failure: str = ""
    mode_history: deque = field(default_factory=lambda: deque(maxlen=MODE_HISTORY_CAP))
    mode_counts: Dict[str, int] = field(default_factory=dict)

    def record_mode(self, mode: str):
        self.mode_history.append(mode)
        self.mode_counts[mode] = self.mode_counts.get(mode, 0) + 1


class ServeEngine:
    """Greedy batched serving of a nested model held by ``store``; runs
    on the store's device."""

    def __init__(self, cfg: ModelConfig, store: NestQuantStore,
                 max_batch: int = 8, max_len: int = 128,
                 policy: Optional[RungPolicy] = None, *,
                 model: Optional[Model] = None, kv=None):
        if kv is not None:
            raise NotImplementedError("the nested KV cache is not ported yet "
                                      "(ROADMAP.md queue 1, item 10)")
        self.cfg = cfg
        self.store = store
        self.device = store.device
        self.model = model if model is not None else make_model(cfg, device=self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.policy = policy if policy is not None else BudgetPolicy()
        self.stats = EngineStats()
        self._tracker = SignalTracker()
        self._params = None

    # -- switching ---------------------------------------------------------
    def ensure_mode(self, memory_budget_bytes: Optional[int] = None,
                    queue_depth: int = 0, backlog_age_s: float = 0.0):
        """Let the policy pick the residency for the current signal and
        flip it; a switch that fails rolls back in the store and the
        engine keeps serving at the current residency."""
        signal = self._tracker.signal(
            memory_budget_bytes=memory_budget_bytes, queue_depth=queue_depth,
            backlog_age_s=backlog_age_s,
            available_rung=self.store.max_available_rung())
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

    # -- serving -----------------------------------------------------------
    def generate(self, requests: List[Request],
                 memory_budget_bytes: Optional[int] = None, *,
                 queue_depth: Optional[int] = None,
                 backlog_age_s: float = 0.0,
                 speculate=None) -> List[Request]:
        """Greedy-decode a batch of requests at the rung the policy picks:
        left-padded prefill, the cache re-homed into a ``max_len`` buffer,
        then one decode step per new token (argmax)."""
        if speculate:
            raise NotImplementedError("speculative decoding is not ported yet "
                                      "(ROADMAP.md queue 1, item 9)")
        if len(requests) > self.max_batch:
            raise ValueError(f"batch of {len(requests)} exceeds "
                             f"max_batch={self.max_batch}")
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
        toks = np.zeros((B, S), np.int64)
        for i, r in enumerate(requests):
            toks[i, S - len(r.prompt):] = r.prompt            # left-pad
        logits, cache = self.model.prefill(
            params, {"tokens": torch.from_numpy(toks).to(self.device)})
        self.stats.prefills += 1
        # re-home the prefill cache into a max_len buffer
        full = self.model.make_cache(B, self.max_len,
                                     dtype=torch_dtype(self.cfg.compute_dtype))
        full["k"][:, :, :S] = cache["k"]
        full["v"][:, :, :S] = cache["v"]
        full["pos"] = cache["pos"]
        cache = full
        next_tok = logits[:, -1, :].argmax(dim=-1)[:, None]
        for _ in range(n_steps):
            host = next_tok[:, 0].tolist()
            for i, r in enumerate(requests):
                if len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(int(host[i]))
            logits, cache = self.model.decode_step(params, {"tokens": next_tok}, cache)
            self.stats.decode_steps += 1
            next_tok = logits[:, -1, :].argmax(dim=-1)[:, None]
        return requests
