"""Deterministic synthetic LM data; counterpart of
``repro/data/pipeline.py``, numpy only.

Stateless: the batch of any step is regenerated from (seed, step, process)
alone, which is what makes a resumed run bitwise equal to an unbroken one.
Each process draws its own rows (``process_index`` of ``process_count``);
by default these are ``torch.distributed``'s rank and world size when it is
initialised, else 0 and 1.  Batches are numpy arrays, bit for bit the
reference's for every (seed, step, process).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    input_kind: str = "tokens"      # tokens | embeddings
    d_model: int = 0                # for embeddings stubs


def _process() -> tuple:
    """(rank, world size) of ``torch.distributed`` when initialised, else
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SyntheticLM:
    """step -> {inputs, labels}; labels are the next-token shift of a
    deterministic Markov-ish token stream (so a model can learn it)."""

    def __init__(self, cfg: DataConfig,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.cfg = cfg
        rank, world = _process()
        self.pi = rank if process_index is None else process_index
        self.pc = world if process_count is None else process_count
        assert cfg.global_batch % self.pc == 0
        self.local_batch = cfg.global_batch // self.pc

    def _tokens(self, step: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([c.seed, step, self.pi]))
        # autoregressive stream: t_{i+1} = (31 * t_i + 17) mod V with
        # probability 0.8, else uniform - so next-token loss is learnable
        B, S, V = self.local_batch, c.seq_len, c.vocab_size
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, size=B)
        rand = rng.integers(0, V, size=(B, S))
        mix = rng.random((B, S)) < 0.8
        for j in range(S):
            toks[:, j + 1] = np.where(mix[:, j], (toks[:, j] * 31 + 17) % V, rand[:, j])
        return toks.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        toks = self._tokens(step)
        out: Dict[str, np.ndarray] = {"labels": toks[:, 1:]}
        if c.input_kind == "tokens":
            out["tokens"] = toks[:, :-1]
        else:
            rng = np.random.default_rng(np.random.SeedSequence([c.seed + 7, step, self.pi]))
            out["embeddings"] = rng.standard_normal(
                (self.local_batch, c.seq_len, c.d_model), dtype=np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
