"""Port parity of the nested KV cache and of ``ServeEngine(kv=...)``.

* ``_quantize_kv`` streams are the JAX package's int32 words bit for bit
  and its scales exactly; ``_render_kv`` lands exactly on the raw ladder's
  dequant at every rung of every <= 4-rung chain of tests/test_kv_cache.py
  (the expectation built in f32).
* A ``NestedKVCache`` switch walk gives the reference's ledger events;
  ``rewind`` fetches nothing.
* ``ServeEngine(kv=...)`` on reduced qwen2 with prompts over 1024 tokens
  (the blockwise long-prefill branch) gives the JAX engine's tokens, KV
  counters and ledger events over a load-driven KV walk 2 -> 1 -> 0 -> 1
  -> 2, and the long prefill's logits within 1e-4.
"""
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.decompose import normalize_bits
from repro.serving import kv_cache as jkv
from repro.serving import policies as jpol
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core.switching import NestQuantStore
from repro_torch.serving import (KVCacheConfig, LoadAdaptivePolicy, NestedKVCache,
                                 Request, ServeEngine, dense_kv_bytes_per_token,
                                 kv_bytes_per_token, kv_stream_widths)
from repro_torch.serving.kv_cache import _quantize_kv, _render_kv
from torch_parity import j2n, jax_tree_to_torch, reduced_qwen2, t2n

jsw = importlib.import_module("repro.core.switching")

PAGE = 4


def _all_chains(n, max_len=4):
    """Every rung chain topping out at n with lower rungs in [2, n)."""
    for r in range(1, max_len):
        for combo in itertools.combinations(range(2, n), r):
            yield tuple(sorted(combo)) + (n,)


def _slab_covering_all_codes(n):
    """A (1, 1, S, 1, 8) slab whose codes sweep all signed INT-n values
    (the reference test's construction: a sentinel pins each amax),
    followed by random positions."""
    lo, hi = -(2 ** (n - 1)), 2 ** (n - 1) - 1
    codes = np.arange(lo, hi + 1, dtype=np.int32)
    pos = int(np.ceil(len(codes) / 7)) * PAGE
    grid = np.zeros((pos, 8), np.float32)
    grid[:, 0] = hi
    grid[:, 1:].reshape(-1)[:len(codes)] = codes
    rand = np.random.default_rng(n).normal(size=(3 * PAGE, 8)).astype(np.float32)
    return np.concatenate([grid, rand]).reshape(1, 1, pos + 3 * PAGE, 1, 8)


def _ladder_codes(codes, bits, rung):
    """The raw rtn ladder in numpy: split the codes down every level, climb
    back up to ``rung`` (no packing)."""
    rng_ = lambda b: (-(2 ** (b - 1)), 2 ** (b - 1) - 1)  # noqa: E731
    cur, deltas = codes.astype(np.int64), []
    for b_hi, b_lo in zip(reversed(bits[1:]), reversed(bits[:-1])):
        gap = b_hi - b_lo
        hi = np.clip(np.round(cur / 2 ** gap), *rng_(b_lo)).astype(np.int64)
        deltas.insert(0, np.clip(cur - hi * 2 ** gap, *rng_(gap + 1)))
        cur = hi
    for i in range(rung):
        cur = np.clip(cur * 2 ** (bits[i + 1] - bits[i]) + deltas[i], *rng_(bits[i + 1]))
    return cur


# the ladders of the serving path and the kernel tests, held word for word
# against the JAX package's jitted quantization (one compile each)
JAX_CHAINS = {(4, 8), (4, 6, 8), (3, 5, 6, 8), (3, 5, 8), (4, 6), (2, 4, 6), (2, 3, 5, 6)}


@pytest.mark.parametrize("n", [8, 6])
def test_quantize_bit_exact_and_render_exact_at_every_rung_of_every_chain(n):
    slab = _slab_covering_all_codes(n)
    lo, hi = -(2 ** (n - 1)), 2 ** (n - 1) - 1
    for chain in _all_chains(n):
        bits = normalize_bits(chain)
        streams, scale = _quantize_kv(torch.from_numpy(slab), bits=bits, page=PAGE,
                                      rounding="rtn")
        if bits in JAX_CHAINS:
            jstreams, jscale = jkv._quantize_kv(jnp.asarray(slab), bits=bits, page=PAGE,
                                                rounding="rtn")
            assert len(streams) == len(jstreams)
            for s, js in zip(streams, jstreams):
                assert s.dtype == torch.int32
                np.testing.assert_array_equal(t2n(s), np.asarray(js), err_msg=f"{bits}")
            np.testing.assert_array_equal(t2n(scale), np.asarray(jscale))
        # the expectation, built in f32 from the raw ladder
        codes = np.clip(np.round(slab / t2n(scale)), lo, hi).astype(np.int32)
        for r in range(len(bits)):
            got = _render_kv(streams[:1 + r], scale, bits=bits, page=PAGE, rung=r)
            want = (_ladder_codes(codes, bits, r).astype(np.float32) * t2n(scale)
                    * np.float32(2.0 ** (bits[-1] - bits[r])))
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(t2n(got), want, err_msg=f"chain {bits} rung {r}")
        np.testing.assert_array_equal(_ladder_codes(codes, bits, len(bits) - 1), codes)


# ---------------------------------------------------------------------------
# the paged cache: ledger, render, rewind against the reference cache
# ---------------------------------------------------------------------------
@pytest.fixture()
def caches():
    rng = np.random.default_rng(0)
    k = rng.normal(size=(2, 2, 4 * PAGE + 3, 2, 8)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    jc = jkv.NestedKVCache(jkv.KVCacheConfig(bits=(3, 5, 8), page=PAGE))
    pc = NestedKVCache(KVCacheConfig(bits=(3, 5, 8), page=PAGE))
    assert jc.ingest(jnp.asarray(k), jnp.asarray(v)) == pc.ingest(
        torch.from_numpy(k), torch.from_numpy(v)) == 4
    return jc, pc


def test_switch_walk_ledgers_like_the_reference(caches):
    jc, pc = caches
    for target in (0, 2, 1, 0, 2):
        jc.to_rung(target)
        pc.to_rung(target)
        assert pc.rung == jc.rung == target
        assert pc.resident_bytes() == jc.resident_bytes()
    assert pc.ledger.events == jc.ledger.events
    assert pc.expected_events == jc.expected_events
    assert [e[:2] for e in pc.ledger.events] == [(2, 1), (1, 0), (0, 1), (1, 2), (2, 1),
                                                 (1, 0), (0, 1), (1, 2)]
    for (f, t, pin, pout), exp in zip(pc.ledger.events, pc.expected_events):
        assert (f, t, pin, pout) == exp
        assert pin + pout == pc.delta_bytes(min(f, t))
    assert pc.ledger.page_in_bytes == pc.ledger.page_out_bytes
    for r in range(3):
        assert pc.rung_resident_bytes(r) == jc.rung_resident_bytes(r)
        for a, b in zip(pc.render(r), jc.render(r)):
            np.testing.assert_array_equal(t2n(a), np.asarray(b))
    assert pc.max_available_rung() == jc.max_available_rung() == 2


def test_render_never_fetches_and_rewind_fetches_nothing(caches):
    _, pc = caches

    class CountingPager:
        def __init__(self, inner):
            self.inner, self.fetches = inner, 0

        def fetch(self, path, level):
            self.fetches += 1
            return self.inner.fetch(path, level)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    pc.to_rung(1)
    with pytest.raises(ValueError, match="never fetches"):
        pc.render(2)
    pc.to_rung(0)
    pc.pager = CountingPager(pc.pager)
    assert pc.rewind(2 * PAGE) == 2
    assert pc.pager.fetches == 0
    assert [pg.index for pg in pc.pages] == [0, 1] and pc.rewound_pages == 2
    assert pc.render()[0].shape[2] == 2 * PAGE
    pc.to_rung(2)                       # the surviving pages page back in
    assert pc.pager.fetches == 2 * 2 * 2


def test_byte_metadata_matches_the_reference():
    for bits, page in (((3, 5, 8), 4), ((4, 6, 8), 16), ((4, 8), 32)):
        for rung in range(len(bits)):
            assert kv_bytes_per_token(KVCacheConfig(bits=bits, page=page), rung, 28, 2, 128) == \
                jkv.kv_bytes_per_token(jkv.KVCacheConfig(bits=bits, page=page), rung, 28, 2, 128)
        assert kv_stream_widths(bits) == jkv.kv_stream_widths(bits)
    assert dense_kv_bytes_per_token(28, 2, 128) == jkv.dense_kv_bytes_per_token(28, 2, 128)


# ---------------------------------------------------------------------------
# the engine with a nested cache: long prompts, a load-driven KV walk
# ---------------------------------------------------------------------------
PROMPT_LENS = (1536, 1529)          # S = 1536 > 1024: the blockwise branch
NEW_TOKENS = 3
MAX_LEN = 1536 + NEW_TOKENS
QUEUE = (0, 8, 8, 0, 0)             # KV rung 2 -> 2, 1, 0, 1, 2


def _prompts(phase, vocab):
    rng = np.random.default_rng(40 + phase)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def kv_engines():
    jcfg, _, nested = reduced_qwen2()
    jstore = jsw.NestQuantStore(nested, mode="full", dtype=jnp.float32)
    pstore = NestQuantStore(jax_tree_to_torch(nested), mode="full", device="cpu")
    cfg = get_config("qwen2-1.5b").reduced()
    jeng = JaxEngine(jcfg, jstore, max_batch=2, max_len=MAX_LEN,
                     policy=jpol.LoadAdaptivePolicy(high_depth=8, low_depth=0),
                     kv=jkv.KVCacheConfig(bits=(4, 6, 8), page=16, rounding="rtn"))
    peng = ServeEngine(cfg, pstore, max_batch=2, max_len=MAX_LEN,
                       policy=LoadAdaptivePolicy(high_depth=8, low_depth=0),
                       kv=KVCacheConfig(bits=(4, 6, 8), page=16, rounding="rtn"))
    return jeng, peng


def test_engine_kv_walk_token_identical_with_exact_ledgers(kv_engines):
    jeng, peng = kv_engines
    rungs = []
    for phase, depth in enumerate(QUEUE):
        prompts = _prompts(phase, peng.cfg.vocab_size)
        jreqs = [JaxRequest(i, p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
        preqs = [Request(i, p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
        jeng.generate(jreqs, queue_depth=depth)
        peng.generate(preqs, queue_depth=depth)
        assert peng.kv.rung == jeng.kv.rung and peng.store.rung == jeng.store.rung
        assert [r.out_tokens for r in preqs] == [r.out_tokens for r in jreqs], phase
        rungs.append(peng.kv.rung)
        assert len(peng.kv.pages) == 1536 // 16
        assert peng.kv_bytes_per_seq() == jeng.kv_bytes_per_seq()
    assert rungs == [2, 1, 0, 1, 2]
    assert peng.kv.ledger.events == jeng.kv.ledger.events
    assert peng.kv.expected_events == jeng.kv.expected_events
    assert [e[:2] for e in peng.kv.ledger.events] == [(2, 1), (1, 0), (0, 1), (1, 2)]
    assert peng.store.ledger.events == jeng.store.ledger.events
    for name in ("kv_switches", "kv_switch_failures", "kv_pages", "switches", "prefills",
                 "decode_steps"):
        assert getattr(peng.stats, name) == getattr(jeng.stats, name), name
    assert peng.stats.kv_pages == 5 * 96
    budget = peng.store.resident_bytes() + 3 * peng.kv_bytes_per_seq(0)
    assert peng.kv_admissible_batch(budget) == jeng.kv_admissible_batch(budget)


def test_long_prefill_logits_within_1e4(kv_engines):
    """The long prompt's prefill through the port's plain blockwise path
    against the JAX model's, on the same nested tree (f32)."""
    jeng, peng = kv_engines
    toks = np.stack([np.pad(p, (1536 - len(p), 0)) for p in _prompts(9, 256)])
    jl, jcache = jax.jit(jeng.model.prefill)(jeng.store.params(), {"tokens": jnp.asarray(toks)})
    pl, pcache = peng.model.prefill(peng.store.params(),
                                    {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(t2n(pl), j2n(jl), rtol=1e-4, atol=1e-4 * np.abs(j2n(jl)).max())
    np.testing.assert_allclose(t2n(pcache["k"]), j2n(jcache["k"]), rtol=1e-4, atol=1e-4)


def test_engine_takes_a_cache_or_a_config_only(kv_engines):
    _, peng = kv_engines
    kv = NestedKVCache(KVCacheConfig())
    assert ServeEngine(peng.cfg, peng.store, kv=kv).kv is kv
    with pytest.raises(TypeError):
        ServeEngine(peng.cfg, peng.store, kv=object())


def test_cache_over_wrapper_pagers_rolls_back_and_fences_like_the_reference():
    """A cache over a ResilientPager(ChaosPager(...)) deposits into the
    InMemoryPager under the wrappers (the ``.inner`` walk) at paths under its
    ``tag``, records into the ledger it was given, and a corrupted upgrade
    rolls back: rung, ledger and rendering as before, the stream quarantined
    (the ceiling drops); the healed link upgrades with the JAX cache's exact
    ledger.  A pager chain with no ``put`` raises."""
    from repro.storage import pager as jpager
    from repro_torch.core.switching import SwitchLedger
    from repro_torch.storage import (ChaosPager, CorruptStreamError, InMemoryPager,
                                     ResilientPager, RetryPolicy)

    rng = np.random.default_rng(3)
    k = rng.normal(size=(2, 1, 2 * PAGE, 2, 8)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    backing, ledger = InMemoryPager({}), SwitchLedger()
    pc = NestedKVCache(KVCacheConfig(bits=(4, 8), page=PAGE), pager=ResilientPager(
        ChaosPager(backing, seed=0)), ledger=ledger, tag="kv7")
    jc = jkv.NestedKVCache(jkv.KVCacheConfig(bits=(4, 8), page=PAGE))
    assert pc.ingest(torch.from_numpy(k), torch.from_numpy(v)) == \
        jc.ingest(jnp.asarray(k), jnp.asarray(v)) == 2
    assert sorted(backing._streams) == [(f"kv7/g1/p{i}/{t}", 0) for i in (0, 1)
                                        for t in ("k", "v")]
    pc.to_rung(0)
    jc.to_rung(0)
    assert pc.ledger is ledger and ledger.events == jc.ledger.events
    before, events = pc.render(), list(ledger.events)
    pc.pager = ResilientPager(ChaosPager(backing, seed=0, p_corrupt=1.0),
                              RetryPolicy(max_attempts=2, backoff_base_s=0.0, jitter=0.0,
                                          quarantine_after=1))
    jc.pager = jpager.ResilientPager(
        jpager.ChaosPager(jc.pager, seed=0, p_corrupt=1.0),
        jpager.RetryPolicy(max_attempts=2, backoff_base_s=0.0, jitter=0.0,
                           quarantine_after=1))
    for cache, err in ((pc, CorruptStreamError), (jc, jpager.CorruptStreamError)):
        with pytest.raises(err):
            cache.to_rung(1)
        assert cache.rung == 0 and cache.max_available_rung() == 0
    assert ledger.events == events == jc.ledger.events
    for a, b in zip(before, pc.render()):
        assert torch.equal(a, b)
    pc.pager, jc.pager = backing, jc.pager.inner.inner
    assert pc.max_available_rung() == 1
    pc.to_rung(1)
    jc.to_rung(1)
    assert ledger.events == jc.ledger.events
    assert ledger.events[-1] == (0, 1, 2 * len(pc.pages) * pc.stream_bytes(1), 0)
    pc.rewind(0)
    assert backing._streams == {}                    # retired through the walk too

    class NoPut:
        def fetch(self, path, level):
            raise AssertionError("never reached")

    with pytest.raises(TypeError, match="put"):
        NestedKVCache(KVCacheConfig(bits=(4, 8), page=PAGE), pager=ChaosPager(NoPut())
                      ).ingest(torch.from_numpy(k), torch.from_numpy(v))
