"""Port parity of the fault tier: the error taxonomy, seeded fault
injection (``ChaosPager``) whose timelines - outcomes, ``faults`` counts,
flipped bits and clocks - equal the JAX package's for the same seeds, the
hardened fetch path (``ResilientPager``: retry, CRC-32 re-verification,
timeout, quarantine), transactional switches that roll back leaving every
resident stream bit-identical, and degraded-mode serving that completes
every request through a fault storm under ``FailureAwarePolicy``; each
mirrors a test of tests/test_chaos.py."""
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_ledger_matches_residency, assert_switch_records_exact
from repro.core import QuantRecipe as JaxRecipe
from repro.core import quantize as jax_quantize
from repro.serving import FailureAwarePolicy as JaxFailure
from repro.serving import HysteresisPolicy as JaxHysteresis
from repro.serving import LoadAdaptivePolicy as JaxLoad
from repro.serving import ServeEngine as JaxEngine
from repro.serving import scheduler as jsched
from repro.storage import pager as jpager
from repro_torch.configs import get_config
from repro_torch.core.switching import NestQuantStore, RungAssignment
from repro_torch.serving import (FailureAwarePolicy, HysteresisPolicy, LoadAdaptivePolicy,
                                 Scheduler, ServeEngine)
from repro_torch.storage import (ArtifactError, ChaosPager, CorruptStreamError,
                                 InMemoryPager, Outage, PagerError, ResilientPager,
                                 RetryPolicy, ThrottledPager, TransientPagerError,
                                 VirtualClock, load_store, save_artifact)
from torch_parity import jax_tree_to_torch, reduced_qwen2

jsw = importlib.import_module("repro.core.switching")


@pytest.fixture(scope="module")
def trees():
    """A small (8, 6, 4) tree quantized by the JAX package, and the port's
    copy of it."""
    params = {"a": {"w": jax.random.normal(jax.random.PRNGKey(0), (128, 64))},
              "b": {"w": jax.random.normal(jax.random.PRNGKey(1), (96, 64))}}
    nested = jax_quantize(params, JaxRecipe(bits=(8, 6, 4)))
    return nested, jax_tree_to_torch(nested)


class ScriptedPager:
    """Consumes ``script`` in fetch order ('ok' | 'transient' | 'corrupt');
    'corrupt' flips bit 0 of element 0 of a COPY, so a retry heals."""

    def __init__(self, inner, script):
        self.inner = inner
        self.script = list(script)
        self.calls = 0

    def fetch(self, path, level):
        self.calls += 1
        op = self.script.pop(0) if self.script else "ok"
        if op == "transient":
            raise TransientPagerError("scripted transient failure")
        words = self.inner.fetch(path, level)
        if op == "corrupt":
            words = words.clone()
            words.reshape(-1)[0] ^= 1
        return words

    def evict(self, path, level):
        self.inner.evict(path, level)

    def resident_bytes(self):
        return self.inner.resident_bytes()

    def available(self, path, level):
        return self.inner.available(path, level)

    def expected_crc(self, path, level):
        return self.inner.expected_crc(path, level)


def _a_stream(trees):
    """The port's pager over the tree and some (path, level) it holds."""
    pager = InMemoryPager.from_tree(trees[1])
    return pager, next(iter(pager._streams))


# ---------------------------------------------------------------------------
# taxonomy and clocks
# ---------------------------------------------------------------------------
def test_error_taxonomy():
    assert issubclass(TransientPagerError, PagerError)
    assert issubclass(CorruptStreamError, PagerError)
    assert issubclass(CorruptStreamError, ArtifactError)
    assert issubclass(PagerError, RuntimeError)


def test_virtual_clock_is_deterministic():
    clk = VirtualClock()
    assert clk.now() == 0.0
    clk.sleep(0.5)
    clk.set(0.2)
    assert clk.now() == 0.5
    clk.set(1.5)
    assert clk.now() == 1.5 and clk.slept_s == 0.5
    clk.sleep(-1.0)
    assert clk.now() == 1.5


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------
def _storm(mod, inner, path, level, seed):
    pager = mod.ChaosPager(inner, seed=seed, p_transient=0.4, p_corrupt=0.3,
                           p_stall=0.3, stall_s=0.1)
    outcomes = []
    for _ in range(40):
        try:
            words = pager.fetch(path, level)
            outcomes.append(np.asarray(words.cpu() if torch.is_tensor(words) else words)
                            .tobytes())
        except mod.TransientPagerError:
            outcomes.append("transient")
    return outcomes, dict(pager.faults), pager.clock.now()


def test_chaos_schedule_replays_from_seed_as_the_reference(trees):
    """The same seed gives the same outcomes - down to which bit of which
    byte a corruption flipped - the same fault counts and the same clock as
    the JAX package's ChaosPager; another seed another timeline."""
    inner, (path, level) = _a_stream(trees)
    jinner = jpager.InMemoryPager.from_tree(trees[0])
    for seed in (3, 4):
        port = _storm(importlib.import_module("repro_torch.storage.pager"), inner, path,
                      level, seed)
        assert port == _storm(jpager, jinner, path, level, seed)
        assert port == _storm(importlib.import_module("repro_torch.storage.pager"), inner,
                              path, level, seed)
        assert port[1]["corrupt"] > 0 and port[1]["transient"] > 0
    assert _storm(jpager, jinner, path, level, 3) != _storm(jpager, jinner, path, level, 4)


def test_chaos_corruption_never_touches_the_source(trees):
    inner, (path, level) = _a_stream(trees)
    pager = ChaosPager(inner, seed=0, p_corrupt=1.0)
    pristine = inner.fetch(path, level).clone()
    corrupted = pager.fetch(path, level)
    assert pager.faults["corrupt"] == 1 and not torch.equal(corrupted, pristine)
    diff = np.bitwise_xor(corrupted.numpy().view(np.uint8), pristine.numpy().view(np.uint8))
    assert np.unpackbits(diff).sum() == 1
    assert torch.equal(inner.fetch(path, level), pristine)
    jcor = jpager.ChaosPager(jpager.InMemoryPager.from_tree(trees[0]), seed=0,
                             p_corrupt=1.0).fetch(path, level)
    assert np.array_equal(corrupted.numpy(), np.asarray(jcor))


def test_chaos_outage_window_opens_and_heals(trees):
    inner, (path, level) = _a_stream(trees)
    clk = VirtualClock()
    pager = ChaosPager(inner, seed=0, clock=clk, outages=(Outage(1.0, 2.0, level=level),))
    assert pager.available(path, level)
    clk.set(1.5)
    assert not pager.available(path, level)
    with pytest.raises(TransientPagerError, match="outage"):
        pager.fetch(path, level)
    assert pager.faults["outage"] == 1
    clk.set(2.0)
    assert pager.available(path, level)
    pager.fetch(path, level)
    assert Outage(0.0, 1.0, pattern=re.escape(path)).covers(path, level, 0.5)
    assert not Outage(0.0, 1.0, pattern="no such leaf").covers(path, level, 0.5)
    with pytest.raises(ValueError):
        Outage(2.0, 1.0)


# ---------------------------------------------------------------------------
# hardened fetch path
# ---------------------------------------------------------------------------
def test_resilient_retries_transient_then_succeeds(trees):
    inner, (path, level) = _a_stream(trees)
    want = inner.fetch(path, level).clone()
    pager = ResilientPager(ScriptedPager(inner, ["transient", "ok"]),
                           RetryPolicy(max_attempts=3, backoff_base_s=0.01))
    assert torch.equal(pager.fetch(path, level), want)
    h = pager.health[(path, level)]
    assert (pager.retries, h.failures, h.consecutive) == (1, 1, 0)


def test_resilient_crc_reverification_heals_corruption(trees):
    inner, (path, level) = _a_stream(trees)
    want = inner.fetch(path, level).clone()
    pager = ResilientPager(ScriptedPager(inner, ["corrupt", "ok"]),
                           RetryPolicy(max_attempts=3, backoff_base_s=0.01))
    assert torch.equal(pager.fetch(path, level), want)
    assert pager.health[(path, level)].corrupt == 1


def test_resilient_exhaustion_reraises_last_error(trees):
    inner, (path, level) = _a_stream(trees)
    pager = ResilientPager(ScriptedPager(inner, ["transient", "transient"]),
                           RetryPolicy(max_attempts=2, backoff_base_s=0.01,
                                       quarantine_after=5))
    with pytest.raises(TransientPagerError, match="scripted"):
        pager.fetch(path, level)
    pager = ResilientPager(ScriptedPager(inner, ["corrupt", "corrupt"]),
                           RetryPolicy(max_attempts=2, backoff_base_s=0.01,
                                       quarantine_after=5))
    with pytest.raises(CorruptStreamError, match="CRC-32"):
        pager.fetch(path, level)


def test_resilient_backoff_on_the_virtual_clock_equals_the_reference(trees):
    """Without jitter two backoffs sum exactly; with seeded jitter the
    clock reads what the JAX package's ResilientPager reads."""
    inner, (path, level) = _a_stream(trees)
    jinner = jpager.InMemoryPager.from_tree(trees[0])
    clk = VirtualClock()
    pager = ResilientPager(ScriptedPager(inner, ["transient", "transient", "ok"]),
                           RetryPolicy(max_attempts=4, backoff_base_s=0.1, backoff_factor=2.0,
                                       jitter=0.0, quarantine_after=5), clock=clk)
    pager.fetch(path, level)
    assert clk.now() == pytest.approx(0.3)
    clocks = []
    for mod, src in ((importlib.import_module("repro_torch.storage.pager"), inner),
                     (jpager, jinner)):
        clk = mod.VirtualClock()
        chaos = mod.ChaosPager(src, seed=2, p_transient=0.6, clock=clk)
        res = mod.ResilientPager(chaos, mod.RetryPolicy(max_attempts=6, quarantine_after=9),
                                 seed=7)
        for _ in range(5):
            try:
                res.fetch(path, level)
            except mod.TransientPagerError:
                pass
        h = res.health[(path, level)]
        clocks.append((clk.now(), res.retries, h.attempts, h.failures, dict(chaos.faults)))
    assert clocks[0] == clocks[1] and clocks[0][1] > 0


def test_resilient_stall_becomes_timeout(trees):
    inner, (path, level) = _a_stream(trees)
    clk = VirtualClock()
    chaos = ChaosPager(inner, seed=0, p_stall=1.0, stall_s=1.0, clock=clk)
    pager = ResilientPager(chaos, RetryPolicy(max_attempts=1, fetch_timeout_s=0.5))
    with pytest.raises(TransientPagerError, match="timeout"):
        pager.fetch(path, level)
    assert pager.health[(path, level)].timeouts == 1


def test_quarantine_fences_then_reprobes(trees):
    inner, (path, level) = _a_stream(trees)
    clk = VirtualClock()
    scripted = ScriptedPager(inner, ["transient"] * 2 + ["ok"])
    pager = ResilientPager(scripted, RetryPolicy(max_attempts=4, backoff_base_s=0.01,
                                                 quarantine_after=2, quarantine_s=5.0),
                           clock=clk)
    with pytest.raises(TransientPagerError):
        pager.fetch(path, level)
    assert pager.quarantines == 1 and (path, level) in pager.quarantined()
    assert not pager.available(path, level)
    calls = scripted.calls
    with pytest.raises(TransientPagerError, match="quarantined"):
        pager.fetch(path, level)
    assert scripted.calls == calls
    clk.sleep(5.0)
    assert pager.available(path, level) and (path, level) not in pager.quarantined()
    pager.fetch(path, level)


def test_filepager_corruption_carries_leaf_context(trees, tmp_path):
    path = str(tmp_path / "artifact")
    save_artifact(trees[1], path)
    raw = bytearray(open(os.path.join(path, "delta_0.seg"), "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(os.path.join(path, "delta_0.seg"), "wb").write(bytes(raw))
    store = load_store(path, mode="part", device="cpu")
    with pytest.raises(CorruptStreamError, match=r"leaf .* level \d+.*CRC-32") as ei:
        store.to_rung(2)
    assert "delta_0" in str(ei.value) and "expected 0x" in str(ei.value)


def test_throttled_pager_sleeps_on_injected_clock(trees):
    inner, (path, level) = _a_stream(trees)
    clk = VirtualClock()
    pager = ThrottledPager(inner, bandwidth_bytes_per_s=1e6, latency_s=0.25, sleep=True,
                           clock=clk)
    arr = pager.fetch(path, level)
    assert clk.now() == pytest.approx(0.25 + arr.numel() * arr.element_size() / 1e6)
    assert pager.simulated_seconds == pytest.approx(clk.now())
    assert ThrottledPager(inner).clock.now() > 0


# ---------------------------------------------------------------------------
# transactional switches
# ---------------------------------------------------------------------------
def _snapshot(store):
    return (store.rung, store.mode, tuple(sorted(store.leaf_rungs().items())),
            tuple(store.ledger.events), store.pager.resident_bytes())


def _streams(store):
    return [(p, leaf.w_base.clone(), tuple(None if d is None else d.clone()
                                           for d in leaf.deltas))
            for p, leaf in store.nested_leaves()]


def _same_streams(a, b):
    return all(p == q and torch.equal(w, v) and len(ds) == len(es) and all(
        (d is None and e is None) or (d is not None and e is not None and torch.equal(d, e))
        for d, e in zip(ds, es)) for (p, w, ds), (q, v, es) in zip(a, b))


def test_rollback_invariant_over_seeded_fault_schedules(trees):
    """25 seeded fault schedules x a rung walk each: every failed switch
    leaves the store - every resident stream, bit for bit - and the ledger
    as they were, every committed one ledgers exactly, and each seed's
    commit/fail sequence and fault counts equal the JAX package's."""
    committed = failed = 0
    for seed in range(25):
        outcomes = []
        for mod, sw, tree, kw in ((importlib.import_module("repro_torch.storage.pager"),
                                   None, trees[1], dict(device="cpu")),
                                  (jpager, jsw, trees[0], dict(dtype=jnp.float32))):
            pg = mod.ResilientPager(
                mod.ChaosPager(mod.InMemoryPager.from_tree(tree), seed=seed,
                               p_transient=0.25, p_corrupt=0.15),
                mod.RetryPolicy(max_attempts=1, backoff_base_s=0.0, jitter=0.0,
                                quarantine_after=10 ** 6), seed=seed)
            store = (sw.NestQuantStore if sw else NestQuantStore)(tree, mode="part",
                                                                  pager=pg, **kw)
            top = store.num_rungs - 1
            seq = []
            for target in (top, 0, 1, top, 0, top):
                pre = _snapshot(store)
                streams = _streams(store) if sw is None else None
                try:
                    store.to_rung(target)
                except mod.PagerError:
                    seq.append("failed")
                    assert _snapshot(store) == pre
                    if streams is not None:
                        assert _same_streams(streams, _streams(store))
                else:
                    seq.append("committed")
                    assert store.rung == target
                assert_ledger_matches_residency(store)
            outcomes.append((seq, dict(pg.inner.faults), list(store.ledger.events)))
        assert outcomes[0] == outcomes[1], seed
        committed += outcomes[0][0].count("committed")
        failed += outcomes[0][0].count("failed")
    assert committed > 0 and failed > 0, (committed, failed)


def test_mixed_apply_rolls_back_atomically(trees):
    """A per-leaf assignment whose second leaf's fetch fails commits no leaf,
    at the same first seed as the JAX package's."""
    found = []
    for mod, sw, tree, kw, ra in (
            (importlib.import_module("repro_torch.storage.pager"), None, trees[1],
             dict(device="cpu"), RungAssignment),
            (jpager, jsw, trees[0], dict(dtype=jnp.float32), jsw.RungAssignment)):
        make = sw.NestQuantStore if sw else NestQuantStore
        paths = sorted(make(tree, mode="part", **kw).leaf_rungs())
        for seed in range(40):
            pg = mod.ResilientPager(
                mod.ChaosPager(mod.InMemoryPager.from_tree(tree), seed=seed, p_transient=0.5),
                mod.RetryPolicy(max_attempts=1, quarantine_after=10 ** 6), seed=seed)
            store = make(tree, mode="part", pager=pg, **kw)
            pre = _snapshot(store)
            streams = _streams(store) if sw is None else None
            try:
                store.apply(ra(default=0, exact=((paths[0], 2), (paths[1], 1))))
            except mod.PagerError:
                assert _snapshot(store) == pre
                if streams is not None:
                    assert _same_streams(streams, _streams(store))
                found.append(seed)
                break
            assert store.leaf_rungs()[paths[0]] == 2 and store.leaf_rungs()[paths[1]] == 1
        else:
            pytest.fail("no fault schedule produced a failed mixed apply")
    assert found[0] == found[1]


# ---------------------------------------------------------------------------
# degraded-mode serving
# ---------------------------------------------------------------------------
def _storm_run(seed, pkg):
    """The reference test's storm (48 requests, 2 new tokens, >= 10 %
    transient faults, an outage of delta 0 over the middle of the trace,
    shallow retries, FailureAwarePolicy) on the reduced qwen2-1.5b."""
    jcfg, _, nested = reduced_qwen2()
    cfg = get_config("qwen2-1.5b").reduced()
    if pkg == "port":
        tree, mk = jax_tree_to_torch(nested), dict(device="cpu")
        pm, sm, store_cls = importlib.import_module("repro_torch.storage.pager"), \
            importlib.import_module("repro_torch.serving.scheduler"), NestQuantStore
        pol = FailureAwarePolicy(HysteresisPolicy(LoadAdaptivePolicy(high_depth=4), dwell=2),
                                 cooldown=4)
    else:
        tree, mk = nested, dict(dtype=jnp.float32)
        pm, sm, store_cls = jpager, jsched, jsw.NestQuantStore
        pol = JaxFailure(JaxHysteresis(JaxLoad(high_depth=4), dwell=2), cooldown=4)
    svc = sm.ServiceModel()
    probe = store_cls(tree, mode="full", **mk)
    qps = 0.4 * svc.capacity_rps(probe.rung_resident_bytes(probe.num_rungs - 1), 2, 4)
    burst = 1.05 * svc.capacity_rps(probe.rung_resident_bytes(0), 2, 4)
    trace = sm.LoadGenerator("burst", qps=qps, n_requests=48, vocab_size=cfg.vocab_size,
                             seed=0, new_tokens=2, burst_qps=burst, burst_window=(0.3, 0.6))
    arr = trace.arrivals()
    clk = pm.VirtualClock()
    chaos = pm.ChaosPager(pm.InMemoryPager.from_tree(tree), seed=seed, p_transient=0.35,
                          p_corrupt=0.05, p_stall=0.05, stall_s=2e-4, clock=clk,
                          outages=(pm.Outage(arr[12].t, arr[36].t, level=0),))
    pager = pm.ResilientPager(chaos, pm.RetryPolicy(max_attempts=2, backoff_base_s=1e-4,
                                                    quarantine_after=3, quarantine_s=2e-3),
                              seed=seed + 1)
    store = store_cls(tree, mode="part", pager=pager, **mk)
    if pkg == "port":
        eng = ServeEngine(cfg, store, max_batch=4, max_len=32, policy=pol)
        report = Scheduler(eng, trace, svc, max_batch=4, clock=clk).run()
    else:
        eng = JaxEngine(jcfg, store, max_batch=4, max_len=32, policy=pol)
        report = sm.Scheduler(eng, trace, svc, max_batch=4, clock=clk).run()
    assert len(report.requests) == 48
    assert all(len(r.request.out_tokens) == 2 for r in report.requests)
    assert_switch_records_exact(report.switch_records)
    assert_ledger_matches_residency(store)
    return eng, report, chaos


def test_scheduler_completes_every_request_through_a_storm():
    """Every seeded storm serves all 48 requests by degrading rungs; some
    storm fails a switch and rolls it back; and one storm's report, fault
    counts, ledger and tokens equal the JAX package's float for float."""
    failures = [_storm_run(seed, "port")[0].stats.switch_failures for seed in range(5)]
    assert any(f > 0 for f in failures), failures
    seed = failures.index(max(failures))
    peng, prep, pchaos = _storm_run(seed, "port")
    jeng, jrep, jchaos = _storm_run(seed, "jax")
    assert prep.summary() == jrep.summary()
    assert prep.steps == jrep.steps and prep.switch_records == jrep.switch_records
    assert pchaos.faults == jchaos.faults and pchaos.fetches == jchaos.fetches
    assert peng.store.ledger.events == jeng.store.ledger.events
    assert peng.stats.switch_failures == jeng.stats.switch_failures
    assert [r.request.out_tokens for r in prep.requests] == \
        [r.request.out_tokens for r in jrep.requests]
