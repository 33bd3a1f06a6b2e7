"""Port parity of the scheduler: the same seeded traces, and for a burst
trace under the CLI's ``load`` composition (HysteresisPolicy around
LoadAdaptivePolicy) the same report - summary, every step record, every
switch record - and the same greedy tokens per request as the JAX
package's, with and without kv-aware admission, and with speculative
drafting gated per batch by ``draft_ok``; ``warmup`` returns the JAX
package's call count."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.serving import HysteresisPolicy as JaxHysteresis
from repro.serving import KVCacheConfig as JaxKVConfig
from repro.serving import LoadAdaptivePolicy as JaxLoad
from repro.serving import ServeEngine as JaxEngine
from repro.serving import SpecConfig as JaxSpec
from repro.serving import scheduler as jsched
from repro_torch.configs import get_config
from repro_torch.core.switching import NestQuantStore
from repro_torch.serving import (TRACES, HysteresisPolicy, KVCacheConfig,
                                 LoadAdaptivePolicy, LoadGenerator, Request,
                                 Scheduler, ServeEngine, ServiceModel, SpecConfig,
                                 calibrate_qps)
from torch_parity import jax_tree_to_torch, reduced_qwen2

jsw = importlib.import_module("repro.core.switching")

MAX_BATCH, PROMPT, NEW_TOKENS, N_REQUESTS = 4, 8, 2, 16
KV = dict(bits=(4, 6, 8), page=4, rounding="rtn")


def _trace(mod, store, vocab):
    """The burst trace as the CLI sizes it, with a burst of 4x the rung-0
    capacity so the 16 requests build a backlog."""
    svc = mod.ServiceModel()
    qps = mod.calibrate_qps(store, svc, steps=NEW_TOKENS, max_batch=MAX_BATCH,
                            utilization=0.4)
    burst = 4 * svc.capacity_rps(store.rung_resident_bytes(0), NEW_TOKENS, MAX_BATCH)
    return svc, mod.LoadGenerator("burst", qps=qps, n_requests=N_REQUESTS,
                                  vocab_size=vocab, seed=0, prompt_len=PROMPT,
                                  new_tokens=NEW_TOKENS, burst_qps=burst)


def _kv_budget(store, engine):
    """Rung-2 weights plus two sequences at KV rung 2."""
    return store.rung_resident_bytes(2) + 2 * engine.kv_bytes_per_seq(2)


@pytest.fixture(scope="module")
def runs():
    """The JAX and port engines over the same tree, each run once plain and
    once kv-aware (the kv engines share the JAX engine's compiled steps)."""
    jcfg, _, nested = reduced_qwen2()
    cfg = get_config("qwen2-1.5b").reduced()
    out = {}
    jstore = jsw.NestQuantStore(nested, mode="full", dtype=jnp.float32)
    jeng = JaxEngine(jcfg, jstore, max_batch=MAX_BATCH, max_len=32,
                     policy=JaxHysteresis(JaxLoad(high_depth=MAX_BATCH), dwell=4))
    pstore = NestQuantStore(jax_tree_to_torch(nested), mode="full", device="cpu")
    peng = ServeEngine(cfg, pstore, max_batch=MAX_BATCH, max_len=32,
                       policy=HysteresisPolicy(LoadAdaptivePolicy(high_depth=MAX_BATCH),
                                               dwell=4))
    for name, mod, eng in (("jax", jsched, jeng), ("port", None, peng)):
        mod = mod or importlib.import_module("repro_torch.serving.scheduler")
        svc, trace = _trace(mod, eng.store, cfg.vocab_size)
        out[name] = (eng, mod.Scheduler(eng, trace, svc).run())
    jkv = JaxEngine(jcfg, jsw.NestQuantStore(nested, mode="full", dtype=jnp.float32),
                    max_batch=MAX_BATCH, max_len=32, model=jeng.model,
                    compiled=jeng.compiled,
                    policy=JaxHysteresis(JaxLoad(high_depth=MAX_BATCH), dwell=4),
                    kv=JaxKVConfig(**KV))
    pkv = ServeEngine(cfg, NestQuantStore(jax_tree_to_torch(nested), mode="full",
                                          device="cpu"),
                      max_batch=MAX_BATCH, max_len=32,
                      policy=HysteresisPolicy(LoadAdaptivePolicy(high_depth=MAX_BATCH),
                                              dwell=4),
                      kv=KVCacheConfig(**KV))
    for name, mod, eng in (("jax_kv", jsched, jkv),
                           ("port_kv", importlib.import_module(
                               "repro_torch.serving.scheduler"), pkv)):
        svc, trace = _trace(mod, eng.store, cfg.vocab_size)
        out[name] = (eng, mod.Scheduler(eng, trace, svc, kv_aware=True,
                                        memory_budget_bytes=_kv_budget(eng.store, eng)
                                        ).run())
    return out


@pytest.mark.parametrize("kind", TRACES)
def test_arrivals_equal_the_reference_for_every_trace(kind):
    kw = dict(qps=50.0, n_requests=40, vocab_size=97, seed=5, prompt_len=7,
              new_tokens=3, burst_qps=400.0)
    port = LoadGenerator(kind, **kw)
    ref = jsched.LoadGenerator(kind, **kw)
    a, b = port.arrivals(), ref.arrivals()
    assert [(x.uid, x.t, x.max_new_tokens) for x in a] == \
        [(x.uid, x.t, x.max_new_tokens) for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) and x.prompt.dtype == y.prompt.dtype
               for x, y in zip(a, b))
    assert [port.rate_at(f / 10) for f in range(11)] == [ref.rate_at(f / 10) for f in range(11)]


@pytest.mark.parametrize("kv", [False, True], ids=["plain", "kv_aware"])
def test_burst_report_and_tokens_equal_the_reference(runs, kv):
    (jeng, jrep), (peng, prep) = (runs["jax_kv"], runs["port_kv"]) if kv else \
        (runs["jax"], runs["port"])
    assert prep.summary() == jrep.summary()
    assert prep.switch_records == jrep.switch_records
    assert prep.kv_switch_records == jrep.kv_switch_records
    assert prep.steps == jrep.steps
    for rec in prep.switch_records + prep.kv_switch_records:
        assert (rec["page_in"], rec["page_out"]) == (rec["expected_in"], rec["expected_out"])
    assert [(r.request.uid, r.request.out_tokens, r.rung, r.mode, r.done_s)
            for r in prep.requests] == \
        [(r.request.uid, r.request.out_tokens, r.rung, r.mode, r.done_s)
         for r in jrep.requests]
    assert (peng.stats.sched_steps, peng.stats.sched_admitted, peng.stats.sched_filler) == \
        (jeng.stats.sched_steps, jeng.stats.sched_admitted, jeng.stats.sched_filler)
    assert peng.store.ledger.events == jeng.store.ledger.events
    walk = [s["rung"] for s in prep.steps]
    assert walk[0] == 2 and min(walk) < 2          # the burst forced a downshift
    if kv:
        assert {s["admit_cap"] for s in prep.steps} != {MAX_BATCH}
        assert peng.kv.ledger.events == jeng.kv.ledger.events


@pytest.mark.parametrize("kv", [False, True], ids=["plain", "kv_aware"])
def test_warmup_call_count_equals_the_reference(runs, kv):
    (jeng, _), (peng, _) = (runs["jax_kv"], runs["port_kv"]) if kv else \
        (runs["jax"], runs["port"])
    events = list(peng.store.ledger.events)
    rungs = peng.store.leaf_rungs()
    resident = peng.store.pager.resident_bytes()
    for kw in (dict(batch=MAX_BATCH), dict(batch=MAX_BATCH, rungs=[0, 2])):
        assert peng.warmup(PROMPT, **kw) == jeng.warmup(PROMPT, **kw)
    assert peng.warmup([PROMPT, PROMPT]) == jeng.warmup([PROMPT, PROMPT])
    # warm-up changes no residency and records no switch
    assert peng.store.ledger.events == events and peng.store.leaf_rungs() == rungs
    assert peng.store.pager.resident_bytes() == resident


def test_scheduler_refusals(runs):
    peng, _ = runs["port"]
    trace = LoadGenerator("poisson", qps=1.0, n_requests=2, vocab_size=8)
    assert Scheduler(peng, trace, speculate=2).speculate == SpecConfig(k=2)
    with pytest.raises(ValueError, match="over-admits"):
        Scheduler(peng, trace, max_batch=MAX_BATCH + 1)
    sched = Scheduler(peng, trace)
    with pytest.raises(RuntimeError, match="start"):
        sched.step()
    assert sched.next_time() is None and sched.now == 0.0
    sched.start()
    assert sched.next_time() == trace.arrivals()[0].t
    while not sched.done:
        sched.step()
    assert sched.next_time() is None and sched.backlog_depth == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        sched.step()
    with pytest.raises(ValueError, match="unknown trace"):
        LoadGenerator("sawtooth", qps=1.0, n_requests=1, vocab_size=4)
    assert calibrate_qps(peng.store, ServiceModel(), steps=2, max_batch=4, rung=0) > \
        calibrate_qps(peng.store, ServiceModel(), steps=2, max_batch=4)
    assert len(Request(0, np.zeros(1, np.int32)).out_tokens) == 0


def test_speculative_gating_report_equals_the_reference(runs):
    """``speculate=`` arms drafting and the policy chain's ``draft_ok``
    gates it per batch (drained queue: draft; backlog: plain decode): the
    report - every step's ``speculative``/``spec_*`` fields and its
    virtual-clock charge from the DecodeProfile - the engine's counters and
    the tokens equal the JAX package's float for float."""
    jcfg, _, nested = reduced_qwen2()
    cfg = get_config("qwen2-1.5b").reduced()
    jref = runs["jax"][0]
    jeng = JaxEngine(jcfg, jsw.NestQuantStore(nested, mode="full", dtype=jnp.float32),
                     max_batch=MAX_BATCH, max_len=32, model=jref.model,
                     compiled=jref.compiled,
                     policy=JaxHysteresis(JaxLoad(high_depth=MAX_BATCH), dwell=4))
    peng = ServeEngine(cfg, NestQuantStore(jax_tree_to_torch(nested), mode="full",
                                           device="cpu"),
                       max_batch=MAX_BATCH, max_len=32,
                       policy=HysteresisPolicy(LoadAdaptivePolicy(high_depth=MAX_BATCH),
                                               dwell=4))
    reps = []
    for mod, eng, spec in ((jsched, jeng, JaxSpec(k=2, draft=0)),
                           (importlib.import_module("repro_torch.serving.scheduler"), peng,
                            SpecConfig(k=2, draft=0))):
        svc, trace = _trace(mod, eng.store, cfg.vocab_size)
        reps.append(mod.Scheduler(eng, trace, svc, speculate=spec).run())
    jrep, prep = reps
    assert prep.summary() == jrep.summary()
    assert prep.steps == jrep.steps and prep.switch_records == jrep.switch_records
    assert 0 < prep.spec_steps < len(prep.steps)
    assert prep.spec_drafted > 0 and 0 < prep.spec_acceptance <= 1
    assert [(r.request.uid, r.request.out_tokens, r.done_s) for r in prep.requests] == \
        [(r.request.uid, r.request.out_tokens, r.done_s) for r in jrep.requests]
    for key in ("spec_rounds", "spec_draft_steps", "spec_drafted", "spec_accepted",
                "spec_rejected", "decode_steps", "sched_steps", "sched_filler"):
        assert getattr(peng.stats, key) == getattr(jeng.stats, key), key
