"""Port parity of self-speculative decoding: the draft rung drafts k
tokens, one chunked full-residency pass verifies them, and the emitted
tokens are the plain greedy tokens - the port's own and the JAX package's -
whatever the draft (a rung, a path map, a RungAssignment, 'floor') and k.
The DecodeProfile, the engine's spec_* counters, the draft resolution and
the virtual-clock charge equal the JAX package's; ``decode_chunk`` row j
equals j sequential decode steps (reduced qwen2-1.5b, f32, on the CPU)."""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.switching import RungAssignment as JaxRA
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxEngine
from repro.serving import SpecConfig as JaxSpec
from repro.serving import StaticRungPolicy as JaxStatic
from repro.serving.engine import DecodeProfile as JaxProfile
from repro.serving.scheduler import ServiceModel as JaxService
from repro_torch.configs import get_config
from repro_torch.core.switching import NestQuantStore, RungAssignment
from repro_torch.models.model import init_params, make_model
from repro_torch.serving import (DecodeProfile, KVCacheConfig, NestedKVCache,
                                 QualityFloorPolicy, Request, ServeEngine, ServiceModel,
                                 SpecConfig, StaticRungPolicy)
from repro_torch.serving import engine as eng_mod
from torch_parity import jax_tree_to_torch, reduced_qwen2, t2n

jsw = importlib.import_module("repro.core.switching")
CFG = get_config("qwen2-1.5b").reduced()
SPEC_KEYS = ("spec_rounds", "spec_draft_steps", "spec_drafted", "spec_accepted",
             "spec_rejected")


def _prompts(n, seed, plen=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, plen).astype(np.int32) for _ in range(n)]


def _reqs(cls, n, seed=0, plen=6, new_tokens=8):
    return [cls(i, p, max_new_tokens=new_tokens)
            for i, p in enumerate(_prompts(n, seed, plen))]


def _port_engine(bits, policy=None, max_batch=2, max_len=48, kv=None):
    """A port engine at the top rung over the reduced model nested on
    ``bits``: the JAX package's (8, 6, 4) tree (the one its engine serves
    here), or the port's own quantization of the same dense weights (held
    bit for bit against the JAX package's in test_torch_quant)."""
    from repro_torch.core.recipe import QuantRecipe, quantize

    _, dense, nested = reduced_qwen2()
    tree = (jax_tree_to_torch(nested) if tuple(bits) == (8, 6, 4) else
            quantize(jax_tree_to_torch(dense), QuantRecipe(bits=bits, rounding="rtn"),
                     device="cpu"))
    store = NestQuantStore(tree, mode="full", device="cpu")
    return ServeEngine(CFG, store, max_batch=max_batch, max_len=max_len,
                       policy=policy or StaticRungPolicy(-1), kv=kv)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) over one JAX-quantized (8, 6, 4) tree."""
    jcfg, _, nested = reduced_qwen2()
    jstore = jsw.NestQuantStore(nested, mode="full", dtype=jnp.float32)
    return (JaxEngine(jcfg, jstore, max_batch=2, max_len=48, policy=JaxStatic(-1)),
            _port_engine((8, 6, 4)))


def _drafts(peng, bits):
    """Every draft form: each rung, a path map, a RungAssignment."""
    paths = list(peng.store.leaf_streams())
    out = [(d, d) for d in range(len(bits))]
    out.append(({paths[0]: 1, paths[-1]: 1}, {paths[0]: 1, paths[-1]: 1}))
    out.append((RungAssignment(default=0, exact=((paths[1], len(bits) - 1),)),
                JaxRA(default=0, exact=((paths[1], len(bits) - 1),))))
    return out


# -- exact greedy equivalence ------------------------------------------------
@pytest.mark.parametrize("bits", [(8, 4), (8, 6, 4)], ids=["bits8-4", "bits8-6-4"])
def test_spec_bit_identical_sweep(engines, bits):
    """Every draft form and k = 1-4 emits the port's plain greedy tokens; on
    (8, 6, 4) those are the JAX engine's, and at k = 3 the DecodeProfile of
    a path-map and a RungAssignment draft equals the JAX engine's."""
    jeng, peng = engines
    if bits != (8, 6, 4):
        jeng, peng = None, _port_engine(bits)
    for seed, drafts, ks in ((0, _drafts(peng, bits), (1, 2, 3, 4)),
                             (1, [(0, 0)], (2, 4))):
        base = [r.out_tokens for r in peng.generate(_reqs(Request, 2, seed))]
        assert peng.last_profile == DecodeProfile(
            steps=8, verify_bytes=peng.store.resident_bytes())
        if jeng is not None:
            assert base == [r.out_tokens for r in jeng.generate(_reqs(JaxRequest, 2, seed))]
        for pd, jd in drafts:
            for k in ks:
                out = [r.out_tokens for r in peng.generate(
                    _reqs(Request, 2, seed), speculate=SpecConfig(k=k, draft=pd))]
                assert out == base, (bits, seed, pd, k)
                assert peng.last_profile.speculative
                if jeng is not None and seed == 0 and k == 3 and not isinstance(pd, int):
                    jeng.generate(_reqs(JaxRequest, 2, seed),
                                  speculate=JaxSpec(k=k, draft=jd))
                    assert dataclasses.asdict(peng.last_profile) == \
                        dataclasses.asdict(jeng.last_profile), (bits, pd)


def test_spec_acceptance_bounds_and_counters(engines):
    """Acceptance lands in (0, 1]; drafting at the top rung accepts all;
    the counters balance and equal the JAX engine's over the same calls."""
    jeng, peng = engines
    p0 = {k: getattr(peng.stats, k) for k in SPEC_KEYS}
    j0 = {k: getattr(jeng.stats, k) for k in SPEC_KEYS}
    peng.generate(_reqs(Request, 2, seed=3), speculate=SpecConfig(k=3, draft=0))
    jeng.generate(_reqs(JaxRequest, 2, seed=3), speculate=JaxSpec(k=3, draft=0))
    p = peng.last_profile
    assert dataclasses.asdict(p) == dataclasses.asdict(jeng.last_profile)
    assert 0.0 < p.acceptance <= 1.0 and p.acceptance == jeng.last_profile.acceptance
    assert p.drafted == 3 * p.verify_passes * 2
    assert p.draft_steps == 3 * p.verify_passes
    dp = {k: getattr(peng.stats, k) - p0[k] for k in SPEC_KEYS}
    dj = {k: getattr(jeng.stats, k) - j0[k] for k in SPEC_KEYS}
    assert dp == dj
    assert (dp["spec_drafted"], dp["spec_accepted"]) == (p.drafted, p.accepted)
    assert dp["spec_rejected"] == dp["spec_drafted"] - dp["spec_accepted"]
    peng.generate(_reqs(Request, 2, seed=3), speculate=SpecConfig(k=3, draft=2))
    assert peng.last_profile.acceptance == 1.0
    assert 0.0 < peng.stats.spec_acceptance <= 1.0


def test_spec_corrupted_draft_still_exact(monkeypatch):
    """A draft from another random model tanks acceptance but cannot change
    the output: every emitted token is a verify argmax."""
    from repro_torch.core.recipe import QuantRecipe, quantize

    peng = _port_engine((8, 4))
    base = [r.out_tokens for r in peng.generate(_reqs(Request, 2, seed=4))]
    other = quantize(init_params(CFG, seed=99, device="cpu"), QuantRecipe(bits=(8, 4)),
                     device="cpu")
    bad = NestQuantStore(other, mode="full", device="cpu").params_for(0)
    orig = eng_mod.SpeculativeDecoder.__init__

    def corrupted(self, engine, spec):
        orig(self, engine, spec)
        self.draft_params = bad
    monkeypatch.setattr(eng_mod.SpeculativeDecoder, "__init__", corrupted)
    out = [r.out_tokens for r in peng.generate(_reqs(Request, 2, seed=4),
                                               speculate=SpecConfig(k=3, draft=0))]
    assert out == base
    assert peng.last_profile.acceptance < 0.15


def test_spec_filler_rows_excluded(engines):
    """Filler clones (uid < 0) ride in the batch but not in the acceptance
    counts, as in the JAX engine."""
    jeng, peng = engines
    for cls, spec, eng in ((Request, SpecConfig, peng), (JaxRequest, JaxSpec, jeng)):
        real = _reqs(cls, 1, seed=5)
        filler = cls(-1, real[0].prompt.copy(), max_new_tokens=real[0].max_new_tokens)
        eng.generate(real + [filler], speculate=spec(k=3, draft=0))
        assert len(filler.out_tokens) == filler.max_new_tokens
    p = peng.last_profile
    assert p.drafted == 3 * p.verify_passes
    assert dataclasses.asdict(p) == dataclasses.asdict(jeng.last_profile)


# -- draft-rung resolution ------------------------------------------------------
def test_spec_draft_resolution_and_clamping():
    jcfg, _, nested = reduced_qwen2()
    jeng = JaxEngine(jcfg, jsw.NestQuantStore(nested, mode="full", dtype=jnp.float32),
                     max_batch=2, max_len=48, policy=JaxStatic(-1))
    peng = _port_engine((8, 6, 4))
    paths = list(peng.store.leaf_streams())
    assert set(peng._draft_rungs(SpecConfig(draft=1)).values()) == {1}
    for pd, jd in _drafts(peng, (8, 6, 4)):
        assert peng._draft_rungs(SpecConfig(draft=pd)) == jeng._draft_rungs(JaxSpec(draft=jd))
        assert peng.draft_resident_bytes(SpecConfig(draft=pd)) == \
            jeng.draft_resident_bytes(JaxSpec(draft=jd))
    m = peng._draft_rungs(SpecConfig(draft={paths[0]: 1}))
    assert m[paths[0]] == 1 and all(m[p] == 0 for p in paths[1:])
    ra = RungAssignment(default=0, exact=((paths[0], 2),))
    assert peng._draft_rungs(SpecConfig(draft=ra))[paths[0]] == 2
    # clamped to residency: with only rung 0 resident every draft reads rung 0
    peng.store.to_rung(0)
    jeng.store.to_rung(0)
    assert set(peng._draft_rungs(SpecConfig(draft=2)).values()) == {0}
    assert peng._draft_rungs(SpecConfig(draft=2)) == jeng._draft_rungs(JaxSpec(draft=2))
    assert peng.draft_resident_bytes(SpecConfig(draft=0)) == \
        peng.store.rung_resident_bytes(0) == jeng.draft_resident_bytes(JaxSpec(draft=0))
    # params_for clamps to residency and moves nothing
    events = list(peng.store.ledger.events)
    stamped = peng.store.params_for(2)
    assert peng.store.ledger.events == events
    assert {leaf.rung for _, leaf in NestQuantStore(stamped, mode="part",
                                                      device="cpu").nested_leaves()} == {0}
    with pytest.raises(ValueError, match="unknown draft spec"):
        peng._draft_rungs(SpecConfig(draft="bogus"))
    with pytest.raises(ValueError, match="QualityFloorPolicy"):
        peng._draft_rungs(SpecConfig(draft="floor"))


def test_spec_floor_draft_uses_quality_floor_policy(engines):
    """'floor' drafts each leaf at the QualityFloorPolicy's floor (whose
    floors test_torch_policies holds against the JAX package's); the tokens
    are the plain greedy ones, the JAX engine's at the same top rung."""
    jeng, _ = engines
    peng = _port_engine((8, 6, 4), policy=QualityFloorPolicy(StaticRungPolicy(-1),
                                                             floor=30.0))
    rungs = peng._draft_rungs(SpecConfig(draft="floor"))
    assert rungs == peng.policy.floor_rungs(peng.store)
    plain = [r.out_tokens for r in jeng.generate(_reqs(JaxRequest, 2, seed=6))]
    assert [r.out_tokens for r in peng.generate(_reqs(Request, 2, seed=6))] == plain
    for k in (1, 2, 3, 4):
        out = [r.out_tokens for r in peng.generate(_reqs(Request, 2, seed=6),
                                                   speculate=SpecConfig(k=k, draft="floor"))]
        assert out == plain, k


# -- the nested KV cache ---------------------------------------------------------
def test_spec_bit_identical_at_downshifted_kv_rung():
    """With the nested KV cache down at its base rung, speculative decode
    emits the plain tokens at that cache rung, and no verify rewind
    fetches a paged-out delta."""

    class CountingPager:
        def __init__(self, inner):
            self.inner, self.fetches = inner, 0

        def fetch(self, path, level):
            self.fetches += 1
            return self.inner.fetch(path, level)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    kv = NestedKVCache(KVCacheConfig(bits=(4, 8), page=2))
    peng = _port_engine((8, 4), kv=kv)
    peng.generate(_reqs(Request, 2, seed=7))
    kv.to_rung(0)
    counting = CountingPager(kv.pager)
    kv.pager = counting
    plain = [r.out_tokens for r in peng.generate(_reqs(Request, 2, seed=7))]
    assert kv.rung == 0 and peng.stats.kv_pages > 0
    out = [r.out_tokens for r in peng.generate(_reqs(Request, 2, seed=7),
                                               speculate=SpecConfig(k=3, draft=0))]
    assert out == plain
    assert peng.last_profile.speculative
    assert counting.fetches == 0


# -- guards and the verify pass ----------------------------------------------------
def test_spec_guards_and_non_dense_families():
    peng = _port_engine((8, 4), max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        peng.generate(_reqs(Request, 1, plen=6, new_tokens=8), speculate=SpecConfig(k=3))
    with pytest.raises(ValueError, match="k >= 1"):
        peng.generate(_reqs(Request, 1, new_tokens=2), speculate=SpecConfig(k=0))
    # families without a rewindable KV cache (ssm, hybrid) have no chunked
    # verify pass (decode_chunk is None, as in the JAX package): the engine
    # refuses to speculate on them before any prefill
    from repro_torch.core.recipe import QuantRecipe, quantize
    for name in ("mamba2-780m", "zamba2-2.7b"):
        cfg = get_config(name).reduced()
        model = make_model(cfg, device="cpu")
        assert model.decode_chunk is None
        store = NestQuantStore(quantize(model.init(0), QuantRecipe(bits=(8, 4), rounding="rtn"),
                                        device="cpu"), mode="part", device="cpu")
        eng = ServeEngine(cfg, store, max_batch=2, max_len=32)
        with pytest.raises(NotImplementedError, match=f"family {cfg.family!r} has none"):
            eng.generate(_reqs(Request, 1, new_tokens=2), speculate=SpecConfig(k=2))
        assert eng.stats.prefills == 0


@pytest.mark.parametrize("B", [1, 4])
def test_decode_chunk_rows_equal_sequential_decode_steps(B):
    """Row j of one decode_chunk over S = 5 positions against j sequential
    decode steps at every rung: bit for bit at B = 4 (M >= 4 rows), within
    1e-6 of max |logit| at B = 1 (the CPU's matrix-vector product sums in
    another order than its matrix product), and the cache written the same;
    and at B = 4 within 1e-4 of max |logit| of the JAX package's
    decode_chunk at rung 2."""
    import jax

    from repro.models import make_model as jax_make_model

    jcfg, _, nested = reduced_qwen2()
    ptree = jax_tree_to_torch(nested)
    model, jmodel = make_model(CFG, device="cpu"), jax_make_model(jcfg)
    rng = np.random.default_rng(20 + B)
    prompt = rng.integers(0, CFG.vocab_size, (B, 6))
    chunk = rng.integers(0, CFG.vocab_size, (B, 5))
    from repro.core.nesting import set_tree_rung as jax_set_rung
    from repro_torch.core.nesting import set_tree_rung
    for rung in range(3):
        p, jp = set_tree_rung(ptree, rung), jax_set_rung(nested, rung)
        _, c = model.prefill(p, {"tokens": torch.from_numpy(prompt)})
        seq = model.make_cache(B, 16)
        seq["k"][:, :, :6], seq["v"][:, :, :6], seq["pos"] = c["k"], c["v"], 6
        par = {k: v.clone() if torch.is_tensor(v) else v for k, v in seq.items()}
        got, par = model.decode_chunk(p, {"tokens": torch.from_numpy(chunk)}, par)
        want = []
        for j in range(5):
            lg, seq = model.decode_step(p, {"tokens": torch.from_numpy(chunk[:, j:j + 1])}, seq)
            want.append(lg)
        want = torch.cat(want, dim=1)
        assert got.shape == (B, 5, CFG.vocab_size) and par["pos"] == seq["pos"] == 11
        peak = want.abs().max().item()
        if B >= 4:
            assert torch.equal(got, want) and torch.equal(par["k"], seq["k"]), rung
        else:
            assert (got - want).abs().max().item() <= 1e-6 * peak, rung
    if B < 4:
        return
    _, jc = jax.jit(jmodel.prefill)(jp, {"tokens": jnp.asarray(prompt, jnp.int32)})
    jfull = jmodel.make_cache(B, 16, dtype=jnp.float32)
    jfull["k"] = jfull["k"].at[:, :, :6].set(jc["k"])
    jfull["v"] = jfull["v"].at[:, :, :6].set(jc["v"])
    jfull["pos"] = jc["pos"]
    jl, _ = jax.jit(jmodel.decode_chunk)(jp, {"tokens": jnp.asarray(chunk, jnp.int32)}, jfull)
    assert np.abs(t2n(got) - np.asarray(jl)).max() <= 1e-4 * peak


def test_warmup_with_spec_counts_the_reference_calls(engines):
    """``warmup(spec=)`` adds a draft-stamped decode step and a verify
    chunk per rung, as the JAX engine counts them, and moves nothing."""
    jeng, peng = engines
    events = list(peng.store.ledger.events)
    kw = dict(batch=2, rungs=[2])
    assert peng.warmup(6, spec=SpecConfig(k=3, draft=0), **kw) == \
        jeng.warmup(6, spec=JaxSpec(k=3, draft=0), **kw) == 4
    assert peng.store.ledger.events == events


# -- the virtual-clock charge -------------------------------------------------------
def test_speculative_seconds_charges_actual_dispatches():
    for svc, jsvc in ((ServiceModel(weight_gbps=1.0, batch_overhead_s=0.0),
                       JaxService(weight_gbps=1.0, batch_overhead_s=0.0)),
                      (ServiceModel(), JaxService())):
        for kw in (dict(draft_steps=6, verify_passes=2, draft_bytes=100, verify_bytes=300,
                        drafted=12, accepted=9),
                   dict(steps=4, verify_bytes=300), dict()):
            p, jp = DecodeProfile(**kw), JaxProfile(**kw)
            assert svc.speculative_seconds(p) == jsvc.speculative_seconds(jp)
            assert (p.speculative, p.acceptance) == (jp.speculative, jp.acceptance)
    svc = ServiceModel(weight_gbps=1.0, batch_overhead_s=0.0)
    assert svc.speculative_seconds(DecodeProfile(draft_steps=6, verify_passes=2,
                                                 draft_bytes=100, verify_bytes=300,
                                                 drafted=12, accepted=9)) == \
        (6 * 100 + 2 * 300) / 1e9
    assert svc.speculative_seconds(DecodeProfile(steps=4, verify_bytes=300)) == \
        svc.batch_seconds(300, 4)
