"""Port parity of the ssm and hybrid families on the CPU in f32: reduced
mamba2-780m (2 Mamba2 layers) and reduced zamba2-2.7b (4 Mamba2 layers,
the shared attention/MLP block applied every 2) against the JAX package,
on the JAX package's parameters carried over through numpy.

* prefill logits and 3 greedy decode steps within 1e-4 of max |logit| of
  the JAX model's, tokens identical: on the dense tree and on the rtn and
  adaptive (8, 6, 4) nestings at every rung;
* the cached decode against the full forward on the nested tree at every
  rung, within the reference's own atol 2e-5 / rtol 1e-4;
* ``ServeEngine.generate`` against the JAX engine (mamba2 over rungs 2,
  0, 1, 2 by budget; zamba2 in the KV test): tokens, switches and ledger
  bytes equal;
* the hybrid on the nested KV cache (``KVCacheConfig((4, 6, 8), 16,
  "rtn")``) over a queue-depth walk of the KV rung: tokens, KV ledger
  events and per-sequence bytes equal (2 attention applications hold
  K/V, not 4 layers), and the warm-up call count equal;
* a prompt shorter than ``ssm_conv_width - 1`` = 3 tokens: the JAX
  package's decode fails, the port refuses it with a ``ValueError``;
* speculation refused with the JAX package's message.

The JAX quantization of each reduced config is shared per process
(``torch_parity.reduced_model``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import switching as jsw
from repro.core.nesting import set_tree_rung as jax_set_rung
from repro.models import make_model as jax_make_model
from repro.serving import KVCacheConfig as JaxKVConfig
from repro.serving import LoadAdaptivePolicy as JaxLoadPolicy
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core.nesting import set_tree_rung
from repro_torch.core.switching import NestQuantStore
from repro_torch.models import make_model
from repro_torch.serving import (KVCacheConfig, LoadAdaptivePolicy, Request, ServeEngine,
                                 SpecConfig)
from repro_torch.serving.kv_cache import kv_bytes_per_token
from torch_parity import (j2n, jax_tree_to_torch, reduced_dense, reduced_model, rehome,
                          t2n)

ARCHS = ("mamba2-780m", "zamba2-2.7b")
TREES = ("dense", "rtn0", "rtn1", "rtn2", "adaptive0", "adaptive1", "adaptive2")
TOL = 1e-4
B, S, STEPS, MAX_LEN = 2, 6, 3, 16


def _trees(arch, which):
    """(JAX tree, port tree) of ``which``: the dense params, or a nesting
    ('rtn' / 'adaptive') stamped at a rung."""
    if which == "dense":
        dense = reduced_dense(arch)[1]
        return dense, jax_tree_to_torch(dense)
    nested = reduced_model(arch, 0, which[:-1])[2]
    rung = int(which[-1])
    return jax_set_rung(nested, rung), set_tree_rung(jax_tree_to_torch(nested), rung)


@functools.lru_cache(maxsize=None)
def _jax_fns(arch):
    """One JAX model and its jitted prefill / decode per config: trees of
    one structure (rtn and adaptive at a rung) share a compile."""
    model = jax_make_model(reduced_dense(arch)[0])
    return model, jax.jit(model.prefill), jax.jit(model.decode_step)


def _jax_run(arch, params, tokens):
    model, prefill, step = _jax_fns(arch)
    logits, cache = prefill(params, {"tokens": jnp.asarray(tokens)})
    full = rehome(cache, model.make_cache(B, MAX_LEN, dtype=jnp.float32), S)
    outs, toks = [logits], []
    nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for _ in range(STEPS):
        toks.append(np.asarray(nxt))
        logits, full = step(params, {"tokens": nxt}, full)
        outs.append(logits)
        nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    return [j2n(o) for o in outs], np.concatenate(toks, axis=1)


def _port_run(cfg, params, tokens):
    model = make_model(cfg, device="cpu")
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens).long()})
    full = rehome(cache, model.make_cache(B, MAX_LEN), S)
    outs, toks = [logits], []
    nxt = logits[:, -1].argmax(dim=-1)[:, None]
    for _ in range(STEPS):
        toks.append(nxt.numpy())
        logits, full = model.decode_step(params, {"tokens": nxt}, full)
        outs.append(logits)
        nxt = logits[:, -1].argmax(dim=-1)[:, None]
    return [t2n(o) for o in outs], np.concatenate(toks, axis=1)


@pytest.mark.parametrize("which", TREES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch, which):
    cfg = get_config(arch).reduced()
    jt, pt = _trees(arch, which)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    ref_logits, ref_toks = _jax_run(arch, jt, tokens)
    got_logits, got_toks = _port_run(cfg, pt, tokens)
    assert got_logits[0].shape == ref_logits[0].shape == (B, 1, cfg.vocab_size)
    for g, r in zip(got_logits, ref_logits):
        assert np.isfinite(g).all()
        assert np.abs(g - r).max() <= TOL * np.abs(r).max()
    np.testing.assert_array_equal(got_toks, ref_toks)


@pytest.mark.parametrize("rung", [0, 1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward_on_the_nested_tree(arch, rung):
    """The cached decode of token S against the full forward over S + 1
    tokens at the reference's own tolerance (atol 2e-5, rtol 1e-4), on the
    adaptive nesting at ``rung``: the state and conv buffer a prefill
    leaves carry the scan on."""
    cfg = get_config(arch).reduced()
    _, pt = _trees(arch, f"adaptive{rung}")
    model = make_model(cfg, device="cpu")
    Sf = 16
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, Sf + 1)))
    logits_full, _ = model.prefill(pt, {"tokens": toks})
    _, cache = model.prefill(pt, {"tokens": toks[:, :Sf]})
    pad = rehome(cache, model.make_cache(B, Sf + 8), Sf)
    logits_dec, pad = model.decode_step(pt, {"tokens": toks[:, Sf:Sf + 1]}, pad)
    np.testing.assert_allclose(t2n(logits_full), t2n(logits_dec), atol=2e-5, rtol=1e-4)
    assert pad["pos"] == Sf + 1


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _budget(store, rung):
    need = [store.rung_resident_bytes(r) for r in range(store.num_rungs)]
    return need[-1] * 2 if rung == store.num_rungs - 1 else need[rung]


def _engines(arch, rounding="adaptive", **kw):
    jcfg, _, nested = reduced_model(arch, 0, rounding)
    jkw = {k: v[0] for k, v in kw.items()}
    pkw = {k: v[1] for k, v in kw.items()}
    jeng = JaxEngine(jcfg, jsw.NestQuantStore(nested, mode="part", dtype=jnp.float32), **jkw)
    peng = ServeEngine(get_config(arch).reduced(),
                       NestQuantStore(jax_tree_to_torch(nested), mode="part", device="cpu"),
                       **pkw)
    return jeng, peng


@pytest.mark.parametrize("arch", ARCHS[:1])
def test_generate_walks_rungs_token_identical_with_exact_ledger(arch):
    """mamba2-780m's engine against the JAX engine over a budget walk;
    zamba2-2.7b's walks rungs 2 -> 1 -> 0 -> 1 -> 2 in the nested KV cache
    test below."""
    jeng, peng = _engines(arch, max_batch=(4, 4), max_len=(24, 24))
    for phase, rung in enumerate((2, 0, 1, 2)):
        rng = np.random.default_rng(10 + phase)
        prompts = [rng.integers(0, 256, size=n).astype(np.int32) for n in (5, 8, 3)]
        jreqs = [JaxRequest(i, p, max_new_tokens=4) for i, p in enumerate(prompts)]
        preqs = [Request(i, p, max_new_tokens=4) for i, p in enumerate(prompts)]
        jeng.generate(jreqs, memory_budget_bytes=_budget(jeng.store, rung))
        peng.generate(preqs, memory_budget_bytes=_budget(peng.store, rung))
        assert peng.store.rung == jeng.store.rung == rung
        assert [r.out_tokens for r in preqs] == [r.out_tokens for r in jreqs], phase
    assert peng.store.ledger.events == jeng.store.ledger.events
    assert peng.store.ledger.switches == jeng.store.ledger.switches == 6
    assert (peng.stats.switches, peng.stats.prefills, peng.stats.decode_steps) == \
        (jeng.stats.switches, jeng.stats.prefills, jeng.stats.decode_steps)
    # no K/V in a pure SSM cache: a sequence costs no cache bytes
    assert peng.kv_bytes_per_seq() == jeng.kv_bytes_per_seq()
    assert (peng.kv_bytes_per_seq() == 0) == (arch == "mamba2-780m")


KV_PROMPTS, KV_NEW, KV_QUEUE = (20, 17), 3, (0, 8, 8, 0, 0)


def test_hybrid_on_the_nested_kv_cache_ledgers_like_the_reference():
    cfg = get_config("zamba2-2.7b").reduced()
    max_len = KV_PROMPTS[0] + KV_NEW + 4
    jeng, peng = _engines(
        "zamba2-2.7b", "rtn", max_batch=(2, 2), max_len=(max_len, max_len),
        policy=(JaxLoadPolicy(high_depth=8, low_depth=0),
                LoadAdaptivePolicy(high_depth=8, low_depth=0)),
        kv=(JaxKVConfig(bits=(4, 6, 8), page=16, rounding="rtn"),
            KVCacheConfig(bits=(4, 6, 8), page=16, rounding="rtn")))
    napps = cfg.num_layers // cfg.hybrid_attn_every
    rungs = []
    for phase, depth in enumerate(KV_QUEUE):
        rng = np.random.default_rng(40 + phase)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in KV_PROMPTS]
        jreqs = [JaxRequest(i, p, max_new_tokens=KV_NEW) for i, p in enumerate(prompts)]
        preqs = [Request(i, p, max_new_tokens=KV_NEW) for i, p in enumerate(prompts)]
        jeng.generate(jreqs, queue_depth=depth)
        peng.generate(preqs, queue_depth=depth)
        assert peng.kv.rung == jeng.kv.rung and peng.store.rung == jeng.store.rung
        assert [r.out_tokens for r in preqs] == [r.out_tokens for r in jreqs], phase
        assert peng.kv_bytes_per_seq() == jeng.kv_bytes_per_seq() == kv_bytes_per_token(
            peng.kv.config, peng.kv.rung, napps, cfg.num_kv_heads, cfg.head_dim) * max_len
        rungs.append(peng.kv.rung)
    assert rungs == [2, 1, 0, 1, 2] and napps == 2 < cfg.num_layers
    assert peng.kv.ledger.events == jeng.kv.ledger.events
    assert peng.kv.expected_events == jeng.kv.expected_events
    assert peng.store.ledger.events == jeng.store.ledger.events
    for name in ("kv_switches", "kv_pages", "switches", "prefills", "decode_steps"):
        assert getattr(peng.stats, name) == getattr(jeng.stats, name), name
    # warm-up warms the KV cache over the 2 applications; a draft stamp
    # adds one decode step per rung and no verify chunk (there is none)
    calls = jeng.warmup(KV_PROMPTS[0])
    assert peng.warmup(KV_PROMPTS[0]) == calls
    assert peng.warmup(KV_PROMPTS[0], spec=SpecConfig(k=2, draft=0)) == calls + 3


@pytest.mark.parametrize("arch", ARCHS)
def test_prompt_shorter_than_the_conv_buffer_is_refused(arch):
    """At S < ssm_conv_width - 1 = 3 the port refuses the prompt with a
    ValueError naming the limit, in ``generate`` and in the model's
    prefill.  The JAX engine's decode step fails there (its ``conv_step``
    einsum meets an S-row buffer); at S = 3 both decode the same tokens
    (the JAX side on mamba2-780m: the conv is the same in both families)."""
    jeng, peng = _engines(arch, max_batch=(2, 2), max_len=(16, 16))
    model = make_model(get_config(arch).reduced(), device="cpu")
    for n in (1, 2, 3):
        prompts = [np.arange(n, dtype=np.int32) + i for i in range(2)]
        jreqs = [JaxRequest(i, p, max_new_tokens=2) for i, p in enumerate(prompts)]
        preqs = [Request(i, p, max_new_tokens=2) for i, p in enumerate(prompts)]
        if n < 3:
            if n == 2 and arch == "mamba2-780m":
                with pytest.raises(ValueError, match="does not match previous terms"):
                    jeng.generate(jreqs)
            with pytest.raises(ValueError, match="at least ssm_conv_width - 1 = 3"):
                peng.generate(preqs)
            with pytest.raises(ValueError, match=f"got {n}"):
                model.prefill(peng.store.params(), {"tokens": torch.zeros((1, n),
                                                                          dtype=torch.int64)})
            assert peng.stats.prefills == 0
        else:
            peng.generate(preqs)
            if arch == "mamba2-780m":
                jeng.generate(jreqs)
                assert [r.out_tokens for r in preqs] == [r.out_tokens for r in jreqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_speculation_is_refused_with_the_reference_message(arch):
    jeng, peng = _engines(arch)
    assert peng.model.decode_chunk is None and jeng._decode_chunk is None
    reqs = [np.arange(6, dtype=np.int32)]
    with pytest.raises(NotImplementedError) as jerr:
        jeng.generate([JaxRequest(0, reqs[0])], speculate=2)
    with pytest.raises(NotImplementedError) as perr:
        peng.generate([Request(0, reqs[0])], speculate=2)
    assert str(perr.value) == str(jerr.value)
    assert "family" in str(perr.value) and peng.stats.prefills == 0
