"""Port parity of the MoE family on the CPU in f32: reduced dbrx-132b
(top-2 of 4 experts, layernorm) and reduced llama4-scout-17b-a16e (top-1,
rmsnorm) against the JAX package.

* ``moe_ffn`` on one layer's dense and nested experts at every rung of an
  (8, 6, 4) ladder, dropless and capacity-dropped (a factor that drops):
  expert indices and kept slots equal, gates and aux within 1e-6, the
  output within 1e-4 of max |y|;
* the trees: the JAX package's MoE params carried over through numpy (4-D
  nested expert stacks, the f32 router), the port's init layout and its
  own quantization equal to the JAX package's;
* prefill logits and greedy decode at every rung within 1e-4, tokens
  identical; the cached decode against the full forward (the mirror of
  ``tests/test_models_smoke.py::test_decode_matches_full_forward``);
* ``ServeEngine.generate`` over rungs 2, 0, 1, 2 against the JAX engine
  (tokens, switches, ledger bytes), a long serve on the nested KV cache
  against it (tokens, KV ledger), speculative tokens equal to plain
  greedy, and ``decode_chunk`` row j within 1e-6 of max |logit| of decode
  step j (the CPU's products differ by M).

The JAX quantization of each reduced config is shared per process
(``torch_parity.reduced_moe``)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.nesting import set_tree_rung as jax_set_rung
from repro.models import make_model as jax_make_model
from repro.models import moe as jmoe
from repro.models.layers import pdot as jax_pdot
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxEngine
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core.nesting import NestedTensor, set_tree_rung
from repro_torch.core.recipe import QuantRecipe, quantize
from repro_torch.core.switching import NestQuantStore
from repro_torch.models import make_model, moe
from repro_torch.models.model import init_params, layer_params
from repro_torch.serving import Request, ServeEngine, SpecConfig, StaticRungPolicy
from torch_parity import j2n, jax_tree_to_torch, reduced_moe, t2n

jsw = importlib.import_module("repro.core.switching")

ARCHS = ("dbrx-132b", "llama4-scout-17b-a16e")
TOL = 1e-4
GATE_TOL = 1e-6
TREES = ("dense", "rung0", "rung1", "rung2")
B, S, STEPS, MAX_LEN = 2, 6, 3, 16


def _trees(arch, which):
    """(JAX tree, port tree) of ``which``: the dense params or the nesting
    stamped at a rung."""
    _, dense, nested = reduced_moe(arch)
    if which == "dense":
        return dense, jax_tree_to_torch(dense)
    rung = int(which[-1])
    jt = jax_set_rung(nested, rung)
    return jt, set_tree_rung(jax_tree_to_torch(nested), rung)


# ---------------------------------------------------------------------------
# moe_ffn: routing, dispatch and output
# ---------------------------------------------------------------------------
def _port_table(routing, E, C, T):
    """The reference's (E*C,) slot table and gates from the port's groups."""
    table, gates = np.full(E * C, T, np.int64), np.zeros(E * C, np.float32)
    for e, rows, g in routing.groups:
        table[e * C:e * C + rows.numel()] = rows.numpy()
        gates[e * C:e * C + rows.numel()] = g.numpy()
    return table, gates


@pytest.mark.parametrize("dropless", [True, False], ids=["dropless", "capacity"])
@pytest.mark.parametrize("which", TREES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, which, dropless):
    cfg = reduced_moe(arch)[0]
    E, K, d = cfg.num_experts, cfg.top_k, cfg.d_model
    # a factor that really drops: C is below the mean load per expert
    factor = cfg.capacity_factor if dropless else 0.5
    jt, pt = _trees(arch, which)
    jlp = jax.tree_util.tree_map(lambda a: a[1], jt["blocks"]["moe"])
    plp = layer_params(pt["blocks"], 1)["moe"]
    x = np.random.default_rng(7).normal(size=(4, 16, d)).astype(np.float32)
    T = 64
    C = moe.capacity(T, E, K, factor, dropless=dropless)
    assert C == jmoe.capacity(T, E, K, factor, dropless=dropless)

    xf = jnp.asarray(x.reshape(T, d))
    rw = jlp["router"]["w"]
    jprobs = jax.nn.softmax(jax_pdot(xf, rw.astype(xf.dtype), preferred=jnp.float32), -1)
    jgate, jidx = jax.lax.top_k(jprobs, K)
    jgate = jgate / jnp.sum(jgate, -1, keepdims=True)
    _, jtable, jgates, jaux = jmoe._dispatch(xf, rw, E=E, K=K, C=C)
    jout, jaux2 = jmoe.moe_ffn(jnp.asarray(x), jlp, num_experts=E, top_k=K,
                               capacity_factor=factor, act=cfg.act, dropless=dropless)

    probs, gate_vals, idx = moe.route_tokens(torch.from_numpy(x.reshape(T, d)),
                                             plp["router"]["w"], K)
    r = moe._dispatch(probs, gate_vals, idx, E=E, C=C)
    table, gates = _port_table(r, E, C, T)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(table, np.asarray(jtable))
    np.testing.assert_allclose(gate_vals.numpy(), np.asarray(jgate), rtol=0, atol=GATE_TOL)
    np.testing.assert_allclose(gates, np.asarray(jgates), rtol=0, atol=GATE_TOL)
    assert abs(r.aux.item() - float(jaux)) <= GATE_TOL
    kept = sum(rows.numel() for _, rows, _ in r.groups)
    assert kept == T * K if dropless else kept < T * K

    out, aux = moe.moe_ffn(torch.from_numpy(x), plp, num_experts=E, top_k=K,
                           capacity_factor=factor, act=cfg.act, dropless=dropless)
    want = j2n(jout)
    assert out.shape == want.shape == x.shape
    assert np.abs(t2n(out) - want).max() <= TOL * np.abs(want).max()
    assert abs(aux.item() - float(jaux2)) <= GATE_TOL
    # the serving paths skip the aux loss; the output is the same bytes
    served, none = moe.moe_ffn(torch.from_numpy(x), plp, num_experts=E, top_k=K,
                               capacity_factor=factor, act=cfg.act, dropless=dropless,
                               want_aux=False)
    assert none is None and torch.equal(served, out)


def test_moe_ffn_records_the_expert_groups_it_launches():
    """``record_groups`` sees each call's (expert, rows) groups, ascending,
    summing to T * K in dropless mode, with the route it named."""
    cfg = reduced_moe(ARCHS[0])[0]
    _, pt = _trees(ARCHS[0], "rung2")
    plp = layer_params(pt["blocks"], 0)["moe"]
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 5, cfg.d_model))
                         .astype(np.float32))
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor, dropless=True)
    with moe.record_groups() as log:
        first, _ = moe.moe_ffn(x, plp, route="decode", **kw)
        moe.moe_ffn(x, plp, **kw)
    assert [(g.route, g.rung, g.tokens) for g in log] == [("decode", 2, 10), (None, 2, 10)]
    assert log[0].groups == log[1].groups
    experts = [e for e, _ in log[0].groups]
    assert experts == sorted(set(experts)) and sum(n for _, n in log[0].groups) == 10 * cfg.top_k
    assert moe._hooks.log is None
    # replaying a pass's own choices computes the same output; other choices
    # route the tokens where they say
    other = (log[0].expert_idx + 1) % cfg.num_experts
    with moe.record_groups() as log2, moe.forced_routing([log[0].expert_idx, other]):
        again, _ = moe.moe_ffn(x, plp, **kw)
        moved, _ = moe.moe_ffn(x, plp, **kw)
    assert torch.equal(again, first) and not torch.allclose(moved, first)
    assert torch.equal(log2[1].expert_idx, other) and moe._hooks.forced is None


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_trees_carry_over_and_quantize_like_the_reference(arch):
    cfg, dense, nested = reduced_moe(arch)
    pnested = jax_tree_to_torch(nested)
    leaves = dict(tree.flatten_with_path(pnested))
    jleaves = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(
        nested, is_leaf=lambda x: isinstance(x, jsw.NestedTensor))[0]}
    assert sorted(leaves) == sorted(jleaves)
    E = cfg.num_experts
    for name in ("w_gate", "w_up", "w_down"):
        leaf = leaves[f"['blocks']['moe']['experts']['{name}']['w']"]
        assert isinstance(leaf, NestedTensor) and leaf.w_base.ndim == 4
        assert leaf.shape[:2] == (cfg.num_layers, E)
    router = leaves["['blocks']['moe']['router']['w']"]
    assert not isinstance(router, NestedTensor) and router.dtype == torch.float32
    assert tuple(router.shape) == (cfg.num_layers, cfg.d_model, E)
    # the port's own rtn quantization of the same dense tree: the same
    # leaves nested, codes bit for bit, scales within an ulp (jit vs eager)
    own = dict(tree.flatten_with_path(quantize(
        jax_tree_to_torch(dense), QuantRecipe(bits=(8, 6, 4), rounding="rtn"), device="cpu")))
    for path, leaf in leaves.items():
        assert isinstance(own[path], NestedTensor) == isinstance(leaf, NestedTensor), path
        if isinstance(leaf, NestedTensor):
            for a, b in zip((own[path].w_base,) + own[path].deltas, (leaf.w_base,) + leaf.deltas):
                assert torch.equal(a, b), path
            torch.testing.assert_close(own[path].scale, leaf.scale, rtol=1e-6, atol=0)
    # the port's init draws its own numbers in the reference's layout
    init = dict(tree.flatten_with_path(init_params(get_config(arch).reduced(), device="cpu")))
    jinit = dict((jax.tree_util.keystr(p), v)
                 for p, v in jax.tree_util.tree_flatten_with_path(dense)[0])
    assert {p: tuple(v.shape) for p, v in init.items()} == \
        {p: tuple(v.shape) for p, v in jinit.items()}
    assert NestQuantStore(pnested, mode="part", device="cpu").bytes() == \
        jsw.NestQuantStore(nested, mode="part", dtype=jnp.float32).bytes()


# ---------------------------------------------------------------------------
# the model: prefill + greedy decode, cached decode against the full forward
# ---------------------------------------------------------------------------
def _jax_run(cfg, params, tokens):
    model = jax_make_model(cfg)
    logits, cache = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(tokens)})
    full = model.make_cache(B, MAX_LEN, dtype=jnp.float32)
    full["k"] = full["k"].at[:, :, :S].set(cache["k"])
    full["v"] = full["v"].at[:, :, :S].set(cache["v"])
    full["pos"] = cache["pos"]
    outs, toks = [logits], []
    step = jax.jit(model.decode_step)
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
    full = model.make_cache(B, MAX_LEN)
    full["k"][:, :, :S] = cache["k"]
    full["v"][:, :, :S] = cache["v"]
    full["pos"] = cache["pos"]
    outs, toks = [logits], []
    nxt = logits[:, -1].argmax(dim=-1)[:, None]
    for _ in range(STEPS):
        toks.append(nxt.numpy())
        logits, full = model.decode_step(params, {"tokens": nxt}, full)
        outs.append(logits)
        nxt = logits[:, -1].argmax(dim=-1)[:, None]
    return [t2n(o) for o in outs], np.concatenate(toks, axis=1)


@pytest.mark.parametrize("which", TREES[1:])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch, which):
    jcfg = reduced_moe(arch)[0]
    cfg = get_config(arch).reduced()
    jt, pt = _trees(arch, which)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    ref_logits, ref_toks = _jax_run(jcfg, jt, tokens)
    got_logits, got_toks = _port_run(cfg, pt, tokens)
    assert got_logits[0].shape == ref_logits[0].shape == (B, 1, cfg.vocab_size)
    for g, r in zip(got_logits, ref_logits):
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got_toks, ref_toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The mirror of the JAX package's smoke test on the port: the same
    params (``PRNGKey(1)``) and tokens, the cached decode of token S
    against the full forward over S + 1 tokens (atol 2e-5, rtol 1e-4)."""
    cfg = get_config(arch).reduced()
    rng = jax.random.PRNGKey(1)
    params = jax_tree_to_torch(jax_make_model(reduced_moe(arch)[0]).init(rng))
    model = make_model(cfg, device="cpu")
    Bf, Sf = 2, 16
    toks = torch.from_numpy(np.array(jax.random.randint(rng, (Bf, Sf + 1), 0,
                                                        cfg.vocab_size))).long()
    logits_full, _ = model.prefill(params, {"tokens": toks})
    _, cache = model.prefill(params, {"tokens": toks[:, :Sf]})
    pad = model.make_cache(Bf, Sf + 8)
    pad["k"][:, :, :Sf], pad["v"][:, :, :Sf], pad["pos"] = cache["k"], cache["v"], cache["pos"]
    logits_dec, _ = model.decode_step(params, {"tokens": toks[:, Sf:Sf + 1]}, pad)
    np.testing.assert_allclose(t2n(logits_full), t2n(logits_dec), atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# serving: the engine against the JAX engine, speculation, the verify pass
# ---------------------------------------------------------------------------
def _budget(store, rung):
    need = [store.rung_resident_bytes(r) for r in range(store.num_rungs)]
    return need[-1] * 2 if rung == store.num_rungs - 1 else need[rung]


def test_generate_walks_rungs_token_identical_with_exact_ledger():
    arch = ARCHS[0]
    jcfg, _, nested = reduced_moe(arch)
    cfg = get_config(arch).reduced()
    jeng = JaxEngine(jcfg, jsw.NestQuantStore(nested, mode="part", dtype=jnp.float32),
                     max_batch=4, max_len=24)
    peng = ServeEngine(cfg, NestQuantStore(jax_tree_to_torch(nested), mode="part",
                                           device="cpu"), max_batch=4, max_len=24)
    for phase, rung in enumerate((2, 0, 1, 2)):
        rng = np.random.default_rng(10 + phase)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 8, 6)]
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


KV_PROMPTS, KV_NEW, KV_QUEUE = (1040, 1033), 3, (0, 8, 0)


def test_long_serve_on_the_nested_kv_cache_matches_reference():
    """A long serve of the reduced dbrx-132b (2 x 1040 prompt tokens: the
    blockwise attention branch, 65 KV pages) on ``KVCacheConfig((4, 6, 8),
    16, "rtn")`` under ``LoadAdaptivePolicy``, queue depths walking the KV
    and weight rungs 2 -> 1 -> 2 (tests/test_torch_kv_cache.py walks the
    whole ladder on qwen2): greedy tokens, KV and weight ledger events and
    per-sequence KV bytes equal to the JAX engine's."""
    from repro.serving import KVCacheConfig as JaxKVConfig
    from repro.serving import LoadAdaptivePolicy as JaxLoadPolicy
    from repro_torch.serving import KVCacheConfig, LoadAdaptivePolicy

    arch = ARCHS[0]
    jcfg, _, nested = reduced_moe(arch)
    cfg = get_config(arch).reduced()
    max_len = KV_PROMPTS[0] + KV_NEW
    jeng = JaxEngine(jcfg, jsw.NestQuantStore(nested, mode="full", dtype=jnp.float32),
                     max_batch=2, max_len=max_len,
                     policy=JaxLoadPolicy(high_depth=8, low_depth=0),
                     kv=JaxKVConfig(bits=(4, 6, 8), page=16, rounding="rtn"))
    peng = ServeEngine(cfg, NestQuantStore(jax_tree_to_torch(nested), mode="full", device="cpu"),
                       max_batch=2, max_len=max_len,
                       policy=LoadAdaptivePolicy(high_depth=8, low_depth=0),
                       kv=KVCacheConfig(bits=(4, 6, 8), page=16, rounding="rtn"))
    rungs = []
    for phase, depth in enumerate(KV_QUEUE):
        rng = np.random.default_rng(60 + phase)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in KV_PROMPTS]
        jreqs = [JaxRequest(i, p, max_new_tokens=KV_NEW) for i, p in enumerate(prompts)]
        preqs = [Request(i, p, max_new_tokens=KV_NEW) for i, p in enumerate(prompts)]
        jeng.generate(jreqs, queue_depth=depth)
        peng.generate(preqs, queue_depth=depth)
        assert peng.kv.rung == jeng.kv.rung and peng.store.rung == jeng.store.rung
        assert [r.out_tokens for r in preqs] == [r.out_tokens for r in jreqs], phase
        assert len(peng.kv.pages) == KV_PROMPTS[0] // 16
        assert peng.kv_bytes_per_seq() == jeng.kv_bytes_per_seq()
        rungs.append(peng.kv.rung)
    assert rungs == [2, 1, 2]
    assert peng.kv.ledger.events == jeng.kv.ledger.events
    assert [e[:2] for e in peng.kv.ledger.events] == [(2, 1), (1, 2)]
    assert peng.kv.expected_events == jeng.kv.expected_events
    assert peng.store.ledger.events == jeng.store.ledger.events
    for name in ("kv_switches", "kv_pages", "switches", "prefills", "decode_steps"):
        assert getattr(peng.stats, name) == getattr(jeng.stats, name), name


def test_speculative_tokens_equal_plain_greedy():
    _, _, nested = reduced_moe(ARCHS[0])
    cfg = get_config(ARCHS[0]).reduced()
    store = NestQuantStore(jax_tree_to_torch(nested), mode="full", device="cpu")
    eng = ServeEngine(cfg, store, max_batch=4, max_len=48, policy=StaticRungPolicy(-1))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 6).astype(np.int32) for _ in range(4)]

    def run(spec=None):
        reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)]
        eng.generate(reqs, speculate=spec)
        return [r.out_tokens for r in reqs]

    plain = run()
    for k, draft in ((2, 0), (3, 1)):
        assert run(SpecConfig(k=k, draft=draft)) == plain, (k, draft)
        assert eng.last_profile.speculative


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chunk_rows_equal_sequential_decode_steps(arch):
    """Row j of one decode_chunk over 5 positions within 1e-6 of max |logit|
    of j sequential decode steps at every rung, the cache written alike."""
    cfg = get_config(arch).reduced()
    ptree = jax_tree_to_torch(reduced_moe(arch)[2])
    model = make_model(cfg, device="cpu")
    rng = np.random.default_rng(21)
    Bc = 4
    prompt = rng.integers(0, cfg.vocab_size, (Bc, 6))
    chunk = rng.integers(0, cfg.vocab_size, (Bc, 5))
    for rung in range(3):
        p = set_tree_rung(ptree, rung)
        _, c = model.prefill(p, {"tokens": torch.from_numpy(prompt)})
        seq = model.make_cache(Bc, 16)
        seq["k"][:, :, :6], seq["v"][:, :, :6], seq["pos"] = c["k"], c["v"], 6
        par = {k: v.clone() if torch.is_tensor(v) else v for k, v in seq.items()}
        got, par = model.decode_chunk(p, {"tokens": torch.from_numpy(chunk)}, par)
        want = torch.cat([model.decode_step(p, {"tokens": torch.from_numpy(chunk[:, j:j + 1])},
                                            seq)[0] for j in range(5)], dim=1)
        assert got.shape == (Bc, 5, cfg.vocab_size) and par["pos"] == seq["pos"] == 11
        peak = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-6 * peak, rung
        assert (par["k"] - seq["k"]).abs().max().item() <= 1e-6 * seq["k"].abs().max().item()
