"""Port parity of the recipe search: the same seeded calibration batches
bit for bit, the same searched recipe JSON as the JAX package's for the
same seed and budget (seeds 0 and 1, unbudgeted and a budget that stops
part-way up the upgrade walk), every rung score within 1e-4 dB (SQNR) and
1e-6 (Pearson) of the reference's, budget monotonicity, the byte
accounting against the store, and a searched recipe serving through the
port's engine with the reference's greedy tokens; each mirrors a test of
tests/test_search.py.

The layer outputs are f32 products in both packages, summed in different
orders (XLA's and PyTorch's), so a score may differ in its last rounded
digits; the recipe does not, and a recipe that differed only through a
flipped rounding would fail here."""
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NestQuantStore as JaxStore
from repro.core import quantize as jax_quantize
from repro.core import search as jsearch
from repro_torch.configs import get_config
from repro_torch.core import search as psearch
from repro_torch.core.recipe import QuantRecipe, quantize
from repro_torch.core.switching import NestQuantStore
from torch_parity import jax_tree_to_torch, reduced_qwen2

SQNR_TOL, PEARSON_TOL = 1e-4, 1e-6
BITS = (8, 6, 4)


@pytest.fixture(scope="module")
def params():
    """The reference test's tree (three 128 x 96 layers at different scales
    and a dense norm) for both packages."""
    rng = np.random.default_rng(0)
    jt, pt = {}, {}
    for i, sc in enumerate((0.04, 0.5, 0.01)):
        w = (rng.normal(size=(128, 96)) * sc).astype(np.float32)
        jt[f"layer{i}"] = {"w": jnp.asarray(w)}
        pt[f"layer{i}"] = {"w": torch.from_numpy(w)}
    jt["norm"] = {"g": jnp.ones((128,), jnp.float32)}
    pt["norm"] = {"g": torch.ones(128)}
    return jt, pt


@pytest.fixture(scope="module")
def searched(params):
    """(reference, port) results per (seed, budget kind): unbudgeted, and a
    budget that affords the minimal ladders and the first upgrade of the
    walk only, which stops it part-way."""
    jt, pt = params
    out = {}
    for seed in (0, 1):
        full = jsearch.search_recipe(jt, bits=BITS, seed=seed)
        first = jsearch._upgrade_sequence(full.layers, "sqnr", start_rung=1)[0]
        mid = full.fp_bytes + sum(ls.rungs[1].resident_bytes for ls in full.layers) + first[2]
        for kind, budget in (("none", None), ("mid", mid)):
            ref = full if budget is None else jsearch.search_recipe(jt, budget, bits=BITS,
                                                                   seed=seed)
            out[(seed, kind)] = (ref, psearch.search_recipe(pt, budget, bits=BITS, seed=seed))
    return out


def _search_quiet(search, tree, budget, seed):
    """``search`` at ``budget``, without the warning a budget below the
    minimal ladders raises (tested on its own below)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "budget .* cannot fit", UserWarning)
        return search(tree, budget, bits=BITS, seed=seed)


def assert_scores_close(port_layers, ref_layers):
    assert [(ls.path, ls.shape, ls.chain) for ls in port_layers] == \
        [(ls.path, ls.shape, ls.chain) for ls in ref_layers]
    for p, r in zip(port_layers, ref_layers):
        for a, b in zip(p.rungs, r.rungs):
            assert (a.rung, a.bits, a.resident_bytes) == (b.rung, b.bits, b.resident_bytes)
            assert abs(a.sqnr_db - b.sqnr_db) <= SQNR_TOL, (p.path, a, b)
            assert abs(a.pearson - b.pearson) <= PEARSON_TOL, (p.path, a, b)


# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------
def test_calibration_is_seeded_and_path_keyed():
    for path, K, seed in (("['x']['w']", 32, 0), ("['y']['w']", 32, 0),
                          ("['x']['w']", 32, 1), ("['blocks']['q']['w']", 64, 7)):
        got = psearch.calibration_batch(path, K, seed=seed, device="cpu")
        want = np.asarray(jsearch.calibration_batch(path, K, seed=seed))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    a = psearch.calibration_batch("['x']['w']", 32, seed=0, device="cpu")
    assert torch.equal(a, psearch.calibration_batch("['x']['w']", 32, seed=0, device="cpu"))
    assert not torch.equal(a, psearch.calibration_batch("['y']['w']", 32, seed=0,
                                                        device="cpu"))
    assert bool((a >= 0).all())


@pytest.mark.parametrize("kind", ["none", "mid"])
@pytest.mark.parametrize("seed", [0, 1])
def test_searched_recipe_json_equals_the_reference(searched, seed, kind):
    ref, port = searched[(seed, kind)]
    pj, rj = json.loads(port.to_json()), json.loads(ref.to_json())
    assert pj["recipe"] == rj["recipe"]
    assert port.recipe.to_json() == ref.recipe.to_json()
    assert port.tops == ref.tops
    for key in ("chain", "rounding", "metric", "budget_bytes", "spent_bytes", "fp_bytes"):
        assert pj[key] == rj[key], key
    assert [(l["path"], l["shape"], l["chain"], l["top"]) for l in pj["layers"]] == \
        [(l["path"], l["shape"], l["chain"], l["top"]) for l in rj["layers"]]
    assert_scores_close(port.layers, ref.layers)
    if kind == "mid":                   # the walk stopped part-way up
        assert {t for _, t in port.tops} == {1, 2}


def test_same_seed_same_recipe_json(params, searched):
    _, pt = params
    ref, port = searched[(0, "mid")]
    again = psearch.search_recipe(pt, ref.budget_bytes, bits=BITS, seed=0)
    assert again.to_json() == port.to_json()
    assert again.recipe.to_json() == port.recipe.to_json()


def test_different_seed_may_differ_but_stays_valid(params):
    jt, pt = params
    ref = jsearch.search_recipe(jt, bits=BITS, seed=123)
    port = psearch.search_recipe(pt, bits=BITS, seed=123)
    assert port.tops == ref.tops
    assert all(1 <= top <= 2 for _, top in port.tops)


# ---------------------------------------------------------------------------
# budget monotonicity
# ---------------------------------------------------------------------------
def test_budget_monotone_never_lowers_a_rung(params, searched):
    jt, pt = params
    _, full_res = searched[(0, "none")]
    full = full_res.spent_bytes
    lo = full - (full - full_res.fp_bytes) // 2
    prev = None
    for b in sorted({lo, full - 4096, full - 1, full, full * 2}):
        port = _search_quiet(psearch.search_recipe, pt, b, seed=0)
        ref = _search_quiet(jsearch.search_recipe, jt, b, seed=0)
        assert port.tops == ref.tops
        tops = port.tops_map
        if prev is not None:
            for path, top in tops.items():
                assert top >= prev[path], f"budget {b} lowered {path}: {prev[path]} -> {top}"
        prev = tops


def test_unbudgeted_takes_full_chain_everywhere(searched):
    ref, port = searched[(0, "none")]
    assert all(top == 2 for _, top in port.tops)
    assert {ls.path for ls in port.layers} == {p for p, _ in port.tops} == \
        {ls.path for ls in ref.layers}


def test_budget_accounting_matches_store(params, searched):
    jt, pt = params
    ref, port = searched[(0, "mid")]
    store = NestQuantStore(quantize(pt, port.recipe, device="cpu"), device="cpu")
    assert port.spent_bytes == store.rung_resident_bytes(store.num_rungs - 1) == \
        JaxStore(jax_quantize(jt, ref.recipe)).rung_resident_bytes(2)


def test_tiny_budget_warns_and_emits_minimum(params):
    jt, pt = params
    with pytest.warns(UserWarning, match="cannot fit"):
        port = psearch.search_recipe(pt, 10, bits=BITS, seed=0)
    with pytest.warns(UserWarning, match="cannot fit"):
        ref = jsearch.search_recipe(jt, 10, bits=BITS, seed=0)
    assert port.tops == ref.tops and all(top == 1 for _, top in port.tops)


# ---------------------------------------------------------------------------
# sensitivity scores
# ---------------------------------------------------------------------------
def test_rung_scores_improve_up_the_ladder(searched):
    ref, port = searched[(1, "none")]
    assert_scores_close(port.layers, ref.layers)
    for ls in port.layers:
        for t in range(1, len(ls.rungs)):
            assert ls.rungs[t].sqnr_db > ls.rungs[t - 1].sqnr_db, ls.path
            assert ls.rungs[t].resident_bytes > ls.rungs[t - 1].resident_bytes, ls.path


def test_score_layer_handles_stacked_leaves():
    w = np.random.default_rng(4).normal(size=(3, 64, 48)).astype(np.float32)
    ref = jsearch.score_layer("['blocks']['w']", jnp.asarray(w), (8, 4))
    port = psearch.score_layer("['blocks']['w']", torch.from_numpy(w), (8, 4))
    assert port.shape == (3, 64, 48) and len(port.rungs) == 2
    assert port.rungs[1].sqnr_db > port.rungs[0].sqnr_db
    assert_scores_close([port], [ref])


# ---------------------------------------------------------------------------
# end to end: recipe JSON -> quantize -> store -> engine
# ---------------------------------------------------------------------------
def test_recipe_roundtrips_and_serves(params, searched):
    jt, pt = params
    ref, port = searched[(0, "mid")]
    recipe = QuantRecipe.from_json(port.recipe.to_json())
    store = NestQuantStore(quantize(pt, recipe, device="cpu"), device="cpu")
    for path, top in port.tops:
        assert recipe.resolve(path, None).bits == port.layers[0].chain[:top + 1]
    for budget in (port.spent_bytes, port.spent_bytes // 2, None):
        asn, want = port.assignment_for(budget), ref.assignment_for(budget)
        assert (asn.default, asn.overrides, asn.exact) == \
            (want.default, want.overrides, want.exact)
    store.apply(port.assignment_for(port.spent_bytes))
    assert store.resident_bytes() <= port.spent_bytes
    payload = json.loads(port.to_json())
    assert payload["recipe"]["bits"] == [4, 6, 8]
    assert {l["path"] for l in payload["layers"]} == {p for p, _ in port.tops}


def test_searched_recipe_serves_through_engine():
    """The reduced qwen2-1.5b's dense weights: the port's search gives the
    reference's recipe, and the port's engine serves it with the
    reference's greedy tokens."""
    from repro.serving import Request as JaxRequest
    from repro.serving import ServeEngine as JaxEngine
    from repro_torch.serving import Request, ServeEngine

    jcfg, dense, _ = reduced_qwen2()
    pdense = jax_tree_to_torch(dense)
    ref = jsearch.search_recipe(dense, bits=(8, 4), seed=0)
    port = psearch.search_recipe(pdense, bits=(8, 4), seed=0)
    assert port.recipe.to_json() == ref.recipe.to_json() and port.tops == ref.tops
    assert_scores_close(port.layers, ref.layers)
    cfg = get_config("qwen2-1.5b").reduced()
    store = NestQuantStore(quantize(pdense, port.recipe, device="cpu"), device="cpu",
                           dtype=torch.float32)
    jstore = JaxStore(jax_quantize(dense, ref.recipe), dtype=jnp.float32)
    budget = store.rung_resident_bytes(store.num_rungs - 1) * 2
    assert budget == jstore.rung_resident_bytes(jstore.num_rungs - 1) * 2
    out = []
    for eng, req in ((ServeEngine(cfg, store, max_batch=2, max_len=32), Request),
                     (JaxEngine(jcfg, jstore, max_batch=2, max_len=32), JaxRequest)):
        reqs = [req(i, np.arange(4, dtype=np.int32), max_new_tokens=2) for i in range(2)]
        eng.generate(reqs, memory_budget_bytes=budget)
        out.append([r.out_tokens for r in reqs])
    assert out[0] == out[1] and all(len(t) == 2 for t in out[0])
