"""Port parity of the policy tier and its store helpers: HysteresisPolicy
decisions over a budget trace, QualityFloorPolicy floors (SQNR and Pearson)
that leave ledger and pager residency as they were, ``hydrated_leaves`` and
``rung_view`` against the JAX store's, the numpy similarity functions,
``LoadAdaptivePolicy.draft_ok`` and ``resolve_draft_ok``, the
``FailureAwarePolicy``'s clamps, and the ``make_policy`` names."""
import importlib
import re

import jax
import numpy as np
import pytest
import torch

from repro.core import LayerOverride as JaxOverride
from repro.core import QuantRecipe as JaxRecipe
from repro.core import quantize as jax_quantize
from repro.core import similarity as jsim
from repro.core.quantizer import sqnr_db as jax_sqnr_db
from repro.serving import policies as jpol
from repro_torch.core import similarity as psim
from repro_torch.core.quantizer import sqnr_db
from repro_torch.core.switching import NestQuantStore
from repro_torch.serving import policies as ppol
from repro_torch.storage import InMemoryPager, PagerError, load_store, save_artifact
from torch_parity import j2n, jax_tree_to_torch, t2n

jsw = importlib.import_module("repro.core.switching")
ATTN = r"\['attn'\]"


@pytest.fixture(scope="module")
def mixed():
    """A tree whose attention leaves nest on (8, 6, 4) and whose MLP nests
    on (8, 4), quantized by the JAX package; and the same tree in the port."""
    k = jax.random.split(jax.random.PRNGKey(0), 4)
    params = {
        "attn": {"wq": {"w": jax.random.normal(k[0], (128, 128))},
                 "wo": {"w": jax.random.normal(k[1], (128, 128))}},
        "mlp": {"w_up": {"w": jax.random.normal(k[2], (128, 256))},
                "w_down": {"w": jax.random.normal(k[3], (256, 128))}},
    }
    recipe = JaxRecipe(bits=(8, 4), rounding="rtn", overrides=(
        JaxOverride(pattern=ATTN, bits=(8, 6, 4)),))
    nested = jax_quantize(params, recipe)
    return nested, jax_tree_to_torch(nested)


def _stores(mixed, mode):
    return (jsw.NestQuantStore(mixed[0], mode=mode),
            NestQuantStore(mixed[1], mode=mode, device="cpu"))


def _budgets(store):
    need = [store.rung_resident_bytes(r) for r in range(store.num_rungs)]
    return [need[-1] * 2, need[0], need[1], need[0]] * 2 + [need[-1] * 2] * 5 + \
        [need[1], None, need[0] - 1]


@pytest.mark.parametrize("dwell", [0, 2, 4])
def test_hysteresis_decisions_equal_the_reference(mixed, dwell):
    jstore, pstore = _stores(mixed, "full")
    budgets = _budgets(pstore)
    want = jpol.simulate_policy(jpol.HysteresisPolicy(dwell=dwell), jstore, budgets)
    got = ppol.simulate_policy(ppol.HysteresisPolicy(dwell=dwell), pstore, budgets)
    assert got == want
    assert pstore.ledger.events == jstore.ledger.events
    raw = ppol.simulate_policy(ppol.BudgetPolicy(), _stores(mixed, "full")[1], budgets)
    assert got["switches"] <= raw["switches"]
    with pytest.raises(ValueError):
        ppol.HysteresisPolicy(dwell=-1)


@pytest.mark.parametrize("metric,floors", [("sqnr", (10.0, 25.0, 35.0, 1e9)),
                                           ("pearson", (0.99, 0.999, 0.9999, 2.0))])
def test_quality_floor_equals_the_reference_and_moves_nothing(mixed, tmp_path,
                                                              metric, floors):
    jstore, pstore = _stores(mixed, "part")
    # the port's store pages from an artifact, so residency is observable
    save_artifact(mixed[1], str(tmp_path / "art"))
    fstore = load_store(str(tmp_path / "art"), mode="part", device="cpu")
    for floor in floors:
        jp = jpol.QualityFloorPolicy(floor=floor, metric=metric)
        for store in (pstore, fstore):
            pp = ppol.QualityFloorPolicy(floor=floor, metric=metric)
            assert pp.floor_rungs(store) == jp.floor_rungs(jstore), floor
            for path, q in pp.leaf_quality(store).items():
                np.testing.assert_allclose(q, jp.leaf_quality(jstore)[path], rtol=1e-5)
            sig = ppol.ResourceSignal(memory_budget_bytes=0)
            got = store.resolve_assignment(pp.decide(store, sig))
            want = jstore.resolve_assignment(jp.decide(jstore, jpol.ResourceSignal(
                memory_budget_bytes=0)))
            assert got == want
    assert fstore.ledger.events == [] and fstore.pager.resident_bytes() == 0
    assert set(fstore.leaf_rungs().values()) == {0}
    with pytest.raises(ValueError, match="metric"):
        ppol.QualityFloorPolicy(metric="kendall")


class _FailsAt:
    """An in-memory pager whose fetch of one (path, level) raises."""

    def __init__(self, inner, bad):
        self.inner, self.bad, self.evicted = inner, bad, []

    def fetch(self, path, level):
        if (path, level) == self.bad:
            raise PagerError(f"no {path} {level}")
        return self.inner.fetch(path, level)

    def evict(self, path, level):
        self.evicted.append((path, level))

    def resident_bytes(self):
        return 0

    def available(self, path, level):
        return True


def test_hydrated_leaves_and_rung_view_equal_the_reference(mixed):
    jstore, pstore = _stores(mixed, "part")
    pstore.to_rung(1)
    jstore.to_rung(1)
    events = list(pstore.ledger.events)
    for (jp, jl), (pp, pl) in zip(jstore.hydrated_leaves(), pstore.hydrated_leaves()):
        assert jp == pp and len(jl.deltas) == len(pl.deltas)
        for jd, pd in zip(jl.deltas, pl.deltas):
            np.testing.assert_array_equal(t2n(pd), np.asarray(jd))
        np.testing.assert_array_equal(t2n(pl.full_bit(torch.float32)),
                                      j2n(jl.full_bit(np.float32)))
    for rung in (0, 1, 2):
        for stamp in (None, 0):
            jv = jstore.rung_view(rung, stamp=stamp)
            pv = pstore.rung_view(rung, stamp=stamp)
            for path, _ in pstore.nested_leaves():
                jl, pl = jv, pv
                for key in re.findall(r"\['([^']*)'\]", path):
                    jl, pl = jl[key], pl[key]
                assert (pl.rung, pl.resident_levels) == (jl.rung, jl.resident_levels)
                for jd, pd in zip(jl.deltas, pl.deltas):
                    assert (jd is None) == (pd is None)
                    if pd is not None:
                        np.testing.assert_array_equal(t2n(pd), np.asarray(jd))
    assert pstore.ledger.events == events and pstore.rung == 1
    # a failed transient fetch evicts what it fetched before raising
    path = "['attn']['wq']['w']"
    store = NestQuantStore(mixed[1], mode="part", device="cpu",
                           pager=_FailsAt(InMemoryPager.from_tree(mixed[1]), (path, 1)))
    with pytest.raises(PagerError):
        store.rung_view(2)
    assert store.pager.evicted[-1] == (path, 0)
    store.pager.evicted.clear()
    with pytest.raises(PagerError):
        store.hydrated_leaves()
    assert (path, 0) in store.pager.evicted and store.rung == 0


def test_similarity_functions_equal_the_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=700)
    y = x + 0.3 * rng.normal(size=700)
    xi = np.round(x * 4)                      # ties for the rank statistics
    for fn in ("pearson", "spearman", "kendall"):
        for a, b in ((x, y), (xi, np.round(y * 4))):
            assert getattr(psim, fn)(a, b) == getattr(jsim, fn)(a, b), fn
    assert psim.kendall(x, y, max_n=300, seed=1) == jsim.kendall(x, y, max_n=300, seed=1)
    assert psim.rank_sum_test(xi, y) == jsim.rank_sum_test(xi, y)
    assert psim.abs_delta_ci(x, y) == jsim.abs_delta_ci(x, y)
    assert psim.quality_report(x, y) == jsim.quality_report(x, y)
    assert psim.quality_report(x, x)["sqnr_db"] == 300.0
    w = x.astype(np.float32)
    assert float(sqnr_db(torch.from_numpy(w), torch.from_numpy(w + np.float32(0.01)))) == \
        pytest.approx(float(jax_sqnr_db(w, w + np.float32(0.01))), rel=1e-6)


def test_make_policy_names_and_refusals():
    assert sorted(ppol.POLICIES) == sorted(jpol.POLICIES)
    for name in ("budget", "hysteresis", "quality", "load", "static", "failure"):
        assert type(ppol.make_policy(name)).__name__ == type(jpol.make_policy(name)).__name__
    assert ppol.make_policy("static", rung=1).rung == 1
    assert ppol.make_policy("failure", cooldown=3).cooldown == 3
    with pytest.raises(ValueError, match="cooldown"):
        ppol.make_policy("failure", cooldown=-1)
    with pytest.raises(ValueError, match="unknown policy"):
        ppol.make_policy("nope")


@pytest.mark.parametrize("high,low,age", [(8, 0, None), (4, 2, None), (4, 0, 0.5)])
def test_draft_ok_and_its_chain_walk_equal_the_reference(high, low, age):
    """Drafting is on only on a drained, unpressured queue, as in the JAX
    package; ``resolve_draft_ok`` finds it through wrappers and answers
    None for a chain without one."""
    pp = ppol.LoadAdaptivePolicy(high_depth=high, low_depth=low, max_age_s=age)
    jp = jpol.LoadAdaptivePolicy(high_depth=high, low_depth=low, max_age_s=age)
    pchain = ppol.FailureAwarePolicy(ppol.HysteresisPolicy(pp, dwell=2))
    jchain = jpol.FailureAwarePolicy(jpol.HysteresisPolicy(jp, dwell=2))
    seen = set()
    for depth in range(0, high + 2):
        for backlog in (0.0, 0.4, 0.6):
            ps = ppol.ResourceSignal(queue_depth=depth, backlog_age_s=backlog)
            js = jpol.ResourceSignal(queue_depth=depth, backlog_age_s=backlog)
            assert pp.draft_ok(ps) == jp.draft_ok(js)
            assert ppol.resolve_draft_ok(pchain, ps) == jpol.resolve_draft_ok(jchain, js) \
                == pp.draft_ok(ps)
            seen.add(pp.draft_ok(ps))
    assert seen == {True, False}
    assert ppol.resolve_draft_ok(ppol.HysteresisPolicy(ppol.BudgetPolicy()),
                                 ppol.ResourceSignal()) is None


@pytest.mark.parametrize("cooldown", [0, 2, 4])
def test_failure_aware_decisions_equal_the_reference(mixed, cooldown):
    """Over a budget trace with delivery failures and a ceiling that drops
    and recovers, FailureAwarePolicy caps upgrades at the deliverable rung,
    holds them through the cooldown, never sheds what is resident, and
    moves both stores to the same residency with the same ledger."""
    jstore, pstore = _stores(mixed, "part")
    budgets = _budgets(pstore)
    jtr, ptr = jpol.SignalTracker(), ppol.SignalTracker()
    pp = ppol.FailureAwarePolicy(ppol.BudgetPolicy(), cooldown=cooldown)
    jp = jpol.FailureAwarePolicy(jpol.BudgetPolicy(), cooldown=cooldown)
    avails = [2, 2, 1, 0, 0, 1, 2, None]
    failures = {3, 9}
    for i, budget in enumerate(budgets):
        avail = avails[i % len(avails)]
        ps = ptr.signal(memory_budget_bytes=budget, available_rung=avail)
        js = jtr.signal(memory_budget_bytes=budget, available_rung=avail)
        pa, ja = pp.decide(pstore, ps), jp.decide(jstore, js)
        want = pstore.resolve_assignment(pa)
        assert want == jstore.resolve_assignment(ja), i
        cur = pstore.leaf_rungs()
        cap = pstore.max_available_rung() if avail is None else avail
        for path, r in want.items():
            assert r <= max(cap, cur[path]), (i, path)
        if i in failures:
            ptr.note(False, failed=True)
            jtr.note(False, failed=True)
            continue
        pm = pstore.apply(pa)["moves"] > 0
        jm = jstore.apply(ja)["moves"] > 0
        assert pm == jm
        ptr.note(pm)
        jtr.note(jm)
    assert pstore.leaf_rungs() == jstore.leaf_rungs()
    assert pstore.ledger.events == jstore.ledger.events and pstore.ledger.events
