"""Port parity of the fleet layer and the store's byte baselines: the
distribution tier's dedup and multicast accounting (``stats()`` and
``fetch_log``), the controller's envelope math, and whole fleets over the
reduced qwen2-1.5b tree whose ``FleetReport.to_dict()`` equals the JAX
package's for the same specs and seeds - every controller mode, with and
without a chaos storm on a subset, and the CLI's 4-replica mix from
``make_specs``; each mirrors a test of tests/test_fleet.py.  The store's
baselines (``bytes``, ``leaf_bits``, the diverse-bitwidth baselines,
``switch_reduction``) equal the reference's integer for integer, and its
``dense_params`` the reference's bit for bit."""
import argparse
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleet as jfleet
from conftest import assert_switch_records_exact
from repro.core import QuantRecipe as JaxRecipe
from repro.core import quantize as jax_quantize
from repro.launch import fleet as jfleet_cli
from repro.launch import flags as jflags
from repro.storage import pager as jpager
from repro_torch import fleet as pfleet
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import switching as psw
from repro_torch.core.nesting import NestedTensor
from repro_torch.launch import fleet as pfleet_cli
from repro_torch.launch import flags as pflags
from repro_torch.storage import pager as ppager
from torch_parity import jax_tree_to_torch, reduced_qwen2, shared_jax_compiles

jsw = importlib.import_module("repro.core.switching")

N_REPLICAS = 4
REQUESTS = 8
MODES = ("rebalance", "equal", "none")


def _specs(mod, chaos=True):
    """The reference test's mix: mixed links, burst on even replicas, a
    chaos storm on replicas 0 and 2 only (or no storm)."""
    links = (100.0, 25.0, 400.0)
    return [mod.ReplicaSpec(
        name=f"replica{i}", link_mbps=links[i % len(links)],
        trace="burst" if i % 2 == 0 else "poisson", n_requests=REQUESTS, seed=i,
        policy="load", max_batch=4, new_tokens=2,
        chaos=(mod.ChaosProfile(seed=100 + i, p_corrupt=0.0)
               if chaos and i % 2 == 0 else None))
        for i in range(N_REPLICAS)]


def _cli_specs(mod, flags_mod, fleet_cli):
    """The fleet CLI's 4-replica mix (``make_specs``): links 100/25/400
    round-robin, burst on even replicas, ``--policy failure`` and chaos on
    replicas 0 and 2."""
    ap = argparse.ArgumentParser(parents=[flags_mod.traffic_parent()])
    args = ap.parse_args(["--trace", "burst", "--requests", "12", "--new-tokens", "2",
                          "--max-batch", "4", "--policy", "failure", "--chaos"])
    args.replicas, args.link_mbps, args.chaos_every = N_REPLICAS, "100,25,400", 2
    return fleet_cli.make_specs(args, [])


def _run(mod, specs, cfg, nested, mode, **kw):
    fleet = mod.build_fleet(specs, cfg=cfg, nested_params=nested, **kw)
    if mode != "none":
        store0 = fleet.replicas[0].store
        top = store0.rung_resident_bytes(store0.num_rungs - 1)
        fleet.controller = mod.FleetController(2 * N_REPLICAS * top, interval_s=0.002,
                                               mode=mode)
    return fleet, fleet.run()


@pytest.fixture(scope="module")
def trees():
    jcfg, _, nested = reduced_qwen2()
    return jcfg, nested, get_config("qwen2-1.5b").reduced(), jax_tree_to_torch(nested)


@pytest.fixture(scope="module")
def runs(trees):
    """Both packages' fleets over the same tree: every controller mode with
    and without chaos, and the CLI's mix under the rebalancing controller."""
    jcfg, nested, cfg, ptree = trees
    out = {}
    with shared_jax_compiles():
        for mode in MODES:
            for chaos in (True, False):
                out[(mode, chaos)] = (
                    _run(jfleet, _specs(jfleet, chaos), jcfg, nested, mode),
                    _run(pfleet, _specs(pfleet, chaos), cfg, ptree, mode, device="cpu"))
        out["cli"] = (
            _run(jfleet, _cli_specs(jfleet, jflags, jfleet_cli), jcfg, nested, "rebalance"),
            _run(pfleet, _cli_specs(pfleet, pflags, pfleet_cli), cfg, ptree, "rebalance",
                 device="cpu"))
    return out


def _dump(report) -> str:
    return json.dumps(report.to_dict(), sort_keys=True)


# ---------------------------------------------------------------------------
# the store's byte baselines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["reduced_qwen2", "one_leaf"])
def test_store_baselines_equal_the_reference(trees, small_dist, which):
    nested = trees[1] if which == "reduced_qwen2" else small_dist[0]
    ptree = jax_tree_to_torch(nested)
    js = jsw.NestQuantStore(nested, mode="part")
    ps = psw.NestQuantStore(ptree, mode="part", device="cpu")
    assert ps.bytes() == js.bytes()
    assert ps.leaf_bits() == js.leaf_bits()
    assert (ps.n, ps.h) == (js.n, js.h)
    assert ps.diverse_baseline() == js.diverse_baseline()
    for bits in ((8, 6, 4), (4, 8), (3, 5, 8)):
        assert ps.diverse_ladder_baseline(bits) == js.diverse_ladder_baseline(bits)
        assert psw.diverse_ladder_bytes(ptree, bits) == jsw.diverse_ladder_bytes(nested, bits)
    assert psw.diverse_bitwidth_bytes(ptree, 8, 4) == jsw.diverse_bitwidth_bytes(nested, 8, 4)
    assert ps.switch_reduction() == js.switch_reduction()
    ps.to_full()
    js.to_full()
    ps.to_part()
    js.to_part()
    assert ps.ledger.events == js.ledger.events and ps.rung == js.rung == 0
    dense = dict(tree.flatten_with_path(psw.NestQuantStore(
        ptree, mode="full", device="cpu", dtype=torch.float32).dense_params()))
    jdense = jsw.NestQuantStore(nested, mode="full", dtype=jnp.float32).dense_params()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jdense)[0]:
        np.testing.assert_array_equal(dense[jax.tree_util.keystr(path)].numpy(), np.asarray(leaf))


# ---------------------------------------------------------------------------
# distribution tier
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_dist():
    w = jax.random.normal(jax.random.PRNGKey(1), (64, 64))
    nested = jax_quantize({"w": w}, JaxRecipe(bits=(8, 6, 4), rounding="rtn"))
    path = next(iter(jsw.NestQuantStore(nested, mode="part").leaf_streams()))
    return nested, jax_tree_to_torch(nested), path


def _dist_walk(mod, pager_mod, nested, path):
    """The reference test's dedup / multicast walk; returns the tier and the
    byte counters after each fetch."""
    clock = pager_mod.VirtualClock()
    dist = mod.DeltaDistribution(pager_mod.InMemoryPager.from_tree(nested), clock=clock,
                                 multicast_window_s=0.05)
    seen = []
    for who, sleep in (("a", 0.0), ("b", 0.0), ("c", 1.0)):
        clock.sleep(sleep)
        dist.client(who).fetch(path, 0)
        seen.append((dist.origin_bytes, dist.edge_bytes, dist.unicast_bytes,
                     dist.dedup_hits, dist.multicast_joins))
    return dist, seen


def test_distribution_dedups_and_multicasts(small_dist):
    nested, ptree, path = small_dist
    jd, jseen = _dist_walk(jfleet, jpager, nested, path)
    pd, pseen = _dist_walk(pfleet, ppager, ptree, path)
    assert pseen == jseen
    nb = pseen[0][0]
    assert pseen == [(nb, nb, 2 * nb, 0, 0), (nb, nb, 4 * nb, 1, 1), (nb, 2 * nb, 6 * nb, 2, 1)]
    assert pd.stats() == jd.stats() and pd.stats()["fleet_bytes"] == 3 * nb
    assert pd.fetch_log == jd.fetch_log
    assert pd.hot_segments(1) == jd.hot_segments(1) == [(path, 0, 3)]


def test_edge_client_evict_is_replica_local(small_dist):
    nested, ptree, path = small_dist
    out = []
    for mod, pager_mod, src in ((jfleet, jpager, nested), (pfleet, ppager, ptree)):
        clock = pager_mod.VirtualClock()
        dist = mod.DeltaDistribution(pager_mod.InMemoryPager.from_tree(src), clock=clock,
                                     multicast_window_s=0.0)
        a = dist.client("a")
        a.fetch(path, 0)
        held = a.resident_bytes()
        a.evict(path, 0)
        clock.sleep(1.0)
        a.fetch(path, 0)                # re-climb after the downshift: a dedup hit
        out.append((held, dist.stats(), dist.fetch_log, a.available(path, 0),
                    a.expected_crc(path, 0)))
    assert out[1] == out[0]
    assert out[1][1]["dedup_hits"] == 1 and out[1][1]["origin_bytes"] == out[1][0]


def test_distribution_validation(small_dist):
    _, ptree, _ = small_dist
    with pytest.raises(ValueError, match="multicast_window_s"):
        pfleet.DeltaDistribution(ppager.InMemoryPager.from_tree(ptree),
                                 multicast_window_s=-1.0)


# ---------------------------------------------------------------------------
# controller envelope math (stub replicas)
# ---------------------------------------------------------------------------
class _StubReplica:
    def __init__(self, name, backlog, done=False, base_bytes=100):
        self.name = name
        self.scheduler = type("S", (), {"backlog_depth": backlog, "done": done})()
        self.store = type("St", (), {"rung_resident_bytes":
                                     staticmethod(lambda r: base_bytes)})()
        self.envelopes = []

    def set_envelope(self, budget, now):
        self.envelopes.append((now, budget))


def _envelope_walk(mod):
    """The reference test's controller cases, as (budget, reason) lists."""
    reps = [_StubReplica("r0", 10)] + [_StubReplica(f"r{i}", 0) for i in (1, 2, 3)]
    out = [mod.FleetController(1000, mode="equal").envelopes(reps)]
    reb = mod.FleetController(1000, mode="rebalance", hot_depth=4)
    out.append(reb.envelopes(reps))
    reps[0].scheduler.done = True
    out.append(reb.envelopes(reps))
    reps[0].scheduler.done = False
    for r in reps:
        r.scheduler.backlog_depth = 10
    out.append(reb.envelopes(reps))
    for r in reps[1:]:
        r.scheduler.backlog_depth = 0
    out.append(mod.FleetController(320, mode="rebalance", hot_depth=4).envelopes(reps))
    reb.apply(reps, now=0.5)
    return ([[(e.replica, e.budget_bytes, e.reason) for e in envs] for envs in out],
            reps[0].envelopes, reb.ticks)


def test_controller_envelope_math():
    port, ref = _envelope_walk(pfleet), _envelope_walk(jfleet)
    assert port == ref
    envs, applied, ticks = port
    assert [b for _, b, _ in envs[0]] == [250] * 4
    assert envs[1][0][1:] == (100, "pinned-hot") and [b for _, b, _ in envs[1][1:]] == [300] * 3
    assert [b for _, b, _ in envs[4]] == [100] * 4
    assert applied == [(0.5, 100)] and ticks == 1


def test_controller_validation():
    for kw, match in ((dict(total_budget_bytes=1000, mode="chaotic"), "mode"),
                      (dict(total_budget_bytes=0), "total_budget_bytes"),
                      (dict(total_budget_bytes=1000, interval_s=0.0), "interval_s")):
        for mod in (pfleet, jfleet):
            with pytest.raises(ValueError, match=match):
                mod.FleetController(**kw)
    with pytest.raises(ValueError, match="unique"):
        pfleet.Fleet([_StubReplica("dup", 0), _StubReplica("dup", 0)], distribution=None,
                     clock=ppager.VirtualClock())


def test_replica_spec_validation():
    for mod in (pfleet, jfleet):
        with pytest.raises(ValueError, match="link_mbps"):
            mod.ReplicaSpec(name="r", link_mbps=0.0)
        with pytest.raises(ValueError, match="n_requests"):
            mod.ReplicaSpec(name="r", n_requests=0)
    assert set(pfleet.__all__) == set(jfleet.__all__)
    assert pfleet.CONTROLLER_MODES == jfleet.CONTROLLER_MODES


# ---------------------------------------------------------------------------
# whole fleets against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chaos", [True, False], ids=["chaos", "calm"])
@pytest.mark.parametrize("mode", MODES)
def test_fleet_report_equals_the_reference(runs, mode, chaos):
    (jf, jrep), (pf, prep) = runs[(mode, chaos)]
    assert _dump(prep) == _dump(jrep)
    assert prep.controller_mode == mode
    assert pf.distribution.stats() == jf.distribution.stats()
    assert pf.distribution.fetch_log == jf.distribution.fetch_log
    for p, j in zip(pf.replicas, jf.replicas):
        assert [(r.request.uid, r.rung, r.mode, r.done_s) for r in prep.replicas[p.name].requests] \
            == [(r.request.uid, r.rung, r.mode, r.done_s) for r in jrep.replicas[j.name].requests]
        assert p.store.ledger.events == j.store.ledger.events
        assert (p.chaos is None) == (j.chaos is None)
        if p.chaos is not None:
            assert (p.chaos.faults, p.chaos.fetches) == (j.chaos.faults, j.chaos.fetches)
            assert (p.resilient.retries, p.resilient.quarantines) == \
                (j.resilient.retries, j.resilient.quarantines)


def test_cli_mix_report_equals_the_reference(runs):
    (jf, jrep), (pf, prep) = runs["cli"]
    assert [s.name for s in (r.spec for r in pf.replicas)] == [f"replica{i}" for i in range(4)]
    assert [r.spec.chaos is not None for r in pf.replicas] == [True, False, True, False]
    assert _dump(prep) == _dump(jrep)
    assert prep.table() == jrep.table()


def test_fleet_beats_unicast_and_zoo(runs):
    _, (_, report) = runs[("rebalance", True)]
    s = report.summary()
    assert s["switches"] > 0
    assert report.fleet_bytes < report.unicast_bytes
    assert report.fleet_bytes < report.zoo_bytes
    assert s["dedup_hits"] > 0
    assert report.transport["origin_bytes"] <= report.transport["edge_cached_bytes"]


def test_fleet_ledgers_exact_under_chaos(runs):
    (jf, jrep), (fleet, report) = runs[("rebalance", True)]
    assert report.verify_ledgers() == jrep.verify_ledgers() == sum(
        len(r.switch_records) for r in report.replicas.values()) > 0
    for rep in report.replicas.values():
        assert_switch_records_exact(rep.switch_records)
    assert fleet.replicas[0].chaos is not None and fleet.replicas[1].chaos is None
    assert sum(sum(fleet.replicas[i].chaos.faults.values()) for i in (0, 2)) > 0
    for rep in report.replicas.values():
        assert len(rep.requests) == REQUESTS


def test_fleet_report_shape(runs):
    _, (_, report) = runs[("rebalance", True)]
    assert set(report.replicas) == {f"replica{i}" for i in range(N_REPLICAS)}
    lat = report.pooled_latency("total")
    assert 0 < lat["p50"] <= lat["p95"] <= lat["max"]
    for log in report.envelopes.values():
        assert log and log[0][0] == 0.0
    d = report.to_dict()
    assert set(d) == {"controller_mode", "elapsed_s", "transport", "zoo", "pooled",
                      "envelopes", "replicas"}
    json.dumps(d)


def test_fleet_is_deterministic_and_leaves_the_shared_tree(trees, runs):
    """A second port fleet over the same tree gives the same report, and no
    replica's paging changed the shared tree: after every fleet of this
    module its leaves equal a fresh copy of the JAX package's tree."""
    _, nested, cfg, ptree = trees
    _, (_, first) = runs[("rebalance", True)]
    _, second = _run(pfleet, _specs(pfleet), cfg, ptree, "rebalance", device="cpu")
    assert _dump(second) == _dump(first)
    pristine = dict(tree.flatten_with_path(jax_tree_to_torch(nested)))
    for path, leaf in tree.flatten_with_path(ptree):
        want = pristine[path]
        if not isinstance(leaf, NestedTensor):
            assert torch.equal(leaf, want), path
            continue
        assert (leaf.rung, leaf.bits, leaf.block) == (want.rung, want.bits, want.block)
        assert torch.equal(leaf.w_base, want.w_base) and torch.equal(leaf.scale, want.scale)
        assert len(leaf.deltas) == len(want.deltas) and all(
            d is not None and torch.equal(d, e) for d, e in zip(leaf.deltas, want.deltas))
