"""Quickstart on the PyTorch/CUDA port in twelve steps, as the JAX
package's tour walks them: build, pick the nesting, quantize, materialize
either model, switch (the paper's two-level names), climb a K-rung ladder,
recipes and rung policies, deploy an artifact, schedule a burst, scale out
to a fleet, decode speculatively off the ladder's own rungs, and nest the
KV cache itself.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

On the card every weight matmul reads the packed words (the CUDA kernels
build at first use); on the CPU the kernels' plain versions run.  Each
step is a function of what the steps before it made.
"""
import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import tree
from repro_torch.api import (BudgetPolicy, FilePager, HysteresisPolicy, KVCacheConfig,
                             LayerOverride, LoadAdaptivePolicy, LoadGenerator,
                             NestedKVCache, NestQuantStore, QuantRecipe, ReplicaSpec, Request,
                             Scheduler, ServeEngine, ServiceModel, SignalTracker, SpecConfig,
                             StaticRungPolicy, build_fleet, calibrate_qps,
                             critical_nested_bits, get_config, make_model, materialize,
                             open_artifact, quantize, save_artifact)
from repro_torch.core import NestedTensor, recompose, set_tree_mode, sqnr_db, tree_bytes


def step1_model(dev):
    """1. a model (any of the 10 archs; reduced() runs anywhere), random
    weights from a seed."""
    cfg = get_config("qwen2-1.5b").reduced()
    model = make_model(cfg, device=dev)
    return cfg, model, model.init(0)


def step2_nesting(params):
    """2. the critical nested combination (paper Eq. 12)."""
    size_mb = sum(x.numel() * 4 / 1e6 for x in tree.leaves(params))
    h = critical_nested_bits(size_mb, n=8)
    print(f"model {size_mb:.1f} MB fp32 -> INT(8|{h}) nesting")
    return h


def step3_quantize(params, h, dev):
    """3. Algorithm 1 over the whole tree (a declarative recipe; per-layer
    overrides come in step 7)."""
    nested = quantize(params, QuantRecipe(bits=(h, 8)), device=dev)
    b = tree_bytes(nested)
    print(f"packed: high={b['high'] / 1e6:.2f}MB low={b['low'] / 1e6:.2f}MB "
          f"scales={b['scales'] / 1e6:.3f}MB fp-kept={b['fp'] / 1e6:.2f}MB")
    return nested


def step4_materialize(cfg, model, params, nested, dev):
    """4. either model from one stored artifact: top-1 agreement of the
    last position's logits with FP32."""
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int64)).to(dev)
    agree = {}
    with torch.no_grad():
        logits_fp, _ = model.prefill(params, {"tokens": toks})
        for mode in ("part", "full"):
            logits, _ = model.prefill(materialize(nested, mode, torch.float32),
                                      {"tokens": toks})
            agree[mode] = float((logits_fp.argmax(-1) == logits.argmax(-1)).float().mean())
            print(f"{mode}-bit model: top-1 agreement with FP32 = {agree[mode]:.3f}")
    return agree


def step5_switch(params, nested, h, dev):
    """5. the paper's two-level view of one leaf (INT-n = INT-h high + l-bit
    low, Eq. 6 exact), then switching as paging w_low in and out (Table
    11)."""
    dense = dict(tree.flatten_with_path(params))
    path, leaf = next((p, x) for p, x in tree.flatten_with_path(nested)
                      if isinstance(x, NestedTensor))
    assert torch.equal(recompose(leaf.codes_high(), leaf.codes_low(), leaf.n, leaf.h),
                       leaf.codes_full())
    assert torch.equal(leaf.with_mode("part").dequant(torch.float32),
                       leaf.part_bit(torch.float32))
    part_db, full_db = (float(sqnr_db(dense[path], w)) for w in
                        (leaf.part_bit(torch.float32), leaf.full_bit(torch.float32)))
    print(f"{path}: INT{leaf.n} = INT{leaf.h} w_high {tuple(leaf.w_high.shape)} words "
          f"+ {leaf.l}-bit w_low {tuple(leaf.w_low.shape)} words (part scale s*2^{leaf.l}); "
          f"SQNR part-bit {part_db:.1f} dB, full-bit {full_db:.1f} dB")
    part = set_tree_mode(nested, "part")
    assert {x.rung for x in tree.leaves(part) if isinstance(x, NestedTensor)} == {0}
    store = NestQuantStore(nested, n=8, h=h, mode="part", device=dev)
    store.to_full()
    base = store.diverse_baseline()
    print(f"upgrade paged in {store.ledger.page_in_bytes / 1e6:.2f}MB (page-out 0); vs "
          f"diverse-bitwidths switch "
          f"{(base['switch_page_in'] + base['switch_page_out']) / 1e6:.2f}MB "
          f"-> {store.switch_reduction():.0%} cheaper")
    return store


def step6_ladder(params, dev):
    """6. beyond the paper: a K-rung ladder (INT8 > INT6 > INT4), one base
    plus one compensated delta per level; every adjacent move pages one
    delta stream."""
    ladder = quantize(params, QuantRecipe(bits=(8, 6, 4)), device=dev)
    store = NestQuantStore(ladder, mode="part", device=dev)
    lb = store.ladder_bytes()
    print(f"ladder 8>6>4: base={lb['base'] / 1e6:.2f}MB + deltas "
          f"{[round(d / 1e6, 2) for d in lb['deltas']]}MB")
    store.to_full()                        # climbs 4 -> 6 -> 8
    for (r_from, r_to, pin, _) in store.ledger.events:
        print(f"  rung {r_from} -> {r_to}: paged in {pin / 1e6:.2f}MB")
    return ladder, store


def step7_recipes(params, dev):
    """7. per-layer ladders from one recipe (attention 8>6>4, the MLP 8>4)
    and a dwell-window policy against switch thrash on a flapping budget;
    returns {policy: switches}."""
    recipe = QuantRecipe(bits=(8, 4), overrides=(
        LayerOverride(pattern=r"\['(q|k|v|o)'\]", bits=(8, 6, 4)),))
    mixed = quantize(params, recipe, device=dev)
    probe = NestQuantStore(mixed, mode="full", device=dev)
    need = [probe.rung_resident_bytes(r) for r in range(probe.num_rungs)]
    osc = [need[-1] * 2, need[0]] * 3 + [need[-1] * 2] * 4
    switches = {}
    for name, pol in (("budget", BudgetPolicy()), ("hysteresis", HysteresisPolicy(dwell=4))):
        st = NestQuantStore(mixed, mode="full", device=dev)
        tracker = SignalTracker()          # decide/apply loop, one step per budget
        n = 0
        for budget in osc:
            rep = st.apply(pol.decide(st, tracker.signal(memory_budget_bytes=budget)))
            n += int(rep["moves"] > 0)
            tracker.note(rep["moves"] > 0)
        switches[name] = n
        paged = st.ledger.page_in_bytes + st.ledger.page_out_bytes
        print(f"recipe + {name:10s}: {n} switches, {paged / 1e6:.2f}MB paged on an "
              f"oscillating budget")
    return switches


def step8_artifact(ladder, dev):
    """8. deployment: save one artifact, cold-boot a store from manifest +
    base segment only, page the rungs in from disk; every upgrade moves
    exactly bytes(delta_k).  Returns the booted store."""
    tmp = tempfile.mkdtemp()
    try:
        save_artifact(ladder, f"{tmp}/artifact", QuantRecipe(bits=(8, 6, 4)))
        art = open_artifact(f"{tmp}/artifact")
        cold = NestQuantStore(art.load_base_tree(dev), mode="part",
                              pager=FilePager(art, device=dev), device=dev)
        print(f"cold boot read {sum(art.bytes_read.values()) / 1e6:.2f}MB (manifest+base) of "
              f"{art.total_nbytes() / 1e6:.2f}MB; serving at rung 0")
        cold.to_full()                     # pages delta_0.seg, delta_1.seg
        for (r_from, r_to, pin, _) in cold.ledger.events:
            print(f"  delivered rung {r_from} -> {r_to}: {pin / 1e6:.2f}MB on the wire")
        assert cold.ledger.page_in_bytes == sum(cold.delta_bytes(k)
                                                for k in range(cold.num_rungs - 1))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return cold


def step9_burst(cfg, ladder, dev):
    """9. serving under load: a burst trace on the engine; the backlog moves
    the ladder down for throughput, the drained queue climbs it back, and
    every switch pages exactly bytes(delta_k) (a virtual clock: the table
    reproduces anywhere)."""
    svc = ServiceModel()
    store = NestQuantStore(ladder, mode="full", dtype=torch.float32, device=dev)
    engine = ServeEngine(cfg, store, max_batch=8, max_len=32,
                         policy=HysteresisPolicy(LoadAdaptivePolicy(high_depth=8), dwell=2))
    qps = calibrate_qps(store, svc, steps=2, max_batch=8, utilization=0.4)
    burst = 1.05 * svc.capacity_rps(store.rung_resident_bytes(0), 2, 8)
    trace = LoadGenerator("burst", qps=qps, n_requests=200, vocab_size=cfg.vocab_size,
                          seed=0, new_tokens=2, burst_qps=burst, burst_window=(0.25, 0.7))
    report = Scheduler(engine, trace, svc).run()
    print(f"burst trace ({qps:.0f} -> {burst:.0f} req/s): " + report.table())
    for rec in report.switch_records:
        print(f"  step {rec['step']:2d}: rung {rec['from_rung']} -> {rec['to_rung']} paged in "
              f"{rec['page_in'] / 1e3:.0f}KB / out {rec['page_out'] / 1e3:.0f}KB "
              f"(== bytes(delta_k))")
        assert rec["page_in"] == rec["expected_in"]
        assert rec["page_out"] == rec["expected_out"]
    return report


def step10_fleet(cfg, ladder, dev):
    """10. a fleet: replicas over the same artifact page deltas through a
    CDN-style tier (each segment crosses the WAN once, concurrent pulls
    multicast), fewer bytes than per-replica unicast; every replica's
    ledger exact."""
    specs = [ReplicaSpec(name="edge-fast", link_mbps=400, trace="burst", n_requests=6,
                         seed=0, policy="load", max_batch=4, new_tokens=2),
             ReplicaSpec(name="edge-slow", link_mbps=25, trace="poisson",
                         n_requests=6, seed=1, policy="load", max_batch=4,
                         new_tokens=2)]
    report = build_fleet(specs, cfg=cfg, nested_params=ladder, device=dev).run()
    checked = report.verify_ledgers()
    print("fleet: " + report.table())
    assert report.fleet_bytes < report.unicast_bytes
    print(f"  distribution tier saved {1 - report.fleet_bytes / report.unicast_bytes:.0%} of "
          f"wire bytes vs per-replica unicast; {checked} switch ledgers exact")
    return report


def step11_speculative(cfg, params, dev):
    """11. self-speculative decoding: the INT8 part-bit rung drafts k tokens,
    one chunked INT16 pass verifies them; the output is bit-identical to
    plain full-bit greedy decode.  Returns (plain, speculative tokens, the
    store)."""
    pair = quantize(params, QuantRecipe(bits=(16, 8)), device=dev)
    store = NestQuantStore(pair, mode="full", dtype=torch.float32, device=dev)
    engine = ServeEngine(cfg, store, max_batch=2, max_len=32, policy=StaticRungPolicy(-1))
    spec = SpecConfig(k=4, draft=0)
    engine.warmup(6, spec=spec)            # build the draft and verify paths once

    def reqs():
        rng = np.random.default_rng(11)
        return [Request(i, rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                        max_new_tokens=12) for i in range(2)]
    plain = [r.out_tokens for r in engine.generate(reqs())]
    spec_out = [r.out_tokens for r in engine.generate(reqs(), speculate=spec)]
    assert spec_out == plain, "speculative decode must be bit-identical"
    p = engine.last_profile
    print(f"speculative decode: {p.verify_passes} verify passes for "
          f"{sum(len(t) for t in spec_out)} tokens (acceptance {p.acceptance:.2f}, draft "
          f"bytes/step {p.draft_bytes / p.verify_bytes:.2f}x verify) - output bit-identical "
          f"to full-bit greedy")
    return plain, spec_out, store


def step12_kv_cache(cfg, store, dev):
    """12. the nested KV cache: prefill K/V quantized into pages whose delta
    streams move down through the pager, every switch ledgered byte-exact;
    a smaller per-sequence cost admits more sequences in one budget.
    Returns (bytes per sequence before, after)."""
    kv = NestedKVCache(KVCacheConfig(bits=(4, 8), page=2))
    engine = ServeEngine(cfg, store, max_batch=2, max_len=32, policy=StaticRungPolicy(-1),
                         kv=kv)
    engine.warmup(6)                       # + the KV quantize and render paths
    rng = np.random.default_rng(12)
    engine.generate([Request(i, rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                             max_new_tokens=4) for i in range(2)])
    hi = engine.kv_bytes_per_seq()
    kv.to_rung(0)                          # ledgered, byte-exact
    lo = engine.kv_bytes_per_seq()
    f_r, t_r, page_in, page_out = kv.ledger.events[-1]
    _, _, exp_in, exp_out = kv.expected_events[-1]
    assert (page_in, page_out) == (exp_in, exp_out) and lo < hi
    budget = 8 * hi
    print(f"nested KV cache: {hi} -> {lo} B/sequence after the rung {f_r}->{t_r} downshift "
          f"(page_out {page_out}B, observed == computed); the same {budget}B cache budget "
          f"now admits {budget // lo} sequences instead of {budget // hi}")
    return hi, lo


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg, model, params = step1_model(dev)
    h = step2_nesting(params)
    nested = step3_quantize(params, h, dev)
    step4_materialize(cfg, model, params, nested, dev)
    step5_switch(params, nested, h, dev)
    ladder, _ = step6_ladder(params, dev)
    step7_recipes(params, dev)
    step8_artifact(ladder, dev)
    step9_burst(cfg, ladder, dev)
    step10_fleet(cfg, ladder, dev)
    _, _, store = step11_speculative(cfg, params, dev)
    step12_kv_cache(cfg, store, dev)


if __name__ == "__main__":
    main()
