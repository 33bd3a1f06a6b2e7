"""Serve a small model on the PyTorch/CUDA port with batched requests while
the memory budget changes: the paper's deployment scenario (Sec. 3.3.3) on
a 3-rung INT8 > INT6 > INT4 nesting ladder.

The engine picks the highest rung that fits the budget at every request
batch: a tight budget serves the INT4 base, a mid budget pages in one delta
stream for INT6, and a loose one climbs to INT8; the ledger shows that
every adjacent rung move pages exactly one delta stream (Table 11 on a
K-rung ladder).  Then an oscillating budget, where a hysteresis policy
switches less than the raw budget policy, and a burst of traffic that the
load-adaptive policy answers by moving down the ladder and back.

  PYTHONPATH=src python examples/serve_switching_torch.py [--device cpu]

On the card every weight matmul reads the packed words (the CUDA kernels
build at first use); on the CPU the kernels' plain versions run.
"""
import argparse

import numpy as np
import torch

from repro_torch.api import (BudgetPolicy, HysteresisPolicy, LoadAdaptivePolicy,
                             LoadGenerator, NestQuantStore, QuantRecipe, Request,
                             Scheduler, ServeEngine, ServiceModel, SignalTracker,
                             StaticRungPolicy, calibrate_qps, get_config, make_model,
                             quantize)

BITS = (8, 6, 4)


def budget_walk(cfg, nested, dev):
    """Serve four batches of requests under budgets that walk the ladder;
    returns the store (its ledger) and the rung each batch ran at."""
    store = NestQuantStore(nested, mode="part", dtype=torch.float32, device=dev)
    engine = ServeEngine(cfg, store, max_batch=8, max_len=64)
    lb = store.ladder_bytes()
    rung_bits = sorted(BITS)
    need = [store.rung_resident_bytes(r) for r in range(store.num_rungs)]
    print("resident bytes per rung: " + ", ".join(
        f"rung{r}(int{rung_bits[r]})={need[r] / 1e6:.2f}MB" for r in range(store.num_rungs)))
    budgets = [("night shift (plenty of HBM)", need[-1] * 2),
               ("co-tenant spike (HBM squeezed)", need[0] + lb["deltas"][0] // 2),
               ("partial recovery (mid budget)", need[1] + lb["deltas"][1] // 2),
               ("spike over", need[-1] * 2)]
    rng = np.random.default_rng(0)
    uid, rungs = 0, []
    for label, budget in budgets:
        reqs = [Request(uid + i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                        max_new_tokens=6) for i in range(8)]
        uid += 8
        engine.generate(reqs, memory_budget_bytes=int(budget))
        rungs.append(store.rung)
        print(f"[{label}] -> rung={store.rung} ({store.mode}); sample output "
              f"{reqs[0].out_tokens}; resident={store.resident_bytes() / 1e6:.2f}MB")
    lg = store.ledger
    print(f"\nledger after {lg.switches} adjacent rung moves: "
          f"page-in {lg.page_in_bytes / 1e6:.2f}MB, page-out {lg.page_out_bytes / 1e6:.2f}MB")
    for (r_from, r_to, pin, pout) in lg.events:
        # one adjacent move pages exactly one delta stream, in or out
        assert abs(r_from - r_to) == 1 and pin + pout == store.delta_bytes(min(r_from, r_to))
        print(f"  rung {r_from} -> {r_to}: in {pin / 1e6:.2f}MB, out {pout / 1e6:.2f}MB "
              f"(== bytes(delta_{min(r_from, r_to)}))")
    print(f"switching overhead vs diverse-bitwidth models: -{store.switch_reduction():.0%}")
    print(f"engine stats: {engine.stats.prefills} prefills, "
          f"{engine.stats.decode_steps} decode steps, modes {list(engine.stats.mode_history)}")
    return store, rungs


def oscillating_budget(nested, need, dev):
    """A co-tenant flapping around a rung boundary: the raw budget policy
    pages the same delta in and out every batch, the hysteresis wrapper
    moves down once, holds through the blips and climbs once after its
    dwell window (DESIGN.md Sec. 9).  Returns {policy: switches}."""
    osc = [need[-1] * 2, need[0]] * 3 + [need[-1] * 2] * 5
    print("\noscillating budget (MB):", [round(x / 1e6, 2) for x in osc])
    switches = {}
    for name, policy in (("budget", BudgetPolicy()), ("hysteresis", HysteresisPolicy(dwell=4))):
        st = NestQuantStore(nested, mode="full", dtype=torch.float32, device=dev)
        tracker = SignalTracker()
        n, modes = 0, []
        for budget in osc:
            rep = st.apply(policy.decide(st, tracker.signal(memory_budget_bytes=budget)))
            n += int(rep["moves"] > 0)
            tracker.note(rep["moves"] > 0)
            modes.append(st.mode)
        switches[name] = n
        paged = (st.ledger.page_in_bytes + st.ledger.page_out_bytes) / 1e6
        print(f"  {name:10s}: {n} switches, {paged:.2f}MB paged, modes {modes}")
    return switches


def burst(cfg, nested, dev):
    """Serving under load (DESIGN.md Sec. 11): an open-loop burst overloads
    even the top rung; the load-adaptive policy moves down the ladder for
    throughput and climbs back once the queue drains, where a fixed
    full-bit deployment takes the whole backlog into its p95.  Returns
    {label: SchedulerReport}."""
    svc = ServiceModel()
    probe = NestQuantStore(nested, mode="full", dtype=torch.float32, device=dev)
    qps = calibrate_qps(probe, svc, steps=2, max_batch=8, utilization=0.4)
    peak = 1.05 * svc.capacity_rps(probe.rung_resident_bytes(0), 2, 8)
    print(f"\nburst trace: {qps:.0f} req/s steady, {peak:.0f} req/s burst")
    reports = {}
    for label, policy in (("static full", StaticRungPolicy(-1)),
                          ("adaptive", HysteresisPolicy(LoadAdaptivePolicy(high_depth=8),
                                                        dwell=2))):
        st = NestQuantStore(nested, mode="full", dtype=torch.float32, device=dev)
        eng = ServeEngine(cfg, st, max_batch=8, max_len=32, policy=policy)
        trace = LoadGenerator("burst", qps=qps, n_requests=200,
                              vocab_size=cfg.vocab_size, seed=0, new_tokens=2, burst_qps=peak,
                              burst_window=(0.25, 0.7))
        reports[label] = Scheduler(eng, trace, svc).run()
        print(f"  {label:12s}: " + reports[label].table())
    return reports


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = get_config("qwen2-1.5b").reduced()
    params = make_model(cfg, device=dev).init(0)
    nested = quantize(params, QuantRecipe(bits=BITS), device=dev)
    store, rungs = budget_walk(cfg, nested, dev)
    need = [store.rung_resident_bytes(r) for r in range(store.num_rungs)]
    switches = oscillating_budget(nested, need, dev)
    reports = burst(cfg, nested, dev)
    return {"rungs": rungs, "store": store, "switches": switches, "reports": reports}


if __name__ == "__main__":
    main()
