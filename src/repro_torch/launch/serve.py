"""Serving driver: a NestQuant model, batched requests and policy
switching; counterpart of ``repro/launch/serve.py``, with every path of
the reference CLI.  Runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \\
      --requests 16 --budget-schedule full,part,full

  # K-rung ladder: phases may name any rung (rung0..rungK-1 | part | full)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \\
      --bits 8,6,4 --budget-schedule full,rung1,part,full

  # declarative per-layer recipe + dwell-window policy
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \\
      --recipe examples/recipe.json --policy hysteresis

  # calibration-driven recipe search, then serve the result
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \\
      --bits 8,6,4 --search-recipe 12 --search-out search.json

  # storage tier: ship one artifact, boot from it
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \\
      --bits 8,6,4 --save-artifact nest_artifact
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \\
      --artifact nest_artifact --link-mbps 100

  # load-adaptive serving of a burst trace, through injected link faults
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \\
      --bits 8,6,4 --trace burst --requests 200 --new-tokens 2 \\
      --policy failure --chaos --chaos-transient 0.3

  # self-speculative ladder decoding: the part-bit rung drafts K tokens,
  # one chunked full-bit pass verifies them
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \\
      --bits 8,6,4 --trace poisson --requests 40 --new-tokens 16 \\
      --speculate 4 --draft-rung 0

The weights are random, from the port's seeded ``Model.init`` (a
``torch.Generator``), so tokens and quality scores differ from the JAX
package's CLI; every line that depends only on shapes, bytes and the
virtual clock is the same.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..api import (NestQuantStore, QuantRecipe, Request, ServeEngine, SpecConfig,
                   get_config, make_model, quantize, recipe_summary)
from ..core.nesting import mode_to_rung
from .flags import traffic_parent


def main(argv=None):
    # traffic/policy/chaos flags come from the shared parent (launch.flags)
    # so serve and fleet cannot drift apart
    ap = argparse.ArgumentParser(parents=[traffic_parent()])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--h", type=int, default=4)
    ap.add_argument("--bits", default=None,
                    help="comma ladder bitwidths (e.g. 8,6,4); overrides n/h")
    ap.add_argument("--recipe", default=None, metavar="recipe.json",
                    help="declarative QuantRecipe JSON (per-layer ladders; "
                         "overrides --bits/--n/--h)")
    ap.add_argument("--rounding", default=None,
                    choices=("bitshift", "rtn", "adaptive"),
                    help="ladder-split rounding for --bits/--n/--h recipes "
                         "(default: adaptive; ignored with --recipe, which "
                         "carries its own)")
    ap.add_argument("--search-recipe", default=None, metavar="BUDGET_MB",
                    help="run the calibration-driven recipe search under a "
                         "full-resident byte budget of BUDGET_MB megabytes "
                         "('none' = unbudgeted), print the per-layer ladder "
                         "table, and serve from the emitted recipe; --bits is "
                         "the candidate chain, --seed seeds calibration")
    ap.add_argument("--search-out", default=None, metavar="search.json",
                    help="with --search-recipe: also write the full "
                         "SearchResult JSON (recipe + sensitivity table)")
    ap.add_argument("--budget-schedule", default="full,part,full",
                    help="comma list of full|part|rungK phases")
    ap.add_argument("--save-artifact", default=None, metavar="DIR",
                    help="quantize per --recipe/--bits, write a NestQuant "
                         "artifact, and exit")
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="cold-boot from a saved artifact: read manifest + "
                         "base segment only, page deltas from disk on demand")
    ap.add_argument("--link-mbps", type=float, default=None,
                    help="with --artifact: simulate paging over an N Mbit/s "
                         "link (ThrottledPager) and report transfer seconds")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="self-speculative decoding: draft K tokens per round "
                         "at the draft rung, verify with ONE chunked "
                         "full-residency pass (0 = off).  With --trace, "
                         "drafting is armed and the policy gates it per batch "
                         "on backlog depth")
    ap.add_argument("--draft-rung", default="0", metavar="R",
                    help="draft rung for --speculate: an int rung index or "
                         "'floor' (per-leaf QualityFloorPolicy floors; needs "
                         "--policy quality)")
    args = ap.parse_args(argv)
    spec = None
    if args.speculate:
        draft = args.draft_rung if args.draft_rung == "floor" else int(args.draft_rung)
        spec = SpecConfig(k=args.speculate, draft=draft)
    if args.policy in ("load", "failure") and not args.trace:
        # the budget-schedule path reports the batch size as queue_depth,
        # which would read as permanent backlog pressure to the load policy
        ap.error(f"--policy {args.policy} needs real traffic signals: use "
                 "it with --trace poisson|burst|diurnal")

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    batch_cap = args.max_batch if args.trace else args.requests

    def build_policy():
        # one policy composition for serve AND fleet (fleet.replica)
        from ..fleet.replica import build_policy as build
        return build(args.policy, max_batch=args.max_batch, dwell=args.dwell,
                     quality_floor=args.quality_floor)

    clock = None
    chaos_state = {}

    def chaosify(pager):
        """Wrap the delta link in ChaosPager -> ResilientPager on a virtual
        clock shared with the Scheduler."""
        if not args.chaos:
            return pager
        nonlocal clock
        from ..storage.pager import ChaosPager, ResilientPager, RetryPolicy, VirtualClock
        clock = VirtualClock()
        chaos = ChaosPager(pager, seed=args.chaos_seed, p_transient=args.chaos_transient,
                           p_corrupt=args.chaos_corrupt, p_stall=args.chaos_stall,
                           stall_s=2e-4, clock=clock)
        resilient = ResilientPager(
            chaos, RetryPolicy(max_attempts=args.retry_attempts, backoff_base_s=1e-4,
                               quarantine_s=2e-3),
            seed=args.chaos_seed + 1)
        chaos_state.update(chaos=chaos, resilient=resilient)
        return resilient

    if args.artifact:
        from ..storage.artifact import open_artifact
        from ..storage.pager import FilePager, ThrottledPager
        art = open_artifact(args.artifact)
        pager = FilePager(art, device=device)
        if args.link_mbps:
            pager = ThrottledPager(pager, bandwidth_bytes_per_s=args.link_mbps * 125e3)
        engine = ServeEngine.from_artifact(
            cfg, art, pager=chaosify(pager), max_batch=batch_cap, max_len=64,
            device=device, policy=build_policy())
        store = engine.store
        print(f"[artifact] cold boot read "
              f"{sum(art.bytes_read.values())/1e6:.2f}MB "
              f"(manifest+base) of {art.total_nbytes()/1e6:.2f}MB total; "
              f"serving at mode={store.mode}")
    else:
        params = make_model(cfg, device=device).init(0)
        rkw = {"rounding": args.rounding} if args.rounding else {}
        if args.recipe:
            with open(args.recipe) as f:
                recipe = QuantRecipe.from_json(f.read())
        elif args.search_recipe is not None:
            from ..core.search import search_recipe
            budget = (None if args.search_recipe.lower() == "none"
                      else int(float(args.search_recipe) * 1e6))
            chain = (tuple(int(x) for x in args.bits.split(","))
                     if args.bits else (8, 6, 4))
            result = search_recipe(params, budget, bits=chain, seed=args.seed, **rkw)
            print("[search] " + result.table())
            if args.search_out:
                with open(args.search_out, "w") as f:
                    f.write(result.to_json())
                print(f"[search] wrote {args.search_out}")
            recipe = result.recipe
        elif args.bits:
            recipe = QuantRecipe(bits=tuple(int(x) for x in args.bits.split(",")), **rkw)
        else:
            recipe = QuantRecipe(bits=(args.h, args.n), **rkw)
        nested = quantize(params, recipe, device=device)
        if args.recipe or args.search_recipe is not None:
            print("[recipe] per-leaf ladders:")
            print(recipe_summary(nested))
        if args.save_artifact:
            from ..storage.artifact import save_artifact
            manifest = save_artifact(nested, args.save_artifact, recipe=recipe)
            for name, seg in manifest["segments"].items():
                print(f"[artifact] {seg['file']}: {seg['nbytes']/1e6:.2f}MB")
            print(f"[artifact] wrote {args.save_artifact}")
            return
        pager = None
        if args.chaos:
            from ..storage.pager import InMemoryPager
            pager = chaosify(InMemoryPager.from_tree(nested))
        store = NestQuantStore(nested, mode="part", dtype=torch.float32, pager=pager,
                               device=device)
        engine = ServeEngine(cfg, store, max_batch=batch_cap, max_len=64,
                             policy=build_policy())

    b = store.bytes()
    need = [store.rung_resident_bytes(r) for r in range(store.num_rungs)]
    print(f"[store] high={b['high']/1e6:.2f}MB low={b['low']/1e6:.2f}MB "
          f"scales={b['scales']/1e6:.2f}MB fp={b['fp']/1e6:.2f}MB; "
          f"resident/rung " +
          ",".join(f"{x/1e6:.2f}MB" for x in need))

    if args.trace:
        # load-adaptive serving: schedule an open-loop arrival trace; the
        # policy sees real backlog, not a hand-written budget schedule
        from ..serving.scheduler import LoadGenerator, Scheduler, ServiceModel, calibrate_qps
        svc = ServiceModel()
        qps = args.qps or calibrate_qps(store, svc, steps=args.new_tokens,
                                        max_batch=args.max_batch, utilization=0.4)
        burst = 1.05 * svc.capacity_rps(need[0], args.new_tokens, args.max_batch)
        trace = LoadGenerator(args.trace, qps=qps, n_requests=args.requests,
                              vocab_size=cfg.vocab_size, seed=args.seed,
                              new_tokens=args.new_tokens, burst_qps=burst)
        print(f"[trace {args.trace}] {args.requests} requests at "
              f"{qps:.0f} req/s steady"
              + (f", {burst:.0f} req/s burst" if args.trace == "burst" else ""))
        if spec is not None:
            # run every (rung, shape) dispatch once, draft stamp and verify
            # chunk included: nothing is built mid-serve
            calls = engine.warmup(trace.prompt_len, spec=spec)
            print(f"[speculate] armed k={spec.k} draft={spec.draft!r}; "
                  f"warmup pre-traced {calls} dispatch shapes")
        report = Scheduler(engine, trace, svc, max_batch=args.max_batch,
                           clock=clock, speculate=spec).run()
        print("[load] " + report.table())
        if spec is not None:
            s = report.summary()
            print(f"[speculate] {s['spec_steps']}/{len(report.steps)} "
                  f"batches drafted; acceptance="
                  f"{s['spec_acceptance']:.3f} "
                  f"({s['spec_accepted']}/{s['spec_drafted']} tokens); "
                  f"output bit-identical to plain full-bit greedy decode")
        for rec in report.switch_records:
            print(f"  step {rec['step']}: rung {rec['from_rung']} -> "
                  f"{rec['to_rung']}: in {rec['page_in']/1e6:.2f}MB "
                  f"out {rec['page_out']/1e6:.2f}MB "
                  f"(= computed bytes(delta_k))")
        if args.chaos:
            ch, rs = chaos_state["chaos"], chaos_state["resilient"]
            f = ch.faults
            print(f"[chaos] fetches={ch.fetches} "
                  f"transient={f['transient']} corrupt={f['corrupt']} "
                  f"stall={f['stall']} outage={f['outage']}; "
                  f"retries={rs.retries} quarantines={rs.quarantines} "
                  f"failed_switches={engine.stats.switch_failures} "
                  f"(all requests served: {len(report.requests)}"
                  f"/{args.requests})")
        return

    rng = np.random.default_rng(0)
    uid = 0
    for phase in args.budget_schedule.split(","):
        # budget that admits exactly the requested rung (and nothing above)
        rung = mode_to_rung(phase, store.num_rungs)
        budget = need[-1] * 2 if rung == store.num_rungs - 1 else need[rung]
        reqs = []
        for _ in range(args.requests):
            reqs.append(Request(uid, rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
                                max_new_tokens=args.new_tokens))
            uid += 1
        t0 = time.time()
        engine.generate(reqs, memory_budget_bytes=int(budget), speculate=spec)
        dt = time.time() - t0
        print(f"[phase {phase}] mode={store.mode} (rung {store.rung}) "
              f"{args.requests} reqs x {args.new_tokens} tokens in {dt:.2f}s; "
              f"ledger: in={store.ledger.page_in_bytes/1e6:.2f}MB "
              f"out={store.ledger.page_out_bytes/1e6:.2f}MB "
              f"switches={store.ledger.switches}")
        if spec is not None and engine.last_profile.speculative:
            p = engine.last_profile
            print(f"  [speculate] {p.verify_passes} rounds, "
                  f"acceptance={p.acceptance:.3f}, "
                  f"draft bytes/step {p.draft_bytes/1e6:.2f}MB vs "
                  f"verify {p.verify_bytes/1e6:.2f}MB")
    red = store.switch_reduction()
    print(f"[switching] overhead reduction vs diverse-bitwidths: {red:.1%}")
    if args.artifact and args.link_mbps:
        print(f"[link] paged {pager.bytes_moved/1e6:.2f}MB over a "
              f"{args.link_mbps:g} Mbit/s link: "
              f"{pager.simulated_seconds:.2f}s simulated transfer")


if __name__ == "__main__":
    main()
