"""Fleet driver: N simulated replicas over one shared nested tree;
counterpart of ``repro/launch/fleet.py``.  Runs on the card unless
``--device cpu`` is given.

  # 4 replicas, mixed links, burst traffic on half of them, controller
  # rebalancing envelopes every 0.05 s of fleet virtual time
  PYTHONPATH=src python -m repro_torch.launch.fleet --arch qwen2-1.5b --smoke \\
      --bits 8,6,4 --replicas 4 --trace burst --requests 40 \\
      --new-tokens 2 --policy load --controller rebalance

  # chaos storm on every 3rd replica (same shared flags as launch.serve)
  PYTHONPATH=src python -m repro_torch.launch.fleet --arch qwen2-1.5b --smoke \\
      --bits 8,6,4 --replicas 8 --trace burst --requests 30 \\
      --new-tokens 2 --policy failure --chaos --chaos-every 3

  # emit a k8s-style indexed Job manifest stub for a real cluster
  PYTHONPATH=src python -m repro_torch.launch.fleet --arch qwen2-1.5b \\
      --replicas 16 --emit-k8s fleet-job.yaml

Replicas run in one process, one after another on one stream and one
shared virtual clock, sharing one model and one distribution tier.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..api import get_config, make_model
from .flags import chaos_profile, traffic_parent

K8S_TEMPLATE = """\
# NestQuant fleet Job stub (generated by repro_torch.launch.fleet --emit-k8s).
# One indexed completion per replica; every pod mounts the SAME artifact
# volume read-only and pages delta segments from the distribution
# service (the in-cluster analogue of repro_torch.fleet.DeltaDistribution).
apiVersion: batch/v1
kind: Job
metadata:
  name: nestquant-fleet
spec:
  completions: {n}
  parallelism: {n}
  completionMode: Indexed
  template:
    spec:
      restartPolicy: Never
      containers:
        - name: replica
          image: nestquant-serve:latest
          command: ["python", "-m", "repro_torch.launch.serve"]
          args: ["--arch", "{arch}", "--artifact", "/artifact",
                 "--trace", "{trace}", "--requests", "{requests}",
                 "--policy", "{policy}",
                 "--seed", "$(JOB_COMPLETION_INDEX)"]
          env:
            - name: NESTQUANT_DISTRIBUTION_ORIGIN
              value: http://nestquant-origin/delta
          volumeMounts:
            - name: artifact
              mountPath: /artifact
              readOnly: true
      volumes:
        - name: artifact
          persistentVolumeClaim:
            claimName: nestquant-artifact
"""


def make_specs(args, need: list) -> list:
    """The CLI's replica mix: round-robin link speeds, burst traffic on
    even replicas when --trace burst, chaos on every --chaos-every'th."""
    from ..api import ReplicaSpec
    links = [float(x) for x in args.link_mbps.split(",")]
    specs = []
    for i in range(args.replicas):
        trace = args.trace or "poisson"
        if trace == "burst" and i % 2 == 1:
            trace = "poisson"           # burst on a subset: the skewed shape
        specs.append(ReplicaSpec(
            name=f"replica{i}", link_mbps=links[i % len(links)],
            trace=trace, qps=args.qps, n_requests=args.requests,
            seed=args.seed + i, policy=args.policy,
            max_batch=args.max_batch, new_tokens=args.new_tokens,
            chaos=(chaos_profile(args, extra_seed=i)
                   if args.chaos and i % args.chaos_every == 0 else None)))
    return specs


def main(argv=None):
    # traffic/policy/chaos flags come from the shared parent (launch.flags)
    # so serve and fleet cannot drift apart
    ap = argparse.ArgumentParser(parents=[traffic_parent()])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the replicas run (default: cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--bits", default="8,6,4",
                    help="comma ladder bitwidths shared by the fleet")
    ap.add_argument("--replicas", "-N", type=int, default=4,
                    help="fleet size (default 4)")
    ap.add_argument("--link-mbps", default="100,25,400",
                    help="comma list of last-mile link speeds assigned "
                         "round-robin across replicas")
    ap.add_argument("--controller", default="rebalance",
                    choices=("rebalance", "equal", "none"),
                    help="global budget-envelope policy (default: "
                         "rebalance by observed backlog; 'equal' = static "
                         "total/N split; 'none' = local policies only)")
    ap.add_argument("--total-budget-x", type=float, default=1.5,
                    help="fleet budget as a multiple of N x top-rung "
                         "bytes (default 1.5)")
    ap.add_argument("--interval-s", type=float, default=0.05,
                    help="controller rebalance interval (fleet virtual "
                         "seconds)")
    ap.add_argument("--multicast-window-s", type=float, default=0.05,
                    help="edge transmissions within this window of shared "
                         "virtual time are joined, not repeated")
    ap.add_argument("--chaos-every", type=int, default=2,
                    help="with --chaos: inject faults on every K'th "
                         "replica (default 2 = half the fleet)")
    ap.add_argument("--json", default=None, metavar="OUT.json",
                    help="also write FleetReport.to_dict() as JSON")
    ap.add_argument("--emit-k8s", default=None, metavar="OUT.yaml",
                    help="write a k8s-style indexed Job manifest stub "
                         "for this fleet and exit (no simulation)")
    args = ap.parse_args(argv)
    if args.replicas <= 0:
        ap.error(f"--replicas must be > 0, got {args.replicas}")

    if args.emit_k8s:
        manifest = K8S_TEMPLATE.format(
            n=args.replicas, arch=args.arch, trace=args.trace or "poisson",
            requests=args.requests, policy=args.policy)
        with open(args.emit_k8s, "w") as f:
            f.write(manifest)
        print(f"[k8s] wrote {args.emit_k8s}: indexed Job, "
              f"{args.replicas} completions")
        return

    from ..api import FleetController, QuantRecipe, build_fleet, quantize
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = make_model(cfg, device=device).init(0)
    nested = quantize(params, QuantRecipe(bits=tuple(int(x) for x in args.bits.split(","))),
                      device=device)

    specs = make_specs(args, [])
    fleet = build_fleet(specs, cfg=cfg, nested_params=nested,
                        multicast_window_s=args.multicast_window_s, device=device)
    store0 = fleet.replicas[0].store
    top = store0.rung_resident_bytes(store0.num_rungs - 1)
    if args.controller != "none":
        fleet.controller = FleetController(
            int(args.total_budget_x * args.replicas * top),
            interval_s=args.interval_s, mode=args.controller)
    print(f"[fleet] {args.replicas} replicas over one "
          f"{sum(store0.bytes().values())/1e6:.2f}MB artifact; "
          f"links {args.link_mbps} Mbit/s round-robin; "
          f"controller={args.controller}")
    report = fleet.run()
    checked = report.verify_ledgers()
    print("[fleet] " + report.table())
    print(f"[fleet] every replica ledger exact: {checked} switch "
          f"records == computed bytes(delta_k)")
    for name, rep in report.replicas.items():
        s = rep.summary()
        print(f"  {name}: {s['requests']} reqs p95={s['p95_ms']:.1f}ms "
              f"mean_rung={s['mean_rung']:.2f} switches={s['switches']} "
              f"faults={s['fault_s']*1e3:.1f}ms")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_dict(), f, indent=1, sort_keys=True)
        print(f"[fleet] wrote {args.json}")


if __name__ == "__main__":
    main()
