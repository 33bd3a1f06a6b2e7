"""Shared trace/policy/chaos CLI flags; counterpart of
``repro/launch/flags.py``, with the same flags and defaults.

``launch/serve`` (one engine) and ``launch/fleet`` (N replicas) drive the
same serving stack, so they describe traffic, policies and fault
injection with the same flags: this module is the one argparse parent
both build on.  Usage::

    ap = argparse.ArgumentParser(parents=[traffic_parent()])

plus :func:`chaos_profile` (and
:func:`repro_torch.fleet.replica.build_policy`) to read the parsed values
the same way on both paths.
"""
from __future__ import annotations

import argparse

POLICY_CHOICES = ("budget", "hysteresis", "quality", "load", "failure")
TRACE_CHOICES = ("poisson", "burst", "diurnal")


def traffic_parent() -> argparse.ArgumentParser:
    """The shared --trace/--qps/--seed/--policy/--chaos* flag set, as an
    ``add_help=False`` argparse parent."""
    ap = argparse.ArgumentParser(add_help=False)
    g = ap.add_argument_group("traffic (shared by serve and fleet)")
    g.add_argument("--trace", default=None, choices=TRACE_CHOICES,
                   help="drive serving from an open-loop arrival trace "
                        "through the continuous-batching Scheduler "
                        "(DESIGN.md Sec. 11); --requests becomes the "
                        "trace length")
    g.add_argument("--qps", type=float, default=None,
                   help="steady arrival rate (default: 40%% of the top "
                        "rung's virtual service capacity)")
    g.add_argument("--requests", type=int, default=8,
                   help="requests per phase (or trace length with --trace)")
    g.add_argument("--new-tokens", type=int, default=8,
                   help="decode steps per request")
    g.add_argument("--max-batch", type=int, default=8,
                   help="admission batch size")
    g.add_argument("--seed", type=int, default=0,
                   help="arrival trace seed")
    g = ap.add_argument_group("policy (shared by serve and fleet)")
    g.add_argument("--policy", default="budget", choices=POLICY_CHOICES,
                   help="rung policy driving each engine (default: budget; "
                        "'load' = backlog-driven LoadAdaptivePolicy wrapped "
                        "in hysteresis - the natural pick with --trace; "
                        "'failure' = the load stack wrapped in "
                        "FailureAwarePolicy, which holds upgrades below "
                        "the deliverable ceiling after delivery faults)")
    g.add_argument("--dwell", type=int, default=4,
                   help="hysteresis dwell window (decisions)")
    g.add_argument("--quality-floor", type=float, default=20.0,
                   help="quality policy: min SQNR dB vs the full-bit model")
    g = ap.add_argument_group("fault injection (shared by serve and fleet)")
    g.add_argument("--chaos", action="store_true",
                   help="inject seeded faults on the delta-paging link "
                        "(ChaosPager) and fetch through retry + CRC "
                        "re-verification (ResilientPager); DESIGN.md "
                        "Sec. 12")
    g.add_argument("--chaos-seed", type=int, default=0,
                   help="fault-injection seed (default 0)")
    g.add_argument("--chaos-transient", type=float, default=0.2,
                   help="per-fetch transient failure probability")
    g.add_argument("--chaos-corrupt", type=float, default=0.05,
                   help="per-fetch CRC-corrupting bit-flip probability")
    g.add_argument("--chaos-stall", type=float, default=0.05,
                   help="per-fetch stall probability (stalls burn virtual "
                        "time on the scheduler clock)")
    g.add_argument("--retry-attempts", type=int, default=4,
                   help="with --chaos: ResilientPager attempts per fetch")
    return ap


def chaos_profile(args, extra_seed: int = 0):
    """The parsed --chaos* flags as a fleet ChaosProfile (None when
    --chaos is off).  ``extra_seed`` offsets the seed per replica so a
    storm on a subset stays deterministic but not identical."""
    if not args.chaos:
        return None
    from ..fleet.replica import ChaosProfile
    return ChaosProfile(seed=args.chaos_seed + extra_seed,
                        p_transient=args.chaos_transient,
                        p_corrupt=args.chaos_corrupt,
                        p_stall=args.chaos_stall,
                        retry_attempts=args.retry_attempts)
