#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of NestQuant (``src/repro_torch``) on one
NVIDIA H100 and check it.

    python3 chip_smoke.py [--report PATH]

Phases (each raises on failure; the script then exits non-zero):

1. Build the hand-written CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc for sm_90a (the ptxas report is printed once), then hold each of
   K1 packed_matmul / K2 nested_matmul / K3 ladder_matmul against its
   plain PyTorch version at every main-path shape of qwen2-1.5b (q/o,
   k/v, gate/up, down, lm_head) at M in {1, 2, 4, 8, 32}, bf16 and f32, and
   time it (CUDA events, cold L2), its plain version and a dense bf16
   ``torch.matmul`` of the same shape (a yardstick only; the port never
   calls it).  Every row at M <= 8 must launch on the decode body (its
   counter says so) and is timed beside the same call on the CUDA-core
   body (``route="cuda_core"``, the "before").  Then the prefill rows: bf16 at M = 64, 2200 (2 x 1100,
   ragged against the 256-row tile) and 4096 (2 x 2048) for q/o, k/v,
   gate/up and down, each launched on the tensor-core body the route
   picks (its counter must say so), held to 2e-2 of max(1, max |y|)
   against the plain version and timed beside the same call on the
   CUDA-core body (``route="cuda_core"``, the "before") and the dense
   bf16 yardstick.
2. Serve full-width qwen2-1.5b (random weights from a seeded generator,
   nested on the (8, 6, 4) ladder) through ``ServeEngine.generate``: four
   calls of 4 requests x 8 prompt tokens x 8 new tokens under budgets
   that land on rungs 2, 0, 1, 2.  The launch counters must show every
   ``packed_linear`` (28 * 7 + 1 per forward) on the kernel of its rung
   and no plain version: the 32-row prefill's 196 on the CUDA-core body,
   its LM head (M = 4) and every decode step on the decode body.
3. Run the same requests through the plain versions (the scoped
   ``reference_pass``) with ``compute_dtype="float32"`` as the reference:
   the f32 kernel path within 1e-4 of it (logits relative to max |logit|)
   with greedy tokens identical; the bf16 kernel path's prefill logits
   within 3e-2 of it and of the plain bf16 pass.  What a kernel that
   drops one delta stream would read is printed beside them.
3b. Ship the phase-2 store as one artifact (``save_artifact`` at rung 2,
   into ``build/``, removed at the end) and serve it as a deployment does:
   a cold boot of ``ServeEngine.from_artifact`` with only the manifest and
   the base segment on disk (a ``FilePager`` onto the card behind a 100
   Mbit/s ``ThrottledPager`` on a virtual clock), phase 2's tokens at rung
   0, then at rungs 1 and 2 as ``delta_0`` and ``delta_1`` arrive and
   ``poll_delivery`` pages exactly each segment's bytes (each poll's
   disk-to-card rate beside the in-memory pager's); ``warmup``; a
   ``Scheduler`` over a 48-request burst trace under the CLI's ``load``
   composition, after which no kernel library, decode-body plan or counter
   buffer is new; and a kv-aware ``Scheduler`` over 16 requests of 512
   prompt tokens on the nested KV cache.  Every switch pages its expected
   bytes and every packed_linear runs on its rung's kernel.
3c. Self-speculative decoding and delivery faults on the phase-2 store.
   Rows: q/o, k/v, gate/up, down and the LM head at rungs 0-2, bf16 and
   f32 - the rows of a decode-route call at M = 12 and 20 (a verify
   chunk of batch 4, k = 2 and 4: the decode body once per group of 8
   rows) equal bit for bit the same rows of M = 4 and M = 1 decode calls;
   each bf16 verify call timed beside the k + 1 decode calls it replaces,
   and a decode step's K1-K3 at batch 16 and 64 timed on the decode route
   (which the decode phase names at every batch) beside the body M alone
   picks (CUDA cores at 16, tensor cores at 64).
   Serve: 4 requests x 8 prompt tokens x 16 new tokens at rung 2 in bf16
   and f32, ``SpecConfig(k=4, draft=0)`` and ``SpecConfig(k=2, draft=1)``
   emit the plain ``generate``'s tokens, every draft step on its rung's
   kernel and every verify on the decode body in groups, no plain launch;
   rounds, acceptance, wall and device busy printed.  Faults: the store's
   pager behind ``ResilientPager(ChaosPager(...))`` (transient faults,
   flipped bits, an outage of delta_1) on one ``VirtualClock`` with a
   ``Scheduler`` under ``make_policy("failure")``, 24 requests from rung
   0: every request completes, every K1-K3 launch on its rung's kernel and
   every decode step's on the decode body, at least one switch fails and
   at least one upgrade commits through the faulty pager; every failed
   switch leaves every resident stream on the card bit-identical and the
   ledger unchanged, every committed upgrade serves streams equal to the
   pristine ones, no step upgrades above the deliverable rung; a forced
   failed upgrade rolls back the same way and a flipped bit is caught by
   the CRC and healed by a retry.
3d. A fleet on the card at full width: ``build_fleet`` over the phase-2
   store's (8, 6, 4) tree at rung 2, four replicas of the fleet CLI's mix
   (``launch/fleet.py::make_specs``: links 100, 25 and 400 Mbit/s, burst
   traffic on even replicas and Poisson on odd ones, ``--policy
   failure``, chaos on replicas 0 and 2; 12 requests of 2 new tokens, max
   batch 4) under ``FleetController(1.5 x 4 x top-rung bytes, interval_s
   0.05, "rebalance")``.  Every request served, every switch record
   paging its computed ``bytes(delta_k)``, fleet bytes below unicast and
   model-zoo bytes, dedup hits, every K1-K3 launch on its rung's kernel
   and none plain, the shared tree and every replica's streams equal to
   the pristine ones, and one served batch per (replica, rung) re-served
   with the same tokens by a lone engine over the phase-2 store; the
   fleet table, per-replica figures, chaos counts, envelope changes by
   reason, wall, device busy share and peak memory printed.  Then the
   serve CLI (burst trace through faults, ``--save-artifact`` and
   ``--artifact --link-mbps 100``, ``--speculate 2``, ``--search-recipe
   none``) and the fleet CLI (``--replicas 4 --json``) in-process at
   ``--smoke`` on the card and on the CPU: each exits 0, no K1-K3 call on
   the card runs a plain version, and the card's lines equal the CPU's
   but for the wall seconds and what depends on the weights.
4. Time the launch floor (a one-element ``zero_()`` under CUDA-graph
   replay).  Hold K4 nested_qk (bit for bit, every KV rung of (4, 6, 8) and
   (3, 5, 6, 8), M = 6 and 48; every row beside a control with the same
   streams and the query codes pushed out of int8 range, which takes K4's
   CUDA-core path instead of its int8 tensor cores), K5 flash_attention
   (S 1100, 2048, 4096, bf16 within 2e-2 and f32 within 1e-4, both of max
   |o| and of every output row's own norm) and K6 nest_recompose (bit for
   bit, (n, h) (6, 4), (8, 6), (8, 4) on every weight shape; the page-in of
   the whole tree at (6, 4) is the sum over shapes times their uses)
   against their plain versions at the long-context path's shapes, timed
   like K1-K3; ``scaled_dot_product_attention`` is timed beside K5 as its
   library yardstick (the port never calls it).
5. Long-context serving on the nested KV cache: 2 requests x 2048 prompt
   tokens x 8 new tokens, ``kv=KVCacheConfig((4, 6, 8), 16, "rtn")`` under
   a ``LoadAdaptivePolicy``, five calls whose queue depths walk the KV
   rung 2 -> 1 -> 0 -> 1 -> 2.  Each prefill launches K5 once per layer and
   the plain blockwise version never, and its 196 weight matmuls (28
   layers x 7) on the tensor-core body, while every decode step and the
   prefill's LM head (M = 2) take the decode body; every KV ledger
   event equals its
   metadata-computed bytes; the top-rung rendering is within 0.02 of the
   dense prefill K/V; the wall time of each ``_kv_ingest`` is printed.
   Then ``nested_attention`` (K4) on the served cache's
   own pages at every rung (bit-exact against the plain version, error
   against the dense oracle shrinking with the rung), a profile of one long
   generate, the f32 long prefill within 1e-4 of its plain pass with
   identical greedy tokens, and K6 on every weight slice of the served
   tree equal to ``chain_recompose`` at rung 1.

The per-shape table and every other measurement go to ``--report``
(default ``build/chip_smoke.json``).  The line before the last prints the
kernels (launches, error, times, bound); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, the script fails before any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# K5 per output row (b, s, head): |kernel - plain| / |plain|, L2 over hd.
# A late row's |o| is ~50x below max |o| (the first rows), so the max |o|
# measure above cannot see a fault confined to late rows; this one can.
# Sound kernels and a control that drops one key tile are in PERF.md.
ROW_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# bf16 end to end (prefill logits, relative to max |logit|): sound kernels
# read 1.68-2.27e-2 against the f32 plain pass and 1.94-2.11e-2 against the
# bf16 plain pass on this seeded model, the same in every run (see PERF.md)
BF16_E2E_TOL = 3e-2
BITS = (8, 6, 4)
MS = (1, 2, 4, 8, 32)    # decode at batch 1-8 (2: the long path's), the short prefill
# prefill rows (bf16): the route's threshold, the ragged 2 x 1100 prefill
# and the long-context path's 2 x 2048
PREFILL_MS = (64, 2 * 1100, 2 * 2048)
L2_BYTES = 50e6
KERNELS = {  # name -> (rung it serves, source, TPU kernel it replaces)
    "packed_matmul": (0, "src/repro_torch/csrc/nest_matmul.cu",
                      "src/repro/kernels/packed_matmul/kernel.py:48"),
    "nested_matmul": (1, "src/repro_torch/csrc/nest_matmul.cu",
                      "src/repro/kernels/nested_matmul/kernel.py:61"),
    "ladder_matmul": (2, "src/repro_torch/csrc/nest_matmul.cu",
                      "src/repro/kernels/nested_matmul/kernel.py:125"),
}
KV_KERNELS = {  # name -> (source, TPU kernel it replaces)
    "nested_qk": ("src/repro_torch/csrc/nested_qk.cu",
                  "src/repro/kernels/nested_attention/kernel.py:69"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:60"),
    "nest_recompose": ("src/repro_torch/csrc/nest_recompose.cu",
                       "src/repro/kernels/nest_recompose/kernel.py:28"),
}
# K4's codes are <= 8 bits, so the card's peak for its products is int8's
PEAK_INT8_OPS = 1979e12
# one page-in of the tree at (6, 4) on the one-thread-per-code K6 body it
# replaces (PERF.md section 6, H100 80GB HBM3 at 700 W): printed beside
# this run's total, never used as a measurement of this run
K6_TREE_MS_BEFORE = 15.35
SERVE_SCHEDULE = (2, 0, 1, 2)
DEVICE = "cuda"
BATCH, PROMPT, NEW_TOKENS, MAX_LEN = 4, 8, 8, 64
# long-context serving on the nested KV cache: queue depths that walk the KV
# rung 2 -> 1 -> 0 -> 1 -> 2 under LoadAdaptivePolicy(high_depth=8, low_depth=0)
BATCH_LONG, PROMPT_LONG, KV_PAGE = 2, 2048, 16
LONG_QUEUE = (0, 8, 8, 0, 0)
RENDER_TOP_TOL = 0.02       # the reference bench's top-rung render limit
# the artifact phase: a 100 Mbit/s link on the virtual clock, the CLI's
# "--policy load" dwell, a 48-request burst trace, and a kv-aware run of 16
# requests x 512 prompt tokens
LINK_BYTES_PER_S = 12.5e6
SCHED_DWELL, SCHED_REQUESTS = 4, 48
KV_SCHED_REQUESTS, KV_PROMPT = 16, 512


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main_path_shapes(cfg):
    """(name, K, N, uses per forward, out f32) of every packed_linear."""
    d, L = cfg.d_model, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return [("q/o", d, qd, 2 * L, False), ("k/v", d, kvd, 2 * L, False),
            ("gate/up", d, cfg.d_ff, 2 * L, False), ("down", cfg.d_ff, d, L, False),
            ("lm_head", d, cfg.vocab_size, 1, True)]


# ---------------------------------------------------------------------------
# phase 1: build, per-kernel check and timing
# ---------------------------------------------------------------------------
def time_ms(fn, iters: int) -> float:
    """Eager time per call: CUDA events around ``iters`` calls, warmed."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, iters: int, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so host launch overhead (Python, ctypes) is not measured.
    The capture runs on the stream the warm-up ran on: the decode body's
    arrival counters are that stream's, sized by the warm-up (nothing may
    be allocated under capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


def kernel_call(name, nt, x, copies, out_dtype, route=None):
    """A closure launching kernel ``name`` on copy ``i % len(copies)`` of
    the leaf's streams (copies exceed L2, as a decode step finds it), on
    the body the route picks or on ``route``."""
    from repro_torch.kernels.nested_matmul import ops as nops
    from repro_torch.kernels.packed_matmul import ops as pops

    rung = KERNELS[name][0]
    scale = nt.rung_scale(rung).reshape(1, -1).contiguous()
    bits = nt.bits[:rung + 1]

    def call(i):
        s = copies[i % len(copies)]
        if name == "packed_matmul":
            return pops.packed_matmul(x, s[0], scale, k=bits[0], K=nt.K,
                                      block_k=nt.block, out_dtype=out_dtype, route=route)
        if name == "nested_matmul":
            return nops.nested_matmul(x, s[0], s[1], scale, n=bits[1], h=bits[0],
                                      K=nt.K, block_k=nt.block, out_dtype=out_dtype,
                                      route=route)
        return nops.ladder_matmul(x, s[:rung + 1], scale, bits=bits, K=nt.K,
                                  block_k=nt.block, out_dtype=out_dtype, route=route)
    return call


def prefill_rows(shape, K, N, uses, nt, streams, copies, dense, gen):
    """bf16 rows at ``PREFILL_MS``: each kernel on the tensor-core body
    the route picks (its counter must show it) against its plain version
    within 2e-2 of max(1, max |y|), timed by CUDA-graph replay beside the
    same call on the CUDA-core body (the "before") and the dense bf16
    yardstick; bound by operations at these M."""
    from repro_torch.kernels import dispatch

    rows = []
    for M in PREFILL_MS:
        x = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        if dispatch.matmul_route(M, x.dtype, x.device) != dispatch.TENSOR_CORE:
            raise AssertionError(f"M={M} bf16 does not take the tensor-core body")
        for name, (rung, _, _) in KERNELS.items():
            counter = dispatch.COUNTERS[name]
            call = kernel_call(name, nt, x, copies, torch.bfloat16)
            before = (counter.launches, counter.tc_launches)
            got = call(0)
            if (counter.launches, counter.tc_launches) != (before[0] + 1, before[1] + 1):
                raise AssertionError(f"{name} {shape} M={M}: not launched on the tensor-core "
                                     f"body ({before} -> {counter})")
            with dispatch.reference_pass():
                ref = call(0)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            peak = ref.float().abs().max().item()
            tol = TOL[torch.bfloat16]
            if not (math.isfinite(err) and err <= tol * max(1.0, peak)):
                raise AssertionError(f"{name} {shape} M={M} tensor-core body: max |kernel - "
                                     f"plain| = {err} > {tol} * max(1, {peak})")
            del got, ref
            ms = time_graph_ms(call, 5, reps=3)
            cc_ms = time_graph_ms(kernel_call(name, nt, x, copies, torch.bfloat16,
                                              route=dispatch.CUDA_CORE), 2, reps=2)
            with dispatch.reference_pass():
                plain_ms = time_ms(call, 1)
            dense_ms = time_graph_ms(lambda i: torch.matmul(x, dense[i % len(dense)]), 5, reps=3)
            nbytes = (x.numel() * 2 + sum(s.numel() * 4 for s in streams[:rung + 1])
                      + N * 4 + M * N * 2)
            flops = 2.0 * M * N * K
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
            rows.append({
                "kernel": name, "shape": shape, "K": K, "N": N, "M": M, "dtype": "bfloat16",
                "route": dispatch.TENSOR_CORE, "uses_per_forward": uses,
                "max_abs_err": err, "max_abs_ref": peak, "ms": ms, "cuda_core_ms": cc_ms,
                "plain_ms": plain_ms, "dense_bf16_matmul_ms": dense_ms, "bytes": nbytes,
                "flops": flops, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            log(f"[prefill] {name:13s} {shape:8s} M={M:4d} bf16 err={err:.2e} tensor-core "
                f"ms={ms:.4f} cuda-core ms={cc_ms:.4f} ({cc_ms / ms:.1f}x) plain={plain_ms:.3f} "
                f"dense_bf16={dense_ms:.4f} bound={rows[-1]['bound_ms']:.4f}")
    return rows


def phase_kernels(cfg, gen):
    from repro_torch.core.nesting import nest_quantize
    from repro_torch.kernels import build, dispatch

    t0 = time.time()
    build.build_all()
    log(f"[build] nvcc sm_90a in {time.time() - t0:.1f}s")
    for source, text in build.build_logs.items():
        log(f"[build] ptxas report for {source}:\n{text.strip()}")
    rows = []
    for shape, K, N, uses, out_f32 in main_path_shapes(cfg):
        w = torch.randn(K, N, generator=gen, device=DEVICE) / math.sqrt(K)
        nt = nest_quantize(w, bits=BITS, rounding="rtn")
        del w
        streams = (nt.w_base,) + nt.deltas
        # enough copies that even the base stream alone cycles through 2x L2
        n_copies = max(1, min(256, math.ceil(2 * L2_BYTES / (nt.w_base.numel() * 4))))
        copies = [streams] + [tuple(s.clone() for s in streams) for _ in range(n_copies - 1)]
        dense = [torch.randn(K, N, generator=gen, device=DEVICE, dtype=torch.bfloat16)
                 for _ in range(max(1, min(256, math.ceil(2 * L2_BYTES / (K * N * 2)))))]
        for dtype in (torch.bfloat16, torch.float32):
            out_dtype = torch.float32 if out_f32 else dtype
            for M in MS:
                x = torch.randn(M, K, generator=gen, device=DEVICE).to(dtype)
                xd = x.to(torch.bfloat16)
                route = dispatch.matmul_route(M, dtype, x.device)
                for name, (rung, _, _) in KERNELS.items():
                    counter = dispatch.counter(name)
                    call = kernel_call(name, nt, x, copies, out_dtype)
                    before = (counter.launches, counter.dec_launches)
                    got = call(0)
                    dec = int(route == dispatch.DECODE)
                    if (counter.launches, counter.dec_launches) != (before[0] + 1, before[1] + dec):
                        raise AssertionError(f"{name} {shape} M={M} {dtype}: not launched on the "
                                             f"{route} body ({before} -> {counter})")
                    with dispatch.reference_pass():
                        ref = call(0)
                    torch.cuda.synchronize()
                    err = (got.float() - ref.float()).abs().max().item()
                    peak = ref.float().abs().max().item()
                    if not (math.isfinite(err) and err <= TOL[dtype] * max(1.0, peak)):
                        raise AssertionError(
                            f"{name} {shape} M={M} {dtype}: max |kernel - plain| = {err} "
                            f"> {TOL[dtype]} * max(1, {peak})")
                    ms = time_graph_ms(call, 20)
                    host_ms = time_ms(call, 20)
                    cc_ms = (time_graph_ms(kernel_call(name, nt, x, copies, out_dtype,
                                                       route=dispatch.CUDA_CORE), 20)
                             if dec else None)
                    with dispatch.reference_pass():
                        plain_ms = time_ms(call, 3)
                    dense_ms = time_graph_ms(lambda i: torch.matmul(xd, dense[i % len(dense)]), 20)
                    nbytes = (x.numel() * x.element_size()
                              + sum(s.numel() * 4 for s in streams[:rung + 1])
                              + N * 4 + M * N * torch.empty((), dtype=out_dtype).element_size())
                    flops = 2.0 * M * N * K
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
                    rows.append({
                        "kernel": name, "shape": shape, "K": K, "N": N, "M": M,
                        "dtype": str(dtype).replace("torch.", ""), "uses_per_forward": uses,
                        "route": route, "max_abs_err": err, "max_abs_ref": peak, "ms": ms,
                        "cuda_core_ms": cc_ms, "eager_call_ms": host_ms,
                        "plain_ms": plain_ms, "dense_bf16_matmul_ms": dense_ms,
                        "bytes": nbytes, "flops": flops,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
                    before_ms = "" if cc_ms is None else f" cuda-core={cc_ms:.4f}"
                    log(f"[kernel] {name:13s} {shape:8s} M={M:2d} {rows[-1]['dtype']:8s} "
                        f"{route:9s} err={err:.2e} ms={ms:.4f}{before_ms} eager={host_ms:.4f} "
                        f"plain={plain_ms:.3f} dense_bf16={dense_ms:.4f} "
                        f"bound={rows[-1]['bound_ms']:.4f}")
        if not out_f32:           # a prefill's LM head sees only the last token
            rows += prefill_rows(shape, K, N, uses, nt, streams, copies, dense, gen)
        del copies, dense, nt, streams
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 2 and 3: full-width serve, then the plain reference pass
# ---------------------------------------------------------------------------
def make_requests(phase: int, vocab: int):
    from repro_torch.serving import Request
    rng = np.random.default_rng(100 + phase)
    return [Request(i, rng.integers(0, vocab, size=PROMPT).astype(np.int32),
                    max_new_tokens=NEW_TOKENS) for i in range(BATCH)]


def budget_for(store, rung: int) -> int:
    """A budget that admits exactly ``rung`` (and nothing above)."""
    need = [store.rung_resident_bytes(r) for r in range(store.num_rungs)]
    return need[-1] * 2 if rung == store.num_rungs - 1 else need[rung]


def prompt_tokens(reqs, device):
    toks = np.stack([r.prompt for r in reqs]).astype(np.int64)
    return {"tokens": torch.from_numpy(toks).to(device)}


def packed_linears_per_forward(store) -> int:
    """Every nested matmul weight is one packed_linear per layer per forward
    (28 * 7 + 1 = 197 at full width); the nested embedding is a gather."""
    return sum(leaf.shape[0] if len(leaf.shape) == 3 else 1
               for path, leaf in store.nested_leaves() if "embed" not in path)


def checked_generate(engine, reqs, rung, per_forward, what):
    """One ``generate`` of a short batch under the budget that lands on
    ``rung``; checks the rung, every packed_linear on the rung's kernel (the
    32-row prefill's on the CUDA-core body, its LM head and every decode
    step's on the decode body), no plain version, and the tokens in range.
    Returns (wall s, launches, decode-body launches) of the call."""
    from repro_torch.kernels import dispatch

    store, vocab = engine.store, engine.cfg.vocab_size
    forwards = 1 + NEW_TOKENS
    want_dec = per_forward * NEW_TOKENS + 1
    before = {n: (c.launches, c.plain_launches) for n, c in dispatch.COUNTERS.items()}
    before_dec = {n: c.dec_launches for n, c in dispatch.COUNTERS.items()}
    torch.cuda.synchronize()
    t0 = time.time()
    engine.generate(reqs, memory_budget_bytes=budget_for(store, rung))
    torch.cuda.synchronize()
    wall = time.time() - t0
    delta = {n: (c.launches - before[n][0], c.plain_launches - before[n][1])
             for n, c in dispatch.COUNTERS.items()}
    want = {n: (per_forward * forwards if n in KERNELS and KERNELS[n][0] == min(rung, 2)
                else 0, 0) for n in dispatch.COUNTERS}
    if store.rung != rung or delta != want:
        raise AssertionError(f"{what}: rung {store.rung} (want {rung}), "
                             f"launches {delta}, want {want}")
    dec = {n: c.dec_launches - before_dec[n] for n, c in dispatch.COUNTERS.items()}
    if dec != {n: want_dec if want[n][0] else 0 for n in dec}:
        raise AssertionError(f"{what}: decode-body launches {dec}, want {want_dec} "
                             f"on the rung's kernel")
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or not all(
                0 <= t < vocab for t in r.out_tokens):
            raise AssertionError(f"{what}: bad tokens {r.out_tokens}")
    return wall, delta, dec


def phase_serve(cfg):
    from repro_torch.core.recipe import QuantRecipe, quantize
    from repro_torch.core.switching import NestQuantStore
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServeEngine

    t0 = time.time()
    params = init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[serve] init {cfg.name} full width in {time.time() - t0:.1f}s")
    t0 = time.time()
    nested = quantize(params, QuantRecipe(bits=BITS), device=DEVICE)
    del params
    store = NestQuantStore(nested, mode="part", device=DEVICE)
    del nested
    torch.cuda.synchronize()
    lb = store.ladder_bytes()
    log(f"[serve] adaptive (8,6,4) quantize + store in {time.time() - t0:.1f}s; "
        f"base={lb['base']} deltas={lb['deltas']} scales={lb['scales']} fp={lb['fp']} "
        f"rung bytes={[store.rung_resident_bytes(r) for r in range(3)]}")
    engine = ServeEngine(cfg, store, max_batch=BATCH, max_len=MAX_LEN)
    per_forward = packed_linears_per_forward(store)
    forwards = 1 + NEW_TOKENS
    log(f"[serve] {per_forward} packed_linear calls per forward, {forwards} "
        f"forwards per generate")
    dispatch.reset_counters()                      # the main path starts here
    phases = []
    for phase, rung in enumerate(SERVE_SCHEDULE):
        reqs = make_requests(phase, cfg.vocab_size)
        wall, delta, dec = checked_generate(engine, reqs, rung, per_forward, f"phase {phase}")
        phases.append({"rung": rung, "mode": store.mode, "wall_s": wall,
                       "page_in": store.ledger.page_in_bytes,
                       "page_out": store.ledger.page_out_bytes,
                       "tokens": [r.out_tokens for r in reqs], "launches": delta,
                       "dec_launches": dec})
        log(f"[serve] phase {phase}: mode={store.mode} rung={store.rung} "
            f"{BATCH}x{NEW_TOKENS} tokens in {wall:.3f}s; ledger in="
            f"{store.ledger.page_in_bytes} out={store.ledger.page_out_bytes} "
            f"switches={store.ledger.switches}; launches {delta}, on the decode body {dec}")
    launches = {n: (dispatch.COUNTERS[n].launches, dispatch.COUNTERS[n].dec_launches)
                for n in KERNELS}
    if any(dispatch.COUNTERS[n].plain_launches for n in KERNELS):
        raise AssertionError("a plain version ran on the main path")
    if any(dispatch.COUNTERS[n].tc_launches for n in KERNELS):
        raise AssertionError(f"a {BATCH * PROMPT}-row prefill took the tensor-core body")
    return engine, store, phases, launches


K1_K3_BODIES = (("decode", ("stream_matmul_dec<",)), ("tensor_core", ("stream_matmul_tc<",)),
                ("cuda_core", ("stream_matmul<",)), ("reduce_partials", ("reduce_partials",)))


def k1_k3_split(dev):
    """K1-K3 device ms and launches by body (and the CUDA-core body's
    split-K pass) from profiler rows (device us, calls, kernel name)."""
    return {body: {"device_ms": sum(t for t, _, k in dev if any(p in k for p in pats)) / 1e3,
                   "calls": sum(c for _, c, k in dev if any(p in k for p in pats))}
            for body, pats in K1_K3_BODIES}


def phase_profile(engine, store, cfg, per_forward):
    """Where one generate call's time goes at the current rung: wall time
    (host clock, unprofiled), device busy time (torch.profiler's CUDA
    kernel self times, profiled run), K1-K3 by body and the largest
    kernels.  Only the 32-row prefill's matmuls take the CUDA-core body,
    so its split-K pass runs per_forward - 1 times and no more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    budget = budget_for(store, store.rung)
    engine.generate(make_requests(90, cfg.vocab_size), memory_budget_bytes=budget)
    torch.cuda.synchronize()
    t0 = time.time()
    engine.generate(make_requests(91, cfg.vocab_size), memory_budget_bytes=budget)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate(make_requests(92, cfg.vocab_size), memory_budget_bytes=budget)
        torch.cuda.synchronize()
    # device-side events only: a CPU op's device time repeats its kernels'
    dev = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 reverse=True)
    busy_ms = sum(d[0] for d in dev) / 1e3
    split = k1_k3_split(dev)
    out = {"rung": store.rung, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms if busy_ms > 0 else None,
           "device_idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else None,
           "k1_k3": split,
           "top_kernels": [{"name": k[:90], "calls": c, "device_ms": t / 1e3}
                           for t, c, k in dev[:8]]}
    log(f"[profile] rung {store.rung} generate ({BATCH}x{NEW_TOKENS} tokens): wall "
        f"{wall_ms:.1f} ms, device busy "
        f"{'not measured' if busy_ms == 0 else f'{busy_ms:.1f} ms'}; K1-K3 by body {split}")
    if busy_ms > 0 and split["reduce_partials"]["calls"] != per_forward - 1:
        raise AssertionError(f"short generate: {split['reduce_partials']['calls']} split-K "
                             f"passes, want {per_forward - 1} (the 32-row prefill's)")
    for k in out["top_kernels"]:
        log(f"[profile]   {k['device_ms']:9.3f} ms  x{k['calls']:5d}  {k['name']}")
    return out


def _rel(a, b) -> float:
    """max |a - b| / max |b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _generate(engine, rung_budget, phase, plain: bool):
    from repro_torch.kernels import dispatch

    reqs = make_requests(phase, engine.cfg.vocab_size)
    if plain:
        with dispatch.reference_pass():
            engine.generate(reqs, memory_budget_bytes=rung_budget)
    else:
        engine.generate(reqs, memory_budget_bytes=rung_budget)
    return np.array([r.out_tokens for r in reqs])


def phase_reference(cfg, store, phases):
    """The same requests through the plain versions (``reference_pass``)
    at rungs 2, 0, 1.  The reference is the plain pass with
    ``compute_dtype="float32"``:

    * f32 kernel path: prefill logits within 1e-4 of it (relative to max
      |logit|) and greedy tokens identical;
    * bf16 kernel path: prefill logits within ``BF16_E2E_TOL`` of it and
      of the plain bf16 pass.  bf16 rounding alone puts the plain bf16
      pass 1.5-2.0e-2 from the f32 one through 28 layers, so the limit
      sits above that floor.  Also printed: greedy-token agreement in bf16
      and, for each rung above 0, the bf16 kernel path of the rung below
      against this rung's reference - what a kernel that dropped the
      finest delta stream would read.

    Every rung is measured before any failure is raised."""
    from repro_torch.core.nesting import set_tree_rung
    from repro_torch.kernels import dispatch
    from repro_torch.serving import ServeEngine

    out, failures = {}, []
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    for phase, rung in enumerate(SERVE_SCHEDULE[:3]):
        budget = budget_for(store, rung)
        # fresh engines, switched through ensure_mode: an engine caches the
        # params of the rung it last switched to
        e16 = ServeEngine(cfg16, store, max_batch=BATCH, max_len=MAX_LEN)
        e16.ensure_mode(budget)
        e32 = ServeEngine(cfg32, store, max_batch=BATCH, max_len=MAX_LEN)
        e32.ensure_mode(budget)
        params = store.params()
        toks = prompt_tokens(make_requests(phase, cfg.vocab_size), store.device)
        k16, _ = e16.model.prefill(params, toks)
        k32, _ = e32.model.prefill(params, toks)
        with dispatch.reference_pass():
            p16, _ = e16.model.prefill(params, toks)
            p32, _ = e32.model.prefill(params, toks)
        t = {(d, plain): _generate(e, budget, phase, plain)
             for d, e in (("bf16", e16), ("f32", e32)) for plain in (False, True)}
        r = {"f32_kernel_vs_plain": _rel(k32, p32),
             "bf16_kernel_vs_f32_plain": _rel(k16, p32),
             "bf16_plain_vs_f32_plain": _rel(p16, p32),
             "bf16_kernel_vs_bf16_plain": _rel(k16, p16),
             "f32_tokens_identical": bool((t["f32", False] == t["f32", True]).all()),
             "bf16_token_agreement": float((t["bf16", False] == t["bf16", True]).mean()),
             "max_abs_logit": p32.abs().max().item()}
        finite = all(bool(x.isfinite().all()) for x in (k16, k32, p16, p32))
        r["bf16_tol"] = BF16_E2E_TOL
        r["ok"] = (finite and r["f32_kernel_vs_plain"] <= 1e-4 and r["f32_tokens_identical"]
                   and r["bf16_kernel_vs_f32_plain"] <= BF16_E2E_TOL
                   and r["bf16_kernel_vs_bf16_plain"] <= BF16_E2E_TOL)
        out[f"rung{rung}"] = r
        if rung > 0:
            short, _ = e16.model.prefill(set_tree_rung(params, rung - 1), toks)
            r["bf16_one_stream_short_vs_f32_plain"] = _rel(short, p32)
            log(f"[reference] rung {rung}: a kernel one delta stream short (the bf16 "
                f"kernel path at rung {rung - 1}) reads "
                f"{r['bf16_one_stream_short_vs_f32_plain']:.3e} against the f32 plain pass")
        log(f"[reference] rung {rung}: f32 kernel vs plain {r['f32_kernel_vs_plain']:.3e} "
            f"(tol 1e-4), tokens identical {r['f32_tokens_identical']}; bf16 kernel vs "
            f"f32 plain {r['bf16_kernel_vs_f32_plain']:.3e}, bf16 kernel vs bf16 plain "
            f"{r['bf16_kernel_vs_bf16_plain']:.3e} (tol {BF16_E2E_TOL:.0e} each), bf16 "
            f"plain vs f32 plain {r['bf16_plain_vs_f32_plain']:.3e}, bf16 greedy token "
            f"agreement {r['bf16_token_agreement']:.3f}")
        if not r["ok"]:
            failures.append(rung)
    if failures:
        raise AssertionError(f"reference pass failed at rungs {failures}: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 3b: one on-disk artifact, progressive cold boot, warm-up, scheduled
# burst trace and a kv-aware scheduled run
# ---------------------------------------------------------------------------
def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _build_state():
    """What a serve must leave alone after warm-up: the loaded kernel
    libraries, the decode-body plans and the current stream's arrival
    counters' buffer."""
    from repro_torch.kernels import build

    buf = build._dec_counters.get((torch.cuda.current_device(),
                                   torch.cuda.current_stream().cuda_stream))
    return {"libraries": sorted(build._libs), "dec_plans": len(build._dec_plans),
            "counters_ptr": None if buf is None else buf.data_ptr(),
            "counters_numel": None if buf is None else buf.numel()}


def _load_policy():
    """The JAX package's CLI composition for ``--policy load``."""
    from repro_torch.serving import HysteresisPolicy, LoadAdaptivePolicy
    return HysteresisPolicy(LoadAdaptivePolicy(high_depth=BATCH), dwell=SCHED_DWELL)


def _scheduled_launches(report, per_forward, decode=False):
    """K1-K3 launches a scheduler run must show: every batch's forwards on
    the kernel of the rung it was served at; with ``decode``, those on the
    decode body (every decode step's and each prefill's LM head)."""
    per_batch = per_forward * NEW_TOKENS + 1 if decode else per_forward * (1 + NEW_TOKENS)
    want = {n: 0 for n in KERNELS}
    for s in report.steps:
        name = next(n for n, v in KERNELS.items() if v[0] == min(s["rung"], 2))
        want[name] += per_batch
    return want


def _check_report(report, n_requests, vocab, what):
    if len(report.requests) != n_requests:
        raise AssertionError(f"{what}: served {len(report.requests)} of {n_requests}")
    for r in report.requests:
        toks = r.request.out_tokens
        if len(toks) != r.request.max_new_tokens or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{what}: request {r.request.uid} bad tokens {toks}")
    for rec in report.switch_records + report.kv_switch_records:
        if (rec["page_in"], rec["page_out"]) != (rec["expected_in"], rec["expected_out"]):
            raise AssertionError(f"{what}: switch record {rec} pages other bytes than expected")


def phase_artifact(cfg, store, phases, per_forward):
    """Ship the phase-2 store as one artifact and serve it as a deployment
    would (``ServeEngine.from_artifact`` + ``Scheduler``):

    a. ``to_rung(2)`` and ``save_artifact`` into ``build/``;
    b. boot with only the manifest and the base segment on disk, through a
       ``FilePager`` onto the card wrapped in a 100 Mbit/s
       ``ThrottledPager`` on a ``VirtualClock``; serve phase 2's rung-0
       requests (tokens identical), then deliver ``delta_0`` and
       ``delta_1`` one by one, ``poll_delivery`` after each (page-in = the
       segment's bytes) and serve phase 2's requests of that rung (tokens
       identical); each poll's disk-to-card rate beside the same streams
       through the phase-2 store's ``InMemoryPager``;
    c. ``warmup``, then record the kernel libraries, the decode-body plans
       and the arrival counters' buffer;
    d. a ``Scheduler`` over a 48-request burst trace under the CLI's
       ``load`` composition: every request served, every switch paging its
       expected bytes, the first batch's tokens equal to a direct
       ``generate`` at its rung, nothing built and the counters kept;
    e. a kv-aware ``Scheduler`` over 16 requests of 512 prompt tokens on a
       nested KV cache, its budget the rung-2 weights plus two sequences at
       KV rung 2: every weight and KV switch paging its expected bytes.

    Every K1-K3 launch of the phase is counted and checked against the
    rung each call served at; no plain version runs.  The artifact is
    removed at the end and the phase-2 store goes back to its rung."""
    import os
    import shutil

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.kernels import dispatch
    from repro_torch.serving import (BudgetPolicy, KVCacheConfig, LoadGenerator, Request,
                                     Scheduler, ServeEngine, ServiceModel, calibrate_qps)
    from repro_torch.storage import (FilePager, ThrottledPager, VirtualClock, open_artifact,
                                     save_artifact)

    t_phase = time.perf_counter()
    out = {}
    prev_rung = store.rung
    root = ROOT / "build" / "artifact_smoke"
    art_dir, aside = root / "artifact", root / "aside"
    shutil.rmtree(root, ignore_errors=True)
    try:
        # -- a. save ---------------------------------------------------------
        store.to_rung(2)
        manifest, save_s = _timed(lambda: save_artifact(
            store.nested_params, str(art_dir), recipe=QuantRecipe(bits=BITS)))
        sizes = {name: seg["nbytes"] for name, seg in manifest["segments"].items()}
        if sizes != {"base": store.rung_resident_bytes(0), "delta_0": store.delta_bytes(0),
                     "delta_1": store.delta_bytes(1)}:
            raise AssertionError(f"segment bytes {sizes} differ from the store's ladder")
        out["save"] = {"segments": sizes, "seconds": save_s}
        log(f"[artifact] saved {', '.join(f'{k} {v / 1e9:.3f} GB' for k, v in sizes.items())}"
            f" in {save_s:.2f}s ({sum(sizes.values()) / save_s / 1e9:.2f} GB/s from the card)")

        # -- b. progressive cold boot ---------------------------------------
        aside.mkdir(parents=True)
        for k in range(2):
            os.replace(art_dir / f"delta_{k}.seg", aside / f"delta_{k}.seg")
        art = open_artifact(str(art_dir))
        clock = VirtualClock()
        pager = ThrottledPager(FilePager(art, device=DEVICE),
                               bandwidth_bytes_per_s=LINK_BYTES_PER_S, clock=clock)
        engine, boot_s = _timed(lambda: ServeEngine.from_artifact(
            cfg, art, pager=pager, max_batch=BATCH, max_len=MAX_LEN, device=DEVICE))
        if art.segments_read != {"base"} or set(art.bytes_read) != {"manifest", "base"}:
            raise AssertionError(f"cold boot read {art.bytes_read}, want the manifest and "
                                 f"the base only")
        log(f"[artifact] cold boot read {art.bytes_read} in {boot_s:.2f}s "
            f"({art.bytes_read['base'] / boot_s / 1e9:.2f} GB/s disk to card)")
        dispatch.reset_counters()                  # this path starts here
        walls = {}
        # phase 2 served make_requests(p) at SERVE_SCHEDULE[p]
        for step, (rung, p) in enumerate(((0, 1), (1, 2), (2, 0))):
            if rung:
                k = rung - 1
                os.replace(aside / f"delta_{k}.seg", art_dir / f"delta_{k}.seg")
                rep, poll_s = _timed(engine.poll_delivery)
                want = manifest["segments"][f"delta_{k}"]["nbytes"]
                if rep["rung"] != rung or rep["page_in"] != want or \
                        want != engine.store.delta_bytes(k) or rep["failed"]:
                    raise AssertionError(f"poll {k}: {rep}, want rung {rung} and page-in "
                                         f"{want} = bytes(delta_{k})")
                paths = [path for path, _ in store.nested_leaves()]
                words, mem_s = _timed(lambda: [store.pager.fetch(path, k) for path in paths])
                mem_bytes = sum(w.numel() * 4 for w in words)
                del words
                if mem_bytes != want:
                    raise AssertionError(f"in-memory delta_{k}: {mem_bytes} bytes, want {want}")
                out[f"poll_{k}"] = {"rung": rung, "page_in": rep["page_in"], "seconds": poll_s,
                                    "gb_per_s": want / poll_s / 1e9,
                                    "in_memory_seconds": mem_s,
                                    "in_memory_gb_per_s": want / mem_s / 1e9}
                log(f"[artifact] delta_{k} delivered: poll -> rung {rep['rung']}, page-in "
                    f"{rep['page_in']} B in {poll_s:.3f}s ({want / poll_s / 1e9:.2f} GB/s disk "
                    f"to card); the same streams through the InMemoryPager {mem_s:.3f}s "
                    f"({want / mem_s / 1e9:.2f} GB/s)")
            reqs = make_requests(p, cfg.vocab_size)
            walls[rung], _, _ = checked_generate(engine, reqs, rung, per_forward,
                                                 f"artifact rung {rung}")
            toks = [r.out_tokens for r in reqs]
            if toks != phases[p]["tokens"]:
                raise AssertionError(f"artifact rung {rung}: tokens {toks} differ from phase "
                                     f"2's {phases[p]['tokens']}")
        if pager.bytes_moved != engine.store.ledger.page_in_bytes:
            raise AssertionError(f"link moved {pager.bytes_moved} B, ledger page-in "
                                 f"{engine.store.ledger.page_in_bytes} B")
        out["boot"] = {"seconds": boot_s, "bytes_read": dict(art.bytes_read),
                       "generate_wall_s": walls, "link_bytes_moved": pager.bytes_moved,
                       "link_simulated_s": pager.simulated_seconds,
                       "virtual_clock_s": clock.now()}
        log(f"[artifact] rungs 0, 1, 2 served phase 2's tokens; generate walls {walls}; "
            f"100 Mbit/s link (virtual): {pager.bytes_moved} B in "
            f"{pager.simulated_seconds:.1f}s simulated = the ledger's page-in")

        # -- c. warm-up -------------------------------------------------------
        calls, warm_s = _timed(lambda: engine.warmup(prompt_len=PROMPT, batch=BATCH))
        built = _build_state()
        out["warmup"] = {"calls": calls, "seconds": warm_s, **built}
        log(f"[artifact] warmup: {calls} calls in {warm_s:.2f}s; {built}")

        # -- d. scheduled burst trace ----------------------------------------
        svc = ServiceModel()
        es = engine.store
        engine.policy = _load_policy()
        qps = calibrate_qps(es, svc, steps=NEW_TOKENS, max_batch=BATCH, utilization=0.4)
        burst = 1.05 * svc.capacity_rps(es.rung_resident_bytes(0), NEW_TOKENS, BATCH)
        trace = LoadGenerator("burst", qps=qps, n_requests=SCHED_REQUESTS,
                              vocab_size=cfg.vocab_size, seed=0, prompt_len=PROMPT,
                              new_tokens=NEW_TOKENS, burst_qps=burst)
        sched = Scheduler(engine, trace, svc, max_batch=BATCH)
        before = {n: dispatch.COUNTERS[n].launches for n in KERNELS}
        # device activity only, summed from the raw events: the ~27
        # full-width generates make ~10^5 device events, and building the
        # profiler's per-op tables over them takes minutes
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            report, sched_s = _timed(sched.run)
        t_sum = time.perf_counter()
        busy_ms = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA) / 1e6
        sum_s = time.perf_counter() - t_sum
        del prof
        got = {n: dispatch.COUNTERS[n].launches - before[n] for n in KERNELS}
        if got != _scheduled_launches(report, per_forward):
            raise AssertionError(f"scheduled run launches {got}, want "
                                 f"{_scheduled_launches(report, per_forward)}")
        _check_report(report, SCHED_REQUESTS, cfg.vocab_size, "scheduled run")
        # the first batch again, directly at its rung, with the same fillers
        first = report.steps[0]
        done = report.requests[:first["batch"]]
        reqs = [Request(r.request.uid, r.request.prompt, NEW_TOKENS) for r in done]
        reqs += [Request(-1, done[-1].request.prompt, NEW_TOKENS)
                 for _ in range(first["filler"])]
        engine.policy = BudgetPolicy()
        checked_generate(engine, reqs, first["rung"], per_forward, "first batch again")
        if [r.out_tokens for r in reqs[:len(done)]] != [r.request.out_tokens for r in done]:
            raise AssertionError("the first scheduled batch's tokens differ from a direct "
                                 "generate at its rung")
        after = _build_state()
        if after != built:
            raise AssertionError(f"a serve after warmup changed the build state: "
                                 f"{built} -> {after}")
        walk = [s["rung"] for s in report.steps]
        summary = report.summary()
        out["scheduler"] = {
            "summary": summary, "rung_walk": walk, "wall_s": sched_s,
            "device_busy_ms": busy_ms if busy_ms > 0 else None,
            "device_busy_share": busy_ms / 1e3 / sched_s if busy_ms > 0 else None,
            "launches": got, "switch_records": report.switch_records,
            "qps": qps, "burst_qps": burst,
            "downshift_and_recovery": min(walk) < walk[0] and walk[-1] == walk[0]}
        log(f"[sched] {report.table()}")
        log(f"[sched] rung walk {walk}; switches {report.switch_records}")
        log(f"[sched] wall {sched_s:.2f}s under the profiler, device busy "
            f"{'not measured' if busy_ms == 0 else f'{busy_ms:.1f} ms ({busy_ms / 1e3 / sched_s:.1%})'}"
            f" (summed in {sum_s:.1f}s); virtual elapsed {summary['elapsed_s']:.2f}s (the "
            f"service model's clock, not "
            f"the card's); launches {got}; first batch re-served identically; build state "
            f"unchanged {after}")
        if not out["scheduler"]["downshift_and_recovery"]:
            log("[sched] no downshift-and-climb-back in this walk (see PERF.md)")

        # -- e. kv-aware scheduled run ---------------------------------------
        kv_engine = ServeEngine(cfg, es, max_batch=BATCH, max_len=KV_PROMPT + NEW_TOKENS,
                                policy=_load_policy(), model=engine.model,
                                kv=KVCacheConfig(bits=(4, 6, 8), page=KV_PAGE, rounding="rtn"))
        kv_calls, kv_warm_s = _timed(lambda: kv_engine.warmup(prompt_len=KV_PROMPT,
                                                              batch=BATCH))
        budget = es.rung_resident_bytes(2) + 2 * kv_engine.kv_bytes_per_seq(2)
        kv_trace = LoadGenerator("burst", qps=qps, n_requests=KV_SCHED_REQUESTS,
                                 vocab_size=cfg.vocab_size, seed=0, prompt_len=KV_PROMPT,
                                 new_tokens=NEW_TOKENS, burst_qps=burst)
        before = {n: dispatch.COUNTERS[n].launches for n in KERNELS}
        kv_report, kv_s = _timed(Scheduler(kv_engine, kv_trace, svc, max_batch=BATCH,
                                           memory_budget_bytes=budget, kv_aware=True).run)
        got_kv = {n: dispatch.COUNTERS[n].launches - before[n] for n in KERNELS}
        if got_kv != _scheduled_launches(kv_report, per_forward):
            raise AssertionError(f"kv-aware run launches {got_kv}, want "
                                 f"{_scheduled_launches(kv_report, per_forward)}")
        _check_report(kv_report, KV_SCHED_REQUESTS, cfg.vocab_size, "kv-aware run")
        if not kv_report.kv_switch_records:
            log("[sched-kv] the KV rung did not move in this run")
        caps = [(s["admit_cap"], s["kv_rung"]) for s in kv_report.steps]
        out["kv_scheduler"] = {
            "summary": kv_report.summary(), "wall_s": kv_s, "warmup_calls": kv_calls,
            "warmup_s": kv_warm_s, "budget_bytes": budget, "admit_cap_kv_rung": caps,
            "rung_walk": [s["rung"] for s in kv_report.steps], "launches": got_kv,
            "switch_records": kv_report.switch_records,
            "kv_switch_records": kv_report.kv_switch_records}
        log(f"[sched-kv] {kv_report.table()}")
        log(f"[sched-kv] warmup {kv_calls} calls in {kv_warm_s:.2f}s; budget {budget} B; "
            f"(admit_cap, kv_rung) per step {caps}; weight rungs "
            f"{out['kv_scheduler']['rung_walk']}; KV switches {kv_report.kv_switch_records}; "
            f"wall {kv_s:.2f}s; launches {got_kv}")
        out["launches"] = {n: (dispatch.COUNTERS[n].launches, dispatch.COUNTERS[n].dec_launches)
                           for n in KERNELS}
        if any(dispatch.COUNTERS[n].plain_launches for n in dispatch.COUNTERS):
            raise AssertionError("a plain version ran on the artifact path")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        store.to_rung(prev_rung)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[artifact] phase 3b took {out['seconds']:.1f}s; K1-K3 launches (all bodies, "
        f"decode body) {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 3c: self-speculative decoding and fault-tolerant delivery
# ---------------------------------------------------------------------------
# the leaf of each main-path shape in the served tree (layer 0 of the stacks)
SHAPE_LEAVES = {"q/o": ("blocks", "q"), "k/v": ("blocks", "k"),
                "gate/up": ("blocks", "mlp", "w_gate"), "down": ("blocks", "mlp", "w_down"),
                "lm_head": ("lm_head",)}
VERIFY_KS = (2, 4)          # verify chunks of batch 4: M = 12 and 20
WIDE_BATCHES = (16, 64)     # decode steps above batch 8 (no served path runs them)
SPEC_NEW_TOKENS = 16
SPEC_CONFIGS = ((4, 0), (2, 1))                     # (k, draft rung)
FAULT_REQUESTS, FAULT_SEED = 24, 5
# the pager's faults and retries.  An upgrade fetches one stream per nested
# leaf (9 at full width) and commits only if each arrives within 2
# attempts: at the JAX package's storm rates (0.35 transient, 0.1 corrupt)
# that is ~18 % of upgrades, and the seeded run committed none; at these,
# it fails one switch and commits two upgrades (0 -> 1 -> 2)
FAULT_CHAOS = {"p_transient": 0.2, "p_corrupt": 0.05}
FAULT_RETRY = {"max_attempts": 2, "backoff_base_s": 1e-4, "quarantine_after": 3,
               "quarantine_s": 2e-3}


def _leaf(params, keys):
    node = params
    for k in keys:
        node = node[k]
    node = node["w"]
    return node.layer(0) if len(node.shape) == 3 else node


def _profiled(fn):
    """(fn(), wall s, device busy ms) of one call under the profiler (device
    activity only; busy summed from its raw CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, wall = _timed(fn)
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6
    return out, wall, busy


def verify_passes(rows, cfg):
    """K1-K3 time of one verify pass per forward (every main-path shape times
    its uses) at M = 12 and 20, beside the k + 1 decode calls at M = 4 it
    replaces, and of one decode step at batch 16 and 64 on the decode route
    beside the body M alone picks, per rung, bf16 (single weight copies: L2
    may hold the small shapes, unlike the cold-L2 decode rows of phase 1)."""
    from repro_torch.kernels import dispatch

    uses = {shape: u for shape, _, _, u, _ in main_path_shapes(cfg)}
    out = {}
    for rung in range(3):
        sel = [r for r in rows if r["rung"] == rung and r["dtype"] == "bfloat16"]
        tot = lambda key: sum(r[key] * uses[r["shape"]] for r in sel)  # noqa: E731
        out[f"rung{rung} bfloat16"] = {
            f"k={k}": {"verify_ms": tot(f"verify_m{BATCH * (k + 1)}_ms"),
                       "decodes_ms": (k + 1) * tot("decode_m4_ms")} for k in VERIFY_KS}
        out[f"rung{rung} bfloat16"].update({
            f"batch={B}": {"decode_route_ms": tot(f"decode_b{B}_ms"),
                           "by_m_ms": tot(f"by_m_b{B}_ms"),
                           "by_m_route": dispatch.matmul_route(B, torch.bfloat16, DEVICE)}
            for B in WIDE_BATCHES})
    for key, v in out.items():
        log(f"[spec-verify] {key}: " + "; ".join(
            f"{k} verify {x['verify_ms']:.3f} ms per forward vs {x['decodes_ms']:.3f} ms for "
            f"the decode steps it replaces" for k, x in v.items() if "verify_ms" in x))
        log(f"[decode-wide] {key}: " + "; ".join(
            f"{k} decode step {x['decode_route_ms']:.3f} ms on the decode route vs "
            f"{x['by_m_ms']:.3f} ms on the {x['by_m_route']} body" for k, x in v.items()
            if "by_m_ms" in x))
    return out


def spec_rows(store, gen):
    """Every main-path shape at rungs 0-2, bf16 and f32: the rows of a
    decode-route call at M = 12 and 20 (batch 4 x k + 1 for k = 2, 4)
    equal bit for bit the same rows of M = 4 and M = 1 decode calls, one
    decode-body launch per group of 8 rows and none elsewhere; in bf16 each
    verify call timed (CUDA-graph replay) beside the k + 1 decode calls at
    M = 4 it replaces (f32 rows are checked, not timed: the decode body's
    time does not depend on the activation dtype, PERF.md), and at batch
    16 and 64 the decode route beside the body M alone picks."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.layers import packed_linear

    params = store.params()
    rows = []
    for shape, keys in SHAPE_LEAVES.items():
        top = _leaf(params, keys)
        out_dtype = torch.float32 if shape == "lm_head" else None
        for rung in range(3):
            nt = top.with_rung(rung)
            counter = dispatch.counter(("packed_matmul", "nested_matmul",
                                        "ladder_matmul")[rung])
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(20, nt.K, generator=gen, device=DEVICE).to(dtype)
                one = torch.cat([packed_linear(x[i:i + 1], nt, out_dtype) for i in range(20)])
                four = torch.cat([packed_linear(x[i:i + 4], nt, out_dtype)
                                  for i in range(0, 20, 4)])
                timed = dtype == torch.bfloat16
                d4_ms = (time_graph_ms(lambda i: packed_linear(x[:4], nt, out_dtype), 10, reps=3)
                         if timed else None)
                row = {"shape": shape, "K": nt.K, "N": nt.shape[-1], "rung": rung,
                       "dtype": str(dtype).replace("torch.", ""), "decode_m4_ms": d4_ms}
                for k in VERIFY_KS:
                    M = BATCH * (k + 1)
                    before = (counter.launches, counter.dec_launches, counter.plain_launches)
                    got = packed_linear(x[:M], nt, out_dtype, route=dispatch.DECODE)
                    groups = -(-M // dispatch.DEC_MAX_M)
                    after = (counter.launches, counter.dec_launches, counter.plain_launches)
                    if after != (before[0] + groups, before[1] + groups, before[2]):
                        raise AssertionError(f"verify {shape} rung {rung} {dtype} M={M}: "
                                             f"launches {before} -> {after}")
                    torch.cuda.synchronize()
                    if not (torch.equal(got, one[:M]) and torch.equal(got, four[:M])):
                        raise AssertionError(f"verify {shape} rung {rung} {dtype} M={M}: rows "
                                             f"differ from the decode calls' rows")
                    row[f"verify_m{M}_ms"] = time_graph_ms(
                        lambda i: packed_linear(x[:M], nt, out_dtype,
                                                route=dispatch.DECODE), 10, reps=3) \
                        if timed else None
                if timed:     # decode steps above batch 8: the named route and M's
                    xb = torch.randn(max(WIDE_BATCHES), nt.K, generator=gen,
                                     device=DEVICE).to(dtype)
                    for B in WIDE_BATCHES:
                        row[f"decode_b{B}_ms"] = time_graph_ms(
                            lambda i: packed_linear(xb[:B], nt, out_dtype,
                                                    route=dispatch.DECODE), 10, reps=3)
                        row[f"by_m_b{B}_ms"] = time_graph_ms(
                            lambda i: packed_linear(xb[:B], nt, out_dtype), 10, reps=3)
                    del xb
                rows.append(row)
                log(f"[spec-rows] {shape:8s} rung {rung} {row['dtype']:8s} rows bit-identical" + (
                    f"; verify M=12 {row['verify_m12_ms']:.4f} ms (3 decodes at M=4 "
                    f"{3 * d4_ms:.4f}), M=20 {row['verify_m20_ms']:.4f} ms (5 decodes "
                    f"{5 * d4_ms:.4f})" if timed else ""))
    return rows


def spec_serve(cfg, store, per_forward):
    """4 requests x 8 prompt tokens x 16 new tokens at rung 2, max_len 64,
    bf16 and f32: plain ``generate`` and speculative ``generate`` with
    SpecConfig(k=4, draft=0) and SpecConfig(k=2, draft=1) on the same
    engine give the same tokens; every draft step's packed_linear on the
    draft rung's kernel (decode body), every verify pass on the decode body
    in groups of 8 rows, no plain launch.  Rounds, acceptance, wall and
    device busy of each (one run under the profiler) are recorded; no limit
    is set on them.  Returns (results, K1-K3 (launches, decode-body
    launches) summed over the speculative generates)."""
    from repro_torch.kernels import dispatch
    from repro_torch.serving import Request, ServeEngine, SpecConfig, StaticRungPolicy

    names = ("packed_matmul", "nested_matmul", "ladder_matmul")
    out, total = {}, {n: (0, 0) for n in names}
    for dtype in ("bfloat16", "float32"):
        engine = ServeEngine(dataclasses.replace(cfg, compute_dtype=dtype), store,
                             max_batch=BATCH, max_len=MAX_LEN, policy=StaticRungPolicy(2))

        def reqs():
            rng = np.random.default_rng(300)
            return [Request(i, rng.integers(0, cfg.vocab_size, size=PROMPT).astype(np.int32),
                            max_new_tokens=SPEC_NEW_TOKENS) for i in range(BATCH)]
        plain, wall, busy = _profiled(lambda: [r.out_tokens for r in engine.generate(reqs())])
        res = {"plain": {"wall_s": wall, "device_busy_ms": busy, "tokens": plain}}
        for k, draft in SPEC_CONFIGS:
            spec = SpecConfig(k=k, draft=draft)
            dispatch.reset_counters()              # this path starts here
            toks, wall, busy = _profiled(lambda: [r.out_tokens for r in engine.generate(
                reqs(), speculate=spec)])
            got = {n: (dispatch.counter(n).launches, dispatch.counter(n).dec_launches)
                   for n in names}
            total = {n: (total[n][0] + got[n][0], total[n][1] + got[n][1]) for n in names}
            prof = engine.last_profile
            if toks != plain:
                raise AssertionError(f"speculative {dtype} k={k} draft={draft}: tokens {toks} "
                                     f"differ from plain greedy {plain}")
            groups = -(-BATCH * (k + 1) // dispatch.DEC_MAX_M)
            want = {n: (0, 0) for n in names}
            want[names[draft]] = (per_forward * prof.draft_steps,) * 2
            want["ladder_matmul"] = (per_forward * (1 + groups * prof.verify_passes),
                                     1 + per_forward * groups * prof.verify_passes)
            if got != want or any(dispatch.counter(n).plain_launches
                                  or dispatch.counter(n).tc_launches for n in names):
                raise AssertionError(f"speculative {dtype} k={k} draft={draft}: launches "
                                     f"{got}, want {want} and no plain or tensor-core launch")
            res[f"k{k}_draft{draft}"] = {
                "wall_s": wall, "rounds": prof.verify_passes, "draft_steps": prof.draft_steps,
                "acceptance": prof.acceptance, "launches": got, "device_busy_ms": busy}
            log(f"[spec] {dtype} k={k} draft={draft}: tokens = plain greedy; {prof.verify_passes} "
                f"rounds, acceptance {prof.acceptance:.3f}; wall {wall:.3f}s, device busy "
                f"{res[f'k{k}_draft{draft}']['device_busy_ms']:.1f} ms (plain: wall "
                f"{res['plain']['wall_s']:.3f}s, busy {res['plain']['device_busy_ms']:.1f} ms); "
                f"launches {got}")
        out[dtype] = res
    return out, total


def _corrupt_then_clean_seed(nbytes: int, p: float) -> int:
    """The first seed whose ChaosPager draws corrupt a first fetch of an
    ``nbytes`` stream and leave the second clean (numpy's draws replayed)."""
    for seed in range(1000):
        rng = np.random.default_rng(seed)
        if rng.random(3)[2] < p:
            rng.integers(nbytes)
            rng.integers(8)
            if rng.random(3)[2] >= p:
                return seed
    raise AssertionError("no seed corrupts once and then heals")


def _resident(store):
    """Clones of every resident stream on the card, leaf by leaf."""
    return [(p, leaf.w_base.clone(), [d.clone() for d in leaf.deltas if d is not None])
            for p, leaf in store.nested_leaves()]


def _check_rolled_back(store, snap, events, what):
    if store.ledger.events != events:
        raise AssertionError(f"{what}: a failed switch changed the ledger")
    for (p, w, ds), (q, leaf) in zip(snap, store.nested_leaves()):
        now = [d for d in leaf.deltas if d is not None]
        if p != q or not torch.equal(w, leaf.w_base) or len(now) != len(ds) or \
                not all(torch.equal(a, b) for a, b in zip(ds, now)):
            raise AssertionError(f"{what}: a failed switch changed {p}'s resident streams")


def _check_pristine(store, inner, what):
    """Every resident delta stream equals the pristine one ``inner`` holds."""
    for p, leaf in store.nested_leaves():
        for lvl in range(leaf.resident_levels):
            if not torch.equal(leaf.deltas[lvl], inner.fetch(p, lvl)):
                raise AssertionError(f"{what}: {p} delta {lvl}: served words differ from the "
                                     f"pristine stream")


def fault_stack(cfg, store, inner):
    """``store`` at rung 0 (through ``inner``), then behind
    ResilientPager(ChaosPager(inner, ...)) with an outage of delta_1 from
    arrival 6 to arrival 18, and a Scheduler under ``make_policy("failure")``
    (the JAX package's storm composition: downshift in the burst, climb
    back through the faults) over the 24-request burst, all on one
    VirtualClock.  Returns (scheduler, engine, chaos pager, resilient
    pager); the caller puts ``inner`` back."""
    from repro_torch.serving import (HysteresisPolicy, LoadAdaptivePolicy, LoadGenerator,
                                     Scheduler, ServeEngine, ServiceModel, calibrate_qps,
                                     make_policy)
    from repro_torch.storage import ChaosPager, Outage, ResilientPager, RetryPolicy, VirtualClock

    store.pager = inner
    store.to_rung(0)
    svc = ServiceModel()
    qps = calibrate_qps(store, svc, steps=NEW_TOKENS, max_batch=BATCH, utilization=0.4)
    burst = 1.05 * svc.capacity_rps(store.rung_resident_bytes(0), NEW_TOKENS, BATCH)
    trace = LoadGenerator("burst", qps=qps, n_requests=FAULT_REQUESTS, vocab_size=cfg.vocab_size,
                          seed=0, prompt_len=PROMPT, new_tokens=NEW_TOKENS, burst_qps=burst)
    arr = trace.arrivals()
    clk = VirtualClock()
    chaos = ChaosPager(inner, seed=FAULT_SEED, clock=clk,
                       outages=(Outage(arr[6].t, arr[18].t, level=1),), **FAULT_CHAOS)
    pager = ResilientPager(chaos, RetryPolicy(**FAULT_RETRY), seed=FAULT_SEED + 1, clock=clk)
    store.pager = pager
    policy = make_policy("failure", cooldown=4, inner=HysteresisPolicy(
        LoadAdaptivePolicy(high_depth=BATCH), dwell=2))
    engine = ServeEngine(cfg, store, max_batch=BATCH, max_len=MAX_LEN, policy=policy)
    return Scheduler(engine, trace, svc, max_batch=BATCH, clock=clk), engine, chaos, pager


def fault_run(cfg, store, per_forward):
    """The scheduled run of :func:`fault_stack` from rung 0: every request
    completes; every K1-K3 launch is on its rung's kernel and every decode
    step's on the decode body; at least one switch fails and at least one
    upgrade commits through the faulty pager; a failed switch leaves every
    resident stream on the card bit-identical and the ledger as it was; a
    committed upgrade serves streams equal to the pristine ones; no step
    upgrades above the deliverable rung.  Then two faults forced: an
    upgrade whose every fetch fails rolls back the same way, and one
    stream's flipped bit is caught by the CRC and healed by a retry.
    Returns the run's record; its ``launches`` are (launches, decode-body
    launches) per kernel, counted from 0 at the run's start."""
    from repro_torch.kernels import dispatch
    from repro_torch.storage import ChaosPager, PagerError, ResilientPager, RetryPolicy

    inner = store.pager
    out = {}
    try:
        sched, engine, chaos, pager = fault_stack(cfg, store, inner)
        dispatch.reset_counters()                  # this path starts here
        sched.start()
        rung, failed_checked, committed = store.rung, 0, 0
        t0 = time.perf_counter()
        while not sched.done:
            snap, events = _resident(store), list(store.ledger.events)
            rec = sched.step()
            if rec["switch_failures"]:
                _check_rolled_back(store, snap, events, f"step {rec['step']}")
                failed_checked += 1
            if rec["rung"] > max(rec["avail_rung"], rung):
                raise AssertionError(f"step {rec['step']}: upgraded to rung {rec['rung']} "
                                     f"above the deliverable rung {rec['avail_rung']}")
            if rec["rung"] > rung:                 # an upgrade through the faulty pager
                _check_pristine(store, inner, f"step {rec['step']}")
                committed += 1
            rung = rec["rung"]
            del snap
        wall = time.perf_counter() - t0
        got = {n: (dispatch.COUNTERS[n].launches, dispatch.COUNTERS[n].dec_launches)
               for n in KERNELS}
        report = sched.report()
        _check_report(report, FAULT_REQUESTS, cfg.vocab_size, "fault run")
        want = {n: (_scheduled_launches(report, per_forward)[n],
                    _scheduled_launches(report, per_forward, decode=True)[n]) for n in KERNELS}
        if got != want or any(c.plain_launches for c in dispatch.COUNTERS.values()):
            raise AssertionError(f"fault run (launches, decode-body launches) {got}, want "
                                 f"{want} and no plain launch")
        if not (failed_checked and committed):
            raise AssertionError(f"fault run: {failed_checked} failed switches and {committed} "
                                 f"committed upgrades; the run must show both")
        _check_pristine(store, inner, "end of the fault run")
        corrupt = sum(h.corrupt for h in pager.health.values())
        # from rung 1, an upgrade every fetch of which fails
        store.pager = inner
        store.to_rung(1)
        store.pager = ResilientPager(ChaosPager(inner, p_transient=1.0),
                                     RetryPolicy(max_attempts=2, backoff_base_s=0.0))
        snap, events = _resident(store), list(store.ledger.events)
        try:
            store.to_rung(2)
        except PagerError:
            _check_rolled_back(store, snap, events, "forced failed upgrade")
        else:
            raise AssertionError("an upgrade through an always-failing pager committed")
        del snap
        # one stream, a seed whose first fetch flips a bit and second does not
        path = next(p for p, _ in store.nested_leaves())
        pristine = inner.fetch(path, 0)
        seed = _corrupt_then_clean_seed(pristine.numel() * 4, 0.5)
        heal = ResilientPager(ChaosPager(inner, seed=seed, p_corrupt=0.5),
                              RetryPolicy(max_attempts=2, backoff_base_s=0.0))
        healed = heal.fetch(path, 0)
        h = heal.health[(path, 0)]
        if not (torch.equal(healed, pristine) and h.corrupt == 1 and heal.retries == 1
                and heal.inner.faults["corrupt"] == 1):
            raise AssertionError(f"a flipped bit was not caught and healed: {h}")
        walk = [s["rung"] for s in report.steps]
        out = {"requests": len(report.requests), "steps": len(report.steps), "rung_walk": walk,
               "avail_walk": [s["avail_rung"] for s in report.steps],
               "switch_failures": engine.stats.switch_failures,
               "failed_steps_checked": failed_checked, "upgrades_committed": committed,
               "faults": dict(chaos.faults), "fetches": chaos.fetches, "crc_caught": corrupt,
               "retries": pager.retries, "quarantines": pager.quarantines,
               "fault_s": report.fault_s, "switch_records": report.switch_records,
               "wall_s": wall, "launches": got, "heal_seed": seed}
        log(f"[faults] {report.table()}")
        log(f"[faults] rung walk {walk}, deliverable {out['avail_walk']}; "
            f"{engine.stats.switch_failures} switches failed and rolled back "
            f"({failed_checked} steps checked bit for bit), {committed} upgrades committed "
            f"through the faulty pager and served the pristine streams; faults {chaos.faults} "
            f"over {chaos.fetches} fetches, {corrupt} caught by the CRC, {pager.retries} "
            f"retries, {pager.quarantines} quarantines; a forced failed upgrade rolled back bit "
            f"for bit; a flipped bit (seed {seed}) caught and healed; wall {wall:.2f}s; "
            f"(launches, decode-body launches) {got}")
    finally:
        store.pager = inner
    return out


def phase_spec_faults(cfg, store, per_forward, gen):
    """Phase 3c: the decode route's rows at the verify shapes, speculative
    serving against plain greedy, and a scheduled run through injected
    delivery faults, on phase 2's store (back at its rung at the end)."""
    t_phase = time.perf_counter()
    prev = store.rung
    store.to_rung(2)
    try:
        rows = spec_rows(store, gen)
        verify = verify_passes(rows, cfg)
        serve, spec_launches = spec_serve(cfg, store, per_forward)
        faults = fault_run(cfg, store, per_forward)
    finally:
        store.to_rung(prev)
    launches = {n: (spec_launches[n][0] + faults["launches"][n][0],
                    spec_launches[n][1] + faults["launches"][n][1]) for n in KERNELS}
    seconds = time.perf_counter() - t_phase
    log(f"[spec] phase 3c took {seconds:.1f}s")
    return {"rows": rows, "verify_passes": verify, "serve": serve, "faults": faults,
            "launches": launches, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 3d: a fleet of replicas on the card, and the serve and fleet CLIs
# ---------------------------------------------------------------------------
FLEET_REPLICAS, FLEET_REQUESTS, FLEET_NEW_TOKENS = 4, 12, 2
# the fleet CLI's traffic flags for this phase (``launch/fleet.py``; its
# defaults give links 100,25,400 Mbit/s round-robin and --chaos-every 2)
FLEET_FLAGS = ["--trace", "burst", "--requests", str(FLEET_REQUESTS),
               "--new-tokens", str(FLEET_NEW_TOKENS), "--max-batch", str(BATCH),
               "--policy", "failure", "--chaos"]
# the CLIs run in-process at --smoke on the card and on the CPU: (module,
# arguments); "{out}" is a directory of the run's own
CLI_RUNS = (
    ("serve", ["--bits", "8,6,4", "--trace", "burst", "--requests", "40", "--new-tokens", "2",
               "--policy", "failure", "--chaos"]),
    ("serve", ["--bits", "8,6,4", "--save-artifact", "{out}/artifact"]),
    ("serve", ["--artifact", "{out}/artifact", "--link-mbps", "100", "--requests", "4",
               "--new-tokens", "2"]),
    ("serve", ["--bits", "8,6,4", "--trace", "poisson", "--requests", "16", "--new-tokens", "2",
               "--speculate", "2", "--draft-rung", "0"]),
    ("serve", ["--bits", "8,6,4", "--search-recipe", "none", "--requests", "4",
               "--new-tokens", "2"]),
    ("fleet", ["--replicas", str(FLEET_REPLICAS), "--json", "{out}/fleet.json", *FLEET_FLAGS]),
)
# what a CLI line may print differently on the card and on the CPU: the
# wall seconds of a budget-schedule phase, and what depends on the weights
# (a torch.Generator on the card draws other numbers than one on the CPU):
# the drafts' acceptance and the search's dB scores
CLI_MASKS = ((r" in \d+\.\d+s;", " in <wall>s;"),
             (r"acceptance=\d\.\d{3} \(\d+/", "acceptance=<x> (<a>/"),
             (r"-?\d+\.\ddB", "<dB>"))


def fleet_specs():
    """The fleet CLI's replica mix (``launch/fleet.py::make_specs``) under
    ``FLEET_FLAGS``: links 100, 25 and 400 Mbit/s round-robin, burst traffic
    on even replicas and Poisson on odd ones, ``--policy failure``, chaos
    on replicas 0 and 2, 12 requests of 2 new tokens, max batch 4."""
    from repro_torch.launch import fleet as fleet_cli
    from repro_torch.launch.flags import traffic_parent

    args = argparse.ArgumentParser(parents=[traffic_parent()]).parse_args(FLEET_FLAGS)
    args.replicas, args.link_mbps, args.chaos_every = FLEET_REPLICAS, "100,25,400", 2
    return fleet_cli.make_specs(args, [])


def _served_batches(report):
    """(step record, the requests it served) of every step of a report."""
    out, i = [], 0
    for s in report.steps:
        out.append((s, report.requests[i:i + s["batch"]]))
        i += s["batch"]
    return out


def _streams(leaf):
    return [leaf.w_base] + [d for d in leaf.deltas if d is not None]


def fleet_run(cfg, store, per_forward):
    """The fleet over the phase-2 store's full (8, 6, 4) tree (rung 2): four
    replicas of ``fleet_specs`` through one ``DeltaDistribution`` under
    ``FleetController(1.5 x 4 x top-rung bytes, interval_s=0.05)``.
    Checks: every request served; every switch record pages its computed
    bytes (``verify_ledgers``, and each the sum of the crossed
    ``bytes(delta_k)``); fleet bytes below unicast and zoo bytes; dedup
    hits; every K1-K3 launch on its rung's kernel (each prefill's 196 on
    the CUDA-core body, its LM head and every decode step on the decode
    body) and no plain or tensor-core launch; every replica's resident
    streams and the shared tree equal to the pristine ones; and one served
    batch per (replica, rung) re-served by a lone engine over the phase-2
    store at that rung with the same tokens."""
    from collections import Counter

    from repro_torch import tree
    from repro_torch.core.nesting import NestedTensor
    from repro_torch.fleet import FleetController, build_fleet
    from repro_torch.kernels import dispatch
    from repro_torch.serving import Request, ServeEngine

    shared = store.nested_params
    pristine = {p: [s.clone() for s in _streams(leaf)] for p, leaf in store.nested_leaves()}
    fleet, build_s = _timed(lambda: build_fleet(fleet_specs(), cfg=cfg, nested_params=shared,
                                                device=DEVICE))
    top = store.rung_resident_bytes(2)
    controller = FleetController(int(1.5 * FLEET_REPLICAS * top), interval_s=0.05,
                                 mode="rebalance")
    changes, last, apply = Counter(), {}, controller.apply

    def apply_and_count(replicas, now):         # envelope changes by reason
        envs = apply(replicas, now)
        for e in envs:
            if last.get(e.replica, -1) != e.budget_bytes:
                changes[e.reason] += 1
                last[e.replica] = e.budget_bytes
        return envs

    controller.apply = apply_and_count
    fleet.controller = controller
    dispatch.reset_counters()                   # this path starts here
    report, wall, busy = _profiled(fleet.run)
    got = {n: (dispatch.COUNTERS[n].launches, dispatch.COUNTERS[n].dec_launches)
           for n in KERNELS}
    odd = {n: (c.plain_launches, c.tc_launches) for n, c in dispatch.COUNTERS.items()
           if c.plain_launches or c.tc_launches}
    peak = torch.cuda.max_memory_allocated()
    want = {n: [0, 0] for n in KERNELS}
    for rep in report.replicas.values():
        for s in rep.steps:
            name = next(n for n, v in KERNELS.items() if v[0] == min(s["rung"], 2))
            want[name][0] += per_forward * (1 + FLEET_NEW_TOKENS)
            want[name][1] += per_forward * FLEET_NEW_TOKENS + 1
    want = {n: tuple(v) for n, v in want.items()}
    if got != want or odd:
        raise AssertionError(f"fleet (launches, decode-body launches) {got}, want {want}; "
                             f"plain or tensor-core launches {odd}")
    for name, rep in report.replicas.items():
        _check_report(rep, FLEET_REQUESTS, cfg.vocab_size, f"fleet {name}")
    checked = report.verify_ledgers()
    if not checked:
        raise AssertionError("the fleet recorded no switch")
    for name, rep in report.replicas.items():
        for rec in rep.switch_records:
            lo, hi = sorted((rec["from_rung"], rec["to_rung"]))
            if rec["page_in"] + rec["page_out"] != sum(map(store.delta_bytes, range(lo, hi))):
                raise AssertionError(f"fleet {name}: switch {rec} pages other bytes than "
                                     f"bytes(delta_k) of the rungs it crossed")
    s = report.summary()
    if not (report.fleet_bytes < report.unicast_bytes and report.fleet_bytes < report.zoo_bytes
            and s["dedup_hits"] > 0):
        raise AssertionError(f"fleet transport {report.transport}, zoo {report.zoo_bytes}: "
                             f"want fleet < unicast, fleet < zoo and dedup hits")
    for rep in fleet.replicas:                  # no replica's paging touched another's
        for p, leaf in rep.store.nested_leaves():
            if not all(torch.equal(a, b) for a, b in zip(_streams(leaf), pristine[p])):
                raise AssertionError(f"fleet {rep.name}: {p} serves streams that differ "
                                     f"from the shared tree's")
    for p, leaf in tree.flatten_with_path(shared):
        if isinstance(leaf, NestedTensor) and not (
                len(_streams(leaf)) == len(pristine[p])
                and all(torch.equal(a, b) for a, b in zip(_streams(leaf), pristine[p]))):
            raise AssertionError(f"the fleet changed the shared tree's {p}")
    del pristine
    # one served batch per (replica, rung) again, on a lone engine over the
    # phase-2 store at that rung, with the same fillers
    lone = ServeEngine(cfg, store, max_batch=BATCH, max_len=MAX_LEN,
                       model=fleet.replicas[0].engine.model)
    isolation = []
    for rep in fleet.replicas:
        seen = set()
        for step, done in _served_batches(report.replicas[rep.name]):
            if step["rung"] in seen:
                continue
            seen.add(step["rung"])
            reqs = [Request(r.request.uid, r.request.prompt, FLEET_NEW_TOKENS) for r in done]
            reqs += [Request(-1, done[-1].request.prompt, FLEET_NEW_TOKENS)
                     for _ in range(step["filler"])]
            lone.generate(reqs, memory_budget_bytes=budget_for(store, step["rung"]))
            if store.rung != step["rung"] or [r.out_tokens for r in reqs[:len(done)]] != \
                    [r.request.out_tokens for r in done]:
                raise AssertionError(f"fleet {rep.name} step {step['step']} at rung "
                                     f"{step['rung']}: a lone engine gave other tokens")
            isolation.append((rep.name, step["rung"], step["step"], len(done)))
    chaos = {rep.name: {"faults": dict(rep.chaos.faults), "fetches": rep.chaos.fetches,
                        "retries": rep.resilient.retries,
                        "quarantines": rep.resilient.quarantines}
             for rep in fleet.replicas if rep.chaos is not None}
    per_replica = {}
    log(f"[fleet] {report.table()}")
    for name, rep in report.replicas.items():
        r = rep.summary()
        per_replica[name] = {k: r[k] for k in ("requests", "p95_ms", "mean_rung", "switches",
                                               "fault_s")}
        per_replica[name]["rung_walk"] = [st["rung"] for st in rep.steps]
        log(f"[fleet]   {name}: {r['requests']} reqs p95={r['p95_ms']:.1f}ms (virtual) "
            f"mean_rung={r['mean_rung']:.2f} switches={r['switches']} "
            f"faults={r['fault_s'] * 1e3:.1f}ms; rung walk {per_replica[name]['rung_walk']}")
    log(f"[fleet] chaos {chaos}; envelope changes by reason {dict(changes)} over "
        f"{controller.ticks} ticks; {checked} switch records exact; transport "
        f"{report.transport}; zoo {report.zoo_bytes} B")
    log(f"[fleet] wall {wall:.2f}s under the profiler (build {build_s:.2f}s), device busy "
        f"{busy:.1f} ms ({busy / 1e3 / wall:.1%}); peak device memory {peak / 1e9:.2f} GB; "
        f"launches {got}; isolation re-served {isolation}")
    return {"summary": s, "transport": dict(report.transport), "zoo_bytes": report.zoo_bytes,
            "replicas": per_replica, "chaos": chaos, "envelope_changes": dict(changes),
            "ticks": controller.ticks, "switch_records_checked": checked,
            "wall_s": wall, "build_s": build_s, "device_busy_ms": busy,
            "device_busy_share": busy / 1e3 / wall, "peak_mem_bytes": peak,
            "launches": got, "isolation": isolation}


def _cli(module, args, device, out_dir):
    """One in-process CLI run: (its stdout lines with ``out_dir`` masked,
    K1-K3 launches and plain launches counted from 0)."""
    import contextlib
    import importlib
    import io

    from repro_torch.kernels import dispatch

    main = importlib.import_module(f"repro_torch.launch.{module}").main
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--device", device,
            *(a.replace("{out}", str(out_dir)) for a in args)]
    dispatch.reset_counters()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
    except SystemExit as e:
        if e.code not in (0, None):
            raise AssertionError(f"{module} {' '.join(argv)} exited {e.code}") from e
    if device == DEVICE:
        torch.cuda.synchronize()
    lines = buf.getvalue().replace(str(out_dir), "<out>").splitlines()
    return lines, ({n: dispatch.COUNTERS[n].launches for n in KERNELS},
                   sum(c.plain_launches for c in dispatch.COUNTERS.values()))


def cli_runs():
    """Each of ``CLI_RUNS`` at --smoke on the card and then on the CPU: each
    exits 0; on the card no K1-K3 call runs a plain version and every run
    that serves launches the kernels; the card's lines equal the CPU's but
    for ``CLI_MASKS``, and the fleet's JSON reports are equal."""
    import re
    import shutil

    root = ROOT / "build" / "cli_smoke"
    shutil.rmtree(root, ignore_errors=True)
    out = []
    try:
        for module, args in CLI_RUNS:
            runs = {}
            for device in (DEVICE, "cpu"):
                d = root / device
                d.mkdir(parents=True, exist_ok=True)
                (lines, counts), secs = _timed(lambda: _cli(module, args, device, d))
                runs[device] = (lines, counts, secs)
            (card, (launches, plain), secs), (host, _, host_s) = runs[DEVICE], runs["cpu"]
            masked = []
            for lines in (card, host):
                for pat, rep in CLI_MASKS:
                    lines = [re.sub(pat, rep, line) for line in lines]
                masked.append(lines)
            what = f"{module} {' '.join(args)}"
            if masked[0] != masked[1]:
                raise AssertionError(f"{what}: the card's lines {card} differ from the "
                                     f"CPU's {host}")
            serves = "--save-artifact" not in args
            if plain or (serves and not sum(launches.values())):
                raise AssertionError(f"{what}: K1-K3 launches {launches}, plain {plain}")
            if module == "fleet" and json.loads((root / DEVICE / "fleet.json").read_text()) != \
                    json.loads((root / "cpu" / "fleet.json").read_text()):
                raise AssertionError("the fleet CLI's JSON report on the card differs from "
                                     "the CPU's")
            out.append({"cli": what, "seconds": secs, "cpu_seconds": host_s,
                        "launches": launches, "lines": card})
            log(f"[cli] {what}: exit 0 in {secs:.2f}s on the card ({host_s:.2f}s on the CPU), "
                f"lines equal but for the masks; K1-K3 launches {launches}")
            for line in card:
                log(f"[cli]   {line}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_fleet(cfg, store, per_forward):
    """Phase 3d: the fleet on the phase-2 store's tree, then the CLIs; the
    store goes back to its rung at the end."""
    t_phase = time.perf_counter()
    prev = store.rung
    store.to_rung(2)
    try:
        fleet = fleet_run(cfg, store, per_forward)
    finally:
        store.to_rung(prev)
    clis = cli_runs()
    seconds = time.perf_counter() - t_phase
    log(f"[fleet] phase 3d took {seconds:.1f}s")
    return {"fleet": fleet, "clis": clis, "launches": fleet["launches"], "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 4: K4-K6 against their plain versions at this slice's shapes
# ---------------------------------------------------------------------------
def kv_streams(x, bits, page):
    """(BH, S, D) values -> the nested KV cache's resident streams of them,
    each (BH, npages * rows_i, D), and the per-position scale (BH, S, 1)."""
    from repro_torch.serving.kv_cache import _quantize_kv

    BH, S, D = x.shape
    streams, scale = _quantize_kv(x.reshape(1, BH, S, 1, D), bits=bits, page=page,
                                  rounding="rtn")
    return ([s.reshape(BH, -1, D) for s in streams], scale.reshape(BH, S, 1))


def _cold_copies(tensors, nbytes):
    """Enough copies of ``tensors`` that cycling through them exceeds L2
    twice, as a decode step over every layer finds its operands."""
    n = max(1, min(256, math.ceil(2 * L2_BYTES / max(1, nbytes))))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def _check_exact(name, got, want, what):
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        bad = (got.long() - want.long()).abs().max().item() if got.shape == want.shape else "shape"
        raise AssertionError(f"{name} {what}: kernel differs from its plain version "
                             f"(max |diff| {bad})")


def _row_rel(got, want) -> float:
    """Largest relative L2 error of one attention output row (b, s, head)."""
    d = (got.float() - want.float()).norm(dim=-1)
    return (d / want.float().norm(dim=-1).clamp_min(1e-30)).max().item()


def _drop_key_tile(q, k, v, want, tile: int = 64):
    """The plain output with key tile 0 dropped from the last query tile:
    what a K5 that skipped one key tile of its last query tile would give
    (the control for the K5 checks)."""
    from repro_torch.models.attention import full_attention

    S = q.shape[1]
    last = full_attention(q[:, S - tile:], k[:, tile:], v[:, tile:], causal=True,
                          q_offset=S - 2 * tile)
    ctl = want.clone()
    ctl[:, S - tile:] = last.to(want.dtype)
    return ctl


def phase_kv_kernels(cfg, gen):
    """K4 bit-exact at every KV rung of (4, 6, 8) and (3, 5, 6, 8), M = 6
    and 48; K5 within 1e-4 (f32) / 2e-2 (bf16) of max |o| and of every
    row's norm at S 1100, 2048, 4096, with what a K5 missing one key tile
    would read, beside ``scaled_dot_product_attention`` as the library
    yardstick;
    K6 bit-exact at (n, h) (6, 4), (8, 6), (8, 4) on every weight shape.
    Each is timed by CUDA-graph replay; its plain version eager."""
    from repro_torch.core.nesting import nest_quantize
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.nest_recompose import ops as nr
    from repro_torch.kernels.nested_attention import ops as qk

    rows = []
    z = torch.zeros(1, device=DEVICE)
    floor_ms = time_graph_ms(lambda i: z.zero_(), 50)
    log(f"[kv-kernels] launch floor (one-element zero_(), CUDA-graph replay): "
        f"{floor_ms * 1e3:.3f} us")
    rows.append(_row("launch_floor", "zeros(1).zero_()", 0, "float32", 0.0, floor_ms, None, 8,
                     0.0, PEAK_FLOPS[torch.float32], None))
    BH, D, S = BATCH_LONG * cfg.num_kv_heads, cfg.head_dim, PROMPT_LONG
    x = torch.randn(BH, S, D, generator=gen, device=DEVICE)
    for bits in ((4, 6, 8), (3, 5, 6, 8)):
        streams, _ = kv_streams(x, bits, KV_PAGE)
        for M in (cfg.num_heads // cfg.num_kv_heads, 6 * NEW_TOKENS):
            qc, _ = qk.quantize_q(torch.randn(BH, M, D, generator=gen, device=DEVICE), bits[-1])
            for rung in range(len(bits)):
                res, st = bits[:rung + 1], streams[:rung + 1]
                got = qk.ladder_qk_scores(qc, st, bits=res, page=KV_PAGE)
                with dispatch.reference_pass():
                    want = qk.ladder_qk_scores(qc, st, bits=res, page=KV_PAGE)
                _check_exact("nested_qk", got, want, f"bits {bits} rung {rung} M={M}")
                nbytes = qc.numel() * 4 + sum(t.numel() * 4 for t in st) + got.numel() * 4
                copies = _cold_copies(st, nbytes)
                ms = time_graph_ms(lambda i: qk.ladder_qk_scores(
                    qc, copies[i % len(copies)], bits=res, page=KV_PAGE), 20)
                with dispatch.reference_pass():
                    plain_ms = time_ms(lambda i: qk.ladder_qk_scores(qc, st, bits=res,
                                                                     page=KV_PAGE), 3)
                # the control: query codes out of int8 range take the CUDA cores
                qw = qc * 256
                got = qk.ladder_qk_scores(qw, st, bits=res, page=KV_PAGE)
                with dispatch.reference_pass():
                    want = qk.ladder_qk_scores(qw, st, bits=res, page=KV_PAGE)
                _check_exact("nested_qk", got, want, f"bits {bits} rung {rung} M={M} control")
                cc_ms = time_graph_ms(lambda i: qk.ladder_qk_scores(
                    qw, copies[i % len(copies)], bits=res, page=KV_PAGE), 20)
                ops = 2.0 * BH * M * S * D
                rows.append(_row("nested_qk", f"bits {bits} rung {rung}", M, "int32",
                                 0.0, ms, plain_ms, nbytes, ops, PEAK_INT8_OPS, None,
                                 cuda_core_ms=cc_ms, BH=BH, S=S, D=D, page=KV_PAGE, rung=rung,
                                 bits=list(bits)))
        del streams
    B, Hq, Hkv, hd = BATCH_LONG, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for S in (1100, PROMPT_LONG, 2 * PROMPT_LONG):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(B, S, h, hd, generator=gen, device=DEVICE).to(dtype)
                       for h in (Hq, Hkv, Hkv))
            got = fa.flash_attention(q, k, v)
            with dispatch.reference_pass():
                want = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            peak = want.float().abs().max().item()
            row = _row_rel(got, want)
            if not (math.isfinite(err) and err <= TOL[dtype] * peak):
                raise AssertionError(f"flash_attention S={S} {dtype}: max |kernel - plain| "
                                     f"= {err} > {TOL[dtype]} * {peak}")
            if not (math.isfinite(row) and row <= ROW_TOL[dtype]):
                raise AssertionError(f"flash_attention S={S} {dtype}: worst row |kernel - "
                                     f"plain| / |plain| = {row} > {ROW_TOL[dtype]}")
            ctl = _drop_key_tile(q, k, v, want)
            ctl_err = (ctl.float() - want.float()).abs().max().item()
            ctl_row = _row_rel(ctl, want)
            if ctl_row <= ROW_TOL[dtype]:
                raise AssertionError(f"flash_attention S={S} {dtype}: the row check cannot "
                                     f"see a missing key tile ({ctl_row})")
            log(f"[kv-kernels] flash_attention S={S} {dtype}: max err / max|o| "
                f"{err / peak:.3e} (tol {TOL[dtype]}), worst row {row:.3e} (tol "
                f"{ROW_TOL[dtype]}); one key tile dropped reads {ctl_err / peak:.3e} and "
                f"{ctl_row:.3e}")
            del ctl
            ms = time_graph_ms(lambda i: fa.flash_attention(q, k, v), 10)
            with dispatch.reference_pass():
                plain_ms = time_ms(lambda i: fa.flash_attention(q, k, v), 3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_ms = time_graph_ms(lambda i: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
            nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
            flops = 2.0 * B * Hq * S * S * hd          # QK^T and PV, causal half
            rows.append(_row("flash_attention", f"S={S}", S, str(dtype).replace("torch.", ""),
                             err, ms, plain_ms, nbytes, flops, PEAK_FLOPS[dtype], lib_ms,
                             max_abs_ref=peak, worst_row_rel=row,
                             control_drop_tile={"err_over_max": ctl_err / peak,
                                                "worst_row_rel": ctl_row},
                             B=B, S=S, Hq=Hq, Hkv=Hkv, hd=hd))
            del q, k, v, got, want
    d, L = cfg.d_model, cfg.num_layers
    shapes = [("q/o", d, cfg.num_heads * cfg.head_dim, 512, 2 * L),
              ("k/v", d, cfg.num_kv_heads * cfg.head_dim, 512, 2 * L),
              ("gate/up", d, cfg.d_ff, 512, 2 * L), ("down", cfg.d_ff, d, 256, L),
              ("lm_head", d, cfg.vocab_size, 512, 1), ("embed", cfg.vocab_size, d, 512, 1)]
    for shape, K, N, block, uses in shapes:
        w = torch.randn(K, N, generator=gen, device=DEVICE)
        for n, h in ((6, 4), (8, 6), (8, 4)):
            nt = nest_quantize(w, bits=(n, h), rounding="rtn", block=block)
            wh, wl = nt.w_base, nt.deltas[0]
            got = nr.nest_recompose(wh, wl, n=n, h=h, K=K, block_k=block)
            with dispatch.reference_pass():
                want = nr.nest_recompose(wh, wl, n=n, h=h, K=K, block_k=block)
            _check_exact("nest_recompose", got, want, f"{shape} n={n} h={h}")
            if not torch.equal(got.to(torch.int32), nt.codes_at(1)):
                raise AssertionError(f"nest_recompose {shape} n={n} h={h}: not the top codes")
            nbytes = (wh.numel() + wl.numel()) * 4 + K * N
            copies = _cold_copies((wh, wl), nbytes)
            ms = time_graph_ms(lambda i: nr.nest_recompose(
                *copies[i % len(copies)], n=n, h=h, K=K, block_k=block), 20)
            with dispatch.reference_pass():
                plain_ms = time_ms(lambda i: nr.nest_recompose(wh, wl, n=n, h=h, K=K,
                                                               block_k=block), 3)
            rows.append(_row("nest_recompose", shape, 0, "int8", 0.0, ms, plain_ms, nbytes,
                             float(K * N), PEAK_INT8_OPS, None, K=K, N=N, n=n, h=h,
                             block=block, uses_per_tree=uses))
            del nt, copies, got, want
        del w
        torch.cuda.empty_cache()
    for r in rows:
        if r["kernel"] == "launch_floor":
            continue
        log(f"[kernel] {r['kernel']:15s} {r['shape']:22s} {r['dtype']:8s} M={r['M']:<4d} "
            f"err={r['max_abs_err']:.2e} ms={r['ms']:.4f} plain={r['plain_ms']:.3f} "
            f"bound={r['bound_ms']:.4f} ({r['bound_by']}) library="
            f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f')}"
            + (f" cuda-core={r['cuda_core_ms']:.4f}" if "cuda_core_ms" in r else ""))
    tree = [r for r in rows if r["kernel"] == "nest_recompose" and (r["n"], r["h"]) == (6, 4)]
    log(f"[kv-kernels] K6 page-in of the tree at (6, 4): "
        f"{sum(r['ms'] * r['uses_per_tree'] for r in tree):.4f} ms over "
        f"{sum(r['uses_per_tree'] for r in tree)} launches (bound "
        f"{sum(r['bound_ms'] * r['uses_per_tree'] for r in tree):.4f} ms; "
        f"{K6_TREE_MS_BEFORE} ms on the one-thread-per-code body it replaces)")
    return rows


def _row(kernel, shape, M, dtype, err, ms, plain_ms, nbytes, ops, peak, lib_ms, **extra):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return {"kernel": kernel, "shape": shape, "M": M, "dtype": dtype, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bytes": nbytes,
            "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", **extra}


# ---------------------------------------------------------------------------
# phase 5: long-context serving on the nested KV cache
# ---------------------------------------------------------------------------
def long_requests(phase: int, vocab: int):
    from repro_torch.serving import Request
    rng = np.random.default_rng(200 + phase)
    return [Request(i, rng.integers(0, vocab, size=PROMPT_LONG).astype(np.int32),
                    max_new_tokens=NEW_TOKENS) for i in range(BATCH_LONG)]


def long_engine(cfg, store):
    from repro_torch.serving import KVCacheConfig, LoadAdaptivePolicy, ServeEngine
    return ServeEngine(cfg, store, max_batch=BATCH_LONG, max_len=PROMPT_LONG + 16,
                       policy=LoadAdaptivePolicy(high_depth=8, low_depth=0),
                       kv=KVCacheConfig(bits=(4, 6, 8), page=KV_PAGE, rounding="rtn"))


def _rel_norm(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def phase_long_serve(cfg, store, per_forward):
    """Full-width qwen2-1.5b, 2 requests x 2048 prompt tokens x 8 new
    tokens, nested KV cache (4, 6, 8) / page 16 under a LoadAdaptivePolicy:
    five generate calls whose queue depths walk the KV rung 2 -> 1 -> 0 ->
    1 -> 2 (one rung per decision; the weight rung walks with it).  Every
    prefill launches K5 once per layer and the plain blockwise version
    never; every KV ledger event equals its metadata-computed bytes; the
    rendered top-rung K/V is within 0.02 (relative norm) of the dense
    prefill K/V."""
    from repro_torch.kernels import dispatch

    engine = long_engine(cfg, store)
    forwards = 1 + NEW_TOKENS
    phases, walk, ingest_s = [], [], []
    kv_ingest = engine._kv_ingest

    def timed_kv_ingest(cache, S):
        torch.cuda.synchronize()
        t = time.perf_counter()
        kv_ingest(cache, S)
        torch.cuda.synchronize()
        ingest_s.append(time.perf_counter() - t)

    engine._kv_ingest = timed_kv_ingest
    dispatch.reset_counters()                      # this path starts here
    # a bf16 prefill's packed_linears but the LM head (M = 2) take the tensor
    # cores; the LM head and every decode step (M = 2) the decode body
    prefill_tc = per_forward - 1 if cfg.compute_dtype == "bfloat16" else 0
    want_dec = per_forward * NEW_TOKENS + 1
    for phase, depth in enumerate(LONG_QUEUE):
        before = {n: (c.launches, c.plain_launches) for n, c in dispatch.COUNTERS.items()}
        before_tc = {n: c.tc_launches for n, c in dispatch.COUNTERS.items()}
        before_dec = {n: c.dec_launches for n, c in dispatch.COUNTERS.items()}
        reqs = long_requests(phase, cfg.vocab_size)
        torch.cuda.synchronize()
        t0 = time.time()
        engine.generate(reqs, queue_depth=depth)
        torch.cuda.synchronize()
        wall = time.time() - t0
        delta = {n: (c.launches - before[n][0], c.plain_launches - before[n][1])
                 for n, c in dispatch.COUNTERS.items()}
        rung = store.rung
        want = {n: (0, 0) for n in dispatch.COUNTERS}
        want[[n for n, v in KERNELS.items() if v[0] == min(rung, 2)][0]] = (per_forward * forwards, 0)
        want["flash_attention"] = (cfg.num_layers, 0)
        if delta != want:
            raise AssertionError(f"long phase {phase}: launches {delta}, want {want}")
        # per body: the bf16 prefill's 196 on the tensor cores, the rest
        # (decode steps, the LM head) on the decode body
        tc = {n: c.tc_launches - before_tc[n] for n, c in dispatch.COUNTERS.items()}
        want_tc = {n: (prefill_tc if want[n][0] and n in KERNELS else 0) for n in tc}
        if tc != want_tc:
            raise AssertionError(f"long phase {phase}: tensor-core launches {tc}, want {want_tc}")
        dec = {n: c.dec_launches - before_dec[n] for n, c in dispatch.COUNTERS.items()}
        want_d = {n: (want_dec if want[n][0] and n in KERNELS else 0) for n in dec}
        if dec != want_d:
            raise AssertionError(f"long phase {phase}: decode-body launches {dec}, want {want_d}")
        for r in reqs:
            if len(r.out_tokens) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size
                                                          for t in r.out_tokens):
                raise AssertionError(f"long phase {phase}: bad tokens {r.out_tokens}")
        walk.append(engine.kv.rung)
        phases.append({"queue_depth": depth, "kv_rung": engine.kv.rung, "weight_rung": rung,
                       "wall_s": wall, "kv_ingest_s": ingest_s[-1],
                       "kv_pages": len(engine.kv.pages),
                       "kv_resident_bytes": engine.kv.resident_bytes(), "launches": delta,
                       "tc_launches": tc, "dec_launches": dec,
                       "tokens": [r.out_tokens for r in reqs]})
        log(f"[long] phase {phase}: queue {depth} -> kv rung {engine.kv.rung}, weight rung "
            f"{rung}; {BATCH_LONG}x{PROMPT_LONG} prompt + {NEW_TOKENS} tokens in {wall:.3f}s "
            f"(_kv_ingest {ingest_s[-1]:.3f}s); "
            f"{len(engine.kv.pages)} pages, kv resident {engine.kv.resident_bytes()} B; "
            f"launches {delta}, on the tensor cores {tc}, on the decode body {dec}")
    launches = {n: c.launches for n, c in dispatch.COUNTERS.items()}
    tc_launches = {n: c.tc_launches for n, c in dispatch.COUNTERS.items()}
    dec_launches = {n: c.dec_launches for n, c in dispatch.COUNTERS.items()}
    del engine._kv_ingest
    if len(ingest_s) != len(LONG_QUEUE):
        raise AssertionError(f"{len(ingest_s)} KV ingests in {len(LONG_QUEUE)} generates")
    if walk != [2, 1, 0, 1, 2]:
        raise AssertionError(f"KV rung walk {walk}, want [2, 1, 0, 1, 2]")
    kv = engine.kv
    events = [list(e) for e in kv.ledger.events]
    if ([tuple(e) for e in events] != kv.expected_events
            or [tuple(e[:2]) for e in events] != [(2, 1), (1, 0), (0, 1), (1, 2)]):
        raise AssertionError(f"KV ledger {events} != expected {kv.expected_events}")
    for f, t, pin, pout in kv.ledger.events:
        if pin + pout != kv.delta_bytes(min(f, t)):
            raise AssertionError(f"KV step {f}->{t} moved {pin + pout} B, metadata says "
                                 f"{kv.delta_bytes(min(f, t))}")
    log(f"[long] KV ledger events {events} equal their expected bytes; stats kv_switches="
        f"{engine.stats.kv_switches} kv_pages={engine.stats.kv_pages}")
    # the dense prefill K/V of the last call's prompts against the cache's
    # rendering of them at the top rung
    toks = prompt_tokens(long_requests(len(LONG_QUEUE) - 1, cfg.vocab_size), store.device)
    _, dense = engine.model.prefill(store.params(), toks)
    render = {}
    for t, (r, d) in zip(("k", "v"), zip(kv.render(2), (dense["k"], dense["v"]))):
        render[t] = _rel_norm(r, d[:, :, :r.shape[2]])
    if max(render.values()) > RENDER_TOP_TOL:
        raise AssertionError(f"top-rung render {render} > {RENDER_TOP_TOL}")
    log(f"[long] rendered top-rung K/V vs dense prefill (relative norm): k "
        f"{render['k']:.3e} v {render['v']:.3e} (tol {RENDER_TOP_TOL})")
    return engine, dense, {"phases": phases, "kv_walk": walk, "kv_ledger": events,
                           "render_top_rel": render, "launches": launches,
                           "tc_launches": tc_launches, "dec_launches": dec_launches,
                           "prefill_tc_launches": prefill_tc}


def phase_long_f32(cfg, store):
    """f32 compute: the long prefill through K5 and K1-K3 against the same
    call under ``reference_pass`` (logits within 1e-4 of max |logit|), and
    a generate on the nested KV cache token-identical to its plain pass."""
    from repro_torch.kernels import dispatch

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    ek, ep = long_engine(cfg32, store), long_engine(cfg32, store)
    params = store.params()
    toks = prompt_tokens(long_requests(50, cfg.vocab_size), store.device)
    kern, _ = ek.model.prefill(params, toks)
    with dispatch.reference_pass():
        plain, _ = ep.model.prefill(params, toks)
    rel = _rel(kern, plain)
    rk, rp = long_requests(51, cfg.vocab_size), long_requests(51, cfg.vocab_size)
    ek.generate(rk, queue_depth=0)
    with dispatch.reference_pass():
        ep.generate(rp, queue_depth=0)
    same = [r.out_tokens for r in rk] == [r.out_tokens for r in rp]
    ok = (bool(kern.isfinite().all()) and rel <= 1e-4 and same
          and ek.kv.rung == ep.kv.rung == 2)
    log(f"[long-f32] prefill logits kernel vs plain {rel:.3e} (tol 1e-4); greedy tokens "
        f"identical {same} at kv rung {ek.kv.rung}")
    if not ok:
        raise AssertionError(f"long f32 check failed: rel {rel}, tokens identical {same}")
    return {"prefill_rel": rel, "tokens_identical": same}


def phase_long_profile(engine, cfg):
    """Where one long generate call's time goes (rung 2, bf16): host wall
    clock unprofiled, then device busy time by kernel under torch.profiler.
    In bf16 no K1-K3 launch of the path takes the CUDA-core body (so no
    split-K pass runs): the prefill's on the tensor cores, the rest on the
    decode body."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reqs = long_requests(60, cfg.vocab_size)
    torch.cuda.synchronize()
    t0 = time.time()
    engine.generate(reqs, queue_depth=0)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate(long_requests(61, cfg.vocab_size), queue_depth=0)
        torch.cuda.synchronize()
    dev = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 reverse=True)
    busy_ms = sum(d[0] for d in dev) / 1e3
    split = k1_k3_split(dev)
    body_ms = {body: v["device_ms"] for body, v in split.items()}
    out = {"kv_rung": engine.kv.rung, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms if busy_ms > 0 else None,
           "device_idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else None,
           "k1_k3_device_ms": body_ms, "k1_k3_calls": {b: v["calls"] for b, v in split.items()},
           "top_kernels": [{"name": k[:90], "calls": c, "device_ms": t / 1e3}
                           for t, c, k in dev[:10]]}
    log(f"[long-profile] generate {BATCH_LONG}x{PROMPT_LONG} + {NEW_TOKENS}: wall "
        f"{wall_ms:.1f} ms, device busy "
        f"{'not measured' if busy_ms == 0 else f'{busy_ms:.1f} ms'}; K1-K3 device ms "
        f"by body {body_ms}")
    for k in out["top_kernels"]:
        log(f"[long-profile]   {k['device_ms']:9.3f} ms  x{k['calls']:5d}  {k['name']}")
    if (busy_ms > 0 and cfg.compute_dtype == "bfloat16"
            and (split["reduce_partials"]["calls"] or split["cuda_core"]["calls"])):
        raise AssertionError(f"long generate: K1-K3 on the CUDA-core body {split}")
    return out


# ---------------------------------------------------------------------------
# phases 6 and 7: K4 on the served cache's pages, K6 on the served tree
# ---------------------------------------------------------------------------
def served_layer(kv, dense, layer):
    """One layer of the engine's own cache as K4 takes it: the streams of
    every page (L, B, rows, Hkv, hd) -> (B * Hkv, npages * rows, hd) (packing
    is per column, so this is bit-exact), the scales (B * Hkv, S, 1), and
    the dense prefill K/V (B * Hkv, S, hd) of the same positions."""
    def heads_first(t):
        t = t[layer]                                   # (B, R, Hkv, X)
        return t.permute(0, 2, 1, 3).reshape(-1, t.shape[1], t.shape[3]).contiguous()

    out = {}
    for t in ("k", "v"):
        streams, scale = kv.streams(t, kv.rung)
        S = scale.shape[2]
        out[t] = ([heads_first(s) for s in streams], heads_first(scale),
                  heads_first(dense[t][:, :, :S]).float())
    return out


def phase_served_kv_attention(engine, dense, cfg, gen):
    """nested_attention (K4 inside) on the served cache's pages, at every
    KV rung, for the first and the last layer: K4 equal to its plain
    version bit for bit, and the error against dense_attention_ref on the
    dense K/V shrinking as deltas become resident."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.nested_attention import ops as qk
    from repro_torch.kernels.nested_attention.ref import dense_attention_ref

    kv = engine.kv
    bits, G = kv.config.bits, cfg.num_heads // cfg.num_kv_heads
    out, failures, launches = [], [], 0
    for layer in (0, cfg.num_layers - 1):
        lay = served_layer(kv, dense, layer)
        (ks, k_scale, k_dense), (vs, v_scale, v_dense) = lay["k"], lay["v"]
        q = torch.randn(k_dense.shape[0], G, cfg.head_dim, generator=gen, device=DEVICE)
        oracle = dense_attention_ref(q, k_dense, v_dense)
        errs = []
        for rung in range(kv.rung + 1):
            before = qk.COUNTER.launches
            o = qk.nested_attention(q, ks[:rung + 1], k_scale, vs[:rung + 1], v_scale,
                                    bits=bits, page=kv.config.page, rung=rung)
            launches += qk.COUNTER.launches - before
            # the same scores again, kernel against plain (not counted)
            qc, _ = qk.quantize_q(q, bits[-1])
            got = qk.ladder_qk_scores(qc, ks[:rung + 1], bits=bits[:rung + 1],
                                      page=kv.config.page)
            with dispatch.reference_pass():
                want = qk.ladder_qk_scores(qc, ks[:rung + 1], bits=bits[:rung + 1],
                                           page=kv.config.page)
            _check_exact("nested_qk", got, want, f"served layer {layer} rung {rung}")
            errs.append(_rel_norm(o, oracle))
        log(f"[served-kv] layer {layer}: nested_attention vs dense oracle (relative norm) "
            f"at rungs 0..{kv.rung}: {', '.join(f'{e:.3e}' for e in errs)}; K4 bit-exact")
        if not all(a > b for a, b in zip(errs, errs[1:])) or not all(map(math.isfinite, errs)):
            failures.append(layer)
        out.append({"layer": layer, "rel_err_by_rung": errs})
    if failures or launches == 0:
        raise AssertionError(f"served-cache attention error did not shrink with the rung "
                             f"at layers {failures}: {out}")
    return {"layers": out, "launches": launches}


def phase_served_recompose(store):
    """nest_recompose(base, delta_0, n=6, h=4) on every layer slice of
    every nested weight of the served tree: equal to chain_recompose at
    rung 1 of the same words and to its plain version."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.nest_recompose import ops as nr

    dispatch.reset_counters()                      # this entry point starts here
    checked = 0
    for path, leaf in store.nested_leaves():
        layers = [leaf.layer(i) for i in range(leaf.shape[0])] if leaf.w_base.ndim == 3 \
            else [leaf]
        for nt in layers:
            n, h = nt.bits[1], nt.bits[0]
            got = nr.nest_recompose(nt.w_base, nt.deltas[0], n=n, h=h, K=nt.K,
                                    block_k=nt.block)
            with dispatch.reference_pass():
                want = nr.nest_recompose(nt.w_base, nt.deltas[0], n=n, h=h, K=nt.K,
                                         block_k=nt.block)
            _check_exact("nest_recompose", got, want, path)
            if not torch.equal(got.to(torch.int32), nt.codes_at(1)):
                raise AssertionError(f"nest_recompose {path}: not chain_recompose at rung 1")
            checked += 1
    log(f"[served-recompose] {checked} weight slices: K6 equal to chain_recompose at rung 1 "
        f"and to its plain version")
    return {"slices": checked, "launches": nr.COUNTER.launches}


def prefill_summary(rows, name, tc_launches):
    """K1-K3's ``prefill`` entry: one long prefill's 196 launches at
    M = 4096 bf16 on the tensor-core body (every main-path shape but the
    LM head times its uses per forward), beside the same launches on the
    CUDA-core body and the dense bf16 yardstick."""
    M = PREFILL_MS[-1]
    sel = [r for r in rows if r["kernel"] == name and r["M"] == M
           and r.get("route") == "tensor_core"]
    tot = lambda key: sum(r[key] * r["uses_per_forward"] for r in sel)  # noqa: E731
    t_bytes = tot("bytes") / HBM_BYTES_PER_S * 1e3
    t_ops = tot("flops") / PEAK_FLOPS[torch.bfloat16] * 1e3
    return {"route": "tensor_core", "launches": tc_launches,
            "per": f"one prefill: {sum(r['uses_per_forward'] for r in sel)} launches at "
                   f"M={M} bf16",
            "max_abs_err": max(r["max_abs_err"] for r in sel), "ms": tot("ms"),
            "cuda_core_ms": tot("cuda_core_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "yardstick_dense_bf16_matmul_ms": tot("dense_bf16_matmul_ms")}


def decode_steps(rows, M, dtype):
    """One decode step (197 launches) per kernel at batch M in ``dtype``:
    the decode body, the CUDA-core body and the dense bf16 yardstick."""
    out = {}
    for name in KERNELS:
        sel = [r for r in rows if r["kernel"] == name and r["M"] == M and r["dtype"] == dtype]
        out[name] = {key: sum(r[key] * r["uses_per_forward"] for r in sel)
                     for key in ("ms", "cuda_core_ms", "dense_bf16_matmul_ms", "bound_ms")}
    return out


def kernel_summary(rows, launches, tc_launches, M=4, dtype="bfloat16"):
    """One entry per kernel: one decode step at batch M in ``dtype``
    (every main-path shape times its uses per forward) on the decode body,
    the same launches on the CUDA-core body beside it (``cuda_core_ms``);
    ``launches`` the short serve's (all bodies), ``decode_launches`` those
    on the decode body; the long prefill's tensor-core launches as its
    ``prefill`` entry."""
    out = []
    for name, (_, source, replaces) in KERNELS.items():
        sel = [r for r in rows if r["kernel"] == name and r["M"] == M and r["dtype"] == dtype]
        tot = lambda key: sum(r[key] * r["uses_per_forward"] for r in sel)
        t_bytes = sum(r["bytes"] * r["uses_per_forward"] for r in sel) / HBM_BYTES_PER_S * 1e3
        t_ops = sum(r["flops"] * r["uses_per_forward"] for r in sel) / 989e12 * 1e3
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name][0], "decode_launches": launches[name][1],
            "max_abs_err": max(r["max_abs_err"] for r in sel),
            "ms": tot("ms"), "cuda_core_ms": tot("cuda_core_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "yardstick_dense_bf16_matmul_ms": tot("dense_bf16_matmul_ms"),
            "per": f"one decode step: {sum(r['uses_per_forward'] for r in sel)} "
                   f"launches at M={M} {dtype}, decode body",
            "prefill": prefill_summary(rows, name, tc_launches[name])})
    return out


def kv_kernel_summary(rows, launches):
    """K4-K6 entries of the kernels line, each at its main-path shape: K4 on
    the served cache (rung 2 of (4, 6, 8), one decode token's G = 6 query
    heads per kv head), K5 one long prefill's attention (S = 2048, bf16,
    per layer), K6 one page-in of every weight slice of the tree at
    (n, h) = (6, 4)."""
    decode_m = min(r["M"] for r in rows if r["kernel"] == "nested_qk")
    floor_ms = next(r["ms"] for r in rows if r["kernel"] == "launch_floor")
    pick = {
        "nested_qk": [r for r in rows if r["kernel"] == "nested_qk" and r["bits"] == [4, 6, 8]
                      and r["rung"] == 2 and r["M"] == decode_m],
        "flash_attention": [r for r in rows if r["kernel"] == "flash_attention"
                            and r["S"] == PROMPT_LONG and r["dtype"] == "bfloat16"],
        "nest_recompose": [r for r in rows if r["kernel"] == "nest_recompose"
                           and (r["n"], r["h"]) == (6, 4)],
    }
    per = {"nested_qk": "one launch: BH=4, S=2048, D=128, page 16, M=6, rung 2 of (4, 6, 8)",
           "flash_attention": "one launch: B=2, S=2048, 12/2 heads of 128, bf16",
           "nest_recompose": "one page-in of every weight slice of the tree at (6, 4): "
                             + ", ".join(f"{r['shape']} x{r['uses_per_tree']}"
                                         for r in pick["nest_recompose"])}
    out = []
    for name, (source, replaces) in KV_KERNELS.items():
        sel = pick[name]
        uses = [r.get("uses_per_tree", 1) for r in sel]
        tot = lambda key: sum(r[key] * u for r, u in zip(sel, uses))  # noqa: E731
        t_bytes = tot("bytes") / HBM_BYTES_PER_S * 1e3
        peak = PEAK_FLOPS[torch.bfloat16] if name == "flash_attention" else PEAK_INT8_OPS
        t_ops = tot("ops") / peak * 1e3
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in sel),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sel[0]["library_ms"] if name == "flash_attention" else None,
            "per": per[name]})
        if name == "nested_qk":          # the CUDA-core control and the launch floor
            out[-1].update(cuda_core_ms=tot("cuda_core_ms"), launch_floor_ms=floor_ms)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", type=Path, default=ROOT / "build" / "chip_smoke.json",
                    help="where the JSON report of every phase is written")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {card}")
    cfg = get_config("qwen2-1.5b")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t_start = time.time()
    rows = phase_kernels(cfg, gen)
    kv_rows = phase_kv_kernels(cfg, gen)
    engine, store, phases, launches = phase_serve(cfg)
    profile_info = phase_profile(engine, store, cfg, packed_linears_per_forward(store))
    reference = phase_reference(cfg, store, phases)
    del engine
    artifact = phase_artifact(cfg, store, phases, packed_linears_per_forward(store))
    spec = phase_spec_faults(cfg, store, packed_linears_per_forward(store), gen)
    peak_before_fleet = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fleet = phase_fleet(cfg, store, packed_linears_per_forward(store))
    launches = {n: tuple(launches[n][i] + artifact["launches"][n][i] + spec["launches"][n][i]
                         + fleet["launches"][n][i] for i in range(2))
                for n in KERNELS}
    peak_before_long = max(peak_before_fleet, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    long_engine_, dense, long_info = phase_long_serve(cfg, store,
                                                      packed_linears_per_forward(store))
    long_info["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[long] peak device memory over the five long generates "
        f"{long_info['peak_mem_bytes'] / 1e9:.2f} GB")
    served_kv = phase_served_kv_attention(long_engine_, dense, cfg, gen)
    del dense
    long_profile = phase_long_profile(long_engine_, cfg)
    del long_engine_
    long_f32 = phase_long_f32(cfg, store)
    served_recompose = phase_served_recompose(store)
    kv_launches = {"flash_attention": long_info["launches"]["flash_attention"],
                   "nested_qk": served_kv["launches"],
                   "nest_recompose": served_recompose["launches"]}
    kernels = (kernel_summary(rows, launches, long_info["tc_launches"])
               + kv_kernel_summary(kv_rows, kv_launches))
    steps = {f"M={M} {dt}": decode_steps(rows, M, dt) for M in MS if M <= 8
             for dt in ("bfloat16", "float32")}
    for key, by in steps.items():
        log(f"[decode-step] {key}: " + "; ".join(
            f"{n} {v['ms']:.3f} ms (cuda-core {v['cuda_core_ms']:.3f}, dense bf16 "
            f"{v['dense_bf16_matmul_ms']:.3f}, bound {v['bound_ms']:.3f})" for n, v in by.items()))
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "rows": rows, "kv_rows": kv_rows, "serve": phases, "profile": profile_info,
              "reference": reference, "artifact": artifact, "spec_faults": spec,
              "fleet": fleet,
              "long_serve": long_info, "served_kv": served_kv,
              "long_profile": long_profile, "long_f32": long_f32,
              "served_recompose": served_recompose,
              "kernels": kernels, "decode_steps": steps,
              "peak_mem_bytes": max(peak_before_long, torch.cuda.max_memory_allocated()),
              "wall_s": time.time() - t_start}
    args.report.parent.mkdir(parents=True, exist_ok=True)
    args.report.write_text(json.dumps(report, indent=1))
    log(f"[done] {time.time() - t_start:.1f}s; peak device memory "
        f"{report['peak_mem_bytes'] / 1e9:.2f} GB")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
