#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of NestQuant (``src/repro_torch``) on one
NVIDIA H100 and check it.

    python3 chip_smoke.py [--report PATH]

Phases (each raises on failure; the script then exits non-zero):

1. Build the hand-written CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc for sm_90a (the ptxas report is printed once), then hold each of
   K1 packed_matmul / K2 nested_matmul / K3 ladder_matmul against its
   plain PyTorch version at every main-path shape of qwen2-1.5b (q/o,
   k/v, gate/up, down, lm_head) at M in {1, 4, 8, 32}, bf16 and f32, and
   time it (CUDA events, cold L2), its plain version and a dense bf16
   ``torch.matmul`` of the same shape (a yardstick only; the port never
   calls it).
2. Serve full-width qwen2-1.5b (random weights from a seeded generator,
   nested on the (8, 6, 4) ladder) through ``ServeEngine.generate``: four
   calls of 4 requests x 8 prompt tokens x 8 new tokens under budgets
   that land on rungs 2, 0, 1, 2.  The launch counters must show every
   ``packed_linear`` (28 * 7 + 1 per forward) on the kernel of its rung
   and no plain version.
3. Run the same requests through the plain versions (the scoped
   ``reference_pass``) with ``compute_dtype="float32"`` as the reference:
   the f32 kernel path within 1e-4 of it (logits relative to max |logit|)
   with greedy tokens identical; the bf16 kernel path's prefill logits
   within 3e-2 of it and of the plain bf16 pass.  What a kernel that
   drops one delta stream would read is printed beside them.

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
# bf16 end to end (prefill logits, relative to max |logit|): sound kernels
# read 1.68-2.27e-2 against the f32 plain pass and 1.94-2.11e-2 against the
# bf16 plain pass on this seeded model, the same in every run (see PERF.md)
BF16_E2E_TOL = 3e-2
BITS = (8, 6, 4)
MS = (1, 4, 8, 32)
L2_BYTES = 50e6
KERNELS = {  # name -> (rung it serves, source, TPU kernel it replaces)
    "packed_matmul": (0, "src/repro_torch/csrc/nest_matmul.cu",
                      "src/repro/kernels/packed_matmul/kernel.py:48"),
    "nested_matmul": (1, "src/repro_torch/csrc/nest_matmul.cu",
                      "src/repro/kernels/nested_matmul/kernel.py:61"),
    "ladder_matmul": (2, "src/repro_torch/csrc/nest_matmul.cu",
                      "src/repro/kernels/nested_matmul/kernel.py:125"),
}
SERVE_SCHEDULE = (2, 0, 1, 2)
DEVICE = "cuda"
BATCH, PROMPT, NEW_TOKENS, MAX_LEN = 4, 8, 8, 64


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
    replayed, so host launch overhead (Python, ctypes) is not measured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def kernel_call(name, nt, x, copies, out_dtype):
    """A closure launching kernel ``name`` on copy ``i % len(copies)`` of
    the leaf's streams (copies exceed L2, as a decode step finds it)."""
    from repro_torch.kernels.nested_matmul import ops as nops
    from repro_torch.kernels.packed_matmul import ops as pops

    rung = KERNELS[name][0]
    scale = nt.rung_scale(rung).reshape(1, -1).contiguous()
    bits = nt.bits[:rung + 1]

    def call(i):
        s = copies[i % len(copies)]
        if name == "packed_matmul":
            return pops.packed_matmul(x, s[0], scale, k=bits[0], K=nt.K,
                                      block_k=nt.block, out_dtype=out_dtype)
        if name == "nested_matmul":
            return nops.nested_matmul(x, s[0], s[1], scale, n=bits[1], h=bits[0],
                                      K=nt.K, block_k=nt.block, out_dtype=out_dtype)
        return nops.ladder_matmul(x, s[:rung + 1], scale, bits=bits, K=nt.K,
                                  block_k=nt.block, out_dtype=out_dtype)
    return call


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
                for name, (rung, _, _) in KERNELS.items():
                    call = kernel_call(name, nt, x, copies, out_dtype)
                    got = call(0)
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
                        "max_abs_err": err, "max_abs_ref": peak, "ms": ms,
                        "eager_call_ms": host_ms,
                        "plain_ms": plain_ms, "dense_bf16_matmul_ms": dense_ms,
                        "bytes": nbytes, "flops": flops,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
                    log(f"[kernel] {name:13s} {shape:8s} M={M:2d} {rows[-1]['dtype']:8s} "
                        f"err={err:.2e} ms={ms:.4f} eager={host_ms:.4f} plain={plain_ms:.3f} "
                        f"dense_bf16={dense_ms:.4f} bound={rows[-1]['bound_ms']:.4f}")
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
    # every nested matmul weight is one packed_linear per layer per forward
    # (28 * 7 + 1 = 197 at full width); the nested embedding is a gather
    per_forward = sum(leaf.shape[0] if len(leaf.shape) == 3 else 1
                      for path, leaf in store.nested_leaves() if "embed" not in path)
    forwards = 1 + NEW_TOKENS
    log(f"[serve] {per_forward} packed_linear calls per forward, {forwards} "
        f"forwards per generate")
    dispatch.reset_counters()                      # the main path starts here
    phases = []
    for phase, rung in enumerate(SERVE_SCHEDULE):
        before = {n: (c.launches, c.plain_launches) for n, c in dispatch.COUNTERS.items()}
        reqs = make_requests(phase, cfg.vocab_size)
        torch.cuda.synchronize()
        t0 = time.time()
        engine.generate(reqs, memory_budget_bytes=budget_for(store, rung))
        torch.cuda.synchronize()
        wall = time.time() - t0
        delta = {n: (c.launches - before[n][0], c.plain_launches - before[n][1])
                 for n, c in dispatch.COUNTERS.items()}
        want = {n: (per_forward * forwards if KERNELS[n][0] == min(rung, 2) else 0, 0)
                for n in KERNELS}
        if store.rung != rung or delta != want:
            raise AssertionError(f"phase {phase}: rung {store.rung} (want {rung}), "
                                 f"launches {delta}, want {want}")
        for r in reqs:
            if len(r.out_tokens) != NEW_TOKENS or not all(
                    0 <= t < cfg.vocab_size for t in r.out_tokens):
                raise AssertionError(f"phase {phase}: bad tokens {r.out_tokens}")
        phases.append({"rung": rung, "mode": store.mode, "wall_s": wall,
                       "page_in": store.ledger.page_in_bytes,
                       "page_out": store.ledger.page_out_bytes,
                       "tokens": [r.out_tokens for r in reqs], "launches": delta})
        log(f"[serve] phase {phase}: mode={store.mode} rung={store.rung} "
            f"{BATCH}x{NEW_TOKENS} tokens in {wall:.3f}s; ledger in="
            f"{store.ledger.page_in_bytes} out={store.ledger.page_out_bytes} "
            f"switches={store.ledger.switches}; launches {delta}")
    launches = {n: dispatch.COUNTERS[n].launches for n in KERNELS}
    if any(dispatch.COUNTERS[n].plain_launches for n in KERNELS):
        raise AssertionError("a plain version ran on the main path")
    return engine, store, phases, launches


def phase_profile(engine, store, cfg):
    """Where one generate call's time goes at the current rung: wall time
    (host clock, unprofiled), device busy time (torch.profiler's CUDA
    kernel self times, profiled run) and the largest kernels."""
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
    out = {"rung": store.rung, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms if busy_ms > 0 else None,
           "device_idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else None,
           "top_kernels": [{"name": k[:90], "calls": c, "device_ms": t / 1e3}
                           for t, c, k in dev[:8]]}
    log(f"[profile] rung {store.rung} generate ({BATCH}x{NEW_TOKENS} tokens): wall "
        f"{wall_ms:.1f} ms, device busy "
        f"{'not measured' if busy_ms == 0 else f'{busy_ms:.1f} ms'}")
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


def kernel_summary(rows, launches, M=4, dtype="bfloat16"):
    """One entry per kernel: one decode step at batch M in ``dtype``
    (every main-path shape times its uses per forward)."""
    out = []
    for name, (_, source, replaces) in KERNELS.items():
        sel = [r for r in rows if r["kernel"] == name and r["M"] == M and r["dtype"] == dtype]
        tot = lambda key: sum(r[key] * r["uses_per_forward"] for r in sel)
        t_bytes = sum(r["bytes"] * r["uses_per_forward"] for r in sel) / HBM_BYTES_PER_S * 1e3
        t_ops = sum(r["flops"] * r["uses_per_forward"] for r in sel) / 989e12 * 1e3
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in sel),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "yardstick_dense_bf16_matmul_ms": tot("dense_bf16_matmul_ms"),
            "per": f"one decode step: {sum(r['uses_per_forward'] for r in sel)} "
                   f"launches at M={M} {dtype}"})
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
    engine, store, phases, launches = phase_serve(cfg)
    profile_info = phase_profile(engine, store, cfg)
    reference = phase_reference(cfg, store, phases)
    kernels = kernel_summary(rows, launches)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "rows": rows, "serve": phases, "profile": profile_info,
              "reference": reference,
              "kernels": kernels, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
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
