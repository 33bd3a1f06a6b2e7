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
   body (``route="cuda_core"``, the "before").  The bf16 rows at M = 32
   (the short prefill), and bf16 rows at M = 16, 48 and 63 for every shape
   but the LM head, must launch on the short-prefill body
   (``csrc/nest_matmul_mid.cu``; its counter says so) and are timed beside
   the same call on the CUDA-core body (the "before"), the decode route in
   8-row groups and the tensor-core body: the measurement behind
   ``dispatch.matmul_route``'s short-prefill range.  The f32 rows at M =
   32 must launch on the f32 body (``csrc/nest_matmul_f32.cu``; its
   counter says so), timed beside the CUDA-core body (the "before").  Then
   the f32 rows at M = 64 and 4096 for q/o, k/v, gate/up and down on the
   f32 body, held to 1e-4 of max(1, max |y|), timed beside the CUDA-core
   body (one call at 4096), the plain version and a dense f32
   ``torch.matmul`` (TF32 off; a yardstick only), bound at the f32 rate;
   ``[f32-layer]`` sums a layer's seven matmuls per M and rung.  No phase
   but this one launches the CUDA-core body (``timed_phase`` holds
   ``dispatch.BODY_LAUNCHES``).  Then the prefill rows: bf16 at M = 64, 2200 (2 x 1100,
   ragged against the 256-row tile) and 4096 (2 x 2048) for q/o, k/v,
   gate/up and down, each launched on the tensor-core body the route
   picks (its counter must say so), held to 2e-2 of max(1, max |y|)
   against the plain version and timed beside the same call on the
   CUDA-core body (``route="cuda_core"``, the "before"; at M = 64 also
   the decode route and the short-prefill body) and the dense bf16
   yardstick.
2. Serve full-width qwen2-1.5b (random weights from a seeded generator,
   nested on the (8, 6, 4) ladder) through ``ServeEngine.generate``: four
   calls of 4 requests x 8 prompt tokens x 8 new tokens under budgets
   that land on rungs 2, 0, 1, 2.  The launch counters must show every
   ``packed_linear`` (28 * 7 + 1 per forward) on the kernel of its rung
   and no plain version: the 32-row prefill's 196 on the short-prefill body,
   its LM head (M = 4) and every decode step on the decode body.
3. Run the same requests through the plain versions (the scoped
   ``reference_pass``) with ``compute_dtype="float32"`` as the reference:
   the f32 kernel path within 1e-4 of it (logits relative to max |logit|)
   with greedy tokens identical, its 32-row prefill's matmuls but the LM
   head on the f32 body; the bf16 kernel path's prefill logits
   within 3e-2 of it and of the plain bf16 pass.  What a kernel that
   drops one delta stream would read is printed beside them, and must
   read above that limit.
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
   picks (the short-prefill body at 16, tensor cores at 64).
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
   none``, and ``--arch dbrx-132b``, ``mamba2-780m`` and ``zamba2-2.7b``
   over a budget schedule) and the fleet CLI (``--replicas 4 --json``)
   in-process at
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
   library yardstick (the port never calls it).  K5 on one rank's block of
   query rows (phase 10's sequence-parallel attention over model = 8: 256
   of 2048 rows at offsets 0, 256, ..., 1792 in bf16, 0 and 1792 in f32)
   against its plain version at an offset, timed beside SDPA with the
   explicit offset causal mask.
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
   identical greedy tokens (its 196 matmuls above M 8 on the f32 body, in
   the prefill alone and in the generate's; K5 on its f32 body once a
   layer), and K6 on every weight slice of the served
   tree equal to ``chain_recompose`` at rung 1.
6. The MoE family at full width: dbrx-132b at its published widths (d
   6144, 48/8 heads of 128, d_ff 10752, 16 experts top-4, vocab 100352)
   with 2 of its 40 layers, random weights from a seeded generator, nested
   on (8, 6, 4) (the quantize seconds and rung bytes printed).  Every
   expert matmul reads the packed words through K1-K3, one launch group
   per (expert, projection) on the expert's 2-D view; ``models/moe.py``
   records each forward's (layer, expert, rows) groups, and the counters
   of every run must equal what that routing implies, on the rung's kernel
   and the body each group's M (or the decode route) picks, none plain.
   Runs: the phase-2 schedule (4 requests x 8 prompt x 8 new tokens at
   rungs 2, 0, 1, 2); 2 requests x 1100 prompt tokens x 4 new tokens at
   rung 2 (K5 once per layer, expert groups of ~550 rows on the tensor
   cores); plain greedy and ``SpecConfig(k=2, draft=0)`` at rung 2 with
   equal tokens, every verify row on the decode body.  Then, uncounted:
   phase 3's reference pass at rungs 2, 0, 1, its plain passes for the
   bf16 checks and the one-stream-short control replaying the bf16 kernel
   pass's expert choices (a router near-tie could otherwise move a token,
   where no tolerance applies; the expert sets an unforced plain bf16 pass
   changes printed) under the limit ``MOE_BF16_TOL``; a decode step per
   rung at batch 4 (wall, device busy, experts touched, K1-K3 split into
   attention, experts and head, bytes and bound); the long prefill against
   a plain bf16 pass replaying its expert choices, then its K1-K3 and K5
   time; K5 alone at its 2 x 1100, 48/8-head shape against its plain
   version, as in phase 1.
7. The ssm and hybrid families at full width with every layer: mamba2-780m
   (48 Mamba2 layers, d 1536, 48 SSM heads of 64, state 128, vocab 50280)
   and zamba2-2.7b (54 Mamba2 layers, d 2560, and one shared attention/MLP
   block, 32/32 heads of 80 and d_ff 10240, applied 9 times), random
   weights from a seeded generator, nested on (8, 6, 4) (the quantize
   seconds and rung bytes printed).  Only ``in_proj``, ``out_proj``, the
   shared block's six matmuls and the LM head are matmuls: 97 and 163 K1-K3
   launches per forward, counted on the rung's kernel and the body each M
   picks, none plain; the scan, conv and gates are plain tensor code.
   Each model: ``warmup``, then phase 2's schedule (after which no
   library, plan, counter buffer or decode-body instantiation is new); a
   long prompt at rung 2 (mamba2 2 x 2048 + 8: the tensor-core body at M =
   4096 on N = 6448 and the scan over 8 chunks; zamba2 2 x 1100 + 4 on the
   nested KV cache, twice, the second at queue depth 8: K5 at head dim 80
   once per application, KV bytes per sequence over 9 attention layers,
   the KV ledger equal to its metadata bytes, the top-rung render within
   0.02 of the dense prefill K/V).  Then, uncounted: phase 3's reference
   pass at rungs 2, 0, 1 (f32 within 1e-4 with identical tokens, bf16
   under the model's ``SSM_BF16_TOL``, which a one-stream-short control
   exceeds); the long prefill against its plain bf16 pass at full depth
   and at its first ``SSM_SHALLOW`` layers, each under its limit in
   ``SSM_LONG_TOL`` which its one-stream-short control exceeds, then
   profiled; K1-K3 on the model's own weights at every (M, body) the main
   path launches (decode at M = 4 and 2, the short prefill's M = 32 on the
   short-prefill body, the long prompt's M on the tensor cores; in_proj's N 6448
   and 10448 and the vocab 50280 are no multiple of 128) against their
   plain versions, timed; a decode step per rung at batch 4 (wall, device
   busy, K1-K3 against their byte bound, the SSM state update against
   its); K5 alone at zamba2's 2 x 1100, 32/32 heads of 80, beside SDPA.

8. Training on the card, then NestQuant of the trained weights (phase 8,
   ``phase_train``; full-width qwen2-1.5b, remat on, batch 2 x 2048 of the
   seeded ``SyntheticLM`` stream).  (a) One ``loss_fn`` and its gradients
   at the first 2 layers with K5 (forward and remat recompute, writing its
   row statistics; the blockwise backward) against the same computation
   under ``reference_pass``: f32 loss within 1e-5, every leaf within 1e-4
   of its max |g|; bf16 under ``BF16_GRAD_TOL``, which the control (K5
   launched outside ``BlockwiseAttention``: q/k/v get no gradient)
   exceeds; every leaf's gradient nonzero.  (b) All 28 layers, bf16
   parameters, f32 AdamW state: ``TRAIN_STEPS`` steps of the train CLI's
   step, each profiled (wall, device busy, K5, the attention backward, the
   optimizer, tokens/s, MFU, peak memory), 56 K5 launches a step, none
   plain, the loss falling.  (c) NestQuant of the trained weights
   (``api.quantize``, adaptive (8, 6, 4), a ``NestQuantStore``) and
   ``loss_fn`` on two held-out batches at rungs 2, 1, 0 through K1-K3 (197
   launches of the rung's kernel and 28 of K5 a forward, none plain),
   each within ``SCORE_TOL`` of the same tree's plain pass, which the tree
   one stream short exceeds; the dense loss beside them.  (d) The train
   CLI as subprocesses (2 layers, 1 x 2048, 6 steps, a checkpoint every
   4), started after phase 9 and running beside phase 10: straight
   through (checkpointing step 6 alone) and killed before step 5 (exit
   42) side by side, then resumed from step 4;
   after phase 10 the step-6 checkpoints equal bit for bit, restored with
   ``CheckpointManager`` (timed) and compared on the card, one saved again
   (timed), every directory under ``build/`` removed.  Phase 4 also holds
   K5 with its row statistics against the plain forward at S 1100 and 2048
   (o as K5's limits, m and l within 1e-5) and times it beside K5 without.

9. The sharded steps of ``distributed/`` (phase 9, ``phase_sharded``): a
   (data 2, model 2) mesh of four rank processes of this script (``--rank``)
   joined by gloo, all on the one card (so their times measure no
   scaling), each on its own blocks, against the world-1 steps (a (1, 1)
   mesh, no process group) on the same card.  (a) The train step of
   qwen2-1.5b at full width with 2 of its 28 layers, 4 x 2048 in
   microbatches of 2: the loss, and each rank's blocks of the f32 state
   after the step against the world-1 state's under ``SHARDED_STATE_TOL``,
   which the control without the data-axis gradient average exceeds: m
   and v per leaf (largest |diff| over the leaf's largest |value|), master
   in units of the learning rate where m is large (``rank_train``); 8
   K5 launches per rank, none plain; the step wall, the all-reduce bytes
   beside ``predicted_train_comm`` and the peak memory per rank.  (b)
   qwen2-1.5b with 4 of its 28 layers nested (4, 8) rtn as
   ``steps.quantize_abstract`` lays it out, each rank nesting its own
   blocks: a prefill of 4 x 64 tokens and 8 decode steps, f32 at rung 0
   (logits within 1e-4, greedy tokens identical) and bf16 at rung 1
   (within 3e-2), fed the world-1 run's tokens; each rank's K1/K2 launches (29 a
   forward, the bodies by M) counted, none plain.  (c) dbrx-132b at its
   published widths with 2 layers, nested, f32: a prefill of 4 x 8 tokens
   and 4 decode steps; each data rank routes its own tokens, each model
   rank computes its 8 of the 16 experts; every ``moe_ffn`` call equals
   the one-card ``moe_ffn`` on the same tokens, each rank's expert groups
   what its tokens' routing implies, and its K2 launches those groups'.

10. Sequence-parallel attention, the sequence-split KV cache and the ssm
   and hybrid families' sharded steps (phase 10, ``phase_seq_ssm_sharded``),
   with phase 9's rank machinery (each world's ``plan.json``, the world-1
   controls on a (1, 1) mesh in the main process).  Eight rank processes
   on a (data 1, model 8) mesh: (a) the train step of qwen2-1.5b at full
   width with 4 of its 28 layers, 2 x 2048 in one microbatch: its 12
   heads do not divide 8, so each model rank attends its 256 query rows
   through K5 at offset 256 r (forward and remat recompute: 8 launches per
   rank, none plain) against the whole k/v, the plain blockwise backward
   beside it; the loss under ``SEQ_SSM_LOSS_TOL``, which the loss control
   (each rank's rows attended at offset 0) exceeds, and the state under
   phase 9's limit, which the control without the model-axis sum of the
   k/v gradient parts exceeds; (b) qwen2-1.5b with 4 of its 28 layers nested
   (4, 8): a prefill of 2 x 2048 (K5 at the offsets, 4 per run), then 4
   decode steps against a cache of 2056 positions split over model (257
   per rank): only the rank holding a position writes it, and the blocks'
   softmax pieces are combined across ranks; f32 at rung 0 (within 1e-4,
   tokens identical), bf16 at rung 1 (3e-2), the control without
   the combine above its limit; 145 K1/K2 launches per rank and run,
   none plain.  Then four rank processes on (2, 2): (c) mamba2-780m's
   train step at full width with 4 of its 48 layers, 2 x 2048, and its
   nested serve at 8 of its 48 layers (4 x 64 prompt tokens, 8 steps,
   rungs 0 and 1, f32); (d) zamba2-2.7b's nested serve at 12 of its 54
   layers (the shared block applied twice) the same way: each model rank
   runs its block of the SSM heads and conv channels; K1/K2 launches per
   rank as the path implies (17 and 37 a forward), none plain.  The
   control of (c) and (d), the gated norm's sum of squares not summed
   over model, reads above the loss, state and serve limits.

11. The dry run (phase 11, ``phase_dryrun``, in the main process):
   ``launch/step_analysis.py`` runs a step once as one rank (rank 0 unless
   said) of a fake world over fake CUDA tensors (nothing launched; each
   kernel wrapper counts the launches the card would make) and counts its
   FLOPs, bytes, collectives, launches and peak memory.  The dry runs need
   the plans alone and are traced while nvcc builds the kernels
   (``dry_runs``); the checks follow phase 10.  (a) Every train step and every
   (dtype, rung) serve (the prefill with the decode cache's fill, and one
   decode step times the run's steps) that phases 9 and 10 ran, at their
   configs, shapes and meshes: the calls and payload bytes of each
   collective and the launches of each kernel on each body equal rank 0's
   measured counts exactly, and phase 9 (a)'s all-reduce also
   ``predicted_train_comm`` (phase 9 (c)'s MoE serve routes by the data,
   which a dry run does not hold, and is left out).  Phase 10's (1, 8)
   world, (a) and (b), is also dry-run as its last model rank
   (``dry_runs_last``), whose query block sits at the largest offset and
   which holds the decode steps' positions:
   its counts equal rank 7's measured ones, and its K5 FLOPs equal
   ``flash_cost`` at offset 7 x 256 for each launch.  (b) The world-1
   train step of qwen2-1.5b at all 28 layers, 2 x 2048 in one
   microbatch: dry-run, then run once on the card; the predicted peak
   within ``DRY_PEAK_TOL`` of ``max_memory_allocated`` (above what was
   allocated before the step's arguments), which the prediction without
   the AdamW moment m exceeds; 56 dry K5 launches, as launched; the
   ``useful_flops_ratio`` within the reference's (0.25, 1.5); the
   roofline terms beside the step's wall and device busy time.  (c) Phase
   9 (a)'s train step dry-run on fake CPU tensors gives exactly the counts
   of the fake CUDA run.

The per-shape table and every other measurement go to ``--report``
(default ``build/chip_smoke.json``).  The line before the last prints the
kernels (launches, error, times, bound); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, the script fails before any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published rates (NVIDIA data sheet, dense, at the 700 W limit) and
# each kernel's (bytes, operations), one copy in the package
from repro_torch.kernels.costs import (HBM_BYTES_PER_S, PEAK_FLOPS,  # noqa: E402
                                       PEAK_INT8_OPS, flash_cost, matmul_cost,
                                       qk_cost, recompose_cost)

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
# more short-prefill rows (bf16, every shape but the LM head): the route's
# measurement of the short-prefill body beside the other three at M 9-63
MID_MS = (16, 48, 63)
# prefill rows (bf16): the route's threshold, the ragged 2 x 1100 prefill
# and the long-context path's 2 x 2048
PREFILL_MS = (64, 2 * 1100, 2 * 2048)
# more f32 rows (every shape but the LM head): the f32 body at the short
# prefill's next tile and at the long-context path's 2 x 2048
F32_MS = (64, 2 * 2048)
F32_SOURCE = "src/repro_torch/csrc/nest_matmul_f32.cu"
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


# seconds of each phase of this run (main) and of the kernels' build
PHASE_S = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_phase(tag, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds kept in ``PHASE_S[tag]`` and
    printed.  No K1-K3 launch of the phase may reach the CUDA-core body
    (``dispatch.BODY_LAUNCHES``, which no reset clears): only phase 1's
    named "before" rows take it."""
    from repro_torch.kernels import dispatch

    cc = dispatch.BODY_LAUNCHES[dispatch.CUDA_CORE]
    t0 = time.time()
    out = fn(*args, **kw)
    PHASE_S[tag] = time.time() - t0
    log(f"[time] phase {tag} took {PHASE_S[tag]:.1f}s")
    if tag != "1" and dispatch.BODY_LAUNCHES[dispatch.CUDA_CORE] != cc:
        raise AssertionError(f"phase {tag}: {dispatch.BODY_LAUNCHES[dispatch.CUDA_CORE] - cc} "
                             f"K1-K3 launches on the CUDA-core body")
    return out


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


def _row(kernel, shape, M, dtype, err, ms, plain_ms, nbytes, ops, peak, lib_ms, **extra):
    """One row of a kernel table; its bound is the larger of ``nbytes`` at
    the HBM rate and ``ops`` at ``peak``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return {"kernel": kernel, "shape": shape, "M": M, "dtype": dtype, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bytes": nbytes,
            "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", **extra}


def checked_launch(name, nt, x, copies, out_dtype, what, route=None):
    """Launch K1-K3 kernel ``name`` once on the body ``matmul_route`` picks
    for ``x`` (it must be ``route`` where one is named), which its counters
    must show: one launch, on that body and no other.  Held against its
    plain version within ``TOL`` of max(1, max |y|).  Returns (the call,
    its route, max |kernel - plain|, max |plain|)."""
    from repro_torch.kernels import dispatch

    body = dispatch.matmul_route(x.shape[0], x.dtype, x.device)
    if route is not None and body != route:
        raise AssertionError(f"{what}: M={x.shape[0]} {x.dtype} takes the {body} body, "
                             f"not the {route} one")
    counter = dispatch.counter(name)
    seen = lambda: (counter.launches, counter.dec_launches, counter.tc_launches,  # noqa: E731
                    counter.mid_launches, counter.f32_launches)
    call = kernel_call(name, nt, x, copies, out_dtype)
    before = seen()
    got = call(0)
    if seen() != (before[0] + 1, before[1] + (body == dispatch.DECODE),
                  before[2] + (body == dispatch.TENSOR_CORE), before[3] + (body == dispatch.MID),
                  before[4] + (body == dispatch.F32)):
        raise AssertionError(f"{what}: not launched on the {body} body ({before} -> {counter})")
    with dispatch.reference_pass():
        ref = call(0)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    peak = ref.float().abs().max().item()
    tol = TOL[x.dtype]
    if not (math.isfinite(err) and err <= tol * max(1.0, peak)):
        raise AssertionError(f"{what} {body} body: max |kernel - plain| = {err} > {tol} * "
                             f"max(1, {peak})")
    return call, body, err, peak


def other_bodies_ms(name, nt, x, copies, out_dtype, route):
    """The same call on each K1-K3 body but ``route`` that takes its M and
    dtype (CUDA-graph replay): the CUDA-core body (the "before" of every
    row), and for bf16 at M 9-64 the decode route in 8-row groups, the
    tensor-core body and the short-prefill body (10 calls x 3 replays:
    their gaps are several-fold).  Keyed ``<body>_ms``."""
    from repro_torch.kernels import dispatch

    M = x.shape[0]
    bodies = [dispatch.CUDA_CORE]
    if x.dtype == torch.bfloat16 and dispatch.DEC_MAX_M < M <= dispatch.MID_MAX_M:
        bodies += [dispatch.DECODE, dispatch.TENSOR_CORE, dispatch.MID]
    iters, reps = ((20, 5) if M <= dispatch.DEC_MAX_M else
                   (10, 3) if M <= dispatch.MID_MAX_M else (2, 2))
    return {f"{b}_ms": time_graph_ms(kernel_call(name, nt, x, copies, out_dtype, route=b),
                                     iters, reps=reps)
            for b in bodies if b != route}


def prefill_rows(shape, K, N, uses, nt, streams, copies, dense, gen):
    """bf16 rows at ``PREFILL_MS``: each kernel on the tensor-core body
    (:func:`checked_launch`), timed by CUDA-graph replay beside the same
    call on the CUDA-core body (the "before"; at M = 64 also the decode
    route and the short-prefill body) and the dense bf16 yardstick; bound
    by operations at these M."""
    from repro_torch.kernels import dispatch

    rows = []
    for M in PREFILL_MS:
        x = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        for name, (rung, _, _) in KERNELS.items():
            call, route, err, peak = checked_launch(name, nt, x, copies, torch.bfloat16,
                                                    f"{name} {shape} M={M}",
                                                    dispatch.TENSOR_CORE)
            ms = time_graph_ms(call, 5, reps=3)
            others = other_bodies_ms(name, nt, x, copies, torch.bfloat16, route)
            cc_ms = others["cuda_core_ms"]
            with dispatch.reference_pass():
                plain_ms = time_ms(call, 1)
            dense_ms = time_graph_ms(lambda i: torch.matmul(x, dense[i % len(dense)]), 5, reps=3)
            rows.append(_row(name, shape, M, "bfloat16", err, ms, plain_ms,
                             *matmul_cost(x, streams[:rung + 1], N, torch.bfloat16),
                             PEAK_FLOPS[torch.bfloat16], None, K=K, N=N, route=route,
                             uses_per_forward=uses, max_abs_ref=peak,
                             dense_bf16_matmul_ms=dense_ms, **others))
            log(f"[prefill] {name:13s} {shape:8s} M={M:4d} bf16 err={err:.2e} tensor-core "
                f"ms={ms:.4f} cuda-core ms={cc_ms:.4f} ({cc_ms / ms:.1f}x)"
                + "".join(f" {k[:-3]}={v:.4f}" for k, v in others.items() if k != "cuda_core_ms")
                + f" plain={plain_ms:.3f} dense_bf16={dense_ms:.4f} "
                f"bound={rows[-1]['bound_ms']:.4f}")
    return rows


def mid_rows(shape, K, N, uses, nt, streams, copies, gen):
    """bf16 rows at ``MID_MS`` (the M = 32 row is phase 1's own): each
    kernel on the short-prefill body the route picks (:func:`checked_launch`,
    which holds it against its plain version), timed by CUDA-graph replay
    beside the same call on the CUDA-core body, the decode route in 8-row
    groups and the tensor-core body (the plain version is timed at M = 32
    only); bound by the words' bytes."""
    from repro_torch.kernels import dispatch

    rows = []
    for M in MID_MS:
        x = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        for name, (rung, _, _) in KERNELS.items():
            call, route, err, peak = checked_launch(name, nt, x, copies, torch.bfloat16,
                                                    f"{name} {shape} M={M}", dispatch.MID)
            ms = time_graph_ms(call, 20)
            others = other_bodies_ms(name, nt, x, copies, torch.bfloat16, route)
            rows.append(_row(name, shape, M, "bfloat16", err, ms, None,
                             *matmul_cost(x, streams[:rung + 1], N, torch.bfloat16),
                             PEAK_FLOPS[torch.bfloat16], None, K=K, N=N, route=route,
                             uses_per_forward=uses, max_abs_ref=peak, **others))
            log(f"[mid] {name:13s} {shape:8s} M={M:2d} bf16 err={err:.2e} mid ms={ms:.4f} "
                + " ".join(f"{k[:-3]}={v:.4f}" for k, v in others.items())
                + f" bound={rows[-1]['bound_ms']:.4f}")
    return rows


def mid_layers(rows):
    """Per rung and M in 16, 32, 48, 63 (and 64), one qwen2-1.5b layer's
    seven matmuls (q, k, v, o, gate, up, down: every shape but the LM head
    once per its uses in a layer) on each K1-K3 body, bf16, from phase 1's
    rows: the route's measurement for the short prefill."""
    out = {}
    per_layer = {"q/o": 2, "k/v": 2, "gate/up": 2, "down": 1}
    for M in sorted({r["M"] for r in rows if r.get("mid_ms") or r.get("route") == "mid"}):
        for rung, name in enumerate(KERNELS):
            sel = [r for r in rows if r["kernel"] == name and r["M"] == M
                   and r["dtype"] == "bfloat16" and r["shape"] in per_layer]
            if len(sel) != len(per_layer):
                continue
            by = {}
            for r in sel:
                times = {r["route"]: r["ms"], **{k[:-3]: v for k, v in r.items()
                                                  if k.endswith("_ms") and k[:-3] in (
                                                      "cuda_core", "decode", "tensor_core",
                                                      "mid") and v is not None}}
                for body, ms in times.items():
                    by[body] = by.get(body, 0.0) + ms * per_layer[r["shape"]]
            out[f"M={M} rung {rung}"] = by
            log(f"[mid-layer] M={M:2d} rung {rung}: a layer's seven matmuls " + " ".join(
                f"{b}={v:.4f}" for b, v in sorted(by.items(), key=lambda kv: kv[1]))
                + f" ms; fastest {min(by, key=by.get)}")
    return out


def f32_rows(shape, K, N, uses, nt, streams, copies, gen):
    """f32 rows at ``F32_MS`` (the M = 32 row is phase 1's own): each kernel
    on the f32 body the route picks (:func:`checked_launch`, which holds it
    against its plain version within 1e-4 of max(1, max |y|)), timed by
    CUDA-graph replay beside the same call on the CUDA-core body (the
    "before"; one call at M 4096), the plain version and a dense f32
    ``torch.matmul`` of the same shape (TF32 off: a yardstick only, the
    port never calls it); bound by operations at the f32 rate."""
    from repro_torch.kernels import dispatch

    dense = [torch.randn(K, N, generator=gen, device=DEVICE)
             for _ in range(max(1, min(64, math.ceil(2 * L2_BYTES / (K * N * 4)))))]
    rows = []
    for M in F32_MS:
        x = torch.randn(M, K, generator=gen, device=DEVICE)
        small = M <= dispatch.TC_MIN_M
        for name, (rung, _, _) in KERNELS.items():
            call, route, err, peak = checked_launch(name, nt, x, copies, torch.float32,
                                                    f"{name} {shape} M={M} f32", dispatch.F32)
            ms = time_graph_ms(call, 20 if small else 3, reps=5 if small else 2)
            before = kernel_call(name, nt, x, copies, torch.float32, route=dispatch.CUDA_CORE)
            cc_ms = time_graph_ms(before, 10, reps=3) if small else time_ms(before, 1)
            with dispatch.reference_pass():
                plain_ms = time_ms(call, 1)
            dense_ms = time_graph_ms(lambda i: torch.matmul(x, dense[i % len(dense)]),
                                     20 if small else 3, reps=5 if small else 2)
            rows.append(_row(name, shape, M, "float32", err, ms, plain_ms,
                             *matmul_cost(x, streams[:rung + 1], N, torch.float32),
                             PEAK_FLOPS[torch.float32], None, K=K, N=N, route=route,
                             uses_per_forward=uses, max_abs_ref=peak, cuda_core_ms=cc_ms,
                             dense_f32_matmul_ms=dense_ms))
            log(f"[f32] {name:13s} {shape:8s} M={M:4d} f32 err={err:.2e} f32 ms={ms:.4f} "
                f"cuda-core ms={cc_ms:.4f} ({cc_ms / ms:.1f}x) plain={plain_ms:.3f} "
                f"dense_f32={dense_ms:.4f} bound={rows[-1]['bound_ms']:.4f}")
    del dense
    return rows


def f32_layers(rows):
    """Per M (32 and ``F32_MS``) and rung, one qwen2-1.5b layer's seven f32
    matmuls (q, k, v, o, gate, up, down) on the f32 body, on the CUDA-core
    body, as dense f32 ``torch.matmul`` (M 64 and 4096) and at the f32
    operations bound, from phase 1's rows."""
    out = {}
    per_layer = {"q/o": 2, "k/v": 2, "gate/up": 2, "down": 1}
    for M in sorted({r["M"] for r in rows if r.get("route") == "f32"}):
        for rung, name in enumerate(KERNELS):
            sel = [r for r in rows if r["kernel"] == name and r["M"] == M
                   and r["dtype"] == "float32" and r["shape"] in per_layer]
            if len(sel) != len(per_layer):
                continue
            by = {key: sum(r[key] * per_layer[r["shape"]] for r in sel)
                  for key in ("ms", "cuda_core_ms", "dense_f32_matmul_ms", "bound_ms")
                  if all(r.get(key) is not None for r in sel)}
            out[f"M={M} rung {rung}"] = by
            log(f"[f32-layer] M={M:4d} rung {rung}: a layer's seven f32 matmuls "
                + " ".join(f"{k[:-3] if k != 'ms' else 'f32'}={v:.4f}" for k, v in by.items())
                + f" ms ({by['cuda_core_ms'] / by['ms']:.1f}x faster than the CUDA-core body, "
                f"{by['ms'] / by['bound_ms']:.2f}x the bound)")
    return out


def phase_kernels(cfg, gen, during=None):
    """Phase 1's rows; the kernels build first, and ``during`` (no
    arguments) runs in this process while nvcc's processes do."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.nesting import nest_quantize
    from repro_torch.kernels import build, dispatch

    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:
        built = pool.submit(lambda: (build.build_all(), time.time() - t0)[1])
        if during is not None:
            during()
        build_s = built.result()
    log(f"[build] nvcc sm_90a in {build_s:.1f}s ({time.time() - t0:.1f}s with what ran "
        f"meanwhile)")
    PHASE_S["build"] = build_s
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
                    call, route, err, peak = checked_launch(
                        name, nt, x, copies, out_dtype, f"{name} {shape} M={M} {dtype}")
                    ms = time_graph_ms(call, 20)
                    host_ms = time_ms(call, 20)
                    others = other_bodies_ms(name, nt, x, copies, out_dtype, route)
                    with dispatch.reference_pass():
                        plain_ms = time_ms(call, 3)
                    dense_ms = time_graph_ms(lambda i: torch.matmul(xd, dense[i % len(dense)]), 20)
                    rows.append(_row(name, shape, M, str(dtype).replace("torch.", ""), err, ms,
                                     plain_ms, *matmul_cost(x, streams[:rung + 1], N, out_dtype),
                                     PEAK_FLOPS[dtype], None, K=K, N=N, uses_per_forward=uses,
                                     route=route, max_abs_ref=peak, eager_call_ms=host_ms,
                                     dense_bf16_matmul_ms=dense_ms,
                                     **{"cuda_core_ms": None, **others}))
                    log(f"[kernel] {name:13s} {shape:8s} M={M:2d} {rows[-1]['dtype']:8s} "
                        f"{route:11s} err={err:.2e} ms={ms:.4f} "
                        + "".join(f"{k[:-3]}={v:.4f} " for k, v in others.items())
                        + f"eager={host_ms:.4f} plain={plain_ms:.3f} dense_bf16={dense_ms:.4f} "
                        f"bound={rows[-1]['bound_ms']:.4f}")
        if not out_f32:           # a prefill's LM head sees only the last token
            rows += mid_rows(shape, K, N, uses, nt, streams, copies, gen)
            rows += prefill_rows(shape, K, N, uses, nt, streams, copies, dense, gen)
            rows += f32_rows(shape, K, N, uses, nt, streams, copies, gen)
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
    32-row prefill's on the short-prefill body, its LM head and every
    decode step's on the decode body), no plain version, and the tokens in
    range.  Returns (wall s, launches, decode-body launches) of the call."""
    from repro_torch.kernels import dispatch

    store, vocab = engine.store, engine.cfg.vocab_size
    forwards = 1 + NEW_TOKENS
    want_dec = per_forward * NEW_TOKENS + 1
    before = {n: (c.launches, c.plain_launches) for n, c in dispatch.COUNTERS.items()}
    before_dec = {n: c.dec_launches for n, c in dispatch.COUNTERS.items()}
    before_mid = {n: c.mid_launches for n, c in dispatch.COUNTERS.items()}
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
    mid = {n: c.mid_launches - before_mid[n] for n, c in dispatch.COUNTERS.items()}
    if mid != {n: per_forward - 1 if want[n][0] else 0 for n in mid}:
        raise AssertionError(f"{what}: short-prefill launches {mid}, want {per_forward - 1} "
                             f"(the {BATCH * PROMPT}-row prefill's) on the rung's kernel")
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
    launches = {n: (dispatch.COUNTERS[n].launches, dispatch.COUNTERS[n].dec_launches,
                    dispatch.COUNTERS[n].mid_launches) for n in KERNELS}
    if any(dispatch.COUNTERS[n].plain_launches for n in KERNELS):
        raise AssertionError("a plain version ran on the main path")
    if any(dispatch.COUNTERS[n].tc_launches for n in KERNELS):
        raise AssertionError(f"a {BATCH * PROMPT}-row prefill took the tensor-core body")
    return engine, store, phases, launches


K1_K3_BODIES = (("decode", ("stream_matmul_dec<",)), ("tensor_core", ("stream_matmul_tc<",)),
                ("mid", ("stream_matmul_mid<",)), ("f32", ("stream_matmul_f32<",)),
                ("cuda_core", ("stream_matmul<",)),
                ("reduce_partials", ("reduce_partials",)))


def device_rows(fn):
    """Profile ``fn()`` (device activity only, read from the raw events:
    a CPU trace of a full-width generate costs the profiler more than the
    generate) -> (device us, calls, kernel name) per kernel name, largest
    first."""
    by = {}
    for name, ms in _events(fn)[2]:
        t, c = by.get(name, (0.0, 0))
        by[name] = (t + ms * 1e3, c + 1)
    return sorted(((t, c, name) for name, (t, c) in by.items() if t > 0), reverse=True)


def k1_k3_split(dev):
    """K1-K3 device ms and launches by body (and the CUDA-core body's
    split-K pass) from profiler rows (device us, calls, kernel name)."""
    return {body: {"device_ms": sum(t for t, _, k in dev if any(p in k for p in pats)) / 1e3,
                   "calls": sum(c for _, c, k in dev if any(p in k for p in pats))}
            for body, pats in K1_K3_BODIES}


def phase_profile(engine, store, cfg, per_forward):
    """Where one generate call's time goes at the current rung: wall time
    (host clock, unprofiled), device busy time (the kernels' device times
    in a profiled run, :func:`device_rows`), K1-K3 by body and the largest
    kernels.  Only the 32-row prefill's matmuls take the short-prefill
    body (per_forward - 1 launches), and nothing takes the CUDA-core body
    or its split-K pass."""
    budget = budget_for(store, store.rung)
    engine.generate(make_requests(90, cfg.vocab_size), memory_budget_bytes=budget)
    torch.cuda.synchronize()
    t0 = time.time()
    engine.generate(make_requests(91, cfg.vocab_size), memory_budget_bytes=budget)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    dev = device_rows(lambda: (engine.generate(make_requests(92, cfg.vocab_size),
                                               memory_budget_bytes=budget),
                               torch.cuda.synchronize()))
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
    if busy_ms > 0 and (split["mid"]["calls"], split["cuda_core"]["calls"],
                        split["reduce_partials"]["calls"]) != (per_forward - 1, 0, 0):
        raise AssertionError(f"short generate: K1-K3 by body {split}, want "
                             f"{per_forward - 1} short-prefill launches (the 32-row "
                             f"prefill's) and no CUDA-core launch")
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


def _expert_sets(glog):
    """Each (MoE call, token)'s set of chosen experts."""
    return [[frozenset(row) for row in g.expert_idx.tolist()] for g in glog]


def phase_reference(cfg, store, tag="reference", bf16_tol=BF16_E2E_TOL):
    """The same requests through the plain versions (``reference_pass``)
    at rungs 2, 0, 1.  The reference is the plain pass with
    ``compute_dtype="float32"``:

    * f32 kernel path: prefill logits within 1e-4 of it (relative to max
      |logit|) and greedy tokens identical;
    * bf16 kernel path: prefill logits within ``bf16_tol`` of it and of
      the plain bf16 pass.  bf16 rounding alone puts the plain bf16 pass
      1.5-2.0e-2 from the f32 one through qwen2-1.5b's 28 layers, so the
      limit sits above that floor;
    * the control, for each rung above 0: the bf16 kernel path of the rung
      below against this rung's f32 reference - what a kernel that dropped
      the finest delta stream would read.  It must read above ``bf16_tol``,
      or the limit could not tell such a kernel from a sound one.

    On a MoE model every plain pass the bf16 checks and the control read
    replays the bf16 kernel pass's expert choices (``moe.forced_routing``,
    from its ``moe.record_groups`` log): a bf16 near-tie in the router
    could otherwise send a token to another expert, where no tolerance
    applies.  The f32 comparison is unforced, and the (layer, token)
    routings an unforced plain bf16 pass moves are counted.  A dense model
    makes no MoE call, so neither hook acts there.

    Every rung is measured before any failure is raised."""
    from repro_torch.core.nesting import set_tree_rung
    from repro_torch.kernels import dispatch
    from repro_torch.models import moe
    from repro_torch.serving import ServeEngine

    out, failures = {}, []
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    f32_launches = dict.fromkeys(KERNELS, 0)
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
        with moe.record_groups() as klog:
            k16, _ = e16.model.prefill(params, toks)
        seen = lambda: {n: (dispatch.counter(n).launches, dispatch.counter(n).dec_launches,  # noqa: E731
                            dispatch.counter(n).f32_launches) for n in KERNELS}
        before = seen()
        k32, _ = e32.model.prefill(params, toks)
        # (launches, decode body, f32 body) of the f32 prefill
        f32_now = {n: tuple(a - b for a, b in zip(v, before[n])) for n, v in seen().items()}
        f32_launches = {n: f32_launches[n] + f32_now[n][2] for n in KERNELS}
        choices = [g.expert_idx for g in klog]
        with dispatch.reference_pass():
            with moe.forced_routing(choices):
                p16, _ = e16.model.prefill(params, toks)
            p32, _ = e32.model.prefill(params, toks)
            if klog:
                with moe.forced_routing(choices):
                    p32f, _ = e32.model.prefill(params, toks)
                with moe.record_groups() as ulog:
                    u16, _ = e16.model.prefill(params, toks)
            else:
                p32f = p32
        # greedy tokens in f32 only: bf16's are held by their logits above
        t = {plain: _generate(e32, budget, phase, plain) for plain in (False, True)}
        # the f32 prefill's launches on the rung's kernel, every one but
        # those at M <= 8 (the LM head; small expert groups) on the f32 body
        name = next(n for n, v in KERNELS.items() if v[0] == min(rung, 2))
        f32_ok = (f32_now[name][2] > 0 and f32_now[name][2] == f32_now[name][0] - f32_now[name][1]
                  and not any(any(f32_now[n]) for n in KERNELS if n != name))
        r = {"f32_body_launches": f32_now[name][2], "f32_body_ok": f32_ok,
             "f32_kernel_vs_plain": _rel(k32, p32),
             "bf16_kernel_vs_f32_plain": _rel(k16, p32f),
             "bf16_plain_vs_f32_plain": _rel(p16, p32f),
             "bf16_kernel_vs_bf16_plain": _rel(k16, p16),
             "f32_tokens_identical": bool((t[False] == t[True]).all()),
             "max_abs_logit": p32.abs().max().item(), "bf16_tol": bf16_tol}
        finite = all(bool(x.isfinite().all()) for x in (k16, k32, p16, p32, p32f))
        r["ok"] = (finite and f32_ok and r["f32_kernel_vs_plain"] <= 1e-4
                   and r["f32_tokens_identical"]
                   and r["bf16_kernel_vs_f32_plain"] <= bf16_tol
                   and r["bf16_kernel_vs_bf16_plain"] <= bf16_tol)
        out[f"rung{rung}"] = r
        if klog:
            r["routed_tokens"] = sum(g.tokens for g in klog)
            r["bf16_unforced_expert_set_changes"] = sum(
                a != b for ka, ua in zip(_expert_sets(klog), _expert_sets(ulog))
                for a, b in zip(ka, ua))
            r["bf16_plain_unforced_vs_forced"] = _rel(u16, p16)
            log(f"[{tag}] rung {rung}: an unforced plain bf16 pass changes the expert set "
                f"of {r['bf16_unforced_expert_set_changes']} of {r['routed_tokens']} (layer, "
                f"token) routings (its logits {r['bf16_plain_unforced_vs_forced']:.3e} from "
                f"the forced pass)")
        if rung > 0:
            with moe.forced_routing(choices):
                short, _ = e16.model.prefill(set_tree_rung(params, rung - 1), toks)
            r["bf16_one_stream_short_vs_f32_plain"] = _rel(short, p32f)
            r["ok"] = r["ok"] and r["bf16_one_stream_short_vs_f32_plain"] > bf16_tol
            log(f"[{tag}] rung {rung}: a kernel one delta stream short (the bf16 "
                f"kernel path at rung {rung - 1}) reads "
                f"{r['bf16_one_stream_short_vs_f32_plain']:.3e} against the f32 plain pass "
                f"(must exceed {bf16_tol:.1e})")
        log(f"[{tag}] rung {rung}: f32 kernel vs plain {r['f32_kernel_vs_plain']:.3e} "
            f"(tol 1e-4; the f32 prefill's {name} launches (all, decode, f32 body) "
            f"{f32_now[name]}), "
            f"tokens identical {r['f32_tokens_identical']}; bf16 kernel vs "
            f"f32 plain {r['bf16_kernel_vs_f32_plain']:.3e}, bf16 kernel vs bf16 plain "
            f"{r['bf16_kernel_vs_bf16_plain']:.3e} (tol {bf16_tol:.1e} each), bf16 "
            f"plain vs f32 plain {r['bf16_plain_vs_f32_plain']:.3e}")
        if not r["ok"]:
            failures.append(rung)
        del e16, e32
    if failures:
        raise AssertionError(f"{tag} pass failed at rungs {failures}: {out}")
    out["f32_launches"] = f32_launches
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
    libraries, the decode-body and short-prefill plans and the current
    stream's arrival counters' buffer (both bodies share it)."""
    from repro_torch.kernels import build

    buf = build._dec_counters.get((torch.cuda.current_device(),
                                   torch.cuda.current_stream().cuda_stream))
    return {"libraries": sorted(build._libs), "dec_plans": len(build._dec_plans),
            "mid_plans": len(build._mid_plans),
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
            # the prefill's matmuls but the LM head: the short-prefill body in
            # bf16, the f32 body in f32
            ladder = dispatch.counter("ladder_matmul")
            pre = ladder.f32_launches if dtype == "float32" else ladder.mid_launches
            if got != want or pre != per_forward - 1 or any(
                    dispatch.counter(n).plain_launches or dispatch.counter(n).tc_launches
                    for n in names):
                raise AssertionError(f"speculative {dtype} k={k} draft={draft}: launches "
                                     f"{got}, want {want}, the prefill's {pre} on the "
                                     f"{'f32' if dtype == 'float32' else 'short-prefill'} "
                                     f"body (want {per_forward - 1}) and no plain or "
                                     f"tensor-core launch")
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
# arguments; --arch qwen2-1.5b unless they name one); "{out}" is a
# directory of the run's own
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
    ("serve", ["--arch", "dbrx-132b", "--bits", "8,6,4", "--budget-schedule",
               "full,part,rung1,full", "--requests", "4", "--new-tokens", "2"]),
    ("serve", ["--arch", "mamba2-780m", "--bits", "8,6,4", "--budget-schedule",
               "full,part,rung1,full", "--requests", "4", "--new-tokens", "2"]),
    ("serve", ["--arch", "zamba2-2.7b", "--bits", "8,6,4", "--budget-schedule",
               "full,part,rung1,full", "--requests", "4", "--new-tokens", "2"]),
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
    arch = [] if "--arch" in args else ["--arch", "qwen2-1.5b"]
    argv = [*arch, "--smoke", "--device", device,
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


def check_flash(q, k, v, what, tag="kv-kernels"):
    """K5 against its plain version on (q, k, v): within ``TOL`` of max |o|
    and ``ROW_TOL`` of every row's norm, and the control that a K5 missing
    one key tile fails the row check.  Returns (max err, max |o|, worst
    row, the control's max err and worst row)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import ops as fa

    dtype = q.dtype
    what = f"flash_attention {what} {str(dtype).replace('torch.', '')}"
    got = fa.flash_attention(q, k, v)
    with dispatch.reference_pass():
        want = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    row = _row_rel(got, want)
    if not (math.isfinite(err) and err <= TOL[dtype] * peak):
        raise AssertionError(f"{what}: max |kernel - plain| = {err} > {TOL[dtype]} * {peak}")
    if not (math.isfinite(row) and row <= ROW_TOL[dtype]):
        raise AssertionError(f"{what}: worst row |kernel - plain| / |plain| = {row} > "
                             f"{ROW_TOL[dtype]}")
    ctl = _drop_key_tile(q, k, v, want)
    ctl_err = (ctl.float() - want.float()).abs().max().item()
    ctl_row = _row_rel(ctl, want)
    if ctl_row <= ROW_TOL[dtype]:
        raise AssertionError(f"{what}: the row check cannot see a missing key tile "
                             f"({ctl_row})")
    log(f"[{tag}] {what}: max err / max|o| {err / peak:.3e} (tol {TOL[dtype]}), worst row "
        f"{row:.3e} (tol {ROW_TOL[dtype]}); one key tile dropped reads {ctl_err / peak:.3e} "
        f"and {ctl_row:.3e}")
    return err, peak, row, ctl_err, ctl_row


STATS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}


def flash_offset_row(q, k, v, off, whole_rows):
    """K5 on a block of query rows at ``off`` into the keys (a
    sequence-parallel rank's rows) against its plain version (``TOL`` of
    max |o|, ``ROW_TOL`` of every row), timed beside the plain version and
    ``scaled_dot_product_attention`` with the explicit offset causal mask
    (the library yardstick; the port never calls it).  Whether the rows
    equal the whole-sequence launch's bit for bit is recorded.  The bound
    counts what the block needs: the keys up to its last row, once, and
    each row's causal share of QK^T and PV."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import ops as fa

    dtype = q.dtype
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    what = (f"flash_attention rows {off}..{off + Sq - 1} of {Skv} "
            f"{str(dtype).replace('torch.', '')}")
    got = fa.flash_attention(q, k, v, q_offset=off)
    with dispatch.reference_pass():
        want = fa.flash_attention(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    row = _row_rel(got, want)
    if not (math.isfinite(err) and err <= TOL[dtype] * peak and row <= ROW_TOL[dtype]):
        raise AssertionError(f"{what}: max |kernel - plain| / max |o| = {err / peak:.3e} "
                             f"(tol {TOL[dtype]}), worst row {row:.3e} (tol {ROW_TOL[dtype]})")
    same = bool(torch.equal(got, whole_rows))
    ms = time_graph_ms(lambda i: fa.flash_attention(q, k, v, q_offset=off), 10)
    with dispatch.reference_pass():
        plain_ms = time_ms(lambda i: fa.flash_attention(q, k, v, q_offset=off), 3)
    pos = torch.arange(Skv, device=q.device)
    mask = pos[None, :] <= off + torch.arange(Sq, device=q.device)[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_graph_ms(lambda i: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True), 10)
    nbytes, flops = flash_cost(q, k, off)
    log(f"[kv-kernels] {what}: max err / max|o| {err / peak:.3e}, worst row {row:.3e}; "
        f"equal to the whole launch's rows: {same}")
    return _row("flash_attention_offset", f"rows {off}..{off + Sq - 1} of {Skv}", Sq,
                str(dtype).replace("torch.", ""), err, ms, plain_ms, nbytes, flops,
                PEAK_FLOPS[dtype], lib_ms, max_abs_ref=peak, worst_row_rel=row,
                equals_whole_rows=same, B=B, Sq=Sq, Skv=Skv, q_offset=off, Hq=Hq, Hkv=Hkv,
                hd=hd)


def check_flash_stats(q, k, v, what):
    """K5 with its row statistics (the training forward's launch) against
    the plain forward at one KV block (``attention._flash_fwd_inner``): o
    within ``TOL`` of max |o|; m within ``STATS_TOL`` of max(1, |m|) and l
    within ``STATS_TOL`` relative, row by row.  Returns the readings."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.attention import _flash_fwd_inner

    dtype = q.dtype
    what = f"flash_attention {what} {str(dtype).replace('torch.', '')} with statistics"
    o, m, l = fa.flash_attention_stats(q, k, v)
    want_o, want_m, want_l = _flash_fwd_inner(q, k, v, True, q.shape[1])
    torch.cuda.synchronize()
    peak = want_o.float().abs().max().item()
    err = (o.float() - want_o.float()).abs().max().item()
    m_err = ((m - want_m).abs() / want_m.abs().clamp_min(1.0)).max().item()
    l_err = ((l - want_l).abs() / want_l).max().item()
    if not (err <= TOL[dtype] * peak and m_err <= STATS_TOL[dtype]
            and l_err <= STATS_TOL[dtype]):
        raise AssertionError(f"{what}: o {err / peak:.3e} of max |o| (tol {TOL[dtype]}), "
                             f"m {m_err:.3e}, l {l_err:.3e} (tol {STATS_TOL[dtype]})")
    log(f"[kv-kernels] {what}: o {err / peak:.3e} of max |o|, m {m_err:.3e}, l "
        f"{l_err:.3e} (tol {STATS_TOL[dtype]:.0e})")
    return {"max_abs_err": err, "max_abs_ref": peak, "m_rel_err": m_err, "l_rel_err": l_err}


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
                nbytes, ops = qk_cost(qc, st, S)
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
            err, peak, row, ctl_err, ctl_row = check_flash(q, k, v, f"S={S}")
            ms = time_graph_ms(lambda i: fa.flash_attention(q, k, v), 10)
            with dispatch.reference_pass():
                plain_ms = time_ms(lambda i: fa.flash_attention(q, k, v), 3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_ms = time_graph_ms(lambda i: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
            nbytes, flops = flash_cost(q, k)
            stats = None
            if S <= PROMPT_LONG:          # the training forward's launch
                stats = check_flash_stats(q, k, v, f"S={S}")
                stats["ms"] = time_graph_ms(lambda i: fa.flash_attention_stats(q, k, v), 10)
                stats["ms_without"] = ms
            rows.append(_row("flash_attention", f"S={S}", S, str(dtype).replace("torch.", ""),
                             err, ms, plain_ms, nbytes, flops, PEAK_FLOPS[dtype], lib_ms,
                             max_abs_ref=peak, worst_row_rel=row,
                             control_drop_tile={"err_over_max": ctl_err / peak,
                                                "worst_row_rel": ctl_row},
                             with_stats=stats, B=B, S=S, Hq=Hq, Hkv=Hkv, hd=hd))
            if S == PROMPT_LONG:
                # phase 10's launches: each of 8 model ranks' block of 256
                # query rows (bf16: every block; f32: the first and last)
                n = S // SEQ_MESH[1]
                whole = fa.flash_attention(q, k, v)
                offs = range(0, S, n) if dtype == torch.bfloat16 else (0, S - n)
                for off in offs:
                    rows.append(flash_offset_row(q[:, off:off + n].contiguous(), k, v, off,
                                                 whole[:, off:off + n]))
                del whole
            del q, k, v
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
            nbytes, ops = recompose_cost(wh, wl, K)
            copies = _cold_copies((wh, wl), nbytes)
            ms = time_graph_ms(lambda i: nr.nest_recompose(
                *copies[i % len(copies)], n=n, h=h, K=K, block_k=block), 20)
            with dispatch.reference_pass():
                plain_ms = time_ms(lambda i: nr.nest_recompose(wh, wl, n=n, h=h, K=K,
                                                               block_k=block), 3)
            rows.append(_row("nest_recompose", shape, 0, "int8", 0.0, ms, plain_ms, nbytes,
                             ops, PEAK_INT8_OPS, None, K=K, N=N, n=n, h=h,
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
            + (f" cuda-core={r['cuda_core_ms']:.4f}" if "cuda_core_ms" in r else "")
            + (f" with-stats={r['with_stats']['ms']:.4f}" if r.get("with_stats") else ""))
    tree = [r for r in rows if r["kernel"] == "nest_recompose" and (r["n"], r["h"]) == (6, 4)]
    log(f"[kv-kernels] K6 page-in of the tree at (6, 4): "
        f"{sum(r['ms'] * r['uses_per_tree'] for r in tree):.4f} ms over "
        f"{sum(r['uses_per_tree'] for r in tree)} launches (bound "
        f"{sum(r['bound_ms'] * r['uses_per_tree'] for r in tree):.4f} ms; "
        f"{K6_TREE_MS_BEFORE} ms on the one-thread-per-code body it replaces)")
    return rows


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
    name = next(n for n, v in KERNELS.items() if v[0] == min(store.rung, 2))
    dispatch.reset_counters()                      # this path starts here
    kern, _ = ek.model.prefill(params, toks)
    torch.cuda.synchronize()
    f32_prefill = {n: dispatch.counter(n).f32_launches for n in KERNELS}
    with dispatch.reference_pass():
        plain, _ = ep.model.prefill(params, toks)
    rel = _rel(kern, plain)
    rk, rp = long_requests(51, cfg.vocab_size), long_requests(51, cfg.vocab_size)
    ek.generate(rk, queue_depth=0)
    with dispatch.reference_pass():
        ep.generate(rp, queue_depth=0)
    same = [r.out_tokens for r in rk] == [r.out_tokens for r in rp]
    # each prefill's 196 matmuls but the LM head (M = 2: the decode body) on
    # the f32 body, K5 once a layer, in the prefill alone and in the generate
    per_forward = packed_linears_per_forward(store)
    f32 = {n: dispatch.counter(n).f32_launches for n in KERNELS}
    k5 = dispatch.counter("flash_attention").launches
    want = {n: per_forward - 1 if n == name else 0 for n in KERNELS}
    launches_ok = (f32_prefill == want and sum(f32.values()) == 2 * (per_forward - 1)
                   and k5 == 2 * cfg.num_layers)
    ok = (bool(kern.isfinite().all()) and rel <= 1e-4 and same and launches_ok
          and ek.kv.rung == ep.kv.rung == 2)
    log(f"[long-f32] prefill logits kernel vs plain {rel:.3e} (tol 1e-4); greedy tokens "
        f"identical {same} at kv rung {ek.kv.rung}; f32-body launches of the prefill "
        f"{f32_prefill} (want {want}), with the generate's {f32} (want "
        f"{2 * (per_forward - 1)} in all), K5 {k5} (want {2 * cfg.num_layers})")
    if not ok:
        raise AssertionError(f"long f32 check failed: rel {rel}, tokens identical {same}, "
                             f"f32-body launches {f32_prefill} / {f32}, K5 {k5}")
    return {"prefill_rel": rel, "tokens_identical": same, "f32_launches": f32,
            "k5_launches": k5}


def phase_long_profile(engine, cfg):
    """Where one long generate call's time goes (rung 2, bf16): host wall
    clock unprofiled, then device busy time by kernel (:func:`device_rows`).
    In bf16 no K1-K3 launch of the path takes the CUDA-core body (so no
    split-K pass runs): the prefill's on the tensor cores, the rest on the
    decode body."""
    reqs = long_requests(60, cfg.vocab_size)
    torch.cuda.synchronize()
    t0 = time.time()
    engine.generate(reqs, queue_depth=0)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    dev = device_rows(lambda: (engine.generate(long_requests(61, cfg.vocab_size), queue_depth=0),
                               torch.cuda.synchronize()))
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
# phase 5, continued: K4 on the served cache's pages, K6 on the served tree
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


# ---------------------------------------------------------------------------
# phase 6: the MoE family at full width (dbrx-132b, 2 of its 40 layers)
# ---------------------------------------------------------------------------
MOE_ARCH, MOE_LAYERS = "dbrx-132b", 2
MOE_LONG_BATCH, MOE_LONG_PROMPT, MOE_LONG_NEW = 2, 1100, 4
# bf16 limit of the MoE checks, between the sound readings (kernel against
# the forced plain passes: 3.4-5.4e-3 on the H100) and the one-stream-short
# control (6.2e-2 at rung 2, 0.28 at rung 1): about their geometric mean
MOE_BF16_TOL = 2e-2
MOE_SPEC = (2, 0)                  # SpecConfig(k, draft rung), verified at rung 2
MOE_STEP_REPS = 5                  # decode steps timed per rung in the report


def moe_config():
    """dbrx-132b at its published widths with 2 of its 40 layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)


def _k_counts():
    """(launches, decode-body, tensor-core, plain, short-prefill, f32-body)
    of every wrapper."""
    from repro_torch.kernels import dispatch
    return {n: (c.launches, c.dec_launches, c.tc_launches, c.plain_launches, c.mid_launches,
                c.f32_launches)
            for n, c in dispatch.COUNTERS.items()}


def _k_delta(before):
    return {n: tuple(a - b for a, b in zip(v, before.get(n, (0,) * 6)))
            for n, v in _k_counts().items()}


def moe_want(glog, L, batch, dtype, attn=4):
    """K1-K3 (launches, decode-body, tensor-core, plain, short-prefill,
    f32-body) per kernel that the routing ``moe.record_groups`` recorded
    implies.  Each forward (L
    consecutive entries, one route and one rung) runs ``attn`` nested
    attention matmuls per layer at M = T (all 4 at full width), 3 matmuls
    per (layer, expert) group at its rows, and the LM head (M = T on the
    decode route, the last position of each of ``batch`` sequences in a
    prefill), on the kernel of the rung its experts carry: a named decode
    route ceil(M / 8) decode-body launches, no route one launch on the body
    ``matmul_route`` picks for M."""
    from repro_torch.kernels import dispatch

    want = {n: [0] * 6 for n in KERNELS}

    def add(name, M, route, times):
        body = route or dispatch.matmul_route(M, dtype, DEVICE)
        k = times * (-(-M // dispatch.DEC_MAX_M) if route == dispatch.DECODE else 1)
        want[name][0] += k
        want[name][1] += k * (body == dispatch.DECODE)
        want[name][2] += k * (body == dispatch.TENSOR_CORE)
        want[name][4] += k * (body == dispatch.MID)
        want[name][5] += k * (body == dispatch.F32)

    if not glog or len(glog) % L:
        raise AssertionError(f"{len(glog)} MoE calls recorded, not whole {L}-layer forwards")
    for f in range(0, len(glog), L):
        fwd = glog[f:f + L]
        route, rung, T = fwd[0].route, fwd[0].rung, fwd[0].tokens
        if any((g.route, g.rung, g.tokens) != (route, rung, T) for g in fwd):
            raise AssertionError(f"forward {f // L}: layers disagree {fwd}")
        name = next(n for n, v in KERNELS.items() if v[0] == min(rung, 2))
        add(name, T, route, attn * L)
        for g in fwd:
            for _, n in g.groups:
                add(name, n, route, 3)
        add(name, T if route else batch, route, 1)
    return {n: tuple(v) for n, v in want.items()}


def _moe_check(glog, L, batch, dtype, delta, what, flash=0, attn=4):
    """The counters of a run against what its recorded routing implies: K1-K3
    per kernel and body, K5 ``flash`` launches, nothing else, nothing plain."""
    want = moe_want(glog, L, batch, dtype, attn)
    got = {n: delta[n] for n in KERNELS}
    others = {n: v for n, v in delta.items() if n not in KERNELS and any(v)}
    want_others = {"flash_attention": (flash, 0, 0, 0, 0, 0)} if flash else {}
    if got != want or others != want_others:
        raise AssertionError(f"{what}: launches (all, decode, tensor core, plain, short "
                             f"prefill, f32) {got} "
                             f"{others}, the recorded routing implies {want} {want_others}")
    return {n: v[:3] for n, v in got.items()}


def _moe_generate(engine, reqs, budget, what, flash=0, spec=None):
    """One generate under the routing recorder; checks the counters against
    the routing and the tokens' range.  Returns (wall s, launches, log)."""
    from repro_torch.models import moe

    cfg = engine.cfg
    nested = {p for p, _ in engine.store.nested_leaves()}
    attn = sum(f"['blocks']['{n}']['w']" in nested for n in "qkvo")
    before = _k_counts()
    with moe.record_groups() as glog:
        _, wall = _timed(lambda: engine.generate(reqs, memory_budget_bytes=budget,
                                                 speculate=spec))
    launches = _moe_check(glog, cfg.num_layers, len(reqs),
                          torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32,
                          _k_delta(before), what, flash, attn)
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"{what}: bad tokens {r.out_tokens}")
    return wall, launches, glog


def _events(fn):
    """(fn(), wall s, [(kernel name, device ms)]) of one profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, wall = _timed(fn)
    return out, wall, [(e.name(), e.duration_ns() / 1e6)
                       for e in prof.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA]


def _ms(events, *patterns):
    return sum(t for name, t in events if any(p in name for p in patterns))


K1_K3_NAMES = ("stream_matmul", "reduce_partials")
K5_NAMES = ("flash_fwd",)


def moe_step_report(cfg, store, gen):
    """Per rung, batch 4: one decode step's wall (host clock, unprofiled,
    mean of ``MOE_STEP_REPS``) and device busy (profiled), the experts it
    touches per layer, the K1-K3 bytes it reads and their bound, and its
    K1-K3 device time split into attention, experts and LM head (each
    group's calls at the step's recorded shapes, replayed in a CUDA graph
    on random activations)."""
    from repro_torch.core.nesting import NestedTensor
    from repro_torch.kernels import dispatch
    from repro_torch.models import moe
    from repro_torch.models.layers import packed_linear
    from repro_torch.models.model import layer_params
    from repro_torch.serving import ServeEngine

    L, d, ff = cfg.num_layers, cfg.d_model, cfg.d_ff
    out = {}
    for rung in range(3):
        engine = ServeEngine(cfg, store, max_batch=BATCH, max_len=MAX_LEN)
        engine.ensure_mode(budget_for(store, rung))
        params = store.params()
        model = engine.model
        _, c = model.prefill(params, prompt_tokens(make_requests(80 + rung, cfg.vocab_size),
                                                   DEVICE))
        cache = model.make_cache(BATCH, MAX_LEN)
        cache["k"][:, :, :PROMPT], cache["v"][:, :, :PROMPT] = c["k"], c["v"]
        cache["pos"] = PROMPT
        tok = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=gen,
                                       device=DEVICE)}
        step = lambda: model.decode_step(params, tok, cache)  # noqa: E731
        step()
        walls = [_timed(step)[1] for _ in range(MOE_STEP_REPS)]
        _, _, ev = _events(step)
        with moe.record_groups() as glog:
            step()
        touched = [len(g.groups) for g in glog]
        # the step's K1-K3 calls, grouped, on random activations of its shapes
        blocks = params["blocks"]
        lays = [layer_params(blocks, i) for i in range(L)]
        xa = torch.randn(BATCH, d, generator=gen, device=DEVICE).bfloat16()
        attn = [(xa, lp[n]["w"]) for lp in lays for n in ("q", "k", "v", "o")
                if isinstance(lp[n]["w"], NestedTensor)]
        experts = []
        for i, g in enumerate(glog):
            ex = lays[i]["moe"]["experts"]
            for e, n in g.groups:
                xe = torch.randn(n, d, generator=gen, device=DEVICE).bfloat16()
                he = torch.randn(n, ff, generator=gen, device=DEVICE).bfloat16()
                experts += [(xe, ex["w_gate"]["w"].layer(e)), (xe, ex["w_up"]["w"].layer(e)),
                            (he, ex["w_down"]["w"].layer(e))]
        head = [(xa, params["lm_head"]["w"])]

        def calls(items, out_dtype=None):
            return lambda i: [packed_linear(x, w, out_dtype, route=dispatch.DECODE)
                              for x, w in items]
        split = {"attention_ms": time_graph_ms(calls(attn), 3, reps=3),
                 "experts_ms": time_graph_ms(calls(experts), 3, reps=3),
                 "head_ms": time_graph_ms(calls(head, torch.float32), 3, reps=3)}

        def rung_bytes(w):
            return sum(w.stream_nbytes()[:rung + 1]) + w.nbytes_scales()
        nbytes = sum(rung_bytes(w) // w.shape[0] for _, w in attn)
        nbytes += sum(rung_bytes(w) // (w.shape[0] * w.shape[1]) for _, w in experts)
        nbytes += rung_bytes(params["lm_head"]["w"])
        launches = len(attn) + len(experts) + len(head)   # M <= 8: one launch each
        r = {"wall_ms": 1e3 * sum(walls) / len(walls), "device_busy_ms": sum(t for _, t in ev),
             "k1_k3_profiled_ms": _ms(ev, *K1_K3_NAMES), **split,
             "k1_k3_launches": launches,
             "experts_touched_per_layer": touched, "k1_k3_bytes": nbytes,
             "k1_k3_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        r["device_idle_share"] = 1 - r["device_busy_ms"] / r["wall_ms"]
        out[f"rung{rung}"] = r
        log(f"[moe-step] rung {rung} batch {BATCH}: decode step wall {r['wall_ms']:.2f} ms, "
            f"device busy {r['device_busy_ms']:.2f} ms (idle {r['device_idle_share']:.1%}); "
            f"experts touched per layer {touched} of {cfg.num_experts}; {launches} K1-K3 "
            f"launches, {r['k1_k3_profiled_ms']:.2f} ms profiled, replayed: attention "
            f"{split['attention_ms']:.3f} + experts {split['experts_ms']:.3f} + head "
            f"{split['head_ms']:.3f} ms; reads {nbytes / 1e9:.3f} GB, bound "
            f"{r['k1_k3_bound_ms']:.3f} ms")
        del engine, cache, c, attn, experts, head, lays
    return out


def phase_moe(gen):
    """Phase 6: dbrx-132b at full width (2 layers) served from the nested
    (8, 6, 4) tree; see the module docstring."""
    from repro_torch.core.recipe import QuantRecipe, quantize
    from repro_torch.core.switching import NestQuantStore
    from repro_torch.kernels import dispatch
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.serving import Request, ServeEngine, SpecConfig, StaticRungPolicy

    t_phase = time.perf_counter()
    cfg = moe_config()
    L = cfg.num_layers
    params, init_s = _timed(lambda: init_params(cfg, seed=0, device=DEVICE))
    nested, quant_s = _timed(lambda: quantize(params, QuantRecipe(bits=BITS), device=DEVICE))
    del params
    store = NestQuantStore(nested, mode="part", device=DEVICE)
    del nested
    torch.cuda.empty_cache()
    rung_bytes = [store.rung_resident_bytes(r) for r in range(3)]
    lb = store.ladder_bytes()
    quant_peak = torch.cuda.max_memory_allocated()
    log(f"[moe] {cfg.name} x{L} layers at full width: init {init_s:.1f}s, adaptive (8,6,4) "
        f"quantize {quant_s:.1f}s (peak device memory so far {quant_peak / 1e9:.2f} GB); "
        f"base={lb['base']} deltas={lb['deltas']} scales={lb['scales']} fp={lb['fp']} "
        f"rung bytes={rung_bytes}")
    dtype = torch.bfloat16

    # 1. the short serve, rungs 2, 0, 1, 2 (the main path starts here)
    dispatch.reset_counters()
    engine = ServeEngine(cfg, store, max_batch=BATCH, max_len=MAX_LEN)
    serve, total = [], {n: [0, 0, 0] for n in KERNELS}
    flash_total = 0

    def add(launches):
        for n, v in launches.items():
            total[n] = [a + b for a, b in zip(total[n], v)]

    for phase, rung in enumerate(SERVE_SCHEDULE):
        reqs = make_requests(phase, cfg.vocab_size)
        wall, launches, glog = _moe_generate(engine, reqs, budget_for(store, rung),
                                             f"moe serve phase {phase}")
        if store.rung != rung or any(g.rung != rung for g in glog):
            raise AssertionError(f"moe serve phase {phase}: rung {store.rung}, want {rung}")
        add(launches)
        touched = [len(g.groups) for g in glog if g.route == dispatch.DECODE]
        serve.append({"rung": rung, "wall_s": wall, "launches": launches,
                      "tokens": [r.out_tokens for r in reqs],
                      "prefill_groups": [g.groups for g in glog if g.route is None],
                      "decode_experts_touched_mean": sum(touched) / len(touched)})
        log(f"[moe] serve phase {phase}: rung {rung}, {BATCH}x{NEW_TOKENS} tokens in "
            f"{wall:.3f}s; K1-K3 (all, decode body, tensor cores) {launches} = the recorded "
            f"routing's; experts touched per decode layer {serve[-1]['decode_experts_touched_mean']:.2f}")

    # 2. the long prompt at rung 2: K5, expert groups of ~550 rows on the
    # tensor cores
    long_eng = ServeEngine(cfg, store, max_batch=MOE_LONG_BATCH,
                           max_len=MOE_LONG_PROMPT + MOE_LONG_NEW + 4)
    rng = np.random.default_rng(400)
    long_reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=MOE_LONG_PROMPT)
                         .astype(np.int32), max_new_tokens=MOE_LONG_NEW)
                 for i in range(MOE_LONG_BATCH)]
    wall, launches, glog = _moe_generate(long_eng, long_reqs, budget_for(store, 2),
                                         "moe long prompt", flash=L)
    add(launches)
    flash_total += L
    big = [n for g in glog if g.route is None for _, n in g.groups]
    if min(big) < dispatch.TC_MIN_M or not all(v[2] for v in launches.values() if v[0]):
        raise AssertionError(f"moe long prompt: expert groups {big} not all on the tensor cores")
    long_info = {"wall_s": wall, "launches": launches, "prefill_group_rows": big}
    log(f"[moe] long prompt {MOE_LONG_BATCH}x{MOE_LONG_PROMPT} + {MOE_LONG_NEW} tokens at rung 2 "
        f"in {wall:.3f}s; K5 x{L}; prefill expert groups of {min(big)}-{max(big)} rows; K1-K3 "
        f"{launches}")

    # 3. speculation at rung 2: SpecConfig(k=2, draft=0) against plain greedy
    k, draft = MOE_SPEC
    spec_eng = ServeEngine(cfg, store, max_batch=BATCH, max_len=MAX_LEN,
                           policy=StaticRungPolicy(2))
    plain_reqs, spec_reqs = make_requests(0, cfg.vocab_size), make_requests(0, cfg.vocab_size)
    add(_moe_generate(spec_eng, plain_reqs, None, "moe greedy at rung 2")[1])
    wall, launches, glog = _moe_generate(spec_eng, spec_reqs, None, "moe speculation",
                                         spec=SpecConfig(k=k, draft=draft))
    add(launches)
    prof = spec_eng.last_profile
    if [r.out_tokens for r in spec_reqs] != [r.out_tokens for r in plain_reqs]:
        raise AssertionError(f"moe speculation: tokens {[r.out_tokens for r in spec_reqs]} "
                             f"differ from plain greedy {[r.out_tokens for r in plain_reqs]}")
    verify = [g for g in glog if g.tokens == BATCH * (k + 1)]
    if (not prof.speculative or len(verify) != L * prof.verify_passes
            or any(g.route != dispatch.DECODE or g.rung != 2 for g in verify)
            or any(v[2] for v in launches.values())):
        raise AssertionError(f"moe speculation: verify calls {verify} for "
                             f"{prof.verify_passes} rounds, launches {launches}")
    spec = {"wall_s": wall, "rounds": prof.verify_passes, "draft_steps": prof.draft_steps,
            "acceptance": prof.acceptance, "launches": launches}
    log(f"[moe] speculation k={k} draft={draft} at rung 2: tokens = plain greedy; "
        f"{prof.verify_passes} rounds, acceptance {prof.acceptance:.3f}, every verify row "
        f"on the decode body; K1-K3 {launches}")
    main_counts = _k_counts()            # the main path ends here
    if ({n: list(main_counts[n][:3]) for n in KERNELS} != total
            or main_counts["flash_attention"][0] != flash_total
            or any(v[3] for v in main_counts.values())):
        raise AssertionError(f"moe main path: counters {main_counts}, checked runs {total}, "
                             f"K5 {flash_total}")
    del engine, long_eng, spec_eng

    # 4. the reference pass; 5. the report (neither counted)
    reference, ref_s = _timed(lambda: phase_reference(cfg, store, "moe-reference",
                                                      MOE_BF16_TOL))
    log(f"[moe] reference pass at rungs 2, 0, 1 took {ref_s:.1f}s")
    steps = moe_step_report(cfg, store, gen)
    store.to_rung(2)
    params = store.params()
    toks = prompt_tokens(long_reqs, DEVICE)
    pre_eng = ServeEngine(cfg, store, max_batch=MOE_LONG_BATCH,
                          max_len=MOE_LONG_PROMPT + MOE_LONG_NEW + 4)
    # the long prefill (K5 at 48/8 heads, expert groups on the tensor
    # cores) against a plain bf16 pass replaying its expert choices
    with moe.record_groups() as llog:
        k_long, _ = pre_eng.model.prefill(params, toks)
    with dispatch.reference_pass(), moe.forced_routing([g.expert_idx for g in llog]):
        p_long, _ = pre_eng.model.prefill(params, toks)
    long_err = _rel(k_long, p_long)
    if not (bool(k_long.isfinite().all()) and long_err <= MOE_BF16_TOL):
        raise AssertionError(f"moe long prefill: bf16 kernel vs forced plain bf16 {long_err} "
                             f"> {MOE_BF16_TOL}")
    log(f"[moe] long prefill {MOE_LONG_BATCH}x{MOE_LONG_PROMPT} at rung 2: bf16 kernel vs "
        f"plain bf16 (replaying its expert choices) {long_err:.3e} (tol {MOE_BF16_TOL:.1e})")
    del k_long, p_long
    _, pre_wall, ev = _events(lambda: pre_eng.model.prefill(params, toks))
    long_prefill = {"wall_ms": pre_wall * 1e3, "device_busy_ms": sum(t for _, t in ev),
                    "k1_k3_ms": _ms(ev, *K1_K3_NAMES), "k5_ms": _ms(ev, *K5_NAMES),
                    "bf16_kernel_vs_bf16_plain_forced": long_err}
    log(f"[moe] long prefill {MOE_LONG_BATCH}x{MOE_LONG_PROMPT} at rung 2 (profiled): wall "
        f"{long_prefill['wall_ms']:.1f} ms, device busy {long_prefill['device_busy_ms']:.1f} ms,"
        f" K1-K3 {long_prefill['k1_k3_ms']:.2f} ms, K5 {long_prefill['k5_ms']:.3f} ms")
    del pre_eng, store, params
    # K5 alone at the long prompt's shape
    q, k, v = (torch.randn(MOE_LONG_BATCH, MOE_LONG_PROMPT, h, cfg.head_dim, generator=gen,
                           device=DEVICE).bfloat16()
               for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    err, peak, row, ctl_err, ctl_row = check_flash(
        q, k, v, f"S={MOE_LONG_PROMPT} {cfg.num_heads}/{cfg.num_kv_heads} heads", tag="moe")
    flash_check = {"B": MOE_LONG_BATCH, "S": MOE_LONG_PROMPT, "Hq": cfg.num_heads,
                   "Hkv": cfg.num_kv_heads, "hd": cfg.head_dim, "dtype": "bfloat16",
                   "max_abs_err": err, "max_abs_ref": peak, "worst_row_rel": row,
                   "control_drop_tile": {"err_over_max": ctl_err / peak, "worst_row_rel": ctl_row}}
    del q, k, v
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"[moe] phase 6 took {seconds:.1f}s ({smi_line()})")
    return {"config": {"name": cfg.name, "num_layers": L, "d_model": cfg.d_model,
                       "d_ff": cfg.d_ff, "num_experts": cfg.num_experts, "top_k": cfg.top_k},
            "init_s": init_s, "quantize_s": quant_s, "quantize_peak_mem_bytes": quant_peak,
            "rung_bytes": rung_bytes,
            "serve": serve, "long": long_info, "spec": spec, "reference": reference,
            "reference_s": ref_s,
            "decode_steps": steps, "long_prefill": long_prefill, "seconds": seconds,
            "launches": {n: (main_counts[n][0], main_counts[n][1]) for n in KERNELS},
            "tc_launches": {n: main_counts[n][2] for n in KERNELS},
            "flash_launches": main_counts["flash_attention"][0], "flash_check": flash_check}


# ---------------------------------------------------------------------------
# phase 7: the ssm and hybrid families at full width from the nested tree
# ---------------------------------------------------------------------------
SSM_ARCHS = ("mamba2-780m", "zamba2-2.7b")
# (batch, prompt, new tokens) of each model's long prompt: mamba2's runs the
# tensor-core body at M = 4096 on N = 6448 and the scan over 8 chunks of
# 256; zamba2's runs K5 at head dim 80 once per shared-block application,
# on the nested KV cache
SSM_LONG = {"mamba2-780m": (2, 2048, 8), "zamba2-2.7b": (2, 1100, 4)}
# bf16 limit of each model's checks (prefill logits relative to max |logit|),
# between the sound readings and the one-stream-short control, about their
# geometric mean.  Random weights through 48 or 54 layers amplify bf16
# rounding: sound kernels read up to 0.40 (mamba2) and 0.17 (zamba2) against
# the f32 plain pass, the control at least 1.04 and 0.77 (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md section 6)
SSM_BF16_TOL = {"mamba2-780m": 0.65, "zamba2-2.7b": 0.36}
# limits of the long prefill's bf16 kernel path against the plain bf16 pass
# (last-position logits relative to max |logit|) at full depth and at the
# first SSM_SHALLOW layers, each about the geometric mean of its sound
# reading and its one-stream-short control: full depth 0.132 / 0.893
# (mamba2) and 0.139 / 0.735 (zamba2), 6 layers 1.36e-2 / 0.250 and
# 2.44e-2 / 0.286 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).
# The error grows with depth: random weights amplify bf16 rounding
SSM_SHALLOW = 6
SSM_LONG_TOL = {"mamba2-780m": (0.34, 5.8e-2), "zamba2-2.7b": (0.32, 8.3e-2)}
SSM_STEP_REPS = 5                  # decode steps timed per rung in the report


def ssm_matmuls(cfg) -> int:
    """K1-K3 launches per forward: in_proj and out_proj per Mamba2 layer,
    the shared block's q, k, v, o, w_up and w_down per application (its
    gelu MLP has no gate), and the LM head (97 for mamba2-780m, 163 for
    zamba2-2.7b)."""
    every = cfg.hybrid_attn_every
    return 2 * cfg.num_layers + (6 * (cfg.num_layers // every) if every else 0) + 1


def ssm_want(cfg, batch, prompt, new, rung, flash=0):
    """(launches, decode-body, tensor-core, plain, short-prefill) per
    wrapper that one generate of ``batch`` prompts of ``prompt`` tokens and
    ``new`` new tokens at ``rung`` implies: every forward's matmuls on the
    rung's kernel; the prefill's on the body M = batch * prompt picks but
    its LM head (M = batch), which takes the decode body as every decode
    step does; ``flash`` K5 launches; nothing plain."""
    from repro_torch.device import torch_dtype
    from repro_torch.kernels import dispatch

    per = ssm_matmuls(cfg)
    name = next(n for n, v in KERNELS.items() if v[0] == min(rung, 2))
    body = dispatch.matmul_route(batch * prompt, torch_dtype(cfg.compute_dtype), DEVICE)
    pre = per - 1
    want = {n: (0,) * 6 for n in dispatch.COUNTERS}
    want[name] = (per * (1 + new), per * new + 1 + pre * (body == dispatch.DECODE),
                  pre * (body == dispatch.TENSOR_CORE), 0, pre * (body == dispatch.MID),
                  pre * (body == dispatch.F32))
    if flash:
        want["flash_attention"] = (flash, 0, 0, 0, 0, 0)
    return want


def _ssm_generate(engine, reqs, what, budget=None, queue_depth=None, flash=0):
    """One generate whose counters must equal :func:`ssm_want`'s and whose
    tokens must be in range.  Returns (wall s, (all, decode body, tensor
    cores) per K1-K3 kernel)."""
    cfg = engine.cfg
    before = _k_counts()
    _, wall = _timed(lambda: engine.generate(reqs, memory_budget_bytes=budget,
                                             queue_depth=queue_depth))
    delta = _k_delta(before)
    want = ssm_want(cfg, len(reqs), max(len(r.prompt) for r in reqs),
                    max(r.max_new_tokens for r in reqs), engine.store.rung, flash)
    if delta != want:
        raise AssertionError(f"{what}: launches (all, decode, tensor core, plain, short "
                             f"prefill, f32) {delta}, want {want}")
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"{what}: bad tokens {r.out_tokens}")
    return wall, {n: delta[n][:3] for n in KERNELS}


def _ssm_matmul_leaves(cfg, params):
    """(name, 2-D nested weights one forward reads, reads of each, activation
    width) of every K1-K3 matmul of a forward: a layer view per Mamba2
    layer, the shared block's weights once per application, the LM head
    (every one is nested at full width: ``phase_ssm_model`` counts them)."""
    from repro_torch.core.nesting import NestedTensor

    L, every = cfg.num_layers, cfg.hybrid_attn_every
    blocks = params["blocks"]
    leaves = [(name, blocks[name]["w"], 1) for name in ("in_proj", "out_proj")]
    if every:
        sp = params["shared"]
        leaves += [(name, w, L // every) for name, w in (
            ("q", sp["q"]["w"]), ("k", sp["k"]["w"]), ("v", sp["v"]["w"]), ("o", sp["o"]["w"]),
            ("w_up", sp["mlp"]["w_up"]["w"]), ("w_down", sp["mlp"]["w_down"]["w"]))]
    leaves.append(("lm_head", params["lm_head"]["w"], 1))
    return [(name, [w.layer(i) for i in range(L)] if len(w.shape) == 3 else [w], reads, w.K)
            for name, w, reads in leaves if isinstance(w, NestedTensor)]


def ssm_rows(cfg, store, gen, long_batch, long_prompt):
    """K1-K3 on the model's own nested weights at rung 2's streams, bf16, at
    every (M, body) the main path launches: decode steps at M = ``BATCH``
    and at the long runs' batch (decode body), the short serve's prefill at
    M = ``BATCH`` * ``PROMPT`` (the short-prefill body) and the long prefill's M
    (tensor cores; the ragged N of in_proj and the LM head among them).
    Each is checked and counted by :func:`checked_launch` and timed by
    CUDA-graph replay (cycling through the layers' words, or cold copies
    of a single weight, so they come from HBM) beside the plain version;
    bound by bytes or operations."""
    from repro_torch.kernels import dispatch

    store.to_rung(2)
    bodies = ((BATCH, dispatch.DECODE), (long_batch, dispatch.DECODE),
              (BATCH * PROMPT, dispatch.MID), (long_batch * long_prompt,
                                               dispatch.TENSOR_CORE))
    rows = []
    for shape, views, reads, K in _ssm_matmul_leaves(cfg, store.params()):
        nt = views[0]
        N = nt.shape[-1]
        streams = (nt.w_base,) + tuple(nt.deltas)
        copies = [(v.w_base,) + tuple(v.deltas) for v in views]
        if len(copies) == 1:
            copies = _cold_copies(copies[0], sum(s.numel() * 4 for s in copies[0]))
        out_dtype = torch.float32 if shape == "lm_head" else torch.bfloat16
        for M, body in bodies:
            x = torch.randn(M, K, generator=gen, device=DEVICE).bfloat16()
            for name, (rung, _, _) in KERNELS.items():
                call, route, err, peak = checked_launch(
                    name, nt, x, copies, out_dtype, f"{cfg.name} {name} {shape} M={M}", body)
                small = M <= BATCH * PROMPT
                ms = time_graph_ms(call, 20 if small else 3, reps=5 if small else 2)
                with dispatch.reference_pass():
                    plain_ms = time_ms(call, 2)
                rows.append(_row(
                    name, shape, M, "bfloat16", err, ms, plain_ms,
                    *matmul_cost(x, streams[:rung + 1], N, out_dtype),
                    PEAK_FLOPS[torch.bfloat16], None, model=cfg.name, K=K, N=N, route=route,
                    # per forward: a prefill's LM head sees the last positions only
                    uses_per_forward=(reads * len(views) if route == dispatch.DECODE
                                      or shape != "lm_head" else 0),
                    max_abs_ref=peak))
                log(f"[ssm-kernel] {cfg.name} {name:13s} {shape:8s} K={K:5d} N={N:6d} M={M:4d} "
                    f"{route:11s} err={err:.2e} ms={ms:.4f} plain={plain_ms:.3f} "
                    f"bound={rows[-1]['bound_ms']:.4f} ({rows[-1]['bound_by']})")
        del copies
        torch.cuda.empty_cache()
    return rows


def ssm_step_report(cfg, store, gen):
    """Per rung, batch 4: one decode step's wall (host clock, unprofiled,
    mean of ``SSM_STEP_REPS``) and device busy (profiled), its K1-K3
    (profiled, and replayed: the step's calls in one CUDA graph on random
    activations of their shapes) beside the bytes they read and that
    bound, and the SSM state update (``ssd_decode_step`` over every layer
    at batch 4, each new state written into the cache's, replayed) beside
    its bound (the state read and written once)."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import mamba2
    from repro_torch.models.layers import packed_linear
    from repro_torch.serving import ServeEngine

    L, H, P, N = cfg.num_layers, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    out = {}
    for rung in range(3):
        engine = ServeEngine(cfg, store, max_batch=BATCH, max_len=MAX_LEN)
        engine.ensure_mode(budget_for(store, rung))
        params = store.params()
        model = engine.model
        _, c = model.prefill(params, prompt_tokens(make_requests(80 + rung, cfg.vocab_size),
                                                   DEVICE))
        cache = model.make_cache(BATCH, MAX_LEN)
        for key, v in c.items():
            if key in ("k", "v"):
                cache[key][:, :, :PROMPT] = v
            else:
                cache[key] = v
        tok = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=gen,
                                       device=DEVICE)}
        step = lambda: model.decode_step(params, tok, cache)  # noqa: E731
        step()
        walls = [_timed(step)[1] for _ in range(SSM_STEP_REPS)]
        _, _, ev = _events(step)
        items, nbytes = [], 0
        for _, views, reads, K in _ssm_matmul_leaves(cfg, params):
            x = torch.randn(BATCH, K, generator=gen, device=DEVICE).bfloat16()
            for w in views:
                items += [(x, w)] * reads
                per = (sum(w.stream_nbytes()[:rung + 1]) + w.nbytes_scales())
                nbytes += reads * (per // L if len(views) == L else per)
        head = params["lm_head"]["w"]
        k13_ms = time_graph_ms(lambda i: [packed_linear(
            x, w, torch.float32 if w is head else None, route=dispatch.DECODE)
            for x, w in items], 2, reps=3)
        state = torch.zeros((L, BATCH, H, P, N), dtype=torch.float32, device=DEVICE)
        xs = torch.randn(BATCH, H, P, generator=gen, device=DEVICE).bfloat16()
        dts = torch.rand(BATCH, H, generator=gen, device=DEVICE)
        A = -torch.rand(H, generator=gen, device=DEVICE)
        Bs, Cs = (torch.randn(BATCH, N, generator=gen, device=DEVICE).bfloat16()
                  for _ in range(2))

        def update(i):
            for layer in range(L):
                state[layer] = mamba2.ssd_decode_step(xs, dts, A, Bs, Cs, state[layer])[1]
        state_ms = time_graph_ms(update, 2, reps=3)
        state_bytes = 2 * state.numel() * 4
        r = {"wall_ms": 1e3 * sum(walls) / len(walls), "device_busy_ms": sum(t for _, t in ev),
             "device_kernels": len(ev),
             "k1_k3_profiled_ms": _ms(ev, *K1_K3_NAMES), "k1_k3_replayed_ms": k13_ms,
             "k1_k3_launches": len(items), "k1_k3_bytes": nbytes,
             "k1_k3_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "state_update_ms": state_ms, "state_bytes_read_and_written": state_bytes,
             "state_update_bound_ms": state_bytes / HBM_BYTES_PER_S * 1e3}
        r["device_idle_share"] = 1 - r["device_busy_ms"] / r["wall_ms"]
        out[f"rung{rung}"] = r
        log(f"[ssm-step] {cfg.name} rung {rung} batch {BATCH}: decode step wall "
            f"{r['wall_ms']:.2f} ms, device busy {r['device_busy_ms']:.2f} ms (idle "
            f"{r['device_idle_share']:.1%}) in {len(ev)} kernels; {len(items)} K1-K3 launches, "
            f"{r['k1_k3_profiled_ms']:.2f} ms profiled, {k13_ms:.3f} ms replayed, reading "
            f"{nbytes / 1e9:.3f} GB (bound {r['k1_k3_bound_ms']:.3f} ms); state update "
            f"{state_ms:.3f} ms over {L} layers ({state_bytes / 1e9:.3f} GB read and "
            f"written, bound {r['state_update_bound_ms']:.3f} ms)")
        del engine, cache, c, items, state
    return out


def ssm_flash(cfg, gen, batch, prompt):
    """K5 at the hybrid's long-prompt shape (head dim 80, padded to 128 in
    shared memory) against its plain version, as phase 4 holds it, timed
    beside the plain version and ``scaled_dot_product_attention``."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import ops as fa

    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = (torch.randn(batch, prompt, h, hd, generator=gen, device=DEVICE).bfloat16()
               for h in (Hq, Hkv, Hkv))
    err, peak, row, ctl_err, ctl_row = check_flash(
        q, k, v, f"S={prompt} {Hq}/{Hkv} heads of {hd}", tag=cfg.name)
    ms = time_graph_ms(lambda i: fa.flash_attention(q, k, v), 10)
    with dispatch.reference_pass():
        plain_ms = time_ms(lambda i: fa.flash_attention(q, k, v), 3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_graph_ms(lambda i: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    nbytes, flops = flash_cost(q, k)
    r = _row("flash_attention", f"hd={hd} S={prompt}", prompt, "bfloat16", err, ms, plain_ms,
             nbytes, flops, PEAK_FLOPS[torch.bfloat16], lib_ms, max_abs_ref=peak,
             worst_row_rel=row, control_drop_tile={"err_over_max": ctl_err / peak,
                                                   "worst_row_rel": ctl_row},
             B=batch, S=prompt, Hq=Hq, Hkv=Hkv, hd=hd)
    log(f"[{cfg.name}] K5 at {batch}x{prompt}, {Hq}/{Hkv} heads of {hd}: {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")
    return r


def _first_layers(cfg, params, n):
    """``cfg`` and ``params`` cut to their first ``n`` layers (the leading
    axis of every stacked leaf; the hybrid's shared block is kept whole)."""
    from repro_torch import tree
    from repro_torch.core.nesting import NestedTensor

    def cut(_, x):
        if isinstance(x, NestedTensor):
            return dataclasses.replace(
                x, w_base=x.w_base[:n], scale=x.scale[:n], shape=(n,) + x.shape[1:],
                deltas=tuple(None if d is None else d[:n] for d in x.deltas))
        return x[:n]
    return (dataclasses.replace(cfg, num_layers=n),
            dict(params, blocks=tree.map_with_path(cut, params["blocks"])))


def long_prefill_check(cfg, store, toks):
    """The long prefill's bf16 kernel path at rung 2 against the plain bf16
    pass on the same tree (last-position logits, relative to max |logit|),
    at full depth and at the first ``SSM_SHALLOW`` layers, each beside its
    one-stream-short control: the kernel path at rung 1 against the same
    plain pass, what a kernel that dropped the finest delta stream would
    read.  Each sound reading must be at most its limit in
    ``SSM_LONG_TOL`` and each control above it.  Every depth is read
    before a failure is raised."""
    from repro_torch.core.nesting import set_tree_rung
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import make_model

    store.to_rung(2)
    params = store.params()
    out, ok = {}, True
    for depth, tol in zip((cfg.num_layers, SSM_SHALLOW), SSM_LONG_TOL[cfg.name]):
        c, p = (cfg, params) if depth == cfg.num_layers else _first_layers(cfg, params, depth)
        model = make_model(c, device=DEVICE)
        k, _ = model.prefill(p, toks)
        short, _ = model.prefill(set_tree_rung(p, 1), toks)
        with dispatch.reference_pass():
            plain, _ = model.prefill(p, toks)
        r = {"bf16_kernel_vs_bf16_plain": _rel(k, plain),
             "one_stream_short_vs_bf16_plain": _rel(short, plain), "tol": tol,
             "finite": all(bool(t.isfinite().all()) for t in (k, short, plain))}
        ok = ok and r["finite"] and (r["bf16_kernel_vs_bf16_plain"] <= tol
                                     < r["one_stream_short_vs_bf16_plain"])
        out[f"layers{depth}"] = r
        log(f"[ssm] {cfg.name} long prefill {tuple(toks['tokens'].shape)} at rung 2, {depth} "
            f"layers: bf16 kernel vs plain bf16 {r['bf16_kernel_vs_bf16_plain']:.3e} (tol "
            f"{tol:.1e}); one stream short (rung 1) "
            f"{r['one_stream_short_vs_bf16_plain']:.3e} (must exceed it)")
        del model, k, short, plain
    if not ok:
        raise AssertionError(f"{cfg.name} long prefill check failed: {out}")
    return out


def _ssm_long_requests(arch, phase, vocab):
    from repro_torch.serving import Request

    batch, prompt, new = SSM_LONG[arch]
    rng = np.random.default_rng(500 + phase)
    return [Request(i, rng.integers(0, vocab, size=prompt).astype(np.int32),
                    max_new_tokens=new) for i in range(batch)]


def phase_ssm_model(arch, gen):
    """One model of phase 7 at full width with every layer, served from the
    nested (8, 6, 4) tree; see the module docstring."""
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import QuantRecipe, quantize
    from repro_torch.core.switching import NestQuantStore
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import init_params, make_model
    from repro_torch.serving import KVCacheConfig, LoadAdaptivePolicy, ServeEngine
    from repro_torch.serving.kv_cache import kv_bytes_per_token

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    L, every = cfg.num_layers, cfg.hybrid_attn_every
    napps = L // every if every else 0
    torch.cuda.reset_peak_memory_stats()
    params, init_s = _timed(lambda: init_params(cfg, seed=0, device=DEVICE))
    nested, quant_s = _timed(lambda: quantize(params, QuantRecipe(bits=BITS), device=DEVICE))
    del params
    store = NestQuantStore(nested, mode="part", device=DEVICE)
    del nested
    torch.cuda.empty_cache()
    quant_peak = torch.cuda.max_memory_allocated()
    rung_bytes = [store.rung_resident_bytes(r) for r in range(3)]
    lb = store.ladder_bytes()
    per_forward = ssm_matmuls(cfg)
    counted = sum(L if p.startswith("['blocks']") else napps if p.startswith("['shared']") else 1
                  for p, _ in store.nested_leaves() if "embed" not in p)
    if counted != per_forward:
        raise AssertionError(f"{arch}: {counted} nested matmuls per forward, want {per_forward}")
    log(f"[ssm] {arch} at full width, {L} layers ({napps} shared-block applications): init "
        f"{init_s:.1f}s, adaptive (8,6,4) quantize {quant_s:.1f}s (peak device memory "
        f"{quant_peak / 1e9:.2f} GB); base={lb['base']} deltas={lb['deltas']} "
        f"scales={lb['scales']} fp={lb['fp']} rung bytes={rung_bytes}; {per_forward} K1-K3 "
        f"launches per forward")
    total = {n: [0, 0, 0] for n in KERNELS}

    def add(launches):
        for n, v in launches.items():
            total[n] = [a + b for a, b in zip(total[n], v)]

    # 1. warm-up, then the short serve at rungs 2, 0, 1, 2 (the main path
    # starts after warm-up): no library, plan, counter buffer or decode
    # instantiation is new
    engine = ServeEngine(cfg, store, max_batch=BATCH, max_len=MAX_LEN)
    calls, warm_s = _timed(lambda: engine.warmup(PROMPT, batch=BATCH))
    built, instances = _build_state(), set(dispatch.DEC_INSTANCES)
    dispatch.reset_counters()
    serve = []
    for phase, rung in enumerate(SERVE_SCHEDULE):
        reqs = make_requests(phase, cfg.vocab_size)
        wall, launches = _ssm_generate(engine, reqs, f"{arch} serve phase {phase}",
                                       budget=budget_for(store, rung))
        if store.rung != rung:
            raise AssertionError(f"{arch} serve phase {phase}: rung {store.rung}, want {rung}")
        add(launches)
        serve.append({"rung": rung, "wall_s": wall, "launches": launches,
                      "tokens": [r.out_tokens for r in reqs]})
        log(f"[ssm] {arch} serve phase {phase}: rung {rung}, {BATCH}x{NEW_TOKENS} tokens in "
            f"{wall:.3f}s; K1-K3 (all, decode body, tensor cores) {launches}")
    if _build_state() != built or dispatch.DEC_INSTANCES != instances:
        raise AssertionError(f"{arch}: the serve after warm-up built something: "
                             f"{built} -> {_build_state()}, decode instantiations "
                             f"{sorted(instances)} -> {sorted(dispatch.DEC_INSTANCES)}")
    log(f"[ssm] {arch} warm-up: {calls} calls in {warm_s:.1f}s; the serve after it loaded no "
        f"library, filled no plan, kept the counter buffer and launched no new decode "
        f"instantiation ({sorted(instances)})")

    # 2. the long prompt: mamba2 at rung 2; zamba2 on the nested KV cache,
    # queue depths 0 then 8 (KV and weight rungs 2, then 1)
    batch, prompt, new = SSM_LONG[arch]
    max_len = prompt + new + 4
    kv = KVCacheConfig(bits=(4, 6, 8), page=KV_PAGE, rounding="rtn") if every else None
    long_eng = ServeEngine(cfg, store, max_batch=batch, max_len=max_len, kv=kv,
                           policy=LoadAdaptivePolicy(high_depth=8, low_depth=0) if kv else None)
    runs = ((0, None), (8, None)) if kv else ((None, budget_for(store, 2)),)
    long_info = []
    for phase, (depth, budget) in enumerate(runs):
        reqs = _ssm_long_requests(arch, phase, cfg.vocab_size)
        wall, launches = _ssm_generate(long_eng, reqs, f"{arch} long prompt {phase}",
                                       budget=budget, queue_depth=depth, flash=napps)
        add(launches)
        info = {"rung": store.rung, "wall_s": wall, "launches": launches}
        if kv:
            want = kv_bytes_per_token(kv, long_eng.kv.rung, napps, cfg.num_kv_heads,
                                      cfg.head_dim) * max_len
            if long_eng._kv_layers() != napps or long_eng.kv_bytes_per_seq() != want:
                raise AssertionError(f"{arch}: KV bytes per sequence "
                                     f"{long_eng.kv_bytes_per_seq()}, want {want} over "
                                     f"{napps} attention layers")
            info.update(kv_rung=long_eng.kv.rung, kv_pages=len(long_eng.kv.pages),
                        kv_bytes_per_seq=want)
            if phase == 0:            # held against the dense prefill K/V below
                rendered = [t.clone() for t in long_eng.kv.render(2)]
        long_info.append(info)
        log(f"[ssm] {arch} long prompt {batch}x{prompt} + {new} tokens at rung {store.rung} in "
            f"{wall:.3f}s; K5 x{napps}; K1-K3 {launches}"
            + (f"; KV rung {info['kv_rung']}, {info['kv_pages']} pages, "
               f"{info['kv_bytes_per_seq']} B per sequence over {napps} layers" if kv else ""))
    if kv:
        events = [tuple(e) for e in long_eng.kv.ledger.events]
        if events != long_eng.kv.expected_events or [e[:2] for e in events] != [(2, 1)] or any(
                pin + pout != long_eng.kv.delta_bytes(min(f, t)) for f, t, pin, pout in events):
            raise AssertionError(f"{arch}: KV ledger {events}, expected "
                                 f"{long_eng.kv.expected_events}")
        log(f"[ssm] {arch} KV ledger {events} equals its metadata bytes")
    main_counts = _k_counts()            # the main path ends here
    if ({n: list(main_counts[n][:3]) for n in KERNELS} != total
            or main_counts["flash_attention"][0] != napps * len(runs)
            or any(v[3] for v in main_counts.values())):
        raise AssertionError(f"{arch} main path: counters {main_counts}, checked runs {total}")
    if kv:
        # the first long run's top-rung rendering against its dense prefill
        # K/V (at that run's weight rung)
        store.to_rung(long_info[0]["rung"])
        _, dense = long_eng.model.prefill(store.params(), prompt_tokens(
            _ssm_long_requests(arch, 0, cfg.vocab_size), DEVICE))
        render = {t: _rel_norm(r, dense[t][:, :, :r.shape[2]])
                  for t, r in zip("kv", rendered)}
        long_info[0]["render_top_rel"] = render
        if max(render.values()) > RENDER_TOP_TOL:
            raise AssertionError(f"{arch}: top-rung render {render} > {RENDER_TOP_TOL}")
        log(f"[ssm] {arch} rendered top-rung K/V vs dense prefill (relative norm): k "
            f"{render['k']:.3e} v {render['v']:.3e} (tol {RENDER_TOP_TOL})")
        del dense, rendered
    del engine, long_eng

    # 3. the reference pass, the long prefill against its plain version, the
    # rows, the decode-step report and K5 at head dim 80 (none counted)
    tol = SSM_BF16_TOL[arch]
    reference, ref_s = _timed(lambda: phase_reference(cfg, store, f"{arch}-reference", tol))
    log(f"[ssm] {arch} reference pass at rungs 2, 0, 1 took {ref_s:.1f}s")
    toks = prompt_tokens(_ssm_long_requests(arch, 0, cfg.vocab_size), DEVICE)
    long_check = long_prefill_check(cfg, store, toks)
    params = store.params()
    model = make_model(cfg, device=DEVICE)
    _, pre_wall, ev = _events(lambda: model.prefill(params, toks))
    long_prefill = {"wall_ms": pre_wall * 1e3, "device_busy_ms": sum(t for _, t in ev),
                    "k1_k3_ms": _ms(ev, *K1_K3_NAMES), "k5_ms": _ms(ev, *K5_NAMES),
                    "check": long_check}
    log(f"[ssm] {arch} long prefill {batch}x{prompt} at rung 2 (profiled): wall "
        f"{long_prefill['wall_ms']:.1f} ms, device busy {long_prefill['device_busy_ms']:.1f} "
        f"ms, K1-K3 {long_prefill['k1_k3_ms']:.2f} ms, K5 {long_prefill['k5_ms']:.3f} ms")
    del model, params
    rows = ssm_rows(cfg, store, gen, batch, prompt)
    steps = ssm_step_report(cfg, store, gen)
    del store
    torch.cuda.empty_cache()
    flash = ssm_flash(cfg, gen, batch, prompt) if every else None
    seconds = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated()
    log(f"[ssm] {arch} took {seconds:.1f}s; peak device memory {peak / 1e9:.2f} GB "
        f"({smi_line()})")
    return {"config": {"name": cfg.name, "num_layers": L, "d_model": cfg.d_model,
                       "d_inner": cfg.d_inner, "ssm_heads": cfg.ssm_heads,
                       "ssm_state": cfg.ssm_state, "shared_applications": napps},
            "init_s": init_s, "quantize_s": quant_s, "quantize_peak_mem_bytes": quant_peak,
            "rung_bytes": rung_bytes, "per_forward": per_forward, "warmup_calls": calls,
            "serve": serve, "long": long_info, "reference": reference, "reference_s": ref_s,
            "long_prefill": long_prefill, "rows": rows, "decode_steps": steps,
            "flash_check": flash, "seconds": seconds, "peak_mem_bytes": peak,
            "launches": {n: tuple(main_counts[n][:3]) for n in KERNELS},
            "flash_launches": main_counts["flash_attention"][0]}


def phase_ssm(gen):
    """Phase 7: mamba2-780m, then zamba2-2.7b; see the module docstring."""
    t0 = time.perf_counter()
    out = {arch: phase_ssm_model(arch, gen) for arch in SSM_ARCHS}
    log(f"[ssm] phase 7 took {time.perf_counter() - t0:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 8: training on the card, then NestQuant of the trained weights
# ---------------------------------------------------------------------------
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_CHECK_LAYERS = 2             # the gradient check's depth (of 28)
# peak learning rate 3e-4: at the CLI's default of 3e-3 the full-width
# model's loss rose over 24 steps (12.18 -> 12.49, a gradient-norm spike
# of 41 at step 14; PERF.md), which says nothing of the port
# 8 steps: the whole script's time limit also holds phase 10's ranks;
# warmup 4, so the last 4 steps run the schedule's cosine decay
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 8, 4, 3e-4
F32_LOSS_TOL, F32_GRAD_TOL = 1e-5, 1e-4
# bf16 gradients against the plain bf16 pass, per leaf relative to the
# leaf's max |g| (the worst leaf): about the geometric mean of the sound
# reading (1.28e-2) and the control (K5 outside the Function: q/k/v get no
# gradient, 1.015) on the H100 (PERF.md)
BF16_GRAD_TOL = 0.1
SCORE_STEPS = (10_000, 10_001)     # held-out batches of the training stream
# a nested loss against the same tree's plain pass, |kernel - plain| /
# plain: about the geometric mean of the worst sound reading (4.1e-5) and
# the lowest one-stream-short control (1.07e-3) on the H100 (PERF.md)
SCORE_TOL = 2e-4
TRAIN_CLI_STEPS, TRAIN_CLI_FAIL_AT = 6, 5
TRAIN_CLI = ["--arch", "qwen2-1.5b", "--layers", "2", "--batch", "1", "--seq", "2048",
             "--steps", str(TRAIN_CLI_STEPS), "--ckpt-every", "4"]


def train_config(layers: int, dtype: str):
    """Full-width qwen2-1.5b with ``layers`` layers, parameters and compute in
    ``dtype``, remat on."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen2-1.5b"), num_layers=layers, dtype=dtype,
                               compute_dtype=dtype, remat=True)


def train_batch(cfg, step: int):
    """Batch ``step`` of the seeded synthetic stream on the card."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import to_device

    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    return to_device(data.batch(step), DEVICE)


def loss_and_grads(model, params, batch):
    """(loss, {keystr: gradient or None}) of one ``loss_fn`` and its backward."""
    from repro_torch import tree

    flat = tree.flatten_with_path(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    loss = model.loss_fn(tree.unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {k: g for (k, _), g in zip(flat, grads)}


class _K5OutsideFunction:
    """The gradient check's control: the training forward's K5 launched
    outside ``BlockwiseAttention``.  Its output has no grad_fn, so q, k and
    v, and the projections before them, get no gradient through attention:
    the failure the Function exists to prevent."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import kernel, ops

        self.ops, self.before = ops, ops.blockwise_attention
        ops.blockwise_attention = lambda q, k, v, causal, kv_block, q_offset=0: (
            kernel.flash_attention(q.detach(), k.detach(), v.detach(), q_offset=q_offset))

    def __exit__(self, *exc):
        self.ops.blockwise_attention = self.before


def grad_gap(got, want):
    """(worst leaf's max |g - g_plain| / max |g_plain|, that leaf); a
    missing gradient reads as zeros."""
    worst, where = 0.0, None
    for key, w in want.items():
        g = torch.zeros_like(w) if got[key] is None else got[key]
        r = ((g.float() - w.float()).abs().max()
             / w.float().abs().max().clamp_min(1e-30)).item()
        if not math.isfinite(r) or r > worst:
            worst, where = (r if math.isfinite(r) else float("inf")), key
    return worst, where


def train_grad_check():
    """8(a): one ``loss_fn`` and its gradients at the first
    ``TRAIN_CHECK_LAYERS`` layers, batch 2 x 2048, with K5 (forward and remat
    recompute, writing its statistics; the blockwise backward) against the
    same computation under ``reference_pass``; f32 and bf16; every leaf's
    gradient nonzero; the control that loses q/k/v's gradient."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import make_model

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = train_config(TRAIN_CHECK_LAYERS, dtype)
        model = make_model(cfg, device=DEVICE)
        params = model.init(1)
        batch = train_batch(cfg, 0)
        dispatch.reset_counters()
        (loss_k, g_k), t_k = _timed(lambda: loss_and_grads(model, params, batch))
        k5 = dispatch.COUNTERS["flash_attention"]
        launches, plain = k5.launches, sum(c.plain_launches for c in dispatch.COUNTERS.values())
        if launches != 2 * cfg.num_layers or plain:
            raise AssertionError(f"train check {dtype}: K5 launched {launches} times (want "
                                 f"{2 * cfg.num_layers}: forward and recompute), {plain} plain")
        with dispatch.reference_pass():
            (loss_p, g_p), t_p = _timed(lambda: loss_and_grads(model, params, batch))
        with _K5OutsideFunction():
            loss_c, g_c = loss_and_grads(model, params, batch)
        zero = [k for k, g in g_k.items() if g is None or not bool((g != 0).any())]
        loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        gap, where = grad_gap(g_k, g_p)
        ctl, ctl_where = grad_gap(g_c, g_p)
        tol = F32_GRAD_TOL if dtype == "float32" else BF16_GRAD_TOL
        r = {"layers": cfg.num_layers, "loss": loss_k.item(), "plain_loss": loss_p.item(),
             "loss_rel": loss_rel, "grad_gap": gap, "grad_gap_leaf": where,
             "control_grad_gap": ctl, "control_leaf": ctl_where, "grad_tol": tol,
             "k5_launches": launches, "zero_grad_leaves": zero, "kernel_s": t_k,
             "plain_s": t_p}
        log(f"[train] check {dtype}, {cfg.num_layers} layers, {TRAIN_BATCH}x{TRAIN_SEQ}: loss "
            f"{r['loss']:.6f} vs plain {r['plain_loss']:.6f} (rel {loss_rel:.2e}); worst leaf "
            f"grad gap {gap:.3e} at {where} (tol {tol:.1e}); control (K5 outside the "
            f"Function) {ctl:.3e} at {ctl_where}; K5 launches {launches}; {t_k:.2f}s kernel, "
            f"{t_p:.2f}s plain")
        ok = (not zero and gap <= tol and ctl > tol
              and (dtype != "float32" or loss_rel <= F32_LOSS_TOL))
        out[dtype] = r
        del params, g_k, g_p, g_c, model
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"train check {dtype} failed: {r}")
    return out


class _SpanTimers:
    """CUDA events around every blockwise attention backward and every
    AdamW update while active (the autograd thread records on the forward's
    stream): device ms per span, read after a synchronize."""

    def __enter__(self):
        from repro_torch.models import attention
        from repro_torch.optim import adamw

        self.spans = {"attention_backward": [], "optimizer": []}
        self.saved = (attention._flash_bwd, adamw.apply_update)

        def wrap(fn, key):
            def timed(*a, **kw):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                res = fn(*a, **kw)
                end.record()
                self.spans[key].append((start, end))
                return res
            return timed

        attention._flash_bwd = wrap(self.saved[0], "attention_backward")
        adamw.apply_update = wrap(self.saved[1], "optimizer")
        return self

    def take(self):
        torch.cuda.synchronize()
        out = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self.spans.items()}
        for v in self.spans.values():
            v.clear()
        return out

    def __exit__(self, *exc):
        from repro_torch.models import attention
        from repro_torch.optim import adamw

        attention._flash_bwd, adamw.apply_update = self.saved


def train_run():
    """8(b): all 28 layers, bf16 parameters, f32 AdamW state, remat, batch 2 x
    2048, ``TRAIN_STEPS`` steps of the CLI's train step (warmup
    ``TRAIN_WARMUP``): every step launches K5 56 times (28 forward, 28 in
    the recompute), none plain, and the loss falls.  Each step is profiled
    (device activity only)."""
    from repro_torch import tree
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import make_model
    from repro_torch.optim import adamw

    cfg = train_config(28, "bfloat16")
    model = make_model(cfg, device=DEVICE)
    params = model.init(2)
    opt = adamw.init_state(params)
    n_params = sum(p.numel() for p in tree.leaves(params))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6.0 * n_params * tokens
    step_fn = make_train_step(model, peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP, total=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    steps, k5_total = [], 0
    with _SpanTimers() as timers:
        for step in range(TRAIN_STEPS):
            batch = train_batch(cfg, step)
            dispatch.reset_counters()
            (params, opt, metrics), wall, ev = _events(
                lambda p=params, o=opt, b=batch, s=step: step_fn(p, o, b, s))
            spans = timers.take()
            k5 = dispatch.COUNTERS["flash_attention"]
            plain = sum(c.plain_launches for c in dispatch.COUNTERS.values())
            if k5.launches != 2 * cfg.num_layers or plain:
                raise AssertionError(f"train step {step}: K5 launched {k5.launches} times "
                                     f"(want {2 * cfg.num_layers}), {plain} plain")
            k5_total += k5.launches
            busy = sum(t for _, t in ev)
            r = {"step": step, "loss": metrics["loss"].item(), "lr": metrics["lr"].item(),
                 "grad_norm": metrics["grad_norm"].item(), "wall_ms": wall * 1e3,
                 "device_busy_ms": busy, "k5_ms": _ms(ev, *K5_NAMES),
                 "attention_backward_ms": spans["attention_backward"],
                 "optimizer_ms": spans["optimizer"], "tokens_per_s": tokens / wall,
                 "mfu": flops / wall / PEAK_FLOPS[torch.bfloat16], "kernels": len(ev),
                 "peak_mem_bytes": torch.cuda.max_memory_allocated()}
            steps.append(r)
            log(f"[train] step {step:2d}: loss {r['loss']:.4f} lr {r['lr']:.2e} gnorm "
                f"{r['grad_norm']:.3f}; wall {r['wall_ms']:.1f} ms, busy {busy:.1f} ms, K5 "
                f"{r['k5_ms']:.2f} ms, attention backward {r['attention_backward_ms']:.1f} ms, "
                f"optimizer {r['optimizer_ms']:.1f} ms; {r['tokens_per_s']:.0f} tokens/s, "
                f"MFU {r['mfu']:.3f}; peak {r['peak_mem_bytes'] / 1e9:.2f} GB")
    first = sum(r["loss"] for r in steps[:4]) / 4
    last = sum(r["loss"] for r in steps[-4:]) / 4
    # the blockwise backward's five products per KV block of 512 keys, on
    # the query rows at or after the block (``attention._flash_bwd``)
    rows = sum(TRAIN_SEQ - j0 for j0 in range(0, TRAIN_SEQ, 512))
    bwd_flops = (5 * 2.0 * TRAIN_BATCH * cfg.num_heads * cfg.head_dim * 512 * rows
                 * cfg.num_layers)
    # AdamW reads p, g (bf16), m, v, master and writes m, v, master, p
    opt_bytes = n_params * (2 + 2 + 12 + 12 + 2)
    bounds = {"attention_backward_f32_ms": bwd_flops / PEAK_FLOPS[torch.float32] * 1e3,
              "attention_backward_bf16_ms": bwd_flops / PEAK_FLOPS[torch.bfloat16] * 1e3,
              "optimizer_ms": opt_bytes / HBM_BYTES_PER_S * 1e3}
    out = {"params": n_params, "flops_per_step": flops, "steps": steps,
           "mean_loss_first4": first, "mean_loss_last4": last, "k5_launches": k5_total,
           "bounds": bounds}
    log(f"[train] {n_params / 1e9:.3f} B parameters, {flops / 1e12:.1f} TFLOP per step "
        f"(6 N tokens); mean loss of the first 4 steps {first:.4f}, last 4 {last:.4f}; "
        f"bounds: attention backward {bwd_flops / 1e12:.2f} TFLOP, "
        f"{bounds['attention_backward_f32_ms']:.1f} ms at the f32 rate, "
        f"{bounds['attention_backward_bf16_ms']:.2f} ms at bf16's; AdamW "
        f"{opt_bytes / 1e9:.1f} GB, {bounds['optimizer_ms']:.1f} ms")
    if not last < first:
        raise AssertionError(f"training did not lower the loss: {first} -> {last}")
    del opt
    torch.cuda.empty_cache()
    return cfg, params, out


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


class TrainCliRuns:
    """8(d)'s train CLI subprocesses on the card at full width
    (``TRAIN_CLI``), run by a thread: straight through (its one checkpoint
    the last step's) and with ``--simulate-failure-at 5`` (exit 42) side
    by side, then resumed.  ``main`` starts them after phase 9 and checks
    them after phase 10 (:func:`train_cli_check`): they wait on the disk,
    phase 10's rank processes on the host, and the card holds both."""

    def __init__(self):
        import shutil
        import threading

        self.base = ROOT / "build" / "train_ckpt"
        shutil.rmtree(self.base, ignore_errors=True)
        self.dirs = {k: self.base / k for k in ("straight", "resumed", "again")}
        self.procs, self.lines, self.error, self.stopped = [], [], None, False
        self.out = {"peak_disk_bytes": 0}
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _cli(self, name, *extra):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
               "--ckpt-dir", str(self.dirs[name]), *extra]
        with self._lock:
            if self.stopped:
                raise RuntimeError("the train CLI runs were stopped")
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            self.procs.append(proc)
        return proc

    def _finish(self, proc, want_rc, what):
        text, _ = proc.communicate(timeout=600)
        if proc.returncode != want_rc:
            raise AssertionError(f"train CLI {what} exited {proc.returncode}, want "
                                 f"{want_rc}:\n{text[-3000:]}")
        self.lines += [f"{what}: {line}" for line in text.strip().splitlines()]
        return text

    def _disk(self):
        self.out["peak_disk_bytes"] = max(self.out["peak_disk_bytes"], _dir_bytes(self.base))

    def _run(self):
        try:
            t0 = time.perf_counter()
            straight = self._cli("straight", "--ckpt-every", str(TRAIN_CLI_STEPS))
            crashed = self._cli("resumed", "--simulate-failure-at", str(TRAIN_CLI_FAIL_AT))
            self._finish(straight, 0, "straight")
            text = self._finish(crashed, 42, "crashed")
            self.out["straight_and_crashed_s"] = time.perf_counter() - t0
            self._disk()
            if f"[failure-injection] dying at step {TRAIN_CLI_FAIL_AT}" not in text:
                raise AssertionError("the crashed run did not die where asked")
            t0 = time.perf_counter()
            text = self._finish(self._cli("resumed"), 0, "resumed")
            self.out["resumed_s"] = time.perf_counter() - t0
            self._disk()
            if "[resume] from step 4" not in text:
                raise AssertionError("the resumed run did not resume from step 4")
        except BaseException as e:          # raised again by ``wait``
            self.error = e

    def wait(self):
        """The runs' times and peak disk once they ended (raises what they
        raised)."""
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.out

    def stop(self):
        """End every process still running and remove every directory."""
        import shutil

        with self._lock:
            self.stopped = True
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
        self._thread.join()
        shutil.rmtree(self.base, ignore_errors=True)


def train_cli_check(runs):
    """8(d), checked: wait for :class:`TrainCliRuns`; the resumed run's
    step-6 checkpoint must equal the straight run's bit for bit.  Both are
    restored with ``CheckpointManager`` (timed) and compared on the card,
    and one is saved again (timed); every directory is removed."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import make_model
    from repro_torch.optim import adamw

    t0 = time.perf_counter()
    try:
        out = dict(runs.wait())
        wait_s = time.perf_counter() - t0
        for line in runs.lines:
            log(f"[train-cli] {line}")
        dirs = runs.dirs
        model = make_model(train_config(2, "bfloat16"), device=DEVICE)
        params = model.init(0)
        tmpl = {"params": params, "opt": adamw.init_state(params)}
        got = {}
        for name in ("straight", "resumed"):
            (tree_, manifest), t = _timed(
                lambda n=name: CheckpointManager(str(dirs[n])).restore(tmpl, step=6))
            got[name] = (tree_, manifest, t)
        from repro_torch.checkpoint.manager import _flatten
        a, b = (dict(_flatten(got[n][0])) for n in ("straight", "resumed"))
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        nbytes = _dir_bytes(dirs["straight"] / "step_0000000006")
        shutil.rmtree(dirs["straight"])
        shutil.rmtree(dirs["resumed"])
        _, t_save = _timed(lambda: CheckpointManager(str(dirs["again"])).save(
            6, got["straight"][0], extra=got["straight"][1]["extra"]))
        runs._disk()
    finally:
        runs.stop()
    out.update({"leaves": len(a), "differing_leaves": differ, "checkpoint_bytes": nbytes,
                "save_s": t_save, "restore_s": [got[n][2] for n in ("straight", "resumed")],
                "data_step": [got[n][1]["extra"]["data_step"] for n in ("straight", "resumed")],
                "waited_after_phase_10_s": wait_s})
    log(f"[train-cli] resumed step-6 checkpoint vs straight: {len(a) - len(differ)} of "
        f"{len(a)} leaves bit for bit; checkpoint {nbytes / 1e9:.2f} GB, save "
        f"{t_save:.1f}s, restore {out['restore_s'][0]:.1f} / {out['restore_s'][1]:.1f}s; "
        f"runs {out['straight_and_crashed_s']:.1f}s (straight and crashed side by side) + "
        f"{out['resumed_s']:.1f}s (resumed), beside phase 10, waited for {wait_s:.1f}s after "
        f"it; peak disk {out['peak_disk_bytes'] / 1e9:.1f} GB")
    del got, a, b, tmpl, params
    torch.cuda.empty_cache()
    if differ or out["data_step"] != [6, 6]:
        raise AssertionError(f"resume is not bitwise: {differ[:8]}, data steps "
                             f"{out['data_step']}")
    return out


def train_score(cfg, params):
    """8(d): NestQuant the trained weights (``api.quantize``, adaptive
    (8, 6, 4)) into a ``NestQuantStore``; ``loss_fn`` on the held-out
    batches at rungs 2, 1, 0 through K1-K3 (one forward: 197 launches of
    the rung's kernel and 28 of K5, none plain), each within
    ``SCORE_TOL`` of the same tree's plain pass, which the tree one stream
    short (the kernel path at the rung below) must exceed; the dense
    trained weights' loss beside them."""
    from repro_torch.api import NestQuantStore, QuantRecipe, make_model, quantize
    from repro_torch.core.nesting import set_tree_rung
    from repro_torch.kernels import dispatch

    model = make_model(cfg, device=DEVICE)
    batches = [train_batch(cfg, s) for s in SCORE_STEPS]
    with torch.no_grad():
        dispatch.reset_counters()
        dense = [model.loss_fn(params, b).item() for b in batches]
        k5 = dispatch.COUNTERS["flash_attention"].launches
        nested, t_q = _timed(lambda: quantize(params, QuantRecipe(bits=BITS), device=DEVICE))
        store = NestQuantStore(nested, mode="full", device=DEVICE)
        del nested
        per_forward = packed_linears_per_forward(store)
        rung_bytes = [store.rung_resident_bytes(r) for r in range(store.num_rungs)]
        log(f"[score] adaptive (8, 6, 4) quantize of the trained weights {t_q:.1f}s; "
            f"resident bytes per rung {rung_bytes}; dense loss "
            f"{', '.join(f'{x:.5f}' for x in dense)}")
        rungs, launches, failures = {}, {n: [0, 0, 0] for n in KERNELS}, []
        for rung in (2, 1, 0):
            store.to_rung(rung)
            tree_ = store.params()
            name = next(n for n, v in KERNELS.items() if v[0] == rung)
            r = {"kernel": [], "plain": [], "control": []}
            for b in batches:
                dispatch.reset_counters()
                r["kernel"].append(model.loss_fn(tree_, b).item())
                c = dispatch.COUNTERS
                got = (c[name].launches, c[name].tc_launches, c["flash_attention"].launches,
                       sum(x.plain_launches for x in c.values()))
                for n in KERNELS:
                    launches[n][0] += c[n].launches
                    launches[n][1] += c[n].dec_launches
                    launches[n][2] += c[n].tc_launches
                if got[0] != per_forward or got[2] != cfg.num_layers or got[3]:
                    raise AssertionError(f"score rung {rung}: {name} {got[0]} launches (want "
                                         f"{per_forward}), K5 {got[2]} (want "
                                         f"{cfg.num_layers}), plain {got[3]}")
                r["tc_launches"] = got[1]
                k5 += got[2]
                with dispatch.reference_pass():
                    r["plain"].append(model.loss_fn(tree_, b).item())
                if rung > 0:
                    r["control"].append(model.loss_fn(set_tree_rung(tree_, rung - 1), b).item())
            r["rel"] = max(abs(k - p) / p for k, p in zip(r["kernel"], r["plain"]))
            r["control_rel"] = (max(abs(k - p) / p for k, p in zip(r["control"], r["plain"]))
                                if rung > 0 else None)
            r["gap_to_dense"] = [k - d for k, d in zip(r["kernel"], dense)]
            rungs[rung] = r
            log(f"[score] rung {rung}: loss {', '.join(f'{x:.5f}' for x in r['kernel'])} "
                f"(plain {', '.join(f'{x:.5f}' for x in r['plain'])}; rel "
                f"{r['rel']:.2e}, tol {SCORE_TOL:.1e}"
                + (f"; one stream short {r['control_rel']:.2e}" if rung > 0 else "")
                + f"); gap to dense {', '.join(f'{x:+.5f}' for x in r['gap_to_dense'])}; "
                f"{name} {per_forward} launches a forward ({r['tc_launches']} on the tensor "
                f"cores), K5 {cfg.num_layers}")
            if not (r["rel"] <= SCORE_TOL and (rung == 0 or r["control_rel"] > SCORE_TOL)
                    and all(math.isfinite(x) for x in r["kernel"])):
                failures.append(rung)
    out = {"quantize_s": t_q, "rung_bytes": rung_bytes, "dense_loss": dense,
           "rungs": rungs, "launches": {n: tuple(v) for n, v in launches.items()},
           "k5_launches": k5,
           "full_bit_gap": rungs[2]["gap_to_dense"], "part_bit_gap": rungs[0]["gap_to_dense"]}
    log(f"[score] full-bit (rung 2) loss gap to dense "
        f"{', '.join(f'{x:+.5f}' for x in out['full_bit_gap'])}; part-bit (rung 0) "
        f"{', '.join(f'{x:+.5f}' for x in out['part_bit_gap'])}")
    del store
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"scoring failed at rungs {failures}: {rungs}")
    return out


def phase_train():
    """Phase 8: the gradient check, training, NestQuant of the trained
    weights and scoring at every rung (the CLI's crash and resume, 8(d),
    runs beside phase 10)."""
    t0 = time.perf_counter()
    check = train_grad_check()
    cfg, params, run = train_run()
    score = train_score(cfg, params)
    del params
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"[train] phase 8 took {seconds:.1f}s ({smi_line()})")
    return {"check": check, "run": run, "score": score, "seconds": seconds,
            "k5_launches": (check["float32"]["k5_launches"] + check["bfloat16"]["k5_launches"]
                            + run["k5_launches"] + score["k5_launches"]),
            "launches": score["launches"]}


# ===========================================================================
# Phase 9: the sharded steps (distributed/), four gloo ranks sharing the card
# ===========================================================================
SHARDED_MESH = (2, 2)                  # (data, model)
SHARDED_TIMEOUT_S = 600
# (a) on the H100 (PERF.md, PR 23): the loss 7.8e-8 from the world-1
# step's (f32 partial sums over model in another order); per leaf, m and v
# 1.75e-2 of the leaf's largest value (bf16 gradients rounded per data
# rank), master 4.0e-4 of the learning rate where m is large; the control
# without the data average 1.0-1.24 and 2.0.  (Read over each whole field,
# a recompute that lost the sharding context read 0.187.)  The limit sits
# between the sound readings and the controls; ``state_gaps`` says how
# each is read.
SHARDED_LOSS_TOL = 1e-5
SHARDED_STATE_TOL = 0.1
SHARDED_SERVE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}     # phase 3's qwen2 limits
SHARDED_MOE_TOL = 1e-4
# the nested serves' depth in phases 9 and 10 (of 28, 48 and 54 layers):
# each layer and each K1/K2 launch repeats the one before it, and zamba2's
# shared block applies twice; the limits above hold per position, and the
# controls read above them from the first layer (PERF.md)
SHARDED_SERVE_LAYERS = {"qwen2-1.5b": 4, "mamba2-780m": 8, "zamba2-2.7b": 12}


def sharded_plan():
    """What phase 9 runs (read by every rank from ``plan.json``): (a) the
    train step of qwen2-1.5b at full width with 2 of its 28 layers, global
    batch 4 x 2048 in microbatches of 2, at schedule step 50 (learning rate
    half its peak); (b) qwen2-1.5b, 4 of its 28 layers, nested (4, 8) rtn
    as ``quantize_abstract`` lays it out: a prefill of 4 x 64 tokens and 8
    decode steps, f32 at rung 0 and bf16 at rung 1; (c) dbrx-132b at its
    published widths with 2 of its 40 layers, nested (4, 8), f32: a prefill
    of 4 x 8 tokens and 4 greedy decode steps."""
    return {"device": DEVICE, "mesh": list(SHARDED_MESH),
            "train": {"arch": "qwen2-1.5b", "layers": 2, "batch": 4, "seq": 2048,
                      "micro": 2, "step": 50},
            "serve": {"arch": "qwen2-1.5b", "layers": SHARDED_SERVE_LAYERS["qwen2-1.5b"],
                      "batch": 4, "prompt": 64,
                      "new": 8, "rungs": {"float32": [0], "bfloat16": [1]},
                      "dtypes": ["float32", "bfloat16"]},
            "moe": {"arch": MOE_ARCH, "layers": MOE_LAYERS, "batch": 4, "prompt": 8,
                    "new": 4, "dtype": "float32"}}


def _plan_config(part, **changes):
    from repro_torch.configs import get_config

    cfg = get_config(part["arch"])
    if part.get("layers"):
        changes["num_layers"] = part["layers"]
    return dataclasses.replace(cfg, **changes) if changes else cfg


def _rungs(part, dtype):
    """The rungs a serve part runs in ``dtype`` (``rungs``: a list for
    every dtype, or a list per dtype)."""
    rungs = part["rungs"]
    return rungs[dtype] if isinstance(rungs, dict) else rungs


def _train_shape(plan, key="train"):
    """(config, shape) of a train part."""
    from repro_torch.configs.base import ShapeConfig

    t = plan[key]
    cfg = _plan_config(t, **({"compute_dtype": t["compute"]} if t.get("compute") else {}))
    return cfg, ShapeConfig("sharded_train", "train", t["seq"], t["batch"],
                            microbatch=t["micro"])


def _train_parts(plan, key="train"):
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import to_device

    t = plan[key]
    cfg, shape = _train_shape(plan, key)
    data = SyntheticLM(DataConfig(cfg.vocab_size, t["seq"], t["batch"]), 0, 1)
    return cfg, shape, to_device(data.batch(0), plan["device"])


def _serve_shapes(part):
    from repro_torch.configs.base import ShapeConfig
    return (ShapeConfig("sharded_prefill", "prefill", part["prompt"], part["batch"]),
            ShapeConfig("sharded_decode", "decode",
                        part.get("cache", part["prompt"] + part["new"]), part["batch"]))


def _nest_as_specs(dense, nested_specs, device):
    """(4, 8) rtn nesting of exactly the leaves whose spec is nested (the
    layout of ``steps.quantize_abstract``)."""
    from repro_torch import tree
    from repro_torch.core.nesting import NestedTensor
    from repro_torch.core.recipe import QuantRecipe, quantize

    nested = {k for k, s in tree.flatten_with_path(nested_specs) if isinstance(s, NestedTensor)}
    recipe = QuantRecipe(bits=(4, 8), rounding="rtn", predicate=lambda path, _: path in nested)
    return quantize(dense, recipe, device=device)


def _dense_specs(nested_specs):
    """The dense weight's spec for each nested spec: its packed words' (the
    output dim only), which cut a dense weight into the column block whose
    nesting is this rank's block of the whole weight's."""
    from repro_torch import tree
    from repro_torch.core.nesting import NestedTensor

    return tree.map_with_path(
        lambda _, s: s.w_base if isinstance(s, NestedTensor) else s, nested_specs)


def _serve_prompt(cfg, part, device):
    g = torch.Generator(device="cpu").manual_seed(9)
    return torch.randint(0, cfg.vocab_size, (part["batch"], part["prompt"]),
                         generator=g).to(device)


def sharded_prefill(prefill, ps, ds, params, prompt, mesh):
    """The prefill -> (its last logits on this data rank's rows, the decode
    cache of ``ds["max_len"]`` positions holding the prompt)."""
    from repro_torch.distributed import steps
    from repro_torch.distributed.sharding import local_shard, shard_tree

    logits, pcache = prefill(params, {"tokens": local_shard(prompt, ps["batch"]["tokens"],
                                                            mesh)})
    cache = shard_tree(ds["model"].make_cache(prompt.shape[0], ds["max_len"]), ds["cache"],
                       mesh)
    steps.fill_decode_cache(cache, pcache, mesh, ps["cache"], ds["cache"])
    return logits[:, -1], cache


def sharded_decode(decode, ds, params, cache, last, forced, steps=None):
    """One decode step per forced token column (None: own greedy tokens;
    ``steps``, default ``ds["new"]``, steps) after the prefill's ``last``
    logits -> (logits per forward, greedy tokens); the cache is written in
    place."""
    outs, toks = [last], [last.argmax(-1)]
    for j in range(ds["new"] if steps is None else steps):
        tok = toks[-1] if forced is None else forced[j]
        logits, cache = decode(params, {"tokens": tok[:, None]}, cache)
        outs.append(logits[:, -1])
        toks.append(logits[:, -1].argmax(-1))
    return torch.stack(outs), torch.stack(toks)


def sharded_serve(prefill, decode, ps, ds, params, prompt, forced, mesh, pre_params=None,
                  times=None):
    """A prefill (of ``pre_params`` where the prefill step lays the tree out
    otherwise than the decode step), then the decode steps -> (logits per
    forward on this data rank's rows, greedy tokens, wall seconds);
    ``times`` (a dict) gets the prefill's and the decode steps' seconds,
    and with its ``keep_cache`` set, a copy of the cache the decode steps
    start from (``start_cache``)."""
    sync = torch.cuda.synchronize if prompt.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    last, cache = sharded_prefill(prefill, ps, ds, params if pre_params is None else pre_params,
                                  prompt, mesh)
    sync()
    t1 = time.perf_counter()
    if times is not None and times.pop("keep_cache", False):
        times["start_cache"] = {k: v.clone() if torch.is_tensor(v) else v
                                for k, v in cache.items()}
    logits, toks = sharded_decode(decode, ds, params, cache, last, forced)
    sync()
    t2 = time.perf_counter()
    if times is not None:
        times.update(prefill_s=t1 - t0, decode_s=t2 - t1)
    return logits, toks, t2 - t0


def _serve_steps(cfg, part, mesh, quant="nested"):
    from repro_torch.distributed import steps

    pshape, dshape = _serve_shapes(part)
    prefill, ps = steps.build_prefill_step(cfg, pshape, mesh, quant)
    decode, ds = steps.build_decode_step(cfg, dshape, mesh, quant)
    ds.update(max_len=dshape.seq_len, new=part["new"])
    return prefill, ps, decode, ds


def world1_train(plan, key: str, path: Path):
    """The world-1 control of a train part on the card (a (1, 1) mesh, no
    process group): the step from the same init and batch, its loss and
    whole f32 state written to ``path``."""
    from repro_torch import tree
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import shape_only
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw

    dev = plan["device"]
    one = shape_only((1, 1), ("data", "model"), dev)
    cfg, shape, batch = _train_parts(plan, key)
    step, specs = steps.build_train_step(cfg, shape, one)
    params = init_params(dataclasses.replace(cfg, dtype="bfloat16"), seed=0, device=dev)
    opt = adamw.init_state(params)
    t0 = time.perf_counter()
    params, opt, metrics = step(params, opt, batch, plan[key]["step"])
    loss = float(metrics["loss"])
    train_s = time.perf_counter() - t0
    state = {f: {k: v.cpu() for k, v in tree.flatten_with_path(getattr(opt, f))}
             for f in ("m", "v", "master")}
    state["leafmax"] = {f: {k: float(v.abs().max()) for k, v in state[f].items()}
                        for f in ("m", "v")}
    state["loss"], state["lr"] = loss, float(metrics["lr"])
    del params, opt, metrics
    torch.save(state, path)
    del state
    _empty_cache(dev)
    return {"loss": loss, "train_s": train_s}


def world1_serve(plan, key: str, path: Path):
    """The world-1 control of a serve part: each (dtype, rung) serve's
    logits and greedy tokens on the whole nested tree, written to
    ``path`` with the prompt."""
    from repro_torch.core.nesting import set_tree_rung
    from repro_torch.launch.mesh import shape_only
    from repro_torch.models.model import init_params

    dev = plan["device"]
    one = shape_only((1, 1), ("data", "model"), dev)
    part = plan[key]
    scfg = _plan_config(part)
    serve = {}
    dense = init_params(scfg, seed=0, device=dev)
    _, _, _, ds0 = _serve_steps(scfg, part, one)
    nested = _nest_as_specs(dense, ds0["params"], dev)
    del dense
    prompt = _serve_prompt(scfg, part, dev)
    for dt in part["dtypes"]:
        prefill, ps, decode, ds = _serve_steps(
            dataclasses.replace(scfg, compute_dtype=dt), part, one)
        for rung in _rungs(part, dt):
            logits, toks, wall = sharded_serve(prefill, decode, ps, ds,
                                               set_tree_rung(nested, rung), prompt, None, one)
            serve[f"{dt}/{rung}"] = {"logits": logits.float().cpu(), "tokens": toks.cpu(),
                                     "wall_s": wall}
    del nested
    torch.save({"serve": serve, "prompt": prompt.cpu()}, path)
    _empty_cache(dev)
    return {k: v["wall_s"] for k, v in serve.items()}


def sharded_world1(plan, work: Path):
    """The world-1 controls of phase 9 on the card: (a) the train step's
    loss and state (``train_w1.pt``), (b) each (dtype, rung) serve's
    logits and greedy tokens (``serve_w1.pt``).  Launches here only
    compare, and are not counted."""
    out = world1_train(plan, "train", work / "train_w1.pt")
    out["serve_wall_s"] = world1_serve(plan, "serve", work / "serve_w1.pt")
    return out


def _empty_cache(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def predicted_train_comm(cfg, shape, mesh, pspec) -> dict:
    """All-reduce payload bytes per rank of one train step, from the specs:
    per microbatch the vocab-split embedding's sum (S d, compute dtype);
    each layer's two row-split products summed in f32 (o, down; S d x 4
    bytes each), and o's again in the remat recompute (which stops early:
    nothing after down's sum is saved for the backward); the logsumexp's
    three (S,) f32 sums; in the backward the LM head's and each layer's two
    column-split inputs' gradients (S d, compute dtype) and the q/k/v
    biases' (f32); then every local f32 gradient over the data axes, the
    gradient norm and the loss.  (The dense family at head-TP with kv
    heads split over model: no all-gather.)"""
    from repro_torch import tree
    from repro_torch.distributed import sharding as shd
    from repro_torch.device import torch_dtype

    msz = mesh.shape["model"]
    dpsz = mesh.axis_size(shd.dp_axes(mesh))
    rows = shape.global_batch // dpsz // shape.num_microbatches
    tok = rows * shape.seq_len
    act = torch_dtype(cfg.compute_dtype).itemsize
    d, L = cfg.d_model, cfg.num_layers
    out = 0
    if msz > 1:
        bias = 0
        if cfg.qkv_bias:
            bias = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim * 4
        per_micro = (tok * d * act                          # embedding sum
                     + L * 3 * tok * d * 4                  # o, down; o's recompute
                     + 3 * tok * 4                          # max, sum of exp, gold
                     + tok * d * act                        # LM head input's gradient
                     + L * (2 * tok * d * act + bias))      # q/k/v and gate/up inputs, biases
        out += shape.num_microbatches * per_micro + 4       # + the gradient norm
    if dpsz > 1:
        local = 0
        for (_, leaf), (_, spec) in zip(tree.flatten_with_path(steps_abstract(cfg)),
                                        tree.flatten_with_path(pspec)):
            n = leaf.numel()
            for ax in spec:
                n //= mesh.axis_size(ax) if ax else 1
            local += n * 4
        out += local + 4                                   # + the loss
    return {"all_reduce": out, "all_gather": 0}


def steps_abstract(cfg):
    from repro_torch.distributed import steps
    return steps.abstract_params(dataclasses.replace(cfg, dtype="bfloat16"))


@contextlib.contextmanager
def without_data_mean(mesh):
    """The control of (a): inside, the mean over the data axes
    (``comm.all_reduce`` with op "mean" on their group) returns this rank's
    own tensor, so the train step leaves the gradients' data-parallel
    average out (and reports this rank's own loss)."""
    from repro_torch.distributed import comm
    from repro_torch.distributed.sharding import dp_axes

    group, real = mesh.group(dp_axes(mesh)), comm.all_reduce

    def local(x, g, op="sum"):
        if op == "mean" and g is not None and g is group:
            return x.clone()
        return real(x, g, op)

    comm.all_reduce = local
    try:
        yield
    finally:
        comm.all_reduce = real


def state_gaps(opt, ospec, ref, mesh):
    """This rank's blocks of the f32 state against the world-1 state's,
    the worst leaf of each reading and where it is:

    * ``moments``: per leaf of m and v, the largest |diff| over the leaf's
      largest |value|;
    * ``master``: per leaf, the largest |diff| in units of the step's
      learning rate, on the elements whose world-1 m is at least
      ``SHARDED_STATE_TOL`` of its leaf's largest |m|;
    * a non-finite value on either side reads inf in both.  Adam's first step
      moves master by lr * sign(g) (weight decay aside): where a gradient
      is zero but for rounding master may go either way (2 lr apart), and
      master's own value (norm scales near 1) is too large to show a step
      at all; where |m| passes the mask, m's own limit keeps its sign, so
      the two steps must agree to rounding.
    """
    from repro_torch import tree
    from repro_torch.distributed.sharding import local_shard

    out = {"moments": (0.0, None), "master": (0.0, None)}

    def worst(kind, gap, where):
        if gap >= out[kind][0]:
            out[kind] = (gap, where)

    flat = {f: tree.flatten_with_path(getattr(opt, f)) for f in ("m", "v", "master")}
    specs = dict(tree.flatten_with_path(ospec.m))
    for i, (key, _) in enumerate(flat["m"]):
        got = {f: flat[f][i][1] for f in flat}
        want = {f: local_shard(ref[f][key], specs[key], mesh).to(got[f].device) for f in flat}
        if not all(bool(torch.isfinite(t[f]).all()) for t in (got, want) for f in flat):
            worst("moments", math.inf, f"non-finite m, v or master{key}")
            worst("master", math.inf, f"non-finite m, v or master{key}")
            continue
        gaps = {f: float((got[f] - want[f]).abs().max()) / max(ref["leafmax"][f][key], 1e-30)
                for f in ("m", "v")}
        mask = want["m"].abs() >= SHARDED_STATE_TOL * ref["leafmax"]["m"][key]
        diff = (got["master"] - want["master"]).abs()[mask]
        gaps["master"] = float(diff.max()) / ref["lr"] if diff.numel() else 0.0
        del want, mask, diff
        f = "m" if gaps["m"] >= gaps["v"] else "v"
        worst("moments", gaps[f], f"{f}{key}")
        worst("master", gaps["master"], f"master{key}")
    return out


def rank_train(plan, mesh, work: Path, key="train", ref_file="train_w1.pt",
               control=without_data_mean, loss_control=None):
    """(a) on this rank: the sharded train step (sound), then its control
    (by default without the data-axis gradient average,
    ``without_data_mean``; None: none), each from the same init, held
    block by block against the world-1 state (``state_gaps``); with
    ``loss_control``, the loss at the same init under it
    (:func:`control_loss`)."""
    from repro_torch.distributed import comm, steps
    from repro_torch.distributed.sharding import local_shard, shard_tree
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw

    dev = plan["device"]
    cfg, shape, batch = _train_parts(plan, key)
    ref = torch.load(work / ref_file, mmap=True, weights_only=False)
    out = {}
    for run in ("sound", "control") if control else ("sound",):
        step, specs = steps.build_train_step(cfg, shape, mesh)
        full = init_params(dataclasses.replace(cfg, dtype="bfloat16"), seed=0, device=dev)
        params = shard_tree(full, specs["params"], mesh)
        del full
        opt = adamw.init_state(params)
        local = {k: local_shard(v, specs["batch"][k], mesh) for k, v in batch.items()}
        _reset_peak(dev)
        comm.reset_counts()
        dispatch.reset_counters()
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with control(mesh) if run == "control" else contextlib.nullcontext():
            params, opt, metrics = step(params, opt, local, plan[key]["step"])
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        k5 = dispatch.counter("flash_attention")
        res = {"loss": loss, "wall_s": wall, "comm": comm.counts(),
               "k5_launches": k5.launches, "k5_plain": k5.plain_launches,
               "counts": _k_totals(),
               "peak_mem_bytes": _peak(dev),
               "predicted_comm": predicted_train_comm(cfg, shape, mesh, specs["params"])}
        gaps = state_gaps(opt, specs["opt"], ref, mesh)
        res.update(moments_gap=gaps["moments"][0], moments_gap_leaf=gaps["moments"][1],
                   master_gap=gaps["master"][0], master_gap_leaf=gaps["master"][1],
                   loss_gap=abs(loss - ref["loss"]) / abs(ref["loss"]))
        out[run] = res
        del params, opt, metrics, step
        _empty_cache(dev)
    if loss_control:
        loss = control_loss(plan, mesh, key, loss_control)
        out["loss_control"] = {"loss": loss, "loss_gap": abs(loss - ref["loss"]) / abs(ref["loss"])}
    return out


def control_loss(plan, mesh, key, control):
    """The train part's loss at its init under ``control`` (a context
    manager factory), computed as the step computes it (the mean over
    microbatches and data ranks) with no backward."""
    from repro_torch.distributed import comm, steps
    from repro_torch.distributed.sharding import dp_axes, local_shard, shard_tree
    from repro_torch.models.model import init_params

    dev = plan["device"]
    cfg, shape, batch = _train_parts(plan, key)
    _, specs = steps.build_train_step(cfg, shape, mesh)
    full = init_params(dataclasses.replace(cfg, dtype="bfloat16"), seed=0, device=dev)
    params = shard_tree(full, specs["params"], mesh)
    del full
    local = {k: local_shard(v, specs["batch"][k], mesh) for k, v in batch.items()}
    nm = shape.num_microbatches
    mb = next(iter(local.values())).shape[0] // nm
    with torch.no_grad(), steps.rules_ctx(mesh, specs["rules"]), control():
        whole = steps._make_whole(params, steps._whole_dims_tree(specs["params"], mesh), mesh)
        loss = sum(specs["model"].loss_fn(whole, {k: v[i * mb:(i + 1) * mb]
                                                  for k, v in local.items()})
                   for i in range(nm)) / nm
    dp = dp_axes(mesh)
    if dp:
        loss = comm.all_reduce(loss, mesh.group(dp), "mean")
    del params, whole
    _empty_cache(dev)
    return float(loss)


def _k_totals():
    from repro_torch.kernels import dispatch
    return {n: {"launches": c.launches, "plain": c.plain_launches, "dec": c.dec_launches,
                "tc": c.tc_launches, "mid": c.mid_launches, "f32": c.f32_launches}
            for n, c in dispatch.COUNTERS.items()}


def _rank_trees(cfg, part, mesh, dev):
    """This rank's nested blocks, as the decode step lays the tree out and,
    where the prefill step lays a leaf out otherwise (replicated q/k/v/o of
    sequence-parallel attention), as the prefill step does (None where the
    two agree): a column block nests to the whole weight's block."""
    from repro_torch import tree
    from repro_torch.core.nesting import NestedTensor
    from repro_torch.core.recipe import QuantRecipe, quantize
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models.model import init_params

    _, ps0, _, ds0 = _serve_steps(cfg, part, mesh)
    spec = lambda s: tuple(s.w_base) if isinstance(s, NestedTensor) else tuple(s)  # noqa: E731
    differ = {k for (k, a), (_, b) in zip(tree.flatten_with_path(ds0["params"]),
                                          tree.flatten_with_path(ps0["params"]))
              if spec(a) != spec(b)}
    dense = init_params(cfg, seed=0, device=dev)
    cut = shard_tree(dense, _dense_specs(ds0["params"]), mesh)
    cut_pre = shard_tree(dense, _dense_specs(ps0["params"]), mesh) if differ else None
    del dense
    nested = _nest_as_specs(cut, ds0["params"], dev)
    del cut
    pre = None
    if differ:
        nest = {k for k, s in tree.flatten_with_path(ps0["params"])
                if k in differ and isinstance(s, NestedTensor)}
        recipe = QuantRecipe(bits=(4, 8), rounding="rtn", predicate=lambda k, _: k in nest)
        other = quantize(cut_pre, recipe, device=dev)
        pre = tree.unflatten(nested, [o if k in differ else n for (k, n), (_, o) in zip(
            tree.flatten_with_path(nested), tree.flatten_with_path(other))])
        del other, cut_pre
    _empty_cache(dev)
    return nested, pre


def rank_serve(plan, mesh, work: Path, key="serve", ref_file="serve_w1.pt", control=None):
    """(b) on this rank: quantize this rank's blocks of the part's model (a
    column block nests to the whole weight's block), then per (dtype, rung)
    the sharded prefill and decode steps, fed the world-1 control's tokens,
    against the control's logits on this data rank's rows; ``control``
    (a context manager factory): one more run at the first (dtype, rung)
    from the same cache under it (the control changes the decode steps
    alone), whose logits must read above the limit."""
    from repro_torch.core.nesting import set_tree_rung
    from repro_torch.distributed import comm
    from repro_torch.kernels import dispatch

    dev = plan["device"]
    part = plan[key]
    cfg = _plan_config(part)
    ref = torch.load(work / ref_file, weights_only=False)
    t0 = time.perf_counter()
    nested, pre = _rank_trees(cfg, part, mesh, dev)
    quant_s = time.perf_counter() - t0
    half = part["batch"] // mesh.shape["data"]
    rows = slice(mesh.coord("data") * half, (mesh.coord("data") + 1) * half)
    prompt = ref["prompt"].to(dev)
    out = {"quantize_s": quant_s, "runs": {}}

    def record(name, logits, toks, want, wall, times):
        n = logits.shape[0]                          # forwards run
        w = want["logits"][:n, rows]
        out["runs"][name] = {
            "gap": float((logits.float().cpu() - w).abs().max() / w.abs().max()),
            "tokens_equal": bool(torch.equal(toks.cpu(), want["tokens"][:n, rows])),
            "wall_s": wall, "counts": _k_totals(), "comm": comm.counts(),
            "finite": bool(torch.isfinite(logits).all()), **times}

    for dt in part["dtypes"]:
        prefill, ps, decode, ds = _serve_steps(dataclasses.replace(cfg, compute_dtype=dt),
                                               part, mesh)
        for rung in _rungs(part, dt):
            want = ref["serve"][f"{dt}/{rung}"]
            forced = want["tokens"][:, rows].to(dev)
            params = set_tree_rung(nested, rung)
            keep = bool(control) and (dt, rung) == (part["dtypes"][0],
                                                    _rungs(part, part["dtypes"][0])[0])
            dispatch.reset_counters()
            comm.reset_counts()
            times = {"keep_cache": keep}
            logits, toks, wall = sharded_serve(
                prefill, decode, ps, ds, params, prompt, forced, mesh,
                None if pre is None else set_tree_rung(pre, rung), times)
            start = times.pop("start_cache", None)
            record(f"{dt}/{rung}", logits, toks, want, wall, times)
            if keep:
                # the decode steps again from the same cache, under the control
                dispatch.reset_counters()
                comm.reset_counts()
                t0 = time.perf_counter()
                with control():
                    logits, toks = sharded_decode(decode, ds, params, start, logits[0],
                                                  forced, CONTROL_STEPS)
                record(f"{dt}/{rung}/control", logits, toks, want,
                       time.perf_counter() - t0, {})
            del start
    out["peak_mem_bytes"] = _peak(dev)
    return out


def rank_moe(plan, mesh):
    """(c) on this rank: dbrx-132b's nested tree (built by one rank at a time:
    the dense draws are large), its sharded prefill and greedy decode steps
    with every ``moe_ffn`` call recorded, then each call's output against
    the one-card ``moe_ffn`` on the same tokens (no context), and this
    rank's expert groups against the one-card routing's."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe
    from repro_torch.models.model import init_params

    dev = plan["device"]
    part = plan["moe"]
    cfg = _plan_config(part, compute_dtype=part["dtype"])
    prefill, ps, decode, ds = _serve_steps(cfg, part, mesh)
    t0 = time.perf_counter()
    params = None
    for turn in range(mesh.size):
        if turn == dist.get_rank():
            dense = init_params(cfg, seed=0, device=dev)
            nested = _nest_as_specs(dense, ds["params"], dev)
            del dense
            params = shard_tree(nested, ds["params"], mesh)
            del nested
            _empty_cache(dev)
        dist.barrier()
    build_s = time.perf_counter() - t0
    calls = []
    real = model_mod.moe_ffn

    def recorded(x, p, **kw):
        y, aux = real(x, p, **kw)
        calls.append((x.detach().clone(), y.detach().clone(), p, kw))
        return y, aux

    prompt = _serve_prompt(cfg, part, dev)
    _reset_peak(dev)
    dispatch.reset_counters()
    model_mod.moe_ffn = recorded
    try:
        with moe.record_groups() as log:
            logits, toks, wall = sharded_serve(prefill, decode, ps, ds, params, prompt, None,
                                               mesh)
    finally:
        model_mod.moe_ffn = real
    counts = _k_totals()
    r, m = mesh.coord("model"), mesh.shape["model"]
    per = cfg.num_experts // m
    worst, bitwise, groups_ok = 0.0, True, True
    for (x, y, p, kw), g in zip(calls, log):
        with moe.record_groups() as one_log:
            want, _ = real(x, p, **kw)                      # one card: no context
        diff = float((y - want).abs().max())
        bitwise &= diff == 0.0
        worst = max(worst, diff / max(float(want.abs().max()), 1e-30))
        mine = tuple((e, n) for e, n in one_log[0].groups if e // per == r)
        groups_ok &= g.groups == mine
    attn = sum(1 for k in ("q", "k", "v", "o")
               if type(ds["params"]["blocks"][k]["w"]).__name__ == "NestedTensor")
    forwards = 1 + part["new"]
    want_launches = (forwards * (cfg.num_layers * attn + 1)
                     + 3 * sum(len(g.groups) for g in log))
    return {"build_s": build_s, "wall_s": wall, "calls": len(calls), "worst": worst,
            "bitwise": bitwise, "groups_ok": groups_ok, "counts": counts,
            "want_launches": want_launches, "experts_per_rank": per,
            "groups": [list(g.groups) for g in log],
            "finite": bool(torch.isfinite(logits).all()), "peak_mem_bytes": _peak(dev)}


def _blocking_sync() -> None:
    """Make this process's waits on the card block instead of spin
    (``CU_CTX_SCHED_BLOCKING_SYNC`` on the primary context, set through the
    driver before the context exists): with one process per core, ranks
    spinning in a stream sync starve the threads gloo's collectives run
    on."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    dev = ctypes.c_int()
    for err in (cuda.cuInit(0), cuda.cuDeviceGet(ctypes.byref(dev), 0),
                cuda.cuDevicePrimaryCtxSetFlags(dev, 0x04)):
        if err:
            raise RuntimeError(f"setting blocking sync on the card: CUDA driver error {err}")


def sharded_rank(rank: int, world: int, work: Path) -> int:
    """One rank of phase 9 or 10 (the plan's ``job``): join the gloo world,
    run its parts, write ``rank<r>.json``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    global DEVICE
    plan = json.loads((work / "plan.json").read_text())
    DEVICE = plan["device"]
    if torch.device(DEVICE).type == "cuda":
        _blocking_sync()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_test_mesh(tuple(plan["mesh"]), ("data", "model"), backend="gloo",
                          device_type=torch.device(DEVICE).type,
                          init_method=f"file://{work / 'init'}", rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = {"rank": rank, "data": mesh.coord("data"), "model": mesh.coord("model")}
        job = plan.get("job", "sharded")
        if job == "sharded":
            out["train"] = rank_train(plan, mesh, work)
            out["serve"] = rank_serve(plan, mesh, work)
            out["moe"] = rank_moe(plan, mesh)
        elif job == "seq":
            out["train"] = rank_train(plan, mesh, work, control=without_kv_grad_sum,
                                      loss_control=without_offset)
            out["serve"] = rank_serve(plan, mesh, work, control=without_combine)
        else:
            out["train"] = rank_train(plan, mesh, work, control=without_norm_sum,
                                      loss_control=without_norm_sum)
            for key in ("serve", "hybrid"):
                out[key] = rank_serve(plan, mesh, work, key=key, ref_file=f"{key}_w1.pt",
                                      control=without_norm_sum)
        out["seconds"] = time.perf_counter() - t0
        (work / f"rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def start_ranks(work: Path, world: int):
    """Start ``world`` rank processes of this script on ``work``'s plan."""
    procs = []
    try:
        for r in range(world):
            log_f = open(work / f"rank{r}.log", "w")
            # one intra-op thread per rank: the ranks' idle thread pools
            # would otherwise spin on the cores gloo's collectives run on
            procs.append((subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
                 "--world", str(world), "--workdir", str(work)],
                stdout=log_f, stderr=subprocess.STDOUT,
                env=dict(os.environ, OMP_NUM_THREADS="1")), log_f))
    except BaseException:
        _stop(procs)
        raise
    return work, procs


def _stop(procs):
    for p, f in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        f.close()


def wait_ranks(started):
    """Wait for the rank processes ``start_ranks`` started; any that fails
    (or outlives ``SHARDED_TIMEOUT_S``) fails the phase, and every process
    started is stopped.  Returns each rank's ``rank<r>.json``."""
    work, procs = started
    try:
        deadline = time.time() + SHARDED_TIMEOUT_S
        while any(p.poll() is None for p, _ in procs):
            if time.time() > deadline or any(p.poll() not in (None, 0) for p, _ in procs):
                break
            time.sleep(0.5)
    finally:
        _stop(procs)
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = "\n".join(f"--- rank {r} ---\n" + (work / f"rank{r}.log").read_text()[-3000:]
                          for r in bad)
        raise AssertionError(f"sharded ranks {bad} failed:\n{tails}")
    return [json.loads((work / f"rank{r}.json").read_text()) for r in range(len(procs))]


def run_ranks(work: Path, world: int):
    """Start ``world`` rank processes of this script and wait for all
    (:func:`start_ranks`, :func:`wait_ranks`)."""
    return wait_ranks(start_ranks(work, world))


def check_serve_runs(tag, serve, part, per_fwd, k5_per_run=0):
    """Each sound (dtype, rung) serve of a rank against its limits and its
    K1/K2 launches against what the path implies (``per_fwd`` a forward:
    the prefill's on the tensor cores in bf16 but its LM head, which takes
    the decode body as every decode step does), ``k5_per_run`` K5 launches
    and nothing plain; each control run above its limit."""
    kernel_of = {0: "packed_matmul", 1: "nested_matmul"}
    for key, run in serve["runs"].items():
        dt, rung, *ctl = key.split("/")
        if ctl:
            if run["gap"] <= SHARDED_SERVE_TOL[dt]:
                raise AssertionError(f"{tag}: the serve control {key} reads "
                                     f"{run['gap']:.3e}: within the limit")
            continue
        name = kernel_of[int(rung)]
        c = run["counts"].get(name, {"launches": 0, "plain": 0, "dec": 0, "tc": 0, "mid": 0,
                                     "f32": 0})
        want = {"launches": per_fwd * (1 + part["new"]), "plain": 0,
                "dec": 1 + per_fwd * part["new"],
                "tc": (per_fwd - 1) if dt == "bfloat16" else 0, "mid": 0,
                "f32": (per_fwd - 1) if dt == "float32" else 0}
        got = {k: c[k] for k in want}
        others = sum(v["launches"] + v["plain"] for n, v in run["counts"].items()
                     if n != name and n in kernel_of.values())
        if got != want or others:
            raise AssertionError(f"{tag}: serve {key} K1-K3 {got} (others {others}), "
                                 f"want {want} on {name}")
        k5 = run["counts"].get("flash_attention", {"launches": 0, "plain": 0})
        if (k5["launches"], k5["plain"]) != (k5_per_run, 0):
            raise AssertionError(f"{tag}: serve {key} K5 {k5['launches']} launches "
                                 f"({k5['plain']} plain), want {k5_per_run}")
        if run["gap"] > SHARDED_SERVE_TOL[dt] or not run["finite"]:
            raise AssertionError(f"{tag}: serve {key} logits gap {run['gap']:.3e}")
        if dt == "float32" and not run["tokens_equal"]:
            raise AssertionError(f"{tag}: serve {key} greedy tokens differ")


def check_train(tag, train, part, loss_tol=SHARDED_LOSS_TOL):
    """A rank's train step against the world-1 step's (loss under
    ``loss_tol``, f32 state; a NaN reads above any limit) and its K5
    launches against what the path implies, none plain; its control, where
    it ran, above the state limit in both readings, and its loss control,
    where it ran, above ``loss_tol``."""
    sound, control = train["sound"], train.get("control")
    # per layer with attention: the forward and its remat recompute, per
    # microbatch (each rank at its own query offset where the sequence splits)
    layers = part["layers"] if _plan_config(part).num_heads else 0
    want_k5 = layers * 2 * (part["batch"] // part["micro"])
    if sound["k5_launches"] != want_k5 or sound["k5_plain"]:
        raise AssertionError(f"{tag}: K5 {sound['k5_launches']} launches "
                             f"({sound['k5_plain']} plain), want {want_k5}")
    if not (sound["loss_gap"] <= loss_tol and sound["moments_gap"] <= SHARDED_STATE_TOL
            and sound["master_gap"] <= SHARDED_STATE_TOL):
        raise AssertionError(
            f"{tag}: train loss gap {sound['loss_gap']:.3e}, moments gap "
            f"{sound['moments_gap']:.3e} at {sound['moments_gap_leaf']}, master gap "
            f"{sound['master_gap']:.3e} at {sound['master_gap_leaf']}")
    if control and min(control["moments_gap"], control["master_gap"]) <= SHARDED_STATE_TOL:
        raise AssertionError(f"{tag}: the train control reads moments "
                             f"{control['moments_gap']:.3e}, master "
                             f"{control['master_gap']:.3e}: within the limit")
    loss_control = train.get("loss_control")
    if loss_control and not loss_control["loss_gap"] > loss_tol:
        raise AssertionError(f"{tag}: the loss control reads {loss_control['loss_gap']:.3e}: "
                             f"within the limit {loss_tol:.1e}")


def check_sharded(ranks, plan):
    """Every rank's results against their limits (raises on any)."""
    for r in ranks:
        tag = f"rank {r['rank']} (data {r['data']}, model {r['model']})"
        check_train(tag, r["train"], plan["train"])
        part = plan["serve"]
        check_serve_runs(tag, r["serve"], part, 7 * _plan_config(part).num_layers + 1)
        mo = r["moe"]
        k2 = mo["counts"].get("nested_matmul", {"launches": 0, "plain": 0})
        plain = sum(v["plain"] for v in mo["counts"].values())
        if k2["launches"] != mo["want_launches"] or plain:
            raise AssertionError(f"{tag}: moe K2 {k2['launches']} launches ({plain} plain), "
                                 f"want {mo['want_launches']}")
        if not mo["groups_ok"] or mo["worst"] > SHARDED_MOE_TOL or not mo["finite"]:
            raise AssertionError(f"{tag}: moe groups {mo['groups_ok']}, output gap "
                                 f"{mo['worst']:.3e}")


def phase_sharded():
    """Phase 9: the sharded train, nested serve and MoE serve on a (2, 2)
    mesh of four gloo rank processes sharing the card, against the world-1
    steps on the same card; see the module docstring."""
    import shutil

    t0 = time.perf_counter()
    plan = sharded_plan()
    work = ROOT / "build" / "sharded"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    world = SHARDED_MESH[0] * SHARDED_MESH[1]
    try:
        (work / "plan.json").write_text(json.dumps(plan))
        w1 = sharded_world1(plan, work)
        t_ranks = time.perf_counter()
        ranks = run_ranks(work, world)
        ranks_s = time.perf_counter() - t_ranks
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t0
    for r in ranks:
        s, c = r["train"]["sound"], r["train"]["control"]
        pred = s["predicted_comm"]["all_reduce"]
        got = s["comm"].get("all_reduce", {}).get("payload_bytes", 0)
        log(f"[sharded] rank {r['rank']} (data {r['data']}, model {r['model']}): train step "
            f"{s['wall_s']:.3f}s, loss {s['loss']:.6f} (world-1 {w1['loss']:.6f}, gap "
            f"{s['loss_gap']:.2e}), moments gap {s['moments_gap']:.2e} at "
            f"{s['moments_gap_leaf']}, master gap {s['master_gap']:.2e} at "
            f"{s['master_gap_leaf']} (control {c['moments_gap']:.2e}, {c['master_gap']:.2e}), "
            f"all-reduce {got / 1e6:.3f} MB (predicted "
            f"{pred / 1e6:.3f} MB), all-gather "
            f"{s['comm'].get('all_gather', {}).get('payload_bytes', 0) / 1e6:.3f} MB, K5 "
            f"{s['k5_launches']}, peak {s['peak_mem_bytes'] / 1e9:.2f} GB")
        for key, run in r["serve"]["runs"].items():
            log(f"[sharded] rank {r['rank']}: serve {key} gap {run['gap']:.2e}, tokens equal "
                f"{run['tokens_equal']}, {run['wall_s']:.3f}s, K1-K3 "
                + ", ".join(f"{n} {v['launches']} (dec {v['dec']}, tc {v['tc']})"
                            for n, v in run["counts"].items() if v["launches"]))
        mo = r["moe"]
        equal = "bit for bit" if mo["bitwise"] else f"within {mo['worst']:.2e}"
        log(f"[sharded] rank {r['rank']}: moe {mo['calls']} moe_ffn calls {equal} "
            f"of the one-card moe_ffn, groups {mo['groups_ok']}, K2 "
            f"{mo['counts'].get('nested_matmul', {}).get('launches', 0)} launches (want "
            f"{mo['want_launches']}), serve {mo['wall_s']:.3f}s, build {mo['build_s']:.1f}s, "
            f"peak {mo['peak_mem_bytes'] / 1e9:.2f} GB; "
            f"rank {r['seconds']:.1f}s")
    log(f"[sharded] phase 9 took {seconds:.1f}s (world-1 controls {w1['train_s']:.1f}s "
        f"train step; ranks {ranks_s:.1f}s) ({smi_line()})")
    check_sharded(ranks, plan)
    launches, k5 = _launch_totals(ranks, lambda r: list(r["serve"]["runs"].values())
                                  + [r["moe"]])
    return {"plan": plan, "world1": w1, "ranks": ranks, "seconds": seconds,
            "ranks_s": ranks_s, "launches": {n: tuple(v) for n, v in launches.items()},
            "k5_launches": k5}


def _launch_totals(ranks, runs_of):
    """(K1-K3 [all, decode body] per kernel, K5) summed over the ranks' sound
    train steps and the counted runs ``runs_of(rank)`` yields."""
    launches = {n: [0, 0] for n in KERNELS}
    k5 = 0
    for r in ranks:
        k5 += r["train"]["sound"]["k5_launches"]
        for run in runs_of(r):
            k5 += run["counts"].get("flash_attention", {}).get("launches", 0)
            for n in KERNELS:
                c = run["counts"].get(n)
                if c:
                    launches[n][0] += c["launches"]
                    launches[n][1] += c["dec"]
    return launches, k5


# ===========================================================================
# Phase 10: sequence-parallel attention, the sequence-split KV cache and the
# ssm/hybrid sharded steps; eight, then four gloo ranks sharing the card
# ===========================================================================
SEQ_MESH = (1, 8)      # qwen2-1.5b's 12 heads and 2 kv heads divide nothing of 8
SSM_MESH = (2, 2)
CONTROL_STEPS = 2      # decode steps of (b)'s control (it reads ~0.57 from its first)
# the loss of (a) and (c) against the world-1 step's, by world: phase 9's
# 1e-5 held f32 partial sums in another order (7.8e-8), while here bf16
# products of a rank's rows round otherwise than the whole sequence's.
# On the H100 (PERF.md) (a) read 8.40e-6 and its loss control
# (``without_offset``) 1.34e-4; (c) 8.99e-6 and ``without_norm_sum``
# 1.13e-3: each limit is about the geometric mean of the two
SEQ_SSM_LOSS_TOL = {"seq": 3e-5, "ssm": 1e-4}


def seq_ssm_plans():
    """What phase 10 runs, by world (each rank reads its world's
    ``plan.json``).  ``seq`` on (data 1, model 8): (a) the train step of
    qwen2-1.5b at full width with 4 of its 28 layers, 2 x 2048 in one
    microbatch of 2, at schedule step 50: sequence-parallel attention, K5
    at offsets 0, 256, ..., 1792; (b) qwen2-1.5b, 4 of its 28 layers,
    nested (4, 8) rtn: a prefill of 2 x 2048 (sequence-parallel, K5 at the
    offsets), then 4 decode steps against a cache of 2056 positions split
    over model (257 per rank), f32 at rung 0 (K1), bf16 at rung 1 (K2).  ``ssm`` on
    (2, 2): (c) mamba2-780m's train step at full width with 4 of its 48
    layers, 2 x 2048, and its nested (4, 8) serve at 8 of its 48 layers,
    4 x 64 prompt tokens and 8 decode steps at rungs 0 and 1, f32; (d)
    zamba2-2.7b's nested serve at 12 of its 54 layers (two applications
    of the shared block) the same way (``SHARDED_SERVE_LAYERS``)."""
    train = {"layers": 4, "batch": 2, "seq": 2048, "micro": 2, "step": 50}
    serve = {"batch": 4, "prompt": 64, "new": 8, "rungs": [0, 1], "dtypes": ["float32"]}
    depth = {arch: {"arch": arch, "layers": n} for arch, n in SHARDED_SERVE_LAYERS.items()}
    return {"seq": {"job": "seq", "device": DEVICE, "mesh": list(SEQ_MESH),
                    "train": dict(train, arch="qwen2-1.5b"),
                    "serve": dict(serve, **depth["qwen2-1.5b"], batch=2, prompt=2048, new=4,
                                  cache=2056,
                                  dtypes=["float32", "bfloat16"],
                                  rungs={"float32": [0], "bfloat16": [1]})},
            "ssm": {"job": "ssm", "device": DEVICE, "mesh": list(SSM_MESH),
                    "train": dict(train, arch="mamba2-780m"),
                    "serve": dict(serve, **depth["mamba2-780m"]),
                    "hybrid": dict(serve, **depth["zamba2-2.7b"])}}


@contextlib.contextmanager
def _swapped(module, name, fn):
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


def without_kv_grad_sum(mesh=None):
    """The control of (a): k and v of sequence-parallel attention keep each
    rank's own gradient part (no sum over model)."""
    from repro_torch.models import model
    return _swapped(model, "_kv_grad_sum", lambda t: t)


def without_offset(mesh=None):
    """The loss control of (a): each rank attends its block of query rows
    as if it began the sequence (q_offset 0: row i sees keys 0 .. i)."""
    from repro_torch.models import model
    real = model._causal_attention
    return _swapped(model, "_causal_attention",
                    lambda q, k, v, S, kv_block, q_offset=0: real(q, k, v, S, kv_block))


def without_norm_sum(mesh=None):
    """The control of (c) and (d): the gated norm's sum of squares over
    this rank's block of d_inner alone (not summed over model)."""
    from repro_torch.models import mamba2
    return _swapped(mamba2, "_norm_sum", lambda ss: ss)


def without_combine(mesh=None):
    """The control of (b): each rank's softmax over its own block of the
    cache's positions (the other blocks' pieces are not gathered)."""
    from repro_torch.models import attention
    return _swapped(attention, "_gather_blocks", lambda x, group: x[None])


def seq_ssm_world1(plan, work: Path):
    """The world-1 controls of one phase-10 world on the card (a (1, 1)
    mesh, no process group); launches here only compare."""
    out = world1_train(plan, "train", work / "train_w1.pt")
    out["serve_wall_s"] = {key: world1_serve(plan, key, work / f"{key}_w1.pt")
                           for key in ("serve", "hybrid") if key in plan}
    return out


def check_seq_ssm(ranks, plan):
    """Every rank's phase-10 results against their limits (raises on any)."""
    for r in ranks:
        tag = f"{plan['job']} rank {r['rank']} (data {r['data']}, model {r['model']})"
        check_train(tag, r["train"], plan["train"], SEQ_SSM_LOSS_TOL[plan["job"]])
        for key in ("serve", "hybrid"):
            if key not in plan:
                continue
            part = plan[key]
            cfg = _plan_config(part)
            transformer = cfg.family in ("dense", "moe")
            per_fwd = 7 * cfg.num_layers + 1 if transformer else ssm_matmuls(cfg)
            k5 = cfg.num_layers if transformer and part["prompt"] > 1024 else 0
            check_serve_runs(f"{tag} {key}", r[key], part, per_fwd, k5)


def _log_seq_ssm(ranks, plan, w1):
    for r in ranks:
        s = r["train"]["sound"]
        c = r["train"].get("control")
        lc = r["train"].get("loss_control")
        log(f"[seq-ssm] {plan['job']} rank {r['rank']} (data {r['data']}, model "
            f"{r['model']}): train {plan['train']['arch']} step {s['wall_s']:.3f}s, loss "
            f"{s['loss']:.6f} (world-1 {w1['loss']:.6f}, gap {s['loss_gap']:.2e}), moments "
            f"gap {s['moments_gap']:.2e} at {s['moments_gap_leaf']}, master gap "
            f"{s['master_gap']:.2e} at {s['master_gap_leaf']}"
            + (f" (control {c['moments_gap']:.2e}, {c['master_gap']:.2e}, loss gap "
               f"{c['loss_gap']:.2e})" if c else "")
            + (f", loss control gap {lc['loss_gap']:.2e}" if lc else "")
            + f", all-reduce {s['comm'].get('all_reduce', {}).get('payload_bytes', 0) / 1e6:.3f}"
            f" MB, all-gather "
            f"{s['comm'].get('all_gather', {}).get('payload_bytes', 0) / 1e6:.3f} MB, K5 "
            f"{s['k5_launches']}, peak {s['peak_mem_bytes'] / 1e9:.2f} GB")
        for key in ("serve", "hybrid"):
            if key not in r:
                continue
            for name, run in r[key]["runs"].items():
                comms = ", ".join(f"{op} {c['calls']} calls {c['payload_bytes'] / 1e6:.1f} MB"
                                  for op, c in run["comm"].items())
                split = (f" (prefill {run['prefill_s']:.3f}s, decode {run['decode_s']:.3f}s)"
                         if "prefill_s" in run else "")
                log(f"[seq-ssm] {plan['job']} rank {r['rank']}: {plan[key]['arch']} serve "
                    f"{name} gap {run['gap']:.2e}, tokens equal {run['tokens_equal']}, "
                    f"{run['wall_s']:.3f}s{split}, {comms}; kernels "
                    + ", ".join(f"{n} {v['launches']} (dec {v['dec']}, tc {v['tc']}, plain "
                                f"{v['plain']})" for n, v in run["counts"].items()
                                if v["launches"] or v["plain"]))
            log(f"[seq-ssm] {plan['job']} rank {r['rank']}: {plan[key]['arch']} nested "
                f"blocks built in {r[key]['quantize_s']:.1f}s, peak "
                f"{r[key]['peak_mem_bytes'] / 1e9:.2f} GB")
        log(f"[seq-ssm] {plan['job']} rank {r['rank']}: {r['seconds']:.1f}s")


def phase_seq_ssm_sharded():
    """Phase 10: sequence-parallel attention and the sequence-split KV cache
    on (1, 8), the ssm and hybrid families on (2, 2), each world of gloo
    rank processes sharing the card against the world-1 steps on the same
    card; see the module docstring."""
    import shutil

    t0 = time.perf_counter()
    plans = seq_ssm_plans()
    root = ROOT / "build" / "seq_ssm"
    shutil.rmtree(root, ignore_errors=True)
    out = {"worlds": {}}
    launches = {n: [0, 0] for n in KERNELS}
    k5 = 0
    try:
        # the ssm world's ranks run while the main process computes the seq
        # world's world-1 controls (the card holds both; times of ranks
        # sharing it measure no scaling anyway)
        works, w1s, ranks_of, times = {}, {}, {}, {}
        for job, plan in plans.items():
            works[job] = root / job
            works[job].mkdir(parents=True)
            (works[job] / "plan.json").write_text(json.dumps(plan))
        t1 = time.perf_counter()
        w1s["ssm"] = seq_ssm_world1(plans["ssm"], works["ssm"])
        started = start_ranks(works["ssm"], SSM_MESH[0] * SSM_MESH[1])
        t2 = time.perf_counter()
        try:
            w1s["seq"] = seq_ssm_world1(plans["seq"], works["seq"])
        except BaseException:
            _stop(started[1])
            raise
        t3 = time.perf_counter()
        ranks_of["ssm"] = wait_ranks(started)
        t4 = time.perf_counter()
        ranks_of["seq"] = run_ranks(works["seq"], SEQ_MESH[0] * SEQ_MESH[1])
        t5 = time.perf_counter()
        times = {"ssm": (t2 - t1, t4 - t2), "seq": (t3 - t2, t5 - t4)}
        for job, plan in plans.items():
            ranks = ranks_of[job]
            _log_seq_ssm(ranks, plan, w1s[job])
            log(f"[seq-ssm] {job} world {plan['mesh']}: world-1 controls "
                f"{times[job][0]:.1f}s, ranks {times[job][1]:.1f}s")
            check_seq_ssm(ranks, plan)
            got, got_k5 = _launch_totals(ranks, lambda r: [
                run for key in ("serve", "hybrid") if key in r
                for name, run in r[key]["runs"].items() if not name.endswith("/control")])
            for n in KERNELS:
                launches[n][0] += got[n][0]
                launches[n][1] += got[n][1]
            k5 += got_k5
            out["worlds"][job] = {"plan": plan, "world1": w1s[job], "ranks": ranks,
                                  "world1_s": times[job][0], "ranks_s": times[job][1]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {n: tuple(v) for n, v in launches.items()}
    out["k5_launches"] = k5
    log(f"[seq-ssm] phase 10 took {out['seconds']:.1f}s ({smi_line()})")
    return out


# ===========================================================================
# Phase 11: the dry run (fake world, fake tensors) against phases 8-10
# ===========================================================================
# (b): |predicted peak - measured peak| / measured peak.  On the H100 the
# sound prediction read 8.32e-5 (50.379 against 50.384 GB) and the control
# (the prediction without the AdamW moment m, one f32 copy of the
# parameters) 0.141 (PERF.md): the limit is about their geometric mean
DRY_PEAK_TOL = 3e-3
# (b): the reference's limits on a train cell's useful_flops_ratio
DRY_USEFUL_RANGE = (0.25, 1.5)


@contextlib.contextmanager
def _dry_mesh(dims, device, rank=0):
    """Rank ``rank``'s mesh of ``dims`` (data, model) in a fake world."""
    from repro_torch.launch.mesh import fake_world, make_fake_mesh

    with fake_world(math.prod(dims), rank=rank):
        yield make_fake_mesh(tuple(dims), ("data", "model"), device)


def dry_train(plan, key, device, rank=0):
    """(rank ``rank``'s ``StepCosts`` of a train part's step on the plan's
    mesh, memory not tracked, and ``predicted_train_comm`` of it)."""
    from repro_torch.distributed import steps
    from repro_torch.launch import dryrun, step_analysis

    cfg, shape = _train_shape(plan, key)
    with _dry_mesh(plan["mesh"], device, rank) as mesh:
        step, specs = steps.build_train_step(cfg, shape, mesh)
        args = dryrun.train_args(specs["model"].cfg, shape, mesh, specs, plan[key]["step"])
        costs = step_analysis.analyze(step, args, mesh, device, memory=False)
        return costs, predicted_train_comm(cfg, shape, mesh, specs["params"])


def dry_serve(plan, key, dtype, rung, device, rank=0):
    """Rank ``rank``'s ``StepCosts`` of one (dtype, rung) serve of a part:
    the prefill with the decode cache's fill (``sharded_prefill``), and one
    decode step at the prompt's end (the run makes ``new`` of those);
    memory not tracked."""
    from repro_torch.core.nesting import set_tree_rung
    from repro_torch.distributed import steps
    from repro_torch.launch import dryrun, step_analysis

    part = plan[key]
    cfg = dataclasses.replace(_plan_config(part), compute_dtype=dtype)
    pshape, dshape = _serve_shapes(part)
    with _dry_mesh(plan["mesh"], device, rank) as mesh:
        prefill, ps, decode, ds = _serve_steps(cfg, part, mesh)
        pre_params, inputs = dryrun.prefill_args(
            cfg, pshape, mesh, ps, set_tree_rung(ps["abstract_params"], rung))
        params, tok, cache = dryrun.decode_args(
            cfg, dshape, mesh, ds, part["prompt"], set_tree_rung(ds["abstract_params"], rung))

        def prefill_and_fill(p, i, c):
            logits, pcache = prefill(p, i)
            return logits, steps.fill_decode_cache(c, pcache, mesh, ps["cache"], ds["cache"])

        pre = step_analysis.analyze(prefill_and_fill, (pre_params, inputs, cache), mesh, device,
                                    memory=False)
        dec = step_analysis.analyze(decode, (params, tok, cache), mesh, device, memory=False)
    return pre, dec


def _dry_totals(parts):
    """(per collective [calls, payload], per kernel [launches, decode body,
    tensor cores, short-prefill body, f32 body]) of ``parts``: (StepCosts,
    calls) pairs summed."""
    comm, kern = {}, {}
    for costs, n in parts:
        for op, calls in costs.num_collectives.items():
            c = comm.setdefault(op, [0, 0])
            c[0] += n * calls
            c[1] += n * costs.payload_bytes[op]
        for name, k in costs.kernels.items():
            c = kern.setdefault(name, [0, 0, 0, 0, 0])
            for i, f in enumerate(("dry_launches", "decode", "tensor_core", "mid", "f32")):
                c[i] += n * k[f]
    return comm, kern


def _measured_totals(comm_counts, k_totals):
    """The same of a rank's measured ``comm.counts()`` and ``_k_totals()``."""
    comm = {op: [c["calls"], c["payload_bytes"]] for op, c in comm_counts.items()
            if c["calls"]}
    kern = {n: [c["launches"], c["dec"], c["tc"], c["mid"], c["f32"]]
            for n, c in k_totals.items()
            if c["launches"]}
    return comm, kern


def _check_dry(tag, dry, measured, rows, rank=0):
    rows.append({"what": tag, "rank": rank, "dry": dry, "measured": measured,
                 "equal": dry == measured})
    log(f"[dryrun] {tag}: collectives {dry[0]}, kernels {dry[1]}; measured "
        f"{'the same' if dry == measured else measured}")
    if dry != measured:
        raise AssertionError(f"{tag}: dry run {dry} differs from rank {rank}'s measured "
                             f"{measured}")


def _check_k5_offset(tag, costs, cfg, batch, seq, rank, blocks, rows):
    """K5's dry FLOPs of rank ``rank`` of sequence-parallel attention (query
    block ``rank`` of ``blocks``) against ``flash_cost`` at the block's
    offset, for each of its launches."""
    from repro_torch.kernels import costs as card

    n = -(-seq // blocks)
    q = torch.empty(batch, n, cfg.num_heads, cfg.head_dim, device="meta")
    k = torch.empty(batch, seq, cfg.num_kv_heads, cfg.head_dim, device="meta")
    k5 = costs.kernels["flash_attention"]
    want = k5["dry_launches"] * card.flash_cost(q, k, q_offset=rank * n)[1]
    rows.append({"what": f"{tag}: K5 FLOPs at offset {rank * n}", "rank": rank,
                 "dry": k5["flops"], "flash_cost": want, "equal": k5["flops"] == want})
    log(f"[dryrun] {tag}: K5 {k5['dry_launches']} launches, {k5['flops'] / 1e12:.4f} TFLOP "
        f"dry, flash_cost at offset {rank * n} {want / 1e12:.4f} TFLOP")
    if k5["flops"] != want:
        raise AssertionError(f"{tag}: K5 dry FLOPs {k5['flops']} != flash_cost {want}")


def _dry_worlds():
    """(phase, plan, serve keys) of every world phases 9 and 10 run."""
    return ([("9", sharded_plan(), ("serve",))]
            + [(f"10 {job}", plan, ("serve", "hybrid"))
               for job, plan in seq_ssm_plans().items()])


def _full_step(device):
    """(config, shape, (1, 1) mesh, step, specs) of (b): qwen2-1.5b at all 28
    layers, 2 x 2048 in one microbatch, the world-1 ``build_train_step``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import shape_only

    cfg = get_config("qwen2-1.5b")
    shape = ShapeConfig("dry_train", "train", TRAIN_SEQ, TRAIN_BATCH, microbatch=TRAIN_BATCH)
    one = shape_only((1, 1), ("data", "model"), device)
    step, specs = steps.build_train_step(cfg, shape, one)
    return cfg, shape, one, step, specs


def dry_runs(device):
    """Every dry run of phase 11, from the plans alone (no measurement
    needed; ``main`` traces them while nvcc builds the kernels and the main
    process would wait): each world's train step, each (dtype, rung) serve,
    phase 10's (1, 8) world as its last model rank, (b)'s step with memory
    tracked and phase 9's train step again on fake CPU tensors."""
    from repro_torch.launch import dryrun, step_analysis

    t0 = time.perf_counter()
    out = {"train": {}, "serve": {}}
    for phase, plan, keys in _dry_worlds():
        out["train"][phase] = dry_train(plan, "train", device)
        for key in (k for k in keys if k in plan):
            part = plan[key]
            for dt in part["dtypes"]:
                for rung in _rungs(part, dt):
                    out["serve"][(phase, key, dt, rung)] = dry_serve(plan, key, dt, rung, device)
    out["last"] = dry_runs_last(device)
    cfg, shape, one, step, specs = _full_step(device)
    out["full"] = step_analysis.analyze(
        step, dryrun.train_args(specs["model"].cfg, shape, one, specs, 50), one, device)
    out["cpu"] = dry_train(sharded_plan(), "train", "cpu")[0]
    out["seconds"] = time.perf_counter() - t0
    log(f"[dryrun] the dry runs traced in {out['seconds']:.1f}s")
    return out


def dry_runs_last(device):
    """Phase 10's (1, 8) world dry-run as its last model rank (its query
    block at the largest offset; in the serve, the rank that holds the
    decode steps' positions): the train step and each (dtype, rung) serve."""
    t0 = time.perf_counter()
    plan = seq_ssm_plans()["seq"]
    rank = plan["mesh"][1] - 1                  # data row 0's last model rank
    out = {"rank": rank, "train": dry_train(plan, "train", device, rank)[0], "serve": {}}
    part = plan["serve"]
    for dt in part["dtypes"]:
        for rung in _rungs(part, dt):
            out["serve"][(dt, rung)] = dry_serve(plan, "serve", dt, rung, device, rank)
    out["seconds"] = time.perf_counter() - t0
    log(f"[dryrun] phase 10's last model rank traced in {out['seconds']:.1f}s")
    return out


def dry_against_ranks(dry, sharded, seq_ssm):
    """(a): the dry runs of every train step and every (dtype, rung) serve
    that phases 9 and 10 ran against rank 0's measured collectives
    (calls, payload) and launches (per kernel and body); phase 9 (a)'s
    all-reduce also against ``predicted_train_comm``.  Phase 9 (c)'s MoE
    serve routes by the data, which a dry run does not hold (it gives
    every expert an equal share), so it is left out."""
    ranks_of = {"9": sharded["ranks"]}
    ranks_of.update({f"10 {job}": w["ranks"] for job, w in seq_ssm["worlds"].items()})
    rows = []
    for phase, plan, keys in _dry_worlds():
        r0 = next(r for r in ranks_of[phase] if r["rank"] == 0)
        costs, pred = dry["train"][phase]
        sound = r0["train"]["sound"]
        _check_dry(f"phase {phase} train {plan['train']['arch']} on {plan['mesh']}",
                   _dry_totals([(costs, 1)]),
                   _measured_totals(sound["comm"], sound["counts"]), rows)
        if phase == "9":
            got = {"all_reduce": costs.payload_bytes.get("all_reduce", 0),
                   "all_gather": costs.payload_bytes.get("all_gather", 0)}
            rows.append({"what": "phase 9 train against predicted_train_comm", "dry": got,
                         "predicted": pred, "equal": got == pred})
            log(f"[dryrun] phase 9 train: dry all-reduce {got['all_reduce'] / 1e6:.3f} MB, "
                f"predicted_train_comm {pred['all_reduce'] / 1e6:.3f} MB")
            if got != pred:
                raise AssertionError(f"phase 9 train: dry run {got} != predicted {pred}")
        for (ph, key, dt, rung), (pre, dec) in dry["serve"].items():
            if ph != phase:
                continue
            part = plan[key]
            run = r0[key]["runs"][f"{dt}/{rung}"]
            _check_dry(f"phase {phase} {key} {part['arch']} {dt} rung {rung} on "
                       f"{plan['mesh']} (prefill + {part['new']} decode steps)",
                       _dry_totals([(pre, 1), (dec, part["new"])]),
                       _measured_totals(run["comm"], run["counts"]), rows)
    rows += dry_last_against_rank(dry["last"], seq_ssm)
    return rows


def dry_last_against_rank(last, seq_ssm):
    """(a) for phase 10's (1, 8) world as its last model rank: the dry runs
    of ``dry_runs_last`` against that rank's measured collectives and
    launches, and K5's dry FLOPs against ``flash_cost`` at the rank's
    query offset (the train step's launches, forward and recompute, and
    the prefill's)."""
    plan = seq_ssm_plans()["seq"]
    rank, blocks = last["rank"], plan["mesh"][1]
    measured = next(r for r in seq_ssm["worlds"]["seq"]["ranks"] if r["rank"] == rank)
    rows = []
    cfg, shape = _train_shape(plan)
    sound = measured["train"]["sound"]
    tag = f"phase 10 seq train {plan['train']['arch']} on {plan['mesh']} as rank {rank}"
    _check_dry(tag, _dry_totals([(last["train"], 1)]),
               _measured_totals(sound["comm"], sound["counts"]), rows, rank)
    _check_k5_offset(tag, last["train"], cfg, shape.microbatch, shape.seq_len, rank, blocks,
                     rows)
    part = plan["serve"]
    for (dt, rung), (pre, dec) in last["serve"].items():
        run = measured["serve"]["runs"][f"{dt}/{rung}"]
        tag = (f"phase 10 seq serve {part['arch']} {dt} rung {rung} on {plan['mesh']} as "
               f"rank {rank}")
        _check_dry(f"{tag} (prefill + {part['new']} decode steps)",
                   _dry_totals([(pre, 1), (dec, part["new"])]),
                   _measured_totals(run["comm"], run["counts"]), rows, rank)
        _check_k5_offset(f"{tag} prefill", pre, _plan_config(part), part["batch"],
                         part["prompt"], rank, blocks, rows)
    return rows


def full_step_check(costs, device):
    """(b): the step of ``_full_step`` run once on the card against its dry
    run ``costs``: the predicted peak against ``max_memory_allocated``
    (above what was allocated before the arguments), the dry K5 launches
    against 2 x 28 and the launched ones, ``useful_flops_ratio`` against
    the reference's limits, the roofline beside the step's wall and
    device busy time."""
    from repro_torch import tree
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun, step_analysis
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw

    cfg, shape, _, step, specs = _full_step(device)
    terms = step_analysis.roofline_terms(costs)
    useful = dryrun.model_flops(cfg, shape) / costs.flops
    k5_dry = costs.kernels.get("flash_attention", {}).get("dry_launches", 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = init_params(specs["model"].cfg, seed=0, device=device)
    opt = adamw.init_state(params)
    m_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(opt.m))
    batch = train_batch(cfg, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counters()
    (params, opt, metrics), wall, ev = _events(lambda: step(params, opt, batch, 50))
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    k5 = dispatch.COUNTERS["flash_attention"]
    busy = sum(t for _, t in ev)
    loss = metrics["loss"].item()
    del params, opt, metrics, batch
    torch.cuda.empty_cache()
    gap = abs(costs.peak_bytes - measured) / measured
    control = abs(costs.peak_bytes - m_bytes - measured) / measured
    out = {"predicted_peak_bytes": costs.peak_bytes, "measured_peak_bytes": measured,
           "peak_gap": gap, "control_without_m_gap": control, "m_bytes": m_bytes,
           "argument_bytes": costs.argument_bytes, "k5_dry_launches": k5_dry,
           "k5_launches": k5.launches, "k5_plain": k5.plain_launches,
           "flops": costs.flops, "bytes": costs.bytes, "useful_flops_ratio": useful,
           "roofline": terms, "wall_s": wall, "device_busy_ms": busy, "loss": loss,
           "trace_s": costs.trace_s}
    log(f"[dryrun] (b) qwen2-1.5b train 2x2048, 28 layers, world 1: predicted peak "
        f"{costs.peak_bytes / 1e9:.3f} GB, measured {measured / 1e9:.3f} GB (gap {gap:.2e}, "
        f"limit {DRY_PEAK_TOL}; control without m {control:.2e}); K5 dry {k5_dry}, "
        f"launched {k5.launches}; {costs.flops / 1e12:.2f} TFLOP counted, useful "
        f"{useful:.3f}; roofline compute {terms['compute_s'] * 1e3:.1f} ms, memory "
        f"{terms['memory_s'] * 1e3:.1f} ms, collective {terms['collective_s'] * 1e3:.1f} ms "
        f"({terms['dominant']}) beside wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms; "
        f"traced in {costs.trace_s:.1f}s")
    for kind in ("bytes", "flops"):
        top = step_analysis.top_contributors(costs, kind, 5)
        out[f"top_{kind}"] = top
        log(f"[dryrun] (b) top {kind}: " + "; ".join(
            f"{op} at {where or 'its kernel'} {v / 1e9:.1f} G" for v, op, where in top))
    if not gap <= DRY_PEAK_TOL < control:
        raise AssertionError(f"(b) peak: gap {gap:.3e}, control {control:.3e}, limit "
                             f"{DRY_PEAK_TOL}")
    want = 2 * cfg.num_layers
    if k5_dry != want or k5.launches != want or k5.plain_launches:
        raise AssertionError(f"(b) K5: dry {k5_dry}, launched {k5.launches} ({k5.plain_launches}"
                             f" plain), want {want}")
    lo, hi = DRY_USEFUL_RANGE
    if not lo < useful < hi:
        raise AssertionError(f"(b) useful_flops_ratio {useful:.3f} outside ({lo}, {hi})")
    return out


def _counts_of(costs):
    return {"flops": costs.flops, "bytes": costs.bytes,
            "kernels": costs.kernels, "num_collectives": costs.num_collectives,
            "payload_bytes": costs.payload_bytes, "per_collective": costs.per_collective}


def phase_dryrun(dry, sharded, seq_ssm):
    """Phase 11: the dry runs (``dry_runs``) held against what phases 8-10
    measured; see the module docstring."""
    t0 = time.perf_counter()
    rows = dry_against_ranks(dry, sharded, seq_ssm)
    full = full_step_check(dry["full"], DEVICE)
    cpu, cuda = dry["cpu"], dry["train"]["9"][0]
    same = _counts_of(cpu) == _counts_of(cuda)
    log(f"[dryrun] (c) phase 9 train dry-run on cpu: {'the same' if same else 'other'} counts "
        f"as on cuda ({cpu.flops / 1e12:.3f} TFLOP, {cpu.bytes / 1e9:.3f} GB; host-card "
        f"copies {cpu.transfer_bytes:.0f} B on cpu, {cuda.transfer_bytes:.0f} B on cuda)")
    if not same:
        raise AssertionError(f"(c) cpu counts {_counts_of(cpu)} != cuda {_counts_of(cuda)}")
    seconds = time.perf_counter() - t0
    log(f"[dryrun] phase 11 took {seconds:.1f}s after {dry['seconds']:.1f}s of dry runs "
        f"during the kernels' build ({smi_line()})")
    return {"checks": rows, "full_step": full, "device_independent": same,
            "dry_runs_s": dry["seconds"], "seconds": seconds}


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
    t_ops = tot("ops") / PEAK_FLOPS[torch.bfloat16] * 1e3
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


def short_prefill_summary(rows, name, mid_launches):
    """K1-K3's ``short_prefill`` entry: one short prefill's 196 launches at
    M = ``BATCH`` * ``PROMPT`` bf16 on the short-prefill body (every
    main-path shape but the LM head times its uses per forward), beside the
    same launches on the CUDA-core body (the "before"), the decode route in
    8-row groups and the tensor-core body; ``launches`` phase 2's on it."""
    M = BATCH * PROMPT
    sel = [r for r in rows if r["kernel"] == name and r["M"] == M and r["dtype"] == "bfloat16"
           and r["shape"] != "lm_head"]
    tot = lambda key: sum(r[key] * r["uses_per_forward"] for r in sel)  # noqa: E731
    t_bytes = tot("bytes") / HBM_BYTES_PER_S * 1e3
    t_ops = tot("ops") / PEAK_FLOPS[torch.bfloat16] * 1e3
    return {"route": "cuda", "source": "src/repro_torch/csrc/nest_matmul_mid.cu",
            "replaces": KERNELS[name][2], "body": "mid", "launches": mid_launches,
            "per": f"one short prefill: {sum(r['uses_per_forward'] for r in sel)} launches "
                   f"at M={M} bf16",
            "max_abs_err": max(r["max_abs_err"] for r in sel), "ms": tot("ms"),
            "cuda_core_ms": tot("cuda_core_ms"), "decode_ms": tot("decode_ms"),
            "tensor_core_ms": tot("tensor_core_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}


def f32_prefill_summary(rows, name, f32_launches):
    """K1-K3's ``f32_prefill`` entry: one long f32 prefill's 196 launches at
    M = 4096 on the f32 body (every main-path shape but the LM head times
    its uses per forward), beside the same launches on the CUDA-core body
    (the "before"), the plain version and the dense f32 yardstick;
    ``launches`` those of phases 3 and 5-f32 on the f32 body."""
    M = F32_MS[-1]
    sel = [r for r in rows if r["kernel"] == name and r["M"] == M and r["route"] == "f32"]
    tot = lambda key: sum(r[key] * r["uses_per_forward"] for r in sel)  # noqa: E731
    t_bytes = tot("bytes") / HBM_BYTES_PER_S * 1e3
    t_ops = tot("ops") / PEAK_FLOPS[torch.float32] * 1e3
    return {"route": "cuda", "source": F32_SOURCE, "replaces": KERNELS[name][2],
            "body": "f32", "launches": f32_launches,
            "per": f"one long f32 prefill: {sum(r['uses_per_forward'] for r in sel)} launches "
                   f"at M={M} f32",
            "max_abs_err": max(r["max_abs_err"] for r in sel), "ms": tot("ms"),
            "cuda_core_ms": tot("cuda_core_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
            "yardstick_dense_f32_matmul_ms": tot("dense_f32_matmul_ms")}


def kernel_summary(rows, launches, tc_launches, mid_launches, f32_launches, moe_info,
                   ssm_info, train_info, M=4, dtype="bfloat16"):
    """One entry per kernel: one decode step at batch M in ``dtype``
    (every main-path shape times its uses per forward) on the decode body,
    the same launches on the CUDA-core body beside it (``cuda_core_ms``);
    ``launches`` the main paths' (all bodies; phases 6 and 7 included),
    ``decode_launches`` those on the decode body; the long prefill's
    tensor-core launches as its ``prefill`` entry, the short prefill's
    short-prefill launches as its ``short_prefill`` entry, the long f32
    prefill's f32-body launches as its ``f32_prefill`` entry; phase 6's (all, decode
    body, tensor cores) as ``moe_launches``, phase 7's per model as
    ``ssm_launches``, phase 8's scoring (all, decode body, tensor cores) as
    ``score_launches``."""
    out = []
    for name, (_, source, replaces) in KERNELS.items():
        sel = [r for r in rows if r["kernel"] == name and r["M"] == M and r["dtype"] == dtype]
        tot = lambda key: sum(r[key] * r["uses_per_forward"] for r in sel)
        t_bytes = sum(r["bytes"] * r["uses_per_forward"] for r in sel) / HBM_BYTES_PER_S * 1e3
        t_ops = (sum(r["ops"] * r["uses_per_forward"] for r in sel)
                 / PEAK_FLOPS[torch.bfloat16] * 1e3)
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
            "prefill": prefill_summary(rows, name, tc_launches[name]),
            "short_prefill": short_prefill_summary(rows, name, mid_launches[name]),
            "f32_prefill": f32_prefill_summary(rows, name, f32_launches[name]),
            "moe_launches": moe_info["launches"][name] + (moe_info["tc_launches"][name],),
            "ssm_launches": {arch: m["launches"][name] for arch, m in ssm_info.items()},
            "score_launches": train_info["launches"][name]})
    return out


def kv_kernel_summary(rows, launches, moe_flash, ssm_flash, train, f32_launches):
    """K4-K6 entries of the kernels line, each at its main-path shape: K4 on
    the served cache (rung 2 of (4, 6, 8), one decode token's G = 6 query
    heads per kv head), K5 one long prefill's attention (S = 2048, bf16,
    per layer; ``moe_flash`` its check at phase 6's shape; the f32 body's
    launch at the same shape as its ``f32`` entry, ``f32_launches`` phase
    5-f32's), K6 one page-in
    of every weight slice of the tree at (n, h) = (6, 4)."""
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
        if name == "flash_attention":
            out[-1].update(moe_check=moe_flash, ssm_check=ssm_flash,
                           train_launches=train["k5_launches"],
                           with_stats=sel[0]["with_stats"])
            r32 = next(r for r in rows if r["kernel"] == "flash_attention"
                       and r["S"] == PROMPT_LONG and r["dtype"] == "float32")
            out[-1]["f32"] = {
                "per": "one launch: B=2, S=2048, 12/2 heads of 128, f32 (the f32 body)",
                "launches": f32_launches,
                **{key: r32[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}}
            offset = [r for r in rows if r["kernel"] == "flash_attention_offset"
                      and r["dtype"] == "bfloat16"]
            last = max(offset, key=lambda r: r["q_offset"])
            out[-1]["offset"] = {
                "per": f"one launch: B=2, rows {last['q_offset']}..{last['Skv'] - 1} of "
                       f"{last['Skv']}, 12/2 heads of 128, bf16 (phase 10's last model rank)",
                **{key: last[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms", "equals_whole_rows")},
                "all_blocks_ms": sum(r["ms"] for r in offset),
                "all_blocks_bound_ms": sum(r["bound_ms"] for r in offset)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", type=Path, default=ROOT / "build" / "chip_smoke.json",
                    help="where the JSON report of every phase is written")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:            # one rank of phase 9 or 10 (run_ranks starts it)
        return sharded_rank(args.rank, args.world, args.workdir)
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
    # phase 11's dry runs need the plans alone: they trace while nvcc builds
    dry_costs = {}
    rows = timed_phase("1", phase_kernels, cfg, gen,
                       during=lambda: dry_costs.update(dry_runs(DEVICE)))
    kv_rows = timed_phase("4", phase_kv_kernels, cfg, gen)
    engine, store, phases, launches = timed_phase("2", phase_serve, cfg)
    mid_launches = {n: launches[n][2] for n in KERNELS}
    profile_info = timed_phase("2-profile", phase_profile, engine, store, cfg,
                               packed_linears_per_forward(store))
    reference = timed_phase("3", phase_reference, cfg, store)
    f32_launches = reference.pop("f32_launches")
    del engine
    artifact = timed_phase("3b", phase_artifact, cfg, store, phases,
                           packed_linears_per_forward(store))
    spec = timed_phase("3c", phase_spec_faults, cfg, store, packed_linears_per_forward(store),
                       gen)
    peak_before_fleet = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fleet = timed_phase("3d", phase_fleet, cfg, store, packed_linears_per_forward(store))
    launches = {n: tuple(launches[n][i] + artifact["launches"][n][i] + spec["launches"][n][i]
                         + fleet["launches"][n][i] for i in range(2))
                for n in KERNELS}
    peak_before_long = max(peak_before_fleet, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    long_engine_, dense, long_info = timed_phase("5", phase_long_serve, cfg, store,
                                                 packed_linears_per_forward(store))
    long_info["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[long] peak device memory over the five long generates "
        f"{long_info['peak_mem_bytes'] / 1e9:.2f} GB")
    served_kv = timed_phase("5-kv", phase_served_kv_attention, long_engine_, dense, cfg, gen)
    del dense
    long_profile = timed_phase("5-profile", phase_long_profile, long_engine_, cfg)
    del long_engine_
    long_f32 = timed_phase("5-f32", phase_long_f32, cfg, store)
    f32_launches = {n: f32_launches[n] + long_f32["f32_launches"][n] for n in KERNELS}
    served_recompose = timed_phase("5-k6", phase_served_recompose, store)
    del store
    torch.cuda.empty_cache()
    peak_before_moe = max(peak_before_long, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    moe_info = timed_phase("6", phase_moe, gen)
    moe_info["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[moe] peak device memory over phase 6 {moe_info['peak_mem_bytes'] / 1e9:.2f} GB")
    peak_before_ssm = max(peak_before_moe, moe_info["peak_mem_bytes"])
    ssm_info = timed_phase("7", phase_ssm, gen)
    peak_before_train = max([peak_before_ssm]
                            + [m["peak_mem_bytes"] for m in ssm_info.values()])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_info = timed_phase("8", phase_train)
    train_info["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[train] peak device memory over phase 8 {train_info['peak_mem_bytes'] / 1e9:.2f} GB")
    torch.cuda.empty_cache()
    sharded = timed_phase("9", phase_sharded)
    torch.cuda.empty_cache()
    train_cli = TrainCliRuns()         # phase 8(d), beside phase 10
    try:
        seq_ssm = timed_phase("10", phase_seq_ssm_sharded)
        torch.cuda.empty_cache()
        train_info["cli"] = timed_phase("8-cli", train_cli_check, train_cli)
    finally:
        train_cli.stop()
    dry = timed_phase("11", phase_dryrun, dry_costs, sharded, seq_ssm)
    launches = {n: tuple(launches[n][i] + moe_info["launches"][n][i]
                         + sum(m["launches"][n][i] for m in ssm_info.values())
                         + train_info["launches"][n][i]
                         for i in range(2))
                for n in KERNELS}
    kv_launches = {"flash_attention": (long_info["launches"]["flash_attention"]
                                       + moe_info["flash_launches"]
                                       + sum(m["flash_launches"] for m in ssm_info.values())
                                       + train_info["k5_launches"]),
                   "nested_qk": served_kv["launches"],
                   "nest_recompose": served_recompose["launches"]}
    kernels = (kernel_summary(rows, launches, long_info["tc_launches"], mid_launches,
                              f32_launches, moe_info, ssm_info, train_info)
               + kv_kernel_summary(kv_rows, kv_launches, moe_info["flash_check"],
                                   ssm_info["zamba2-2.7b"]["flash_check"], train_info,
                                   long_f32["k5_launches"]))
    for k in kernels:          # phases 9 and 10, summed over their rank processes
        if k["name"] in sharded["launches"]:
            k["sharded_launches"] = sharded["launches"][k["name"]]
            k["seq_ssm_launches"] = seq_ssm["launches"][k["name"]]
        if k["name"] == "flash_attention":
            k["sharded_launches"] = sharded["k5_launches"]
            k["seq_ssm_launches"] = seq_ssm["k5_launches"]
    steps = {f"M={M} {dt}": decode_steps(rows, M, dt) for M in MS if M <= 8
             for dt in ("bfloat16", "float32")}
    for key, by in steps.items():
        log(f"[decode-step] {key}: " + "; ".join(
            f"{n} {v['ms']:.3f} ms (cuda-core {v['cuda_core_ms']:.3f}, dense bf16 "
            f"{v['dense_bf16_matmul_ms']:.3f}, bound {v['bound_ms']:.3f})" for n, v in by.items()))
    layers = mid_layers(rows)
    layers32 = f32_layers(rows)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "rows": rows, "kv_rows": kv_rows, "serve": phases, "profile": profile_info,
              "reference": reference, "artifact": artifact, "spec_faults": spec,
              "fleet": fleet,
              "long_serve": long_info, "served_kv": served_kv,
              "long_profile": long_profile, "long_f32": long_f32,
              "served_recompose": served_recompose, "moe": moe_info, "ssm": ssm_info,
              "train": train_info, "sharded": sharded, "seq_ssm": seq_ssm, "dryrun": dry,
              "kernels": kernels, "decode_steps": steps, "phase_s": PHASE_S,
              "mid_layers": layers, "f32_layers": layers32,
              "peak_mem_bytes": max(peak_before_train, train_info["peak_mem_bytes"]),
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
