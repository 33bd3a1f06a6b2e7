"""Dry run of every (arch x shape) cell on the production meshes: what one
step of each would cost per card, without a card; counterpart of
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell with XLA on 512 fake host
devices and reads memory, FLOPs, bytes and collectives off the compiled
program: one SPMD program, the same on every device.  The port runs each
cell's step builder (``distributed/steps.py``) as one rank of a fake world
of 256 or 512 ranks (``launch/mesh.py::fake_world``) over fake tensors, and
counts the call with ``launch/step_analysis.py``.  Every rank holds blocks
of the same shapes (the rules split evenly or not at all), but not every
rank does the same work, and the record is the heaviest card's, since the
slowest card sets a step's time:

* where attention is sequence-parallel (``logical_rules(...)["attn_seq"]``:
  the heads do not divide ``model``), a model rank attends its query block
  at offset ``rank * n`` under the causal mask, and K5's work, and the
  blockwise backward's, grows with the offset.  A train or prefill cell is
  dry-run as rank 0 and as the last model rank of data row 0; the record's
  ``counts``, ``top``, ``roofline`` and ``memory`` are the last rank's, its
  ``lightest`` block holds rank 0's counts, and ``counted_flops_global``
  sums every rank of the mesh: from the two ends where the step is a
  forward alone (its counts are affine in the offset), from a dry run of
  every model offset in a train step (the backward skips the key blocks
  past each query block, so its counts rise in steps);
* a decode step on a cache whose sequence dim is split writes the new
  position on the rank that holds it: for a full cache, the last rank
  along the split axes, which is dry-run (every rank reads a full block);
* every other cell (head-parallel attention, whole caches, the ssm
  family) does equal work on every rank, and rank 0 is dry-run;
* on fake tensors MoE routing gives every expert an equal share, the
  remainder to the first experts: where the experts are split over
  ``model`` and the shares do not divide evenly, the first model ranks
  compute more rows, and every model rank of the row is dry-run.

The record's ``rank`` names the rank whose counts it holds where that is
not rank 0, and ``global_summed_from`` how the global FLOPs were summed
where the ranks differ.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--device cpu]

``--device cuda`` (the default) makes the fake tensors CUDA tensors, as
the step's would be; it needs a torch built with CUDA (no card), since a
CPU-only build aborts the whole process in a fake CUDA backward.  There,
``--device cpu`` gives the same counts (the wrappers take the route the
card would take on either).  Records land in
``build/dryrun/<arch>__<shape>__<mesh>.json``; a failing cell is recorded
with its error and the sweep carries on, and the exit code is then 1.
``--table`` prints the records of both meshes as one Markdown table.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from dataclasses import dataclass
from typing import Optional

import torch

from ..configs import ARCHS, SHAPES, get_config, supports_shape
from ..distributed import steps as steps_lib
from ..distributed.sharding import (cache_pspecs, local_shard, logical_rules, shard_tree,
                                    spec_axes)
from ..models import moe
from ..models.model import make_model
from ..optim import adamw
from . import step_analysis
from .mesh import fake_world, make_fake_mesh, production_shape, shape_only

DEFAULT_OUT = "build/dryrun"


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D train / 2*N_active*D forward,
    plus attention score/value and SSD-scan terms (not part of 6ND)."""
    n = cfg.param_count()
    if cfg.num_experts:
        # embedding/head + attention stay dense; experts scale by top_k/E
        expert = cfg.num_layers * cfg.num_experts * 3 * cfg.d_model * cfg.d_ff
        n = n - expert + expert * cfg.top_k / cfg.num_experts
    B, S = shape.global_batch, shape.seq_len

    # attention "KV" flops (per fwd pass)
    attn_fwd = 0.0
    if cfg.family in ("dense", "moe"):
        # QK + PV, causal => S^2/2 each
        attn_fwd = cfg.num_layers * 2.0 * B * cfg.num_heads * cfg.head_dim * S * S * 0.5 * 2
    elif cfg.family == "hybrid":
        napps = (cfg.num_layers + cfg.hybrid_attn_every - 1) // cfg.hybrid_attn_every
        attn_fwd = napps * 2.0 * B * cfg.num_heads * cfg.head_dim * S * S * 0.5 * 2
    ssd_fwd = 0.0
    if cfg.family in ("ssm", "hybrid"):
        Q, N, din = cfg.ssm_chunk, cfg.ssm_state, cfg.d_inner
        ssd_fwd = cfg.num_layers * 2.0 * B * S * (Q * N + Q * din + 2 * din * N)

    if shape.kind == "train":
        return 6.0 * n * B * S + 3.0 * (attn_fwd + ssd_fwd)
    if shape.kind == "prefill":
        return 2.0 * n * B * S + attn_fwd + ssd_fwd
    # decode: one token per sequence; attention reads the whole cache
    attn_dec = 0.0
    if cfg.family in ("dense", "moe"):
        attn_dec = cfg.num_layers * 4.0 * B * cfg.num_heads * cfg.head_dim * S
    elif cfg.family == "hybrid":
        napps = (cfg.num_layers + cfg.hybrid_attn_every - 1) // cfg.hybrid_attn_every
        attn_dec = napps * 4.0 * B * cfg.num_heads * cfg.head_dim * S
    ssd_dec = 0.0
    if cfg.family in ("ssm", "hybrid"):
        N, din = cfg.ssm_state, cfg.d_inner
        ssd_dec = cfg.num_layers * 6.0 * B * din * N
    return 2.0 * n * B + attn_dec + ssd_dec


def check_device(device) -> None:
    """Refuse fake CUDA tensors on a torch built without CUDA, where a fake
    CUDA backward aborts the process (no exception to record)."""
    if torch.device(device).type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("this torch is built without CUDA: a fake CUDA backward aborts "
                           "the process; dry-run with device 'cpu' (the same counts)")


def train_args(cfg, shape, mesh, specs, step: int = 1):
    """Abstract local arguments of a train step: bf16 params, the f32 AdamW
    state, the batch."""
    params = specs["abstract_params"]
    opt = adamw.init_state(params)
    batch = steps_lib.input_specs(cfg, shape)
    return (shard_tree(params, specs["params"], mesh), shard_tree(opt, specs["opt"], mesh),
            {k: local_shard(v, specs["batch"][k], mesh) for k, v in batch.items()}, step)


def prefill_args(cfg, shape, mesh, specs, params=None):
    """Abstract local arguments of a prefill step (``params``: the whole
    abstract tree, by default the step's ``abstract_params``)."""
    inputs = steps_lib.input_specs(cfg, shape)
    params = specs["abstract_params"] if params is None else params
    return (shard_tree(params, specs["params"], mesh),
            {k: local_shard(v, specs["batch"][k], mesh) for k, v in inputs.items()})


def decode_args(cfg, shape, mesh, specs, pos=None, params=None):
    """Abstract local arguments of a decode step: the cache holds ``pos``
    positions (default a full cache, its last position next); ``params``
    as in :func:`prefill_args`."""
    io = steps_lib.input_specs(cfg, shape, model=make_model(cfg, device="meta"))
    cache = shard_tree(io["cache"], specs["cache"], mesh)
    cache["pos"] = shape.seq_len - 1 if pos is None else pos
    params = specs["abstract_params"] if params is None else params
    return (shard_tree(params, specs["params"], mesh),
            {k: local_shard(v, specs["batch"][k], mesh) for k, v in io["inputs"].items()},
            cache)


def cell_step(cfg, shape, mesh, quant=None):
    """(step, its abstract local arguments) of one cell on ``mesh``."""
    if shape.kind == "train":
        step, specs = steps_lib.build_train_step(cfg, shape, mesh)
        return step, train_args(specs["model"].cfg, shape, mesh, specs)
    if shape.kind == "prefill":
        step, specs = steps_lib.build_prefill_step(cfg, shape, mesh, quant)
        return step, prefill_args(cfg, shape, mesh, specs)
    step, specs = steps_lib.build_decode_step(cfg, shape, mesh, quant)
    return step, decode_args(cfg, shape, mesh, specs)


def counts_record(costs) -> dict:
    """The ``counts`` block of a record (the reference's ``hlo`` block)."""
    return {"flops_per_device": costs.flops, "aten_flops_per_device": costs.aten_flops,
            "kernel_flops_per_device": costs.kernel_flops,
            "bytes_per_device": costs.bytes, "aten_bytes_per_device": costs.aten_bytes,
            "kernel_bytes_per_device": costs.kernel_bytes,
            "transfer_bytes_per_device": costs.transfer_bytes,
            "collective_bytes_per_device": costs.collective_bytes,
            "per_collective": costs.per_collective,
            "num_collectives": costs.num_collectives,
            "payload_bytes": costs.payload_bytes, "kernels": costs.kernels}


def dry_rank(cfg, shape, dims, axes, device, rank: int = 0, memory: bool = True):
    """``StepCosts`` of one cell's step dry-run as rank ``rank`` of a fake
    world on the mesh ``dims`` / ``axes``."""
    with fake_world(math.prod(dims), rank=rank):
        mesh = make_fake_mesh(tuple(dims), tuple(axes), device)
        step, args = cell_step(cfg, shape, mesh)
        return step_analysis.analyze(step, args, mesh, device, memory=memory)


def new_position_rank(cfg, shape, dims, axes) -> int:
    """The rank that writes a decode step's new position into a full cache
    whose sequence dim the step splits: the last block along the split
    axes (the others at 0; ranks are row-major); 0 where the cache is
    whole."""
    spec = cache_pspecs(cfg, shape, shape_only(dims, axes)).get("k")
    seq = spec_axes((spec[2],)) if spec is not None else ()
    rank = 0
    for n, a in zip(dims, axes):
        rank = rank * n + (n - 1 if a in seq else 0)
    return rank


@dataclass
class CellCosts:
    """A cell's dry runs: the heaviest rank's costs (the record's), the
    lightest's where the ranks dry-run differ, and the FLOPs of every rank
    summed (``summed`` says how, for the record)."""
    rank: int
    costs: step_analysis.StepCosts
    flops_global: float
    summed: str
    light_rank: Optional[int] = None
    light: Optional[step_analysis.StepCosts] = None
    trace_s: float = 0.0


def _bound_s(costs) -> float:
    terms = step_analysis.roofline_terms(costs)
    return max(terms["compute_s"], terms["memory_s"], terms["collective_s"])


def _uneven_experts(cfg, rules, M: int, log) -> bool:
    """Whether a dry run's MoE dispatches (``moe.record_groups``'s log) leave
    the model ranks different row counts: experts split over ``model``,
    equal shares whose remainder falls unevenly (``moe.dry_owner_rows``)."""
    if "model" not in spec_axes((rules.get("experts"),)):
        return False
    return any(len(set(moe.dry_owner_rows(g.tokens, cfg.top_k, cfg.num_experts, M,
                                          g.capacity))) > 1 for g in log)


def dry_cell(cfg, shape, dims, axes, device="cuda") -> CellCosts:
    """Dry-run one cell on the mesh ``dims`` / ``axes`` as the ranks whose
    work differs (module docstring); ``model`` is the last axis, so the
    model ranks of one data row are consecutive.  Where the dry run's
    equal expert shares leave the first model ranks more rows, every
    model rank of the row is dry-run.  The heaviest rank is the one with
    the longest roofline bound (then the most bytes, FLOPs, the lowest
    rank)."""
    t0 = time.time()
    chips = math.prod(dims)
    M = dict(zip(axes, dims))["model"]
    rules = logical_rules(cfg, shape, shape_only(dims, axes))
    seq = shape.kind != "decode" and rules["attn_seq"]
    home = new_position_rank(cfg, shape, dims, axes) if shape.kind == "decode" else 0
    row = range(home - home % M, home - home % M + M)

    def run(rank, memory=True):
        return dry_rank(cfg, shape, dims, axes, device, rank, memory=memory)

    tracked = {home, row[-1]} if seq else {home}      # dry-run with memory
    with moe.record_groups() as log:
        runs = {r: run(r) for r in sorted(tracked)}
    if _uneven_experts(cfg, rules, M, log) or (seq and shape.kind == "train"):
        for r in row:
            if r not in runs:
                runs[r] = run(r, memory=False)
        per_row = sum(runs[r].flops for r in row)
        summed = "every model rank"
    elif seq:
        per_row = M * (runs[row[0]].flops + runs[row[-1]].flops) / 2
        summed = "the first and last model ranks (affine in the offset)"
    else:
        per_row = M * runs[home].flops
        summed = "every rank alike"

    def weight(r):
        return (_bound_s(runs[r]), runs[r].bytes, runs[r].flops, -r)
    heavy = max(runs, key=weight)
    light = min(runs, key=weight)
    if heavy not in tracked:
        runs[heavy] = run(heavy)
    if weight(light) == weight(heavy):
        light = None
    return CellCosts(heavy, runs[heavy], per_row * (chips // M), summed, light,
                     None if light is None else runs[light], time.time() - t0)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str = DEFAULT_OUT,
             skip_existing: bool = False, device="cuda"):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_tag}.json")
    if skip_existing and os.path.exists(out_path):
        print(f"[skip existing] {out_path}")
        return True
    if not supports_shape(cfg, shape):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "skipped": True,
               "reason": "long_500k needs sub-quadratic attention; "
                         "full-attention arch (see DESIGN.md)"}
        _write(out_path, rec)
        print(f"[skip] {arch} x {shape_name}: full-attention arch")
        return True

    check_device(device)
    dims, axes = production_shape(multi_pod)
    try:
        cell = dry_cell(cfg, shape, dims, axes, device)
        costs = cell.costs
        terms = step_analysis.roofline_terms(costs)
        mf = model_flops(cfg, shape)
        rec = {
            "arch": arch, "shape": shape_name, "mesh": mesh_tag,
            "skipped": False, "chips": math.prod(dims), "device": str(device),
            "trace_s": round(cell.trace_s, 1),
            "memory": {
                "argument_bytes": costs.argument_bytes,
                "output_bytes": costs.output_bytes,
                "peak_bytes": costs.peak_bytes,
                "per_device_total": costs.peak_bytes,
            },
            "counts": counts_record(costs),
            "top": {kind: step_analysis.top_contributors(costs, kind, 5)
                    for kind in ("bytes", "flops", "collective")},
            "roofline": terms,
            "model_flops_global": mf,
            "counted_flops_global": cell.flops_global,
            "useful_flops_ratio": mf / cell.flops_global if cell.flops_global else None,
        }
        # a cell whose ranks do equal work keeps the record it always had
        if cell.rank:
            rec["rank"] = cell.rank
        if cell.light is not None:
            rec["lightest"] = {"rank": cell.light_rank, "counts": counts_record(cell.light)}
            rec["global_summed_from"] = cell.summed
        _write(out_path, rec)
        print(f"[ok] {arch} x {shape_name} x {mesh_tag} rank {cell.rank}: "
              f"trace={cell.trace_s:.0f}s peak={costs.peak_bytes / 1e9:.2f}GB "
              f"dom={terms['dominant']} "
              f"c/m/coll={terms['compute_s']:.4f}/{terms['memory_s']:.4f}/"
              f"{terms['collective_s']:.4f}s "
              f"useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}")
        return True
    except Exception as e:  # noqa: BLE001 - record the failure, keep sweeping
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        _write(out_path, rec)
        print(f"[FAIL] {arch} x {shape_name} x {mesh_tag}: {type(e).__name__}: {e}")
        return False


MESHES = ("pod16x16", "pod2x16x16")


def table(out_dir: str = DEFAULT_OUT) -> str:
    """The records under ``out_dir`` as a Markdown table: one row per
    supported cell, each figure given for the single-pod and the
    multi-pod mesh (``a / b``; a cell with an error says so)."""
    recs = {}
    for name in os.listdir(out_dir):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                r = json.load(f)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    cols = (("peak GB", lambda r: r["memory"]["peak_bytes"] / 1e9, ".2f"),
            ("TFLOP", lambda r: r["counts"]["flops_per_device"] / 1e12, ".3f"),
            ("HBM GB", lambda r: r["counts"]["bytes_per_device"] / 1e9, ".1f"),
            ("wire GB", lambda r: r["counts"]["collective_bytes_per_device"] / 1e9, ".3f"),
            ("dominant", lambda r: r["roofline"]["dominant"], ""),
            ("useful", lambda r: r["useful_flops_ratio"], ".3f"))
    lines = ["| arch | shape | " + " | ".join(c[0] for c in cols) + " |",
             "|---|---|" + "---|" * len(cols)]
    for arch in ARCHS:
        for shape in SHAPES:
            pair = [recs.get((arch, shape, m)) for m in MESHES]
            if all(r is None or r.get("skipped") for r in pair):
                continue
            cells = []
            for _, get, fmt in cols:
                vals = ["missing" if r is None else
                        "error" if "error" in r else format(get(r), fmt) for r in pair]
                cells.append(vals[0] if vals[0] == vals[1] else " / ".join(vals))
            lines.append(f"| {arch} | {shape} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def _write(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the fake tensors (no card needed; 'cpu' on a torch "
                         "built without CUDA)")
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out as a Markdown table and exit")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        raise SystemExit(0)
    check_device(args.device)

    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    ok = True
    for arch, shape in cells:
        ok &= run_cell(arch, shape, args.multi_pod, args.out,
                       skip_existing=args.skip_existing, device=args.device)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
