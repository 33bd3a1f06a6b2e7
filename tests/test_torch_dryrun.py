"""The dry run (``repro_torch/launch/dryrun.py``, ``launch/step_analysis.py``)
on the CPU: fake tensors and a fake world, ``device="cpu"`` throughout (a
CPU-only torch aborts the process in a fake CUDA backward).

* ``model_flops`` equals the reference's for all 40 cells;
* each kernel wrapper on fake tensors returns the plain version's shapes
  and dtypes, counts one dry launch per launch the card would make (the
  decode route once per 8 rows), leaves ``launches`` and
  ``plain_launches`` alone and records its cost function's work;
* a reduced train step dry-run on a one-device mesh against the JAX
  package's compiled step: argument bytes (the difference stated) and
  FLOPs (equal);
* the roofline, the tally, the CLI's records and the fake world's life;
* the ranks whose work differs: on a (1, 8) world where attention is
  sequence-split, each rank's K5 work is ``flash_cost`` at its offset, the
  record is the last rank's with rank 0's under ``lightest`` and the global
  FLOPs the eight ranks' sum; a head-parallel cell keeps rank 0's record;
  a split-cache decode dry-runs the rank holding the new position; uneven
  expert shares dry-run every model rank.

The dry run's collectives against the measured gloo worlds are in
test_torch_distributed (the worlds run there).
"""
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.distributed import steps as jsteps
from repro.launch import hlo_analysis
from repro.optim import adamw as jadamw
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.nesting import nest_quantize
from repro_torch.distributed import steps
from repro_torch.kernels import costs, dispatch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.nest_recompose import ops as nr
from repro_torch.kernels.nested_attention import ops as qk
from repro_torch.kernels.nested_matmul import ops as nops
from repro_torch.kernels.packed_matmul import ops as pops
from repro_torch.launch import dryrun, step_analysis
from repro_torch.launch.mesh import fake_world, make_fake_mesh, shape_only
from repro_torch.models import moe
from repro_torch.serving.kv_cache import _quantize_kv


def _reference_dryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS to 512 host devices when
    imported: import it with the variable restored afterwards, so no JAX
    backend started later in this process sees 512 devices."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


@pytest.fixture(autouse=True)
def no_world_left():
    """Every test that starts a fake world leaves no process group."""
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
@pytest.mark.parametrize("shape", sorted(JAX_SHAPES))
def test_model_flops_equals_the_reference(arch, shape):
    ref = _reference_dryrun()
    assert dryrun.model_flops(get_config(arch), SHAPES[shape]) == \
        ref.model_flops(jax_get_config(arch), JAX_SHAPES[shape])


# ---------------------------------------------------------------------------
# each kernel wrapper on fake tensors
# ---------------------------------------------------------------------------
def _fake(tree, mode):
    return step_analysis._map(tree, mode.from_tensor)


def _nested(bits, K=512, N=64, seed=0):
    w = torch.randn(K, N, generator=torch.Generator().manual_seed(seed))
    return nest_quantize(w, bits=bits, rounding="rtn", block=256)


def _matmul(name, nt, route):
    """(the wrapper of ``name`` as a function of (x, streams, scale), the
    streams and the scale of its rung)"""
    rung = {"packed_matmul": 0, "nested_matmul": 1, "ladder_matmul": 2}[name]
    scale = nt.rung_scale(rung).reshape(1, -1)
    streams = (nt.w_base,) + nt.deltas[:rung]
    if name == "packed_matmul":
        return (lambda x, s, sc: pops.packed_matmul(x, s[0], sc, k=nt.bits[0], K=nt.K,
                                                    block_k=nt.block, route=route),
                streams, scale)
    if name == "nested_matmul":
        return (lambda x, s, sc: nops.nested_matmul(x, s[0], s[1], sc, n=nt.bits[1],
                                                    h=nt.bits[0], K=nt.K, block_k=nt.block,
                                                    route=route), streams, scale)
    return (lambda x, s, sc: nops.ladder_matmul(x, s, sc, bits=nt.bits[:3], K=nt.K,
                                                block_k=nt.block, route=route),
            streams, scale)


@pytest.mark.parametrize("name", ["packed_matmul", "nested_matmul", "ladder_matmul"])
@pytest.mark.parametrize("M,dtype,route,launches,body", [
    (4, torch.bfloat16, None, 1, dispatch.DECODE),
    (20, torch.float32, dispatch.DECODE, 3, dispatch.DECODE),       # one per 8 rows
    (32, torch.bfloat16, None, 1, dispatch.MID),
    (64, torch.bfloat16, None, 1, dispatch.TENSOR_CORE),
    (64, torch.float32, None, 1, dispatch.F32),
    (4096, torch.float32, None, 1, dispatch.F32),
])
def test_matmul_wrappers_count_the_cards_launches_on_fake_tensors(name, M, dtype, route,
                                                                   launches, body):
    nt = _nested((4, 6, 8))
    call, streams, scale = _matmul(name, nt, route)
    x = torch.randn(M, nt.K, generator=torch.Generator().manual_seed(1)).to(dtype)
    want = call(x, streams, scale)                       # the plain version, on the CPU
    dispatch.reset_counters()
    with FakeTensorMode() as mode:
        fx, fs, fsc = _fake((x, streams, scale), mode)
        got = call(fx, fs, fsc)
    c = dispatch.counter(name)
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    assert (c.launches, c.plain_launches) == (0, 0)
    assert c.dry_launches == launches
    assert c.dry_dec_launches == launches * (body == dispatch.DECODE)
    assert c.dry_tc_launches == launches * (body == dispatch.TENSOR_CORE)
    assert c.dry_mid_launches == launches * (body == dispatch.MID)
    assert c.dry_f32_launches == launches * (body == dispatch.F32)
    step = dispatch.DEC_MAX_M if body == dispatch.DECODE else M
    work = [costs.matmul_cost(x[g:g + step], streams, nt.w_base.shape[1], dtype)
            for g in range(0, M, step)]
    assert (c.dry_bytes, c.dry_flops) == (sum(w[0] for w in work), sum(w[1] for w in work))


@pytest.mark.parametrize("M,route", [(9, None), (63, None), (16, dispatch.MID)])
def test_mid_route_dry_launch_and_its_partials(M, route):
    """bf16 at M 9-63, or a named short-prefill route, dry-runs one launch
    on the short-prefill body, and the call's peak holds the f32 partials
    that launch allocates on the card (``build.mid_workspace`` on an H100's
    132 SMs) beside its arguments and output."""
    from repro_torch.kernels import build

    nt = _nested((4, 6, 8), K=1536, N=256)
    call, streams, scale = _matmul("ladder_matmul", nt, route)
    x = torch.randn(M, nt.K, generator=torch.Generator().manual_seed(M)).bfloat16()
    dispatch.reset_counters()
    got = step_analysis.analyze(call, (x, streams, scale), shape_only((1, 1)), "cpu")
    c = dispatch.counter("ladder_matmul")
    assert (c.dry_launches, c.dry_mid_launches, c.dry_dec_launches, c.dry_tc_launches,
            c.launches) == (1, 1, 0, 0, 0)
    assert got.kernels["ladder_matmul"]["mid"] == 1
    per_row, tiles = build.mid_workspace(nt.bits[:3], 256, nt.K, nt.block, costs.SMS)
    assert tiles == 16 and per_row == (16 + 192) * 16
    held = got.argument_bytes + M * 256 * 2 + per_row * M * 4
    assert held <= got.peak_bytes <= held + 4 * 1024


@pytest.mark.parametrize("M,N,splits", [(9, 256, 12), (63, 1536, 5), (4096, 256, 4),
                                         (2200, 1536, 1)])
def test_f32_route_dry_launch_and_its_partials(M, N, splits):
    """f32 above M 8 dry-runs one launch on the f32 body, and the call's
    peak holds the f32 partials that launch allocates on the card (one
    (M, N) slot per run of K steps, ``build.f32_workspace`` on an H100's
    132 SMs; none where the tiles fill the SMs) beside its arguments and
    output."""
    from repro_torch.kernels import build

    nt = _nested((4, 6, 8), K=1536, N=N)
    call, streams, scale = _matmul("ladder_matmul", nt, None)
    x = torch.randn(M, nt.K, generator=torch.Generator().manual_seed(M))
    dispatch.reset_counters()
    got = step_analysis.analyze(call, (x, streams, scale), shape_only((1, 1)), "cpu")
    c = dispatch.counter("ladder_matmul")
    assert (c.dry_launches, c.dry_f32_launches, c.dry_mid_launches, c.dry_dec_launches,
            c.dry_tc_launches, c.launches) == (1, 1, 0, 0, 0, 0)
    assert got.kernels["ladder_matmul"]["f32"] == 1
    floats, _ = build.f32_workspace(M, N, nt.K, nt.block, costs.SMS)
    assert floats == (splits * M * N if splits > 1 else 0)
    held = got.argument_bytes + M * N * 4 + floats * 4
    assert held <= got.peak_bytes <= held + 4 * 1024


def test_flash_attention_counts_its_launch_served_and_in_training():
    B, S, Hq, Hkv, hd = 1, 64, 4, 2, 16
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(B, S, h, hd, generator=g) for h in (Hq, Hkv, Hkv))
    want = fa.flash_attention(q, k, v, kv_block=16)
    dispatch.reset_counters()
    c = dispatch.counter("flash_attention")
    with FakeTensorMode() as mode:
        fq, fk, fv = _fake((q, k, v), mode)
        got = fa.flash_attention(fq, fk, fv, kv_block=16)
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
        assert (c.dry_launches, c.launches, c.plain_launches) == (1, 0, 0)
        assert (c.dry_bytes, c.dry_flops) == costs.flash_cost(q, k)
        # the training forward: K5 with its row statistics, then the plain
        # blockwise backward (aten ops, no launch)
        lq = fq.detach().requires_grad_(True)
        o = fa.flash_attention(lq, fk, fv, kv_block=16, q_offset=0)
        o.sum().backward()
        assert lq.grad.shape == q.shape
    assert (c.dry_launches, c.launches, c.plain_launches) == (2, 0, 0)
    assert c.dry_bytes == costs.flash_cost(q, k)[0] * 2 + 2 * B * Hq * S * 4


def test_nested_qk_and_recompose_count_their_launch():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 4, 32, 1, 16, generator=g)
    streams, _ = _quantize_kv(x, bits=(4, 6, 8), page=4, rounding="rtn")
    streams = [s.reshape(4, -1, 16) for s in streams]
    q_codes, _ = qk.quantize_q(torch.randn(4, 3, 16, generator=g), 8)
    want_qk = qk.ladder_qk_scores(q_codes, streams[:2], bits=(4, 6), page=4)
    nt = _nested((6, 4), K=512, N=32)
    want_nr = nr.nest_recompose(nt.w_base, nt.deltas[0], n=6, h=4, K=512, block_k=256)
    dispatch.reset_counters()
    with FakeTensorMode() as mode:
        fq, fs, fh, fl = _fake((q_codes, streams[:2], nt.w_base, nt.deltas[0]), mode)
        got_qk = qk.ladder_qk_scores(fq, fs, bits=(4, 6), page=4)
        got_nr = nr.nest_recompose(fh, fl, n=6, h=4, K=512, block_k=256)
    for got, want, name, cost in (
            (got_qk, want_qk, "nested_qk", costs.qk_cost(q_codes, streams[:2], 32)),
            (got_nr, want_nr, "nest_recompose",
             costs.recompose_cost(nt.w_base, nt.deltas[0], 512))):
        c = dispatch.counter(name)
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
        assert (c.dry_launches, c.launches, c.plain_launches) == (1, 0, 0)
        assert (c.dry_bytes, c.dry_flops) == cost


def test_abstract_route_checks_operands_and_covers_meta_tensors():
    assert dispatch.is_abstract(torch.empty(2, device="meta"))
    assert not dispatch.is_abstract(torch.empty(2))
    nt = _nested((4, 8))
    x = torch.empty(4, nt.K + 1, device="meta")          # K does not match the words
    with pytest.raises(ValueError):
        pops.packed_matmul(x, nt.w_base.to("meta"), nt.rung_scale(0).reshape(1, -1).to("meta"),
                           k=4, K=nt.K, block_k=nt.block)


# ---------------------------------------------------------------------------
# a reduced step against the reference's compiled one
# ---------------------------------------------------------------------------
SEQ, BATCH, MICRO = 32, 4, 2


def test_reduced_train_step_against_the_reference_compile():
    cfg = jax_get_config("qwen2-1.5b").reduced()
    kw = ({"axis_types": (jax.sharding.AxisType.Auto,) * 2}
          if hasattr(jax.sharding, "AxisType") else {})
    jmesh = jax.make_mesh((1, 1), ("data", "model"), **kw)
    jitted, specs = jsteps.build_train_step(cfg, JaxShape("t", "train", SEQ, BATCH,
                                                         microbatch=MICRO), jmesh)
    params = jax.eval_shape(specs["model"].init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(jadamw.init_state, params)
    batch = jsteps.input_specs(specs["model"].cfg, JaxShape("t", "train", SEQ, BATCH,
                                                            microbatch=MICRO))
    compiled = jitted.lower(params, opt, batch, jax.ShapeDtypeStruct((), jnp.int32)).compile()
    ref_args = compiled.memory_analysis().argument_size_in_bytes
    ref_flops = hlo_analysis.analyze(compiled.as_text()).flops

    one = shape_only((1, 1), ("data", "model"), "cpu")
    shape = ShapeConfig("t", "train", SEQ, BATCH, microbatch=MICRO)
    step, pspecs = steps.build_train_step(get_config("qwen2-1.5b-smoke"), shape, one)
    got = step_analysis.analyze(step, dryrun.train_args(pspecs["model"].cfg, shape, one,
                                                        pspecs), one, "cpu")
    # the same parameters and f32 state; the port's tokens and labels are
    # int64 where the reference's are int32, and its step number a Python
    # int where the reference's is an int32 scalar
    assert got.argument_bytes - ref_args == 2 * BATCH * SEQ * 4 - 4
    # both count every matmul of the forward, the remat recompute and the
    # backward: the reference the compiled HLO's dots (the microbatch loop's
    # trip count multiplied through), the port the aten ops.  XLA keeps the
    # recompute (``nothing_saveable``) and merges none of these products,
    # so the counts agree exactly (no tolerance needed)
    assert got.flops == ref_flops
    assert got.peak_bytes > got.argument_bytes


# ---------------------------------------------------------------------------
# roofline, tally, CLI, world
# ---------------------------------------------------------------------------
def test_roofline_terms_dominance():
    c = step_analysis.StepCosts(flops=costs.PEAK_FLOPS[torch.bfloat16],
                                bytes=costs.HBM_BYTES_PER_S / 2, collective_bytes=1)
    t = step_analysis.roofline_terms(c)
    assert t["dominant"] == "compute"
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.5)
    c = step_analysis.StepCosts(collective_bytes=costs.NVLINK_BYTES_PER_S * 2, flops=1)
    assert step_analysis.roofline_terms(c)["dominant"] == "collective"


def test_sharded_step_tally_ranks_the_largest_first():
    cfg = get_config("qwen2-1.5b-smoke")
    shape = ShapeConfig("t", "train", 16, 4, microbatch=2)
    with fake_world(4):
        mesh = make_fake_mesh((2, 2), ("data", "model"), "cpu")
        step, args = dryrun.cell_step(cfg, shape, mesh)
        c = step_analysis.analyze(step, args, mesh, "cpu")
    for kind, total in (("bytes", c.bytes), ("flops", c.flops),
                        ("collective", c.collective_bytes)):
        top = step_analysis.top_contributors(c, kind, 1000)
        amounts = [t[0] for t in top]
        assert amounts == sorted(amounts, reverse=True) and amounts[0] > 0
        assert sum(amounts) == pytest.approx(total)
    assert c.flops == c.aten_flops         # dense weights, S <= 1024: no kernel
    assert c.num_collectives["all_reduce"] > 0


def test_cli_writes_a_skip_and_a_clean_record(tmp_path):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    rec = json.loads((tmp_path / "qwen2-1.5b__long_500k__pod16x16.json").read_text())
    assert rec["skipped"] and "reason" in rec
    assert dryrun.run_cell("qwen2-1.5b-smoke", "decode_32k", False, str(tmp_path),
                           device="cpu")
    rec = json.loads((tmp_path / "qwen2-1.5b-smoke__decode_32k__pod16x16.json").read_text())
    assert not rec["skipped"] and rec["chips"] == 256 and "error" not in rec
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["counts"]["flops_per_device"] > 0
    assert rec["top"]["bytes"][0][0] >= rec["top"]["bytes"][-1][0] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["useful_flops_ratio"] > 0 and rec["trace_s"] >= 0
    assert dryrun.table(str(tmp_path)).splitlines()[0].startswith("| arch | shape | peak GB")


def test_cli_records_a_failing_cell_and_exits_1(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise ValueError("no such layout")
    monkeypatch.setattr(dryrun, "cell_step", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "qwen2-1.5b__decode_32k__pod16x16.json").read_text())
    assert rec["error"] == "ValueError: no such layout" and "traceback" in rec


def test_fake_world_refuses_a_running_group_and_ends_with_its_block():
    with pytest.raises(RuntimeError):
        with fake_world(4):
            assert dist.get_world_size() == 4 and dist.get_backend() == "fake"
            with fake_world(2):
                pass
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        make_fake_mesh((2, 2), ("data", "model"), "cpu")


# ---------------------------------------------------------------------------
# the heaviest rank where attention is sequence-split, on a (1, 8) world
# ---------------------------------------------------------------------------
SEQ8 = ((1, 8), ("data", "model"))
SEQ8_SHAPES = {"prefill": ShapeConfig("p2k", "prefill", 2048, 2),
               "train": ShapeConfig("t2k", "train", 2048, 2, microbatch=2)}


@pytest.fixture(scope="module")
def seq8_ranks():
    """Each of the eight ranks' dry run of the reduced qwen2-1.5b (4 heads:
    sequence-parallel attention at model = 8; 2048 tokens in query blocks
    of 256), per kind."""
    cfg = get_config("qwen2-1.5b-smoke")
    return cfg, {kind: [dryrun.dry_rank(cfg, shape, *SEQ8, "cpu", r, memory=False)
                        for r in range(8)]
                 for kind, shape in SEQ8_SHAPES.items()}


def _counts(c):
    return json.loads(json.dumps(dryrun.counts_record(c)))


@pytest.mark.parametrize("kind", sorted(SEQ8_SHAPES))
def test_each_ranks_k5_work_is_flash_cost_at_its_offset(seq8_ranks, kind):
    cfg, ranks = seq8_ranks
    B, S = SEQ8_SHAPES[kind].global_batch, SEQ8_SHAPES[kind].seq_len
    q = torch.empty(B, S // 8, cfg.num_heads, cfg.head_dim, device="meta")
    k = torch.empty(B, S, cfg.num_kv_heads, cfg.head_dim, device="meta")
    # a prefill launches K5 once a layer; a train step with its row
    # statistics, in the forward and again in the remat recompute
    launches = cfg.num_layers * (2 if kind == "train" else 1)
    for r, c in enumerate(ranks[kind]):
        nbytes, flops = costs.flash_cost(q, k, q_offset=256 * r, stats=kind == "train")
        k5 = c.kernels["flash_attention"]
        assert (k5["dry_launches"], k5["flops"], k5["bytes"]) == \
            (launches, launches * flops, launches * nbytes)
    # the forward alone is affine in the offset; the train step's blockwise
    # backward rises in steps (a rank visits the 512-key blocks up to its
    # block's end), which is why the dry run sums every offset there
    for field in ("flops", "bytes"):
        steps_ = [getattr(b, field) - getattr(a, field)
                  for a, b in zip(ranks[kind], ranks[kind][1:])]
        assert (len(set(steps_)) == 1) == (kind == "prefill"), (field, steps_)


@pytest.mark.parametrize("kind", sorted(SEQ8_SHAPES))
def test_sequence_parallel_record_is_the_last_ranks(seq8_ranks, kind, tmp_path, monkeypatch):
    cfg, ranks = seq8_ranks
    monkeypatch.setattr(dryrun, "production_shape", lambda multi_pod: SEQ8)
    monkeypatch.setitem(dryrun.SHAPES, SEQ8_SHAPES[kind].name, SEQ8_SHAPES[kind])
    assert dryrun.run_cell("qwen2-1.5b-smoke", SEQ8_SHAPES[kind].name, False, str(tmp_path),
                           device="cpu")
    rec = json.loads((tmp_path / f"qwen2-1.5b-smoke__{SEQ8_SHAPES[kind].name}__pod16x16.json")
                     .read_text())
    assert rec["rank"] == 7 and rec["counts"] == _counts(ranks[kind][7])
    assert rec["lightest"] == {"rank": 0, "counts": _counts(ranks[kind][0])}
    assert rec["counts"]["flops_per_device"] > rec["lightest"]["counts"]["flops_per_device"]
    assert rec["counted_flops_global"] == sum(c.flops for c in ranks[kind])
    assert rec["useful_flops_ratio"] == rec["model_flops_global"] / rec["counted_flops_global"]
    assert rec["global_summed_from"] == (
        "every model rank" if kind == "train" else
        "the first and last model ranks (affine in the offset)")


def test_head_parallel_cell_dry_runs_rank_0_alone(tmp_path, monkeypatch):
    """4 heads at model = 4 split by head: every rank does rank 0's work, and
    the record is rank 0's dry run as it was, with no rank of its own."""
    cfg, dims = get_config("qwen2-1.5b-smoke"), ((1, 4), ("data", "model"))
    shape = SEQ8_SHAPES["prefill"]
    r0 = dryrun.dry_rank(cfg, shape, *dims, "cpu", 0)
    cell = dryrun.dry_cell(cfg, shape, *dims, "cpu")
    assert (cell.rank, cell.light, cell.flops_global) == (0, None, 4 * r0.flops)
    monkeypatch.setattr(dryrun, "production_shape", lambda multi_pod: dims)
    monkeypatch.setitem(dryrun.SHAPES, shape.name, shape)
    assert dryrun.run_cell("qwen2-1.5b-smoke", shape.name, False, str(tmp_path), device="cpu")
    rec = json.loads((tmp_path / f"qwen2-1.5b-smoke__{shape.name}__pod16x16.json").read_text())
    assert rec["counts"] == _counts(r0) and rec["memory"]["peak_bytes"] == r0.peak_bytes
    assert not {"rank", "lightest", "global_summed_from"} & set(rec)


def test_split_cache_decode_dry_runs_the_rank_holding_the_new_position():
    prod = dryrun.production_shape(False)
    assert dryrun.new_position_rank(get_config("qwen2-1.5b"), SHAPES["decode_32k"],
                                    *prod) == 15            # split over model
    assert dryrun.new_position_rank(get_config("zamba2-2.7b"), SHAPES["long_500k"],
                                    *prod) == 15 * 16       # batch 1: split over data
    assert dryrun.new_position_rank(get_config("musicgen-large"), SHAPES["decode_32k"],
                                    *prod) == 0             # kv heads split: whole cache
    assert dryrun.new_position_rank(get_config("mamba2-780m"), SHAPES["decode_32k"],
                                    *prod) == 0             # no KV cache
    cfg, shape = get_config("qwen2-1.5b-smoke"), ShapeConfig("d", "decode", 2048, 2)
    first, last = (dryrun.dry_rank(cfg, shape, *SEQ8, "cpu", r, memory=False) for r in (0, 7))
    cell = dryrun.dry_cell(cfg, shape, *SEQ8, "cpu")
    # the last rank writes the new k/v; every rank reads a full block
    assert cell.rank == 7 and _counts(cell.costs) == _counts(last)
    assert last.flops == first.flops and last.bytes > first.bytes


@pytest.mark.parametrize("rank", [-1, 4])
def test_fake_world_refuses_a_rank_outside_it(rank):
    with pytest.raises(ValueError):
        with fake_world(4, rank=rank):
            pass


def test_uneven_expert_shares_dry_run_every_model_rank():
    """The reduced llama4 (4 experts, top-1) on (1, 4) decodes 2 tokens:
    equal shares give experts 0 and 1 a row each, so model ranks 0 and 1
    compute an expert and ranks 2 and 3 none; the global count sums all four."""
    cfg, dims = get_config("llama4-scout-17b-a16e-smoke"), ((1, 4), ("data", "model"))
    shape = ShapeConfig("d", "decode", 64, 2)
    per = [dryrun.dry_rank(cfg, shape, *dims, "cpu", r, memory=False) for r in range(4)]
    assert per[0].flops == per[1].flops > per[2].flops == per[3].flops
    assert moe.dry_owner_rows(2, 1, 4, 4, 8) == (1, 1, 0, 0)
    assert moe.dry_owner_rows(4, 1, 4, 4, 8) == (1, 1, 1, 1)
    cell = dryrun.dry_cell(cfg, shape, *dims, "cpu")
    assert cell.summed == "every model rank"
    assert cell.flops_global == sum(c.flops for c in per)
    assert cell.rank == 0 and _counts(cell.costs) == _counts(per[0])
    assert cell.light_rank == 2 and _counts(cell.light) == _counts(per[2])
