"""The port's sharded stack on gloo worlds of separate processes on the CPU
(``tests/torch_dist.py`` holds the rank programs; no fake in-process
devices), held against the JAX package in this process: its
``build_train_step`` and ``build_decode_step`` on a (1, 1) mesh of the one
CPU device, its ``_dispatch`` on each data shard's tokens.

* Train (reduced qwen2, bf16 parameters, f32 AdamW state, 2 microbatches)
  on (2, 2), (1, 4) (k/v projections split by columns where the rules
  keep kv heads whole: gathered) and (2, 1), three steps against the
  reference's: the loss within 1e-5 (relative), the f32 moments within
  ``STATE_TOL`` of each leaf's max |value| and the f32 master within
  ``STATE_TOL`` of the summed learning rate where m is large, a limit
  that the control with the data-axis gradient average left out exceeds
  in both.
* Decode (reduced qwen2, f32) on (2, 2), dense and nested ((4, 8) rtn,
  the embedding dense): the prefill's and every decode step's logits
  within 1e-4 of max |logit|, greedy tokens identical; the reduced dbrx's
  nested serve the same way (experts replicated over model by the specs,
  computed by block).
* MoE (reduced dbrx, 4 experts over model = 2): capacity-dropped routing
  of each data rank's tokens equals the reference's ``_dispatch`` on that
  shard (within 1e-5 of max |y|) and the aux loss the mean over the data
  ranks; a dropless serve equals the global path.
* ``grad_compress``: one rank bit for bit the reference's one-device
  ``shard_map``; four ranks the reference formula in numpy; the error
  feedback converging.
* Checkpoint: saved from (2, 2), restored onto (1, 4), (4, 1) and plainly
  (and by the JAX package's manager): identical values.
* A dim split over data and model at once raises ``NotImplementedError``,
  a KV cache length its sequence split does not divide ``ValueError``
  (sequence-parallel attention, the sequence-split cache and the ssm and
  hybrid families run: test_torch_seq_parallel, test_torch_ssm_sharded).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as td
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.core.nesting import default_predicate as jax_default_predicate
from repro.core.recipe import QuantRecipe as JaxRecipe
from repro.core.recipe import quantize as jax_quantize
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.distributed import steps as jsteps
from repro.models import make_model as jax_make_model
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import steps
from repro_torch.distributed.grad_compress import compress_decompress
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import shape_only
from torch_parity import j2n, jax_tree_to_torch, rehome, t2n

LOSS_TOL, LOGIT_TOL, MOE_TOL = 1e-5, 1e-4, 1e-5
# the f32 moments after each step, worst leaf's max |diff| over its max
# |value|.  Gradients of bf16 parameters are bf16, in both packages
# (rounded per microbatch, and here per data rank before the average), so
# an f32 product summed in another order can land one bf16 step away: the
# sound runs read 1.1e-3 (model only) to 1.1e-2 (data-split, v of q.w at
# the first step); the control without the data-axis average reads 1.4 or
# more.  The limit sits between them.  The f32 master is held in units of
# the learning rate summed over the steps so far (see ``_state_gaps``),
# under the same limit.
STATE_TOL = 0.1


def _jax_mesh():
    kw = ({"axis_types": (jax.sharding.AxisType.Auto,) * 2}
          if hasattr(jax.sharding, "AxisType") else {})
    return jax.make_mesh((1, 1), ("data", "model"), **kw)


def _pred(path, leaf):
    return "embed" not in path.lower() and jax_default_predicate(path, leaf)


def _nest(params):
    recipe = JaxRecipe(bits=(4, 8), rounding="rtn", predicate=_pred)
    return jax.jit(lambda p: jax_quantize(p, recipe))(params)


def _reference_train(params, cfg=None, seq=td.TRAIN_SEQ, batch=td.TRAIN_BATCH,
                     micro=td.TRAIN_MICRO, steps=td.TRAIN_STEPS):
    """Losses and (m, v, master) after each of the steps (the reduced qwen2
    unless ``cfg`` is given), on the data stream's batches at ``steps``."""
    cfg = cfg or jax_get_config("qwen2-1.5b").reduced()
    shape = JaxShape("t", "train", seq, batch, microbatch=micro)
    step, _ = jsteps.build_train_step(cfg, shape, _jax_mesh(), peak_lr=td.TRAIN_LR)
    # distinct buffers for every leaf: the step donates params and state
    params, opt = jax.tree.map(lambda a: jnp.array(a, copy=True),
                               (params, jadamw.init_state(params)))
    data = JaxSyntheticLM(JaxDataConfig(cfg.vocab_size, seq, batch), 0, 1)
    losses, states = [], []
    for s in steps:
        batch_s = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
        params, opt, metrics = step(params, opt, batch_s, jnp.asarray(s))
        losses.append(float(metrics["loss"]))
        states.append({f: {jax.tree_util.keystr(p): j2n(x) for p, x in
                           jax.tree_util.tree_flatten_with_path(getattr(opt, f))[0]}
                       for f in ("m", "v", "master")})
    return losses, states


def _reference_serve(cfg, params, prompt, quant, maxlen=td.DEC_MAXLEN):
    """The reference's prefill, then its decode step on a (1, 1) mesh
    against a cache of ``maxlen`` positions: logits (1 + DEC_NEW, B, V)
    and greedy tokens."""
    model = jax_make_model(cfg)
    B, S = prompt.shape
    step, _ = jsteps.build_decode_step(cfg, JaxShape("d", "decode", maxlen, B),
                                       _jax_mesh(), quant)
    logits, cache = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(prompt)})
    cache = rehome(cache, model.make_cache(B, maxlen), S)
    out = [j2n(logits[:, -1])]
    tok = jnp.argmax(logits[:, -1], -1)
    toks = [np.asarray(tok)]
    for _ in range(td.DEC_NEW):
        logits, cache = step(params, {"tokens": tok[:, None].astype(jnp.int32)}, cache)
        out.append(j2n(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1], -1)
        toks.append(np.asarray(tok))
    return np.stack(out), np.stack(toks)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Inputs from the JAX package, the two gloo worlds (4 and 2 ranks)
    started at once, the references computed while they run."""
    work = tmp_path_factory.mktemp("dist")
    qcfg = jax_get_config("qwen2-1.5b").reduced()
    mcfg = jax_get_config("dbrx-132b").reduced()
    train_params = jax_make_model(dataclasses.replace(qcfg, dtype="bfloat16")).init(
        jax.random.PRNGKey(1))
    dense = jax_make_model(qcfg).init(jax.random.PRNGKey(0))
    moe_params = jax_make_model(mcfg).init(jax.random.PRNGKey(2))
    nested, moe_nested = _nest(dense), _nest(moe_params)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, qcfg.vocab_size, (td.DEC_BATCH, td.DEC_PROMPT)).astype(np.int32)
    moe_x = rng.normal(size=(td.MOE_BATCH, td.MOE_SEQ, mcfg.d_model)).astype(np.float32)
    compress_g = rng.normal(size=(4, 128)).astype(np.float32)
    data = JaxSyntheticLM(JaxDataConfig(qcfg.vocab_size, td.TRAIN_SEQ, td.TRAIN_BATCH), 0, 1)
    batches = [{k: torch.from_numpy(v).long() for k, v in data.batch(s).items()}
               for s in td.TRAIN_STEPS]
    ckpt_tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
                 "b": torch.arange(8, dtype=torch.bfloat16)}
    torch.save({"train_params": jax_tree_to_torch(train_params), "train_batches": batches,
                "dense": jax_tree_to_torch(dense), "nested": jax_tree_to_torch(nested),
                "prompt": torch.from_numpy(prompt).long(),
                "moe_params": jax_tree_to_torch(moe_params),
                "moe_nested": jax_tree_to_torch(moe_nested),
                "moe_x": torch.from_numpy(moe_x),
                "compress_g": [torch.from_numpy(g) for g in compress_g],
                "ckpt_tree": ckpt_tree}, work / "inputs.pt")
    started = [td.start_world("cpu4", 4, work), td.start_world("cpu2", 2, work)]
    try:
        refs = {"train": _reference_train(train_params),
                "decode": _reference_serve(qcfg, dense, prompt, None),
                "decode_nested": _reference_serve(qcfg, nested, prompt, "nested"),
                "moe_serve": _reference_serve(mcfg, moe_nested, prompt % mcfg.vocab_size,
                                              "nested")}
    finally:
        out4, out2 = (td.wait_world(s, timeout=600) for s in started)
    return {"cpu4": out4, "cpu2": out2, "refs": refs, "moe_params": moe_params,
            "moe_x": moe_x, "compress_g": compress_g, "ckpt_tree": ckpt_tree, "work": work}


def _state_gaps(states, ref_states):
    """Per step, (moments, master): the worst leaf's max |diff| / max
    |value| over m and v; and master's max |diff| in units of the learning
    rate summed over the steps so far, on the elements whose reference m
    was at least ``STATE_TOL`` of its leaf's largest |m| after every step so
    far.  (Adam's first step moves master by lr * sign(g): where a gradient
    is zero but for rounding it may go either way, for good, and master's
    own value is too large to show a step; where |m| passes the mask, m's
    limit keeps its sign.)"""
    out, masks, lr_sum = [], {}, 0.0
    for got, want, s in zip(states, ref_states, td.TRAIN_STEPS):
        lr_sum += td.TRAIN_LR * s / 100                           # warmup 100
        moments, master = 0.0, 0.0
        flat = {f: dict(steps_flat(getattr(got, f))) for f in ("m", "v", "master")}
        for f in ("m", "v"):
            for key, w in want[f].items():
                gap = np.abs(flat[f][key] - w).max() / max(np.abs(w).max(), 1e-30)
                moments = max(moments, float(gap))
        for key, w in want["master"].items():
            m = np.abs(want["m"][key])
            masks[key] = (m >= STATE_TOL * m.max()) & masks.get(key, True)
            if masks[key].any():
                gap = np.abs(flat["master"][key] - w)[masks[key]].max() / lr_sum
                master = max(master, float(gap))
        out.append((moments, master))
    return out


def steps_flat(t):
    from repro_torch import tree
    return [(k, t2n(v)) for k, v in tree.flatten_with_path(t)]


@pytest.mark.parametrize("run", ["train_2x2", "train_1x4", "train_2x1"])
def test_sharded_train_step_matches_the_reference(worlds, run):
    ref_loss, ref_states = worlds["refs"]["train"]
    ranks = worlds["cpu2" if run == "train_2x1" else "cpu4"]
    for r in ranks:                               # every rank reports the same loss
        np.testing.assert_allclose(r[run]["loss"], ref_loss, rtol=LOSS_TOL)
    gaps = _state_gaps(ranks[0][run]["opt"], ref_states)
    assert max(max(g) for g in gaps) <= STATE_TOL, gaps
    if run == "train_2x2":
        control = _state_gaps(ranks[0]["train_2x2_control"]["opt"], ref_states)
        assert min(min(g) for g in control) > STATE_TOL, control


def test_remat_recompute_keeps_the_sharding_context_in_another_thread(worlds):
    """A CUDA backward (and the remat recompute inside it) runs on autograd's
    device thread: the checkpointed layer body carries the context it ran
    under, so its collectives run there too and the gradients equal those
    of a backward inside the context, bit for bit."""
    assert all(r["remat_thread"] for r in worlds["cpu4"])


def test_train_collectives_are_counted(worlds):
    counts = worlds["cpu4"][0]["train_comm"]
    assert counts["all_reduce"]["calls"] > 0 and counts["all_reduce"]["wire_bytes"] > 0


@pytest.mark.parametrize("run,dims,cfg", [
    ("train_2x2", (2, 2), lambda: get_config("qwen2-1.5b").reduced()),
    ("seq_1x4", (1, 4), lambda: td.sp_config(6, 3))])
def test_dry_run_counts_the_gloo_worlds_collectives(worlds, run, dims, cfg):
    """The dry run of one train step (rank 0 of a fake world of 4 ranks,
    fake tensors, ``launch/step_analysis.py``) gives rank 0's measured
    calls and payload bytes of every collective in the gloo world: head-TP
    on (2, 2), sequence-parallel attention on (1, 4)."""
    from repro_torch.launch import step_analysis
    from repro_torch.launch.dryrun import train_args
    from repro_torch.launch.mesh import fake_world, make_fake_mesh

    shape = ShapeConfig("t", "train", td.TRAIN_SEQ, td.TRAIN_BATCH, microbatch=td.TRAIN_MICRO)
    with fake_world(4):
        mesh = make_fake_mesh(dims, ("data", "model"), "cpu")
        step, specs = steps.build_train_step(cfg(), shape, mesh)
        costs = step_analysis.analyze(step, train_args(specs["model"].cfg, shape, mesh, specs),
                                      mesh, "cpu", memory=False)
    measured = worlds["cpu4"][0]["step_comm"][run]
    assert {op: (c["calls"], c["payload_bytes"]) for op, c in measured.items()} == \
        {op: (n, costs.payload_bytes[op]) for op, n in costs.num_collectives.items()}
    assert ("all_gather" in measured) == (run == "seq_1x4")     # the o rows gathered


@pytest.mark.parametrize("run", ["decode", "decode_nested", "moe_serve"])
def test_sharded_serve_matches_the_reference(worlds, run):
    want_logits, want_tokens = worlds["refs"][run]
    half = td.DEC_BATCH // 2
    for r in worlds["cpu4"]:
        got = r[run]
        rows = slice(got["data"] * half, (got["data"] + 1) * half)
        w = want_logits[:, rows]
        gap = float(np.abs(t2n(got["logits"]) - w).max() / np.abs(w).max())
        assert gap <= LOGIT_TOL, gap
        np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens[:, rows])


def test_moe_per_shard_dispatch_equals_the_reference(worlds):
    cfg = jax_get_config("dbrx-132b").reduced()
    lp = jax.tree.map(lambda a: a[0], worlds["moe_params"]["blocks"]["moe"])
    E, K = cfg.num_experts, cfg.top_k
    x = worlds["moe_x"]
    half = td.MOE_BATCH // 2
    want, auxes = [], []
    for d in range(2):
        xf = jnp.asarray(x[d * half:(d + 1) * half].reshape(-1, cfg.d_model))
        C = jmoe.capacity(xf.shape[0], E, K, cfg.capacity_factor, 8)
        xg, table, gates, aux = jmoe._dispatch(xf, lp["router"]["w"], E=E, K=K, C=C)
        y = jmoe._expert_compute(xg, lp, cfg.act, xf.dtype)
        want.append(j2n(jmoe._combine(y, table, gates, xf.shape[0], cfg.d_model)))
        auxes.append(float(aux))
    glob, _ = jmoe.moe_ffn(jnp.asarray(x), lp, num_experts=E, top_k=K,
                           capacity_factor=cfg.capacity_factor, act=cfg.act, dropless=True)
    glob = j2n(glob)
    held = set()
    for r in worlds["cpu4"]:
        got = r["moe"]
        d = got["data"]
        w = want[d].reshape(half, td.MOE_SEQ, cfg.d_model)
        assert float(np.abs(t2n(got["train"]) - w).max() / np.abs(w).max()) <= MOE_TOL
        np.testing.assert_allclose(float(got["aux"]), np.mean(auxes), rtol=1e-6)
        g = glob[d * half:(d + 1) * half]
        assert float(np.abs(t2n(got["serve"]) - g).max() / np.abs(g).max()) <= MOE_TOL
        # each model rank holds and computes its 2 of the 4 experts
        assert got["held"] == E // 2
        for groups in got["groups"]:
            held |= {(got["model"], e) for e, _ in groups}
            assert all(e // (E // 2) == got["model"] for e, _ in groups)
    assert {m for m, _ in held} == {0, 1}


def test_grad_compress_one_rank_is_the_reference_bit_for_bit():
    from jax.sharding import PartitionSpec as P

    from repro.distributed.grad_compress import compress_decompress as jcompress
    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:
        from jax.experimental.shard_map import shard_map
    kw = ({"axis_types": (jax.sharding.AxisType.Auto,)}
          if hasattr(jax.sharding, "AxisType") else {})
    mesh = jax.make_mesh((1,), ("d",), **kw)

    @jax.jit
    def step(g, r):
        return shard_map(lambda g, r: jcompress(g, r, "d"), mesh=mesh,
                         in_specs=(P(), P()), out_specs=(P(), P()))(g, r)

    rng = np.random.default_rng(5)
    g = rng.normal(size=(64, 32)).astype(np.float32)
    r = (rng.normal(size=(64, 32)) * 1e-3).astype(np.float32)
    want = step(jnp.asarray(g), jnp.asarray(r))
    got = compress_decompress(torch.from_numpy(g), torch.from_numpy(r), None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(t2n(a), j2n(b))


def test_grad_compress_four_ranks_is_the_reference_formula(worlds):
    gs = worlds["compress_g"]
    # the reference's scale under jit: amax times the f32 reciprocal of 127
    scale = np.maximum(np.abs(gs).max(axis=1), np.float32(1e-12)) * np.float32(1 / 127)
    codes = np.clip(np.round(gs / scale[:, None]), -128, 127).astype(np.int32)
    n = np.float32(4)
    want = codes.sum(axis=0).astype(np.float32) * (scale.sum(dtype=np.float32) / n) / n
    for rank, r in enumerate(worlds["cpu4"]):
        g_avg, resid = r["compress"]
        np.testing.assert_allclose(g_avg.numpy(), want, rtol=1e-6, atol=0)
        fused = gs[rank].astype(np.float64) - codes[rank] * np.float64(scale[rank])
        np.testing.assert_array_equal(resid.numpy(), fused.astype(np.float32))


def test_compressed_mean_tree_is_compress_decompress_per_leaf():
    from repro_torch.distributed.grad_compress import compressed_mean_tree, init_residuals
    rng = np.random.default_rng(7)
    grads = {"a": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
             "b": {"c": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))}}
    resid = init_residuals(grads)
    assert all(float(r.abs().max()) == 0.0 for r in (resid["a"], resid["b"]["c"]))
    mean, new = compressed_mean_tree(grads, resid, None)
    for key, g, r, m, n in (("a", grads["a"], resid["a"], mean["a"], new["a"]),
                            ("c", grads["b"]["c"], resid["b"]["c"], mean["b"]["c"],
                             new["b"]["c"])):
        want = compress_decompress(g, r, None)
        assert torch.equal(m, want[0]) and torch.equal(n, want[1]), key


def test_grad_compress_error_feedback_converges():
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(128,)).astype(np.float32))
    resid, total = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(30):
        g_avg, resid = compress_decompress(g, resid, None)
        total += g_avg
    assert float((total / 30 - g).abs().max()) < float(g.abs().max()) * 0.02


def test_checkpoint_saved_on_2x2_restores_onto_other_meshes(worlds):
    from repro.checkpoint import CheckpointManager as JaxManager

    full = worlds["ckpt_tree"]
    for r in worlds["cpu4"]:
        ck = r["ckpt"]
        for shape in ((1, 4), (4, 1)):
            got = ck[shape]
            d, m = got["coord"]
            rows, cols = 8 // shape[0], 8 // shape[1]
            np.testing.assert_array_equal(
                got["tree"]["w"].numpy(),
                full["w"][d * rows:(d + 1) * rows, m * cols:(m + 1) * cols].numpy())
            assert torch.equal(got["tree"]["b"], full["b"])
            assert got["tree"]["b"].dtype == torch.bfloat16
            assert got["extra"] == {"mesh": "2x2"}
        for k in full:
            assert torch.equal(ck["plain"][k], full[k])
    tmpl = {"w": jax.ShapeDtypeStruct((8, 8), jnp.float32),
            "b": jax.ShapeDtypeStruct((8,), jnp.bfloat16)}
    restored, _ = JaxManager(str(worlds["work"] / "ckpt")).restore(tmpl)
    np.testing.assert_array_equal(np.asarray(restored["w"]), full["w"].numpy())
    np.testing.assert_array_equal(j2n(restored["b"]), full["b"].float().numpy())


def test_layouts_the_port_does_not_run_yet_raise():
    cfg = get_config("qwen2-1.5b").reduced()
    # a single dim split over data and model at once is queued
    with pytest.raises(NotImplementedError, match="data and model at once"):
        steps._whole_dims("['blocks']['q']['w']", P(None, None, ("data", "model")),
                          shape_only((2, 2)))
    # 2 kv heads over model = 4: the decode cache splits its sequence dim,
    # and 15 positions do not split over 4 ranks (the reference pads)
    with pytest.raises(ValueError, match="KV cache of 15 positions"):
        steps.build_decode_step(cfg, ShapeConfig("d", "decode", 15, 4), shape_only((1, 4)))
    # batch 1 over data = 2: the sequence dim takes data
    with pytest.raises(ValueError, match="KV cache of 15 positions"):
        steps.build_prefill_step(cfg, ShapeConfig("p", "prefill", 15, 1), shape_only((2, 1)))
    # what the port runs now builds: sequence-parallel attention (4 heads
    # over model = 3), the split caches, the ssm and hybrid families
    train = ShapeConfig("t", "train", 16, 4, microbatch=2)
    steps.build_train_step(cfg, train, shape_only((1, 3)))
    steps.build_decode_step(cfg, ShapeConfig("d", "decode", 16, 4), shape_only((1, 4)))
    steps.build_prefill_step(cfg, ShapeConfig("p", "prefill", 16, 1), shape_only((2, 1)))
    for arch in ("mamba2-780m", "zamba2-2.7b"):
        steps.build_train_step(get_config(arch).reduced(), train, shape_only((1, 4)))
    # on a mesh of one rank every layout runs
    steps.build_decode_step(cfg, ShapeConfig("d", "decode", 16, 1), shape_only((1, 1)))
