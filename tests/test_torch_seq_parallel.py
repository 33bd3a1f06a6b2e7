"""Sequence-parallel attention and the sequence-split KV cache of the port's
sharded steps, on gloo worlds of separate processes on the CPU
(``tests/torch_dist.py`` jobs ``seq3``, ``seq4``, ``seq2``), held against
the JAX package's steps on a (1, 1) mesh; and K5's query offset on the
CPU.

* K5's plain offset forward (a block of query rows at ``q_offset`` into
  the keys) equals the reference's ``full_attention(..., q_offset=...)``
  and the matching rows of the whole-sequence plain pass, f32 within 1e-5
  of max |o|; the blockwise backward at an offset equals the reference's
  vjp of ``full_attention`` within 1e-5.
* Train, reduced qwen2 (4 heads over model = 3: each rank attends its
  block of ceil(S / 3) query rows): three steps at S 48 and one at S 2048
  (over 1024: the flash op, here its plain blockwise version at offsets
  0, 683 and 1366, the last block shorter) against the reference's, the
  loss within ``LOSS_TOL`` and the f32 state within ``STATE_TOL``; the
  control without the model-axis sum of the k/v gradient parts reads
  above it.
* Serve, one prompt of 12 into a cache of 24 positions, dense f32: the
  cache's sequence split over model (4 heads on (1, 3); on (1, 4), where
  2 kv heads do not cover model), over data ((2, 1), batch 1) and over
  (data, model) (6 heads, 3 kv heads on (2, 2), batch 1): every rank's
  logits within ``LOGIT_TOL`` of the reference's, greedy tokens
  identical; the control where each rank takes the softmax over its own
  block of positions reads above the limit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as td
from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import make_model as jax_make_model
from repro.models.attention import full_attention as jax_full_attention
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention
from test_torch_distributed import (LOGIT_TOL, LOSS_TOL, STATE_TOL, _reference_serve,
                                    _reference_train, _state_gaps)
from torch_parity import j2n, jax_tree_to_torch, t2n

OFFSET_TOL = 1e-5


def _attn_inputs(S, seed=0, B=1, Hq=4, Hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, h, hd)).astype(np.float32) for h in (Hq, Hkv, Hkv))


def _blocks(S, n_blocks):
    n = -(-S // n_blocks)
    return [(r * n, min(n, S - r * n)) for r in range(n_blocks)]


@pytest.mark.parametrize("S,kv_block,n_blocks", [(2048, 512, 3), (1100, 512, 4), (48, 16, 3)])
def test_offset_forward_matches_reference_and_whole_rows(S, kv_block, n_blocks):
    q, k, v = _attn_inputs(S, seed=S)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    whole = attention.blockwise_forward(tq, tk, tv, True, kv_block)
    for start, rows in _blocks(S, n_blocks):
        qb = q[:, start:start + rows]
        want = j2n(jax_full_attention(jnp.asarray(qb), jnp.asarray(k), jnp.asarray(v),
                                      causal=True, q_offset=start))
        tqb = torch.from_numpy(qb)
        got = attention.blockwise_forward(tqb, tk, tv, True, kv_block, start)
        op = flash_ops.flash_attention(tqb, tk, tv, kv_block, start)    # the CPU's plain route
        scale = np.abs(want).max()
        for o in (got, op):
            assert np.abs(t2n(o) - want).max() <= OFFSET_TOL * scale
            assert np.abs(t2n(o) - t2n(whole[:, start:start + rows])).max() <= OFFSET_TOL * scale


def test_offset_backward_matches_reference_vjp():
    S, kv_block, start, rows = 1024, 256, 300, 341
    q, k, v = _attn_inputs(S, seed=5)
    qb = q[:, start:start + rows]
    do = np.random.default_rng(6).normal(size=qb.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_full_attention(a, b, c, causal=True, q_offset=start),
                     *map(jnp.asarray, (qb, k, v)))
    want = [j2n(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (qb, k, v)]
    out = attention.blockwise_attention(*leaves, True, kv_block, start)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, want):
        assert np.abs(t2n(g) - w).max() <= OFFSET_TOL * np.abs(w).max()
    # keys past the block's last row get no gradient at all
    assert float(got[1][:, start + rows:].abs().max()) == 0.0


def test_offset_operands_are_checked():
    q, k, v = (torch.zeros(1, s, 2, 16) for s in (8, 16, 16))
    dispatch.check_flash_operands(q, k, v, 8)
    with pytest.raises(ValueError, match="do not fit"):
        dispatch.check_flash_operands(q, k, v, 9)


def _variant(heads, kv_heads):
    return dataclasses.replace(jax_get_config("qwen2-1.5b").reduced(), num_heads=heads,
                               num_kv_heads=kv_heads)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Inputs from the JAX package, the three gloo worlds (3, 4 and 2 ranks)
    started at once, the references computed while they run."""
    work = tmp_path_factory.mktemp("seq")
    qcfg = _variant(4, 2)
    train_params = jax_make_model(dataclasses.replace(qcfg, dtype="bfloat16")).init(
        jax.random.PRNGKey(1))
    dense = jax_make_model(qcfg).init(jax.random.PRNGKey(0))
    dense63 = jax_make_model(_variant(6, 3)).init(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(3).integers(
        0, qcfg.vocab_size, (td.SP_BATCH, td.SP_PROMPT)).astype(np.int32)

    def batches(seq, batch, steps):
        data = JaxSyntheticLM(JaxDataConfig(qcfg.vocab_size, seq, batch), 0, 1)
        return [{k: torch.from_numpy(v).long() for k, v in data.batch(s).items()}
                for s in steps]

    torch.save({"train_params": jax_tree_to_torch(train_params),
                "sp_batches": batches(td.SP_SEQ, td.TRAIN_BATCH, td.TRAIN_STEPS),
                "sp_long_batches": batches(td.SP_LONG, 1, td.TRAIN_STEPS[:1]),
                "dense": jax_tree_to_torch(dense), "dense63": jax_tree_to_torch(dense63),
                "sp_prompt": torch.from_numpy(prompt).long()}, work / "inputs.pt")
    started = [td.start_world("seq3", 3, work), td.start_world("seq4", 4, work),
               td.start_world("seq2", 2, work)]
    try:
        refs = {"train": _reference_train(train_params, qcfg, td.SP_SEQ),
                "train_long": _reference_train(train_params, qcfg, td.SP_LONG, 1, 1,
                                               td.TRAIN_STEPS[:1]),
                "serve": _reference_serve(qcfg, dense, prompt, None, td.SP_MAXLEN),
                "serve63": _reference_serve(_variant(6, 3), dense63, prompt, None,
                                            td.SP_MAXLEN)}
    finally:
        outs = [td.wait_world(s, timeout=600) for s in started]
    return dict(zip(("seq3", "seq4", "seq2"), outs), refs=refs)


@pytest.mark.parametrize("run", ["train", "train_long"])
def test_sequence_parallel_train_matches_the_reference(worlds, run):
    ref_loss, ref_states = worlds["refs"][run]
    for r in worlds["seq3"]:
        np.testing.assert_allclose(r[run]["loss"], ref_loss, rtol=LOSS_TOL)
    gaps = _state_gaps(worlds["seq3"][0][run]["opt"], ref_states)
    assert max(max(g) for g in gaps) <= STATE_TOL, gaps
    if run == "train":
        control = _state_gaps(worlds["seq3"][0]["train_control"]["opt"], ref_states)
        assert min(max(g) for g in control) > STATE_TOL, control


@pytest.mark.parametrize("world,run,ref", [("seq3", "serve", "serve"),
                                           ("seq4", "model", "serve"),
                                           ("seq2", "data", "serve"),
                                           ("seq4", "data_model", "serve63")])
def test_sequence_split_cache_serve_matches_the_reference(worlds, world, run, ref):
    want_logits, want_tokens = worlds["refs"][ref]
    scale = np.abs(want_logits).max()
    for r in worlds[world]:
        got = r[run]
        assert float(np.abs(t2n(got["logits"]) - want_logits).max() / scale) <= LOGIT_TOL
        np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens)
    control = {"serve": ("seq3", "serve_control"),
               "data_model": ("seq4", "data_model_control")}.get(run)
    if control:
        for r in worlds[control[0]]:
            gap = float(np.abs(t2n(r[control[1]]["logits"]) - want_logits).max() / scale)
            assert gap > LOGIT_TOL, gap
