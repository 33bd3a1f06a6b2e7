"""The ssm and hybrid families' sharded steps, on a gloo world of four
separate processes on the CPU (``tests/torch_dist.py`` job ``ssm4``),
held against the JAX package's steps on a (1, 1) mesh.

Each model rank runs its block of the SSM heads on its block of the conv
channels: in_proj split on its output columns (gathered: a block cuts
across the z | x | B | C | dt segments), conv and conv_buf on their
channels, A_log and D over heads, out_proj on its input rows; the gated
norm's sum of squares summed over model.  The hybrid's shared attention
block is head-TP, its k/v cache split over model on (1, 4) (2 kv heads do
not cover it).

* Train (reduced mamba2-780m and zamba2-2.7b, bf16 parameters, f32 AdamW
  state, 2 microbatches) on (2, 2) and (1, 4), three steps against the
  reference's: the f32 state within ``STATE_TOL`` after every step, and
  the first step's loss (on the same parameters) within ``LOSS_TOL``.
  (After an update the bf16 parameters differ by rounding, the more where
  the data-split gradients are rounded to bf16 per rank: the port's own
  one-card zamba2 step reads 2.2e-5 from the reference at the third step,
  its (2, 2) step 1.4e-5 from the one-card step; the state check holds
  each step's parameters instead.)  The control whose gated norm sums its
  squares over this rank's block alone reads above ``STATE_TOL``.
* Serve (dense f32, a prefill of 4 x 8 tokens, 4 decode steps) on the same
  meshes: logits within ``LOGIT_TOL`` of the reference's, greedy tokens
  identical; the same control above the limit.
* Checkpoint: each tree saved as the train step lays it out on (2, 2),
  restored onto (1, 4) and plainly: identical values.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_dist as td
from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import make_model as jax_make_model
from test_torch_distributed import (LOGIT_TOL, LOSS_TOL, STATE_TOL, _reference_serve,
                                    _reference_train, _state_gaps)
from torch_parity import jax_tree_to_torch, t2n

ARCHS = ("mamba2-780m", "zamba2-2.7b")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs from the JAX package, the gloo world started, the references
    computed while it runs."""
    work = tmp_path_factory.mktemp("ssm")
    inputs, refs = {}, {}
    params = {}
    for i, arch in enumerate(ARCHS):
        cfg = jax_get_config(arch).reduced()
        params[arch] = (jax_make_model(dataclasses.replace(cfg, dtype="bfloat16")).init(
            jax.random.PRNGKey(10 + i)), jax_make_model(cfg).init(jax.random.PRNGKey(20 + i)))
        inputs[f"{arch}/train_params"] = jax_tree_to_torch(params[arch][0])
        inputs[f"{arch}/dense"] = jax_tree_to_torch(params[arch][1])
    vocab = jax_get_config(ARCHS[0]).reduced().vocab_size
    data = JaxSyntheticLM(JaxDataConfig(vocab, td.TRAIN_SEQ, td.TRAIN_BATCH), 0, 1)
    inputs["ssm_batches"] = [{k: torch.from_numpy(v).long() for k, v in data.batch(s).items()}
                             for s in td.TRAIN_STEPS]
    prompt = np.random.default_rng(4).integers(
        0, vocab, (td.DEC_BATCH, td.DEC_PROMPT)).astype(np.int32)
    inputs["prompt"] = torch.from_numpy(prompt).long()
    torch.save(inputs, work / "inputs.pt")
    started = td.start_world("ssm4", 4, work)
    try:
        for arch in ARCHS:
            cfg = jax_get_config(arch).reduced()
            refs[arch] = {"train": _reference_train(params[arch][0], cfg),
                          "serve": _reference_serve(cfg, params[arch][1], prompt, None)}
    finally:
        ranks = td.wait_world(started, timeout=600)
    return {"ranks": ranks, "refs": refs}


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_sharded_train_matches_the_reference(world, arch, mesh):
    ref_loss, ref_states = world["refs"][arch]["train"]
    ranks = world["ranks"]
    for r in ranks:
        np.testing.assert_allclose(r[(arch, mesh)]["train"]["loss"][0], ref_loss[0],
                                   rtol=LOSS_TOL)
    gaps = _state_gaps(ranks[0][(arch, mesh)]["train"]["opt"], ref_states)
    assert max(max(g) for g in gaps) <= STATE_TOL, gaps
    if mesh == (2, 2):
        control = _state_gaps(ranks[0][(arch, mesh)]["train_control"]["opt"], ref_states)
        assert min(max(g) for g in control) > STATE_TOL, control


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_sharded_serve_matches_the_reference(world, arch, mesh):
    want_logits, want_tokens = world["refs"][arch]["serve"]
    rows_per = td.DEC_BATCH // mesh[0]
    for r in world["ranks"]:
        runs = r[(arch, mesh)]
        rows = slice(runs["serve"]["data"] * rows_per, (runs["serve"]["data"] + 1) * rows_per)
        w = want_logits[:, rows]
        gap = float(np.abs(t2n(runs["serve"]["logits"]) - w).max() / np.abs(w).max())
        assert gap <= LOGIT_TOL, gap
        np.testing.assert_array_equal(runs["serve"]["tokens"].numpy(), want_tokens[:, rows])
        if mesh == (2, 2):
            gap = float(np.abs(t2n(runs["serve_control"]["logits"]) - w).max()
                        / np.abs(w).max())
            assert gap > LOGIT_TOL, gap


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_checkpoint_saved_on_2x2_restores_onto_1x4_and_plainly(world, arch):
    for r in world["ranks"]:
        ck = r[(arch, "ckpt")]
        assert ck["onto_1x4"] and ck["plain"], ck
        assert ck["split"] > 0            # the (1, 4) blocks are blocks, not whole leaves
