"""Port parity of the dense model: reduced qwen2-1.5b in f32, prefill and
decode logits at every rung of an (8, 6, 4) ladder within 1e-4 of the
JAX package's and greedy tokens identical - on the JAX-quantized tree
(converted through numpy) and on the port's own quantization of the same
dense parameters."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import make_model as jax_make_model
from repro_torch.configs import get_config
from repro_torch.core import nesting as tn
from repro_torch.core.recipe import QuantRecipe, quantize
from repro_torch.models import make_model
from torch_parity import j2n, jax_tree_to_torch, reduced_qwen2, t2n

jn = importlib.import_module("repro.core.nesting")

B, S, STEPS, MAX_LEN = 2, 6, 3, 16
TOL = 1e-4


@pytest.fixture(scope="module")
def trees():
    cfg, dense, nested = reduced_qwen2()
    own = quantize(jax_tree_to_torch(dense), QuantRecipe(bits=(8, 6, 4), rounding="rtn"),
                   device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    # the JAX run at each rung, once for both port trees
    reference = [_jax_run(cfg, jn.set_tree_rung(nested, rung), tokens) for rung in range(3)]
    return tokens, reference, jax_tree_to_torch(nested), own


def _jax_run(cfg, params, tokens):
    model = jax_make_model(cfg)
    logits, cache = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(tokens)})
    full = model.make_cache(B, MAX_LEN, dtype=jnp.float32)
    full["k"] = full["k"].at[:, :, :S].set(cache["k"])
    full["v"] = full["v"].at[:, :, :S].set(cache["v"])
    full["pos"] = cache["pos"]
    outs, toks = [logits], []
    step = jax.jit(model.decode_step)
    nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for _ in range(STEPS):
        toks.append(np.asarray(nxt))
        logits, full = step(params, {"tokens": nxt}, full)
        outs.append(logits)
        nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    return [j2n(o) for o in outs], np.concatenate(toks, axis=1)


def _port_run(cfg, params, tokens):
    model = make_model(cfg, device="cpu")
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens).long()})
    full = model.make_cache(B, MAX_LEN)
    full["k"][:, :, :S] = cache["k"]
    full["v"][:, :, :S] = cache["v"]
    full["pos"] = cache["pos"]
    outs, toks = [logits], []
    nxt = logits[:, -1].argmax(dim=-1)[:, None]
    for _ in range(STEPS):
        toks.append(nxt.numpy())
        logits, full = model.decode_step(params, {"tokens": nxt}, full)
        outs.append(logits)
        nxt = logits[:, -1].argmax(dim=-1)[:, None]
    return [t2n(o) for o in outs], np.concatenate(toks, axis=1)


@pytest.mark.parametrize("source", ["jax_quantized", "port_quantized"])
def test_logits_and_greedy_tokens_match_at_every_rung(trees, source):
    tokens, reference, nested_conv, own = trees
    cfg = get_config("qwen2-1.5b").reduced()
    port_tree = nested_conv if source == "jax_quantized" else own
    for rung, (ref_logits, ref_toks) in enumerate(reference):
        got_logits, got_toks = _port_run(cfg, tn.set_tree_rung(port_tree, rung), tokens)
        assert got_logits[0].shape == ref_logits[0].shape == (B, 1, cfg.vocab_size)
        for g, r in zip(got_logits, ref_logits):
            np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got_toks, ref_toks)


def test_model_surface_raises_for_what_is_not_ported():
    """Every family builds and has the reference's ``loss_fn`` now, with
    ``Model``'s fields in the reference's order; what still raises is a
    stacked leaf (an expert stack) in ``packed_linear``, instead of
    dequantizing around the kernels."""
    from repro.models.model import Model as JaxModel
    from repro_torch.models.layers import packed_linear
    from repro_torch.models.model import Model
    assert Model._fields == JaxModel._fields
    for arch in ("qwen2-1.5b", "dbrx-132b", "mamba2-780m", "zamba2-2.7b"):
        model = make_model(get_config(arch).reduced(), device="cpu")
        assert callable(model.loss_fn), arch
    stacked = tn.nest_quantize(torch.randn(2, 64, 32, generator=torch.Generator().manual_seed(0)),
                               bits=(8, 4), rounding="rtn", block=64)
    with pytest.raises(NotImplementedError, match="takes a 2-D weight"):
        packed_linear(torch.zeros(3, 64), stacked)


def test_blockwise_attention_matches_full_attention():
    """The long-prefill path (S > 1024 in attn_seq) against direct
    attention and against the JAX package's blockwise_attention on the
    same inputs, at a small block so the test stays small."""
    from repro.models.attention import blockwise_attention as jax_blockwise
    from repro_torch.models.attention import blockwise_attention, full_attention
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(1, 64, h, 16)).astype(np.float32) for h in (4, 2, 2))
    got = blockwise_attention(*map(torch.from_numpy, (q, k, v)), True, kv_block=16)
    torch.testing.assert_close(got, full_attention(*map(torch.from_numpy, (q, k, v)),
                                                   causal=True), rtol=1e-5, atol=1e-5)
    ref = jax_blockwise(*map(jnp.asarray, (q, k, v)), True, kv_block=16)
    np.testing.assert_allclose(t2n(got), j2n(ref), rtol=1e-5, atol=1e-5)
