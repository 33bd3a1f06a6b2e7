"""The port's mirror of ``tests/test_models_smoke.py`` on the CPU in f32:
every reduced config in ``ARCHS`` (dense, MoE, ssm, hybrid; phi-3-vision
and musicgen through ``inputs["embeddings"]``) builds, and on the JAX
package's parameters (``PRNGKey(0)``, carried over through numpy) its
prefill and decode give the reference's shapes and no NaN, with prefill
logits within 1e-4 of max |logit| of the JAX model's on the same inputs.
The cached decode against the full forward (atol 2e-5, rtol 1e-4, the
reference's own) for qwen2-1.5b, dbrx-132b, mamba2-780m and zamba2-2.7b.

The train-step half of the reference's test: on the same parameters every
config's ``loss_fn`` and its gradient are finite and one AdamW update
moves the parameters (the loss and gradients of the four families are
held against the JAX package's in tests/test_torch_train.py)."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import make_model as jax_make_model
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.models import make_model
from repro_torch.optim import adamw
from torch_parity import j2n, jax_tree_to_torch, rehome, t2n

TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed):
    """The JAX model of the reduced config and its ``PRNGKey(seed)`` init
    (jitted: one compile where eager init runs hundreds of ops)."""
    model = jax_make_model(ARCHS[arch].reduced())
    return model, jax.jit(model.init)(jax.random.PRNGKey(seed))


def _batch(cfg, rng, B=2, S=16):
    """The reference test's inputs: prefill and one decode token."""
    toks = jax.random.randint(rng, (B, S + 1), 0, cfg.vocab_size)
    if cfg.input_kind == "tokens":
        return {"tokens": toks[:, :-1]}, {"tokens": toks[:, :1]}
    return ({"embeddings": jax.random.normal(rng, (B, S, cfg.d_model))},
            {"embeddings": jax.random.normal(rng, (B, 1, cfg.d_model))})


def _to_port(inputs):
    return {k: torch.from_numpy(np.array(v)).long() if k == "tokens"
            else torch.from_numpy(np.array(v)) for k, v in inputs.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_arch_smoke_prefill_and_decode(arch):
    cfg = get_config(arch).reduced()
    jmodel, jparams = _jax_params(arch, 0)
    batch, dec_in = _batch(jmodel.cfg, jax.random.PRNGKey(0))
    model = make_model(cfg, device="cpu")
    params = jax_tree_to_torch(jparams)
    assert ("embed" in params) == (cfg.input_kind == "tokens")
    B, S = 2, 16
    logits, cache = model.prefill(params, _to_port(batch))
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert not torch.isnan(logits).any()
    want, _ = jax.jit(jmodel.prefill)(jparams, batch)
    assert np.abs(t2n(logits) - j2n(want)).max() <= TOL * np.abs(j2n(want)).max()
    pad = rehome(cache, model.make_cache(B, S + 4, dtype="float32"), S)
    logits2, cache2 = model.decode_step(params, _to_port(dec_in), pad)
    assert logits2.shape == (B, 1, cfg.vocab_size)
    assert not torch.isnan(logits2).any()
    assert int(cache2["pos"]) == S + 1


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "dbrx-132b", "mamba2-780m", "zamba2-2.7b"])
def test_decode_matches_full_forward(arch):
    """KV/state-cache decode equals the full-sequence forward."""
    cfg = get_config(arch).reduced()
    model = make_model(cfg, device="cpu")
    _, jparams = _jax_params(arch, 1)
    params = jax_tree_to_torch(jparams)
    B, S = 2, 16
    toks = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(1), (B, S + 1), 0, cfg.vocab_size))).long()
    logits_full, _ = model.prefill(params, {"tokens": toks})
    _, cache = model.prefill(params, {"tokens": toks[:, :S]})
    pad = rehome(cache, model.make_cache(B, S + 8, dtype="float32"), S)
    logits_dec, _ = model.decode_step(params, {"tokens": toks[:, S:S + 1]}, pad)
    np.testing.assert_allclose(t2n(logits_full), t2n(logits_dec), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_arch_smoke_train_step(arch):
    cfg = get_config(arch).reduced()
    jmodel, jparams = _jax_params(arch, 0)
    batch, _ = _batch(jmodel.cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(0), (2, 17), 0, cfg.vocab_size)
    batch["labels"] = toks[:, 1:]
    model = make_model(cfg, device="cpu")
    params = jax_tree_to_torch(jparams)
    inputs = _to_port(batch)
    inputs["labels"] = inputs["labels"].long()
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss = model.loss_fn(tree.unflatten(params, leaves), inputs)
    grads = torch.autograd.grad(loss, leaves)
    assert np.isfinite(loss.item())
    assert all(bool(g.isfinite().all()) for g in grads)
    new, _, metrics = adamw.apply_update(params, tree.unflatten(params, grads),
                                         adamw.init_state(params), lr=1e-3)
    assert np.isfinite(metrics["grad_norm"].item())
    assert max((a.float() - b.float()).abs().max().item()
               for a, b in zip(tree.leaves(params), tree.leaves(new))) > 0
