"""Port parity of the checkpoint manager (``repro_torch/checkpoint``): the
reference's on-disk layout and keys, atomic saves, retention, the missing
checkpoint and missing-key errors, packed trees round-tripped bit for bit
without densifying, and a checkpoint the JAX package wrote restored into
the port's template (bf16 parameters, AdamW state, a nested tree)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.core.recipe import QuantRecipe as JaxRecipe
from repro.core.recipe import quantize as jax_quantize
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.core.nesting import NestedTensor
from repro_torch.core.recipe import QuantRecipe, quantize
from repro_torch.optim import adamw
from torch_parity import j2n, jax_tree_to_torch, t2n


def _params():
    g = torch.Generator().manual_seed(0)
    return {"blocks": {"w": torch.randn(2, 128, 96, generator=g).to(torch.bfloat16),
                       "b": torch.randn(2, 96, generator=g)},
            "norm": {"scale": torch.ones(96)}}


def test_layout_keys_and_dtypes(tmp_path):
    params = _params()
    state = adamw.init_state(params)
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(7, {"params": params, "opt": state}, extra={"data_step": 7})
    assert os.path.basename(path) == "step_0000000007"
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert sorted(manifest) == ["extra", "keys", "step", "time"]
    assert manifest["keys"] == sorted(manifest["keys"])
    assert "['opt'].step" in manifest["keys"] and "['opt'].m['blocks']['w']" in manifest["keys"]
    with np.load(os.path.join(path, "arrays.npz")) as data:
        i = manifest["keys"].index("['params']['blocks']['w']")
        assert data[f"a{i}"].dtype == np.float32          # bf16 widened
        j = manifest["keys"].index("['opt'].step")
        assert data[f"a{j}"].shape == ()
    restored, got = mgr.restore({"params": params, "opt": state})
    assert got["extra"] == {"data_step": 7}
    assert restored["params"]["blocks"]["w"].dtype == torch.bfloat16
    assert isinstance(restored["opt"], adamw.AdamWState)
    for (ka, a), (kb, b) in zip(_flatten({"params": params, "opt": state}), _flatten(restored)):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_atomic_save_retention_and_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        mgr.restore({"a": torch.zeros(2)})
    for step in (1, 2, 3):
        mgr.save(step, {"a": torch.full((2,), float(step))})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3

    class Boom:                      # a leaf that fails while the save writes
        def __array__(self, *a, **k):
            raise RuntimeError("disk full")

    with pytest.raises(RuntimeError, match="disk full"):
        mgr.save(4, {"a": torch.ones(2), "b": Boom()})
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002", "step_0000000003"]
    restored, _ = mgr.restore({"a": torch.zeros(2)})
    assert torch.equal(restored["a"], torch.full((2,), 3.0))
    restored, _ = mgr.restore({"a": torch.zeros(2)}, step=2)
    assert torch.equal(restored["a"], torch.full((2,), 2.0))
    with pytest.raises(KeyError, match="no entry for") as ei:
        mgr.restore({"a": torch.zeros(2), "b": torch.zeros(2)})
    assert "['b']" in ei.value.args[0]


def test_packed_tree_round_trips_bit_for_bit(tmp_path, monkeypatch):
    """The packed int32 words and f32 scales move, never a dense weight; a
    paged-out delta stays absent."""
    import repro_torch.core.nesting as nesting

    nested = quantize({"w": torch.randn(128, 96, generator=torch.Generator().manual_seed(1)),
                       "norm": {"scale": torch.ones(96)}},
                      QuantRecipe(bits=(8, 6, 4), rounding="rtn"), device="cpu")
    w = nested["w"]
    paged = w._replace(deltas=(w.deltas[0], None), rung=1)
    monkeypatch.setattr(nesting, "materialize", lambda *a, **k: pytest.fail("densified"))
    monkeypatch.setattr(NestedTensor, "rung_weight", lambda *a, **k: pytest.fail("densified"))
    for t in ({"w": w, "norm": nested["norm"]}, {"w": paged}):
        mgr = CheckpointManager(str(tmp_path / str(len(t))))
        mgr.save(1, t)
        back, _ = mgr.restore(t)
        a, b = t["w"], back["w"]
        assert (a.bits, a.block, a.shape, a.rung) == (b.bits, b.block, b.shape, b.rung)
        assert b.w_base.dtype == torch.int32 and torch.equal(a.w_base, b.w_base)
        assert torch.equal(a.scale, b.scale)
        assert len(a.deltas) == len(b.deltas)
        for da, db in zip(a.deltas, b.deltas):
            assert (da is None and db is None) or torch.equal(da, db)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """The JAX package's manager writes {params (bf16 and f32), AdamW state
    after one update} and a nested tree; the port's manager restores both
    into templates it builds itself, leaf for leaf bit for bit."""
    key = jax.random.PRNGKey(0)
    jparams = {"blocks": {"w": jax.random.normal(key, (2, 128, 96)).astype(jnp.bfloat16),
                          "b": jnp.zeros((2, 96))},
               "norm": {"scale": jnp.ones((96,))}}
    jstate = jadamw.init_state(jparams)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jparams)
    jparams, jstate, _ = jadamw.apply_update(jparams, grads, jstate, lr=1e-3)
    jnested = jax_quantize({"w": jax.random.normal(key, (128, 96))},
                           JaxRecipe(bits=(8, 6, 4), rounding="rtn"))
    JaxManager(str(tmp_path / "a")).save(3, {"params": jparams, "opt": jstate},
                                         extra={"data_step": 3})
    JaxManager(str(tmp_path / "b")).save(5, jnested)

    tparams = jax_tree_to_torch(jax.tree.map(jnp.zeros_like, jparams))
    tmpl = {"params": tparams, "opt": adamw.init_state(tparams)}
    back, manifest = CheckpointManager(str(tmp_path / "a")).restore(tmpl)
    assert manifest["step"] == 3 and manifest["extra"] == {"data_step": 3}
    assert int(back["opt"].step) == 1
    ref = {"params": jparams, "m": jstate.m, "v": jstate.v, "master": jstate.master}
    got = {"params": back["params"], "m": back["opt"].m, "v": back["opt"].v,
           "master": back["opt"].master}
    for part in ref:
        for (k, a), b in zip(tree.flatten_with_path(got[part]), jax.tree_util.tree_leaves(
                ref[part])):
            assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16 else torch.float32), k
            assert t2n(a).tobytes() == j2n(b).tobytes(), (part, k)

    tnested = jax_tree_to_torch(jnested)
    empty = {"w": tnested["w"]._replace(w_base=torch.zeros_like(tnested["w"].w_base),
                                        deltas=tuple(torch.zeros_like(d)
                                                     for d in tnested["w"].deltas),
                                        scale=torch.zeros_like(tnested["w"].scale))}
    back, _ = CheckpointManager(str(tmp_path / "b")).restore(empty)
    assert torch.equal(back["w"].w_base, tnested["w"].w_base)
    assert all(torch.equal(a, b) for a, b in zip(back["w"].deltas, tnested["w"].deltas))
    assert torch.equal(back["w"].scale, tnested["w"].scale)
