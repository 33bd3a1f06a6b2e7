"""Port parity of the sharding rules (``repro_torch/distributed/sharding.py``,
``ctx.py``, ``steps.quantize_abstract`` / ``_nested_pspecs``) against the
JAX package's, in one process with no devices: the reference's spec
functions take a shape-only mesh as they stand.

Every arch in the registry, on the meshes (16, 16), (2, 16, 16), (2, 2),
(1, 4) and (4, 1), for each of ``SHAPES``: ``param_pspecs`` (with and
without ``fsdp``, with ``attn_cols``), ``logical_rules``, ``batch_pspecs``,
``cache_pspecs`` and ``opt_pspecs`` equal the reference's entry for
entry.  Exact equality throughout: these are pure functions of integers."""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.distributed import sharding as jshd
from repro.distributed import steps as jsteps
from repro.models import make_model as jax_make_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import ctx, sharding, steps
from repro_torch.launch import mesh as pmesh
from repro_torch import tree

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2): ("data", "model"), (1, 4): ("data", "model"), (4, 1): ("data", "model")}


def _jax_mesh(shape, axes):
    return types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)


def _flat_jax(specs):
    P = jax.sharding.PartitionSpec
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _flat_port(specs):
    return {k: tuple(s) for k, s in tree.flatten_with_path(specs)}


_ABSTRACT = {}


def _abstract(name):
    """(the reference's eval_shape of its init, the port's meta init) of the
    full-size config."""
    if name not in _ABSTRACT:
        jcfg = jax_get_config(name)
        _ABSTRACT[name] = (jax.eval_shape(jax_make_model(jcfg).init, jax.random.PRNGKey(0)),
                           steps.abstract_params(get_config(name)))
    return _ABSTRACT[name]


def test_registries_agree():
    assert sorted(ARCHS) == sorted(JAX_ARCHS) and len(ARCHS) == 10
    assert sorted(SHAPES) == sorted(JAX_SHAPES)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_have_the_reference_shapes(arch):
    jabs, pabs = _abstract(arch)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            ((jax.tree_util.keystr(p), v) for p, v in
             jax.tree_util.tree_flatten_with_path(jabs)[0])}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in tree.flatten_with_path(pabs)}
    assert got == want
    assert all(v.device.type == "meta" for v in tree.leaves(pabs))


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_the_reference(arch, mesh_shape):
    axes = MESHES[mesh_shape]
    jmesh = _jax_mesh(mesh_shape, axes)
    pm = pmesh.shape_only(mesh_shape, axes)
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jabs, pabs = _abstract(arch)
    for kw in ({}, {"fsdp": None}, {"attn_cols": True}, {"fsdp": "data", "attn_cols": True}):
        want = jshd.param_pspecs(jcfg, jabs, jmesh, **kw)
        got = sharding.param_pspecs(cfg, pabs, pm, **kw)
        assert _flat_port(got) == _flat_jax(want), kw
        ow, og = jshd.opt_pspecs(want), sharding.opt_pspecs(got)
        assert tuple(og.step) == tuple(ow.step)
        for f in ("m", "v", "master"):
            assert _flat_port(getattr(og, f)) == _flat_jax(getattr(ow, f)), f
    for name, jshape in JAX_SHAPES.items():
        shape = SHAPES[name]
        assert sharding.logical_rules(cfg, shape, pm) == jshd.logical_rules(jcfg, jshape, jmesh)
        for labels in (False, True):
            got = sharding.batch_pspecs(cfg, shape, pm, labels)
            want = jshd.batch_pspecs(jcfg, jshape, jmesh, labels)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}
        got = sharding.cache_pspecs(cfg, shape, pm)
        want = jshd.cache_pspecs(jcfg, jshape, jmesh)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


def test_dp_axes_and_port_specs_are_tuples():
    assert sharding.dp_axes(pmesh.shape_only((2, 16, 16), ("pod", "data", "model"))) == \
        ("pod", "data")
    s = sharding.P("data", None)
    assert isinstance(s, tuple) and tuple(s) == ("data", None) and sharding.P() == ()


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "dbrx-132b"])
def test_quantize_abstract_has_the_reference_leaves(arch):
    from repro.core.nesting import NestedTensor as JaxNested
    from repro_torch.core.nesting import NestedTensor

    want = jsteps.quantize_abstract(jax_get_config(arch))
    got = steps.quantize_abstract(get_config(arch))
    jflat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, JaxNested))[0]
    jflat = {jax.tree_util.keystr(p): v for p, v in jflat}
    pflat = dict(tree.flatten_with_path(got))
    assert sorted(pflat) == sorted(jflat)
    n_nested = 0
    for key, w in jflat.items():
        g = pflat[key]
        if isinstance(w, JaxNested):
            n_nested += 1
            assert isinstance(g, NestedTensor), key
            assert (g.shape, g.bits, g.block) == (tuple(w.shape), tuple(w.bits), w.block), key
            pairs = [(g.w_base, w.w_base), (g.scale, w.scale)] + list(zip(g.deltas, w.deltas))
            for a, b in pairs:
                assert tuple(a.shape) == tuple(b.shape), key
                assert str(a.dtype).replace("torch.", "") == str(b.dtype), key
        else:
            assert tuple(g.shape) == tuple(w.shape), key
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), key
    assert n_nested > 0 and "embed" not in " ".join(
        k for k, v in pflat.items() if isinstance(v, NestedTensor))


def test_nested_pspecs_match_the_reference_on_the_reduced_qwen2():
    from repro.core.nesting import NestedTensor as JaxNested

    jcfg = jax_get_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    jmesh = _jax_mesh((2, 2), ("data", "model"))
    pm = pmesh.shape_only((2, 2), ("data", "model"))
    jabs = jax.eval_shape(jax_make_model(jcfg).init, jax.random.PRNGKey(0))
    jdense = jshd.param_pspecs(jcfg, jabs, jmesh, fsdp=None, attn_cols=True)
    want = jsteps._nested_pspecs(jsteps.quantize_abstract(jcfg), jdense)
    pdense = sharding.param_pspecs(cfg, steps.abstract_params(cfg), pm, fsdp=None,
                                   attn_cols=True)
    got = steps._nested_pspecs(steps.quantize_abstract(cfg), pdense)
    P = jax.sharding.PartitionSpec
    jflat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, (P, JaxNested)))[0]
    jflat = {jax.tree_util.keystr(p): v for p, v in jflat}
    pflat = dict(tree.flatten_with_path(got))
    assert sorted(pflat) == sorted(jflat)
    nested = 0
    for key, w in jflat.items():
        g = pflat[key]
        if isinstance(w, JaxNested):
            nested += 1
            assert tuple(g.w_base) == tuple(w.w_base) and tuple(g.scale) == tuple(w.scale)
            assert [tuple(d) for d in g.deltas] == [tuple(d) for d in w.deltas]
        else:
            assert tuple(g) == tuple(w), key
    assert nested > 0


def test_shard_hint_outside_a_context_returns_its_input():
    x = torch.arange(12.0).reshape(1, 3, 4)
    assert ctx.shard_hint(x, ("batch", None, "heads")) is x
    assert ctx.shard_hint(x, ("batch", None, "heads"), full=(None, None, 8)) is x
    assert ctx.current() is None
    assert ctx.enter_model(x) is x and ctx.sum_model(x) is x
    assert ctx.gather_model(x, -1) is x and ctx.mean_batch(x) is x
    assert ctx.to_pspec(("batch", None), {"batch": "data"}) == ("data", None)


def test_local_shard_cuts_each_rank_s_block():
    m = pmesh.shape_only((2, 2), ("data", "model"))
    x = torch.arange(16).reshape(4, 4)
    assert sharding.local_shard(x, sharding.P(), m) is x
    # a shape-only mesh is coordinate 0 of every axis
    np.testing.assert_array_equal(sharding.local_shard(x, sharding.P("data", "model"), m),
                                  x[:2, :2])
    with pytest.raises(ValueError):
        sharding.local_shard(torch.zeros(3, 4), sharding.P("data", None), m)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "dbrx-132b", "zamba2-2.7b", "musicgen-large"])
def test_input_specs_have_the_reference_shapes(arch):
    """Token ids are int64 in the port (int32 in the reference) and a cache's
    ``pos`` is a Python int (a 0-d array there); every other shape is the
    reference's."""
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        want = jsteps.input_specs(jax_get_config(arch), JAX_SHAPES[name])
        got = dict(tree.flatten_with_path(steps.input_specs(get_config(arch), SHAPES[name])))
        jflat = {jax.tree_util.keystr(p): tuple(v.shape)
                 for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        if "['cache']['pos']" in jflat:
            assert jflat.pop("['cache']['pos']") == () and got.pop("['cache']['pos']") == 0
        assert {k: tuple(v.shape) for k, v in got.items()} == jflat, name
