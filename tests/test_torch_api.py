"""The port's public surface (``repro_torch/api.py``): a counterpart of
every name the JAX package exports, re-exported lazily from the package
root, and ``nest_quantize_tree``, the compatibility shim, giving the
reference's tree bit for bit."""
import subprocess
import sys

import jax
import pytest
import torch

import repro
import repro.api as japi
import repro_torch
import repro_torch.api as api
from torch_parity import jax_tree_to_torch

# reference names the port leaves out on purpose (none: every one is ported)
ABSENT = frozenset()


def test_every_reference_export_has_a_counterpart():
    assert len(japi.__all__) == 86
    missing = [n for n in japi.__all__ if n not in api.__all__ and n not in ABSENT]
    assert not missing, missing
    assert list(api.__all__) == list(japi.__all__)
    for name in api.__all__:
        obj = getattr(api, name)
        assert getattr(repro_torch, name) is obj, name
        ref = getattr(japi, name)
        assert type(obj) is type(ref) or (callable(obj) and callable(ref)), name
    # the reference's package root exports a subset; the port's root all
    assert set(repro.__all__) <= set(repro_torch.__all__)
    assert tuple(repro_torch.__all__) == tuple(api.__all__)
    with pytest.raises(AttributeError):
        repro_torch.no_such_name


def test_package_import_is_lazy():
    code = ("import sys, repro_torch; "
            "assert 'repro_torch.serving.engine' not in sys.modules; "
            "repro_torch.ServeEngine; "
            "assert 'repro_torch.serving.engine' in sys.modules; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": "src", "PATH": ""}, cwd=repro_torch.__path__[0] + "/../..")


def _tree():
    k = jax.random.split(jax.random.PRNGKey(3), 3)
    return {"blocks": {"q": {"w": jax.random.normal(k[0], (2, 128, 96))},
                       "attn_norm": {"scale": jax.numpy.ones((2, 128))}},
            "lm_head": {"w": jax.random.normal(k[1], (128, 200))},
            "small": {"w": jax.random.normal(k[2], (32, 32))}}


@pytest.mark.parametrize("kw", [dict(n=8, h=None, rounding="bitshift", block=64),
                                dict(bits=(8, 6, 4))])
def test_nest_quantize_tree_is_the_reference_s(kw):
    from repro.core.nesting import nest_quantize_tree as jax_shim

    jtree = _tree()
    with pytest.warns(DeprecationWarning, match="compatibility shim"):
        want = jax_shim(jtree, **kw)
    with pytest.warns(DeprecationWarning, match="compatibility shim"):
        got = api.nest_quantize_tree(jax_tree_to_torch(jtree), **kw, device="cpu")
    want = jax_tree_to_torch(want)
    from repro_torch import tree
    flat_w, flat_g = tree.flatten_with_path(want), tree.flatten_with_path(got)
    assert [k for k, _ in flat_w] == [k for k, _ in flat_g]
    for (key, a), (_, b) in zip(flat_w, flat_g):
        if isinstance(a, api.NestedTensor):
            assert isinstance(b, api.NestedTensor), key
            assert (a.bits, a.block, a.shape, a.rung) == (b.bits, b.block, b.shape, b.rung)
            assert torch.equal(a.w_base, b.w_base) and torch.equal(a.scale, b.scale), key
            assert all(torch.equal(x, y) for x, y in zip(a.deltas, b.deltas)), key
        else:
            assert not isinstance(b, api.NestedTensor) and torch.equal(a, b), key
    assert isinstance(got["blocks"]["q"]["w"], api.NestedTensor)
    assert not isinstance(got["small"]["w"], api.NestedTensor)
