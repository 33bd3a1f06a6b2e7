"""The rest of the reference's core surface in the port: the flat slot-major
packing, Eq. 4, the CASE metric, recipe overrides, the two-level names of
``NestedTensor`` and the package exports.  The same inputs, made from a
seed with numpy, go through the JAX function and the port's on the CPU:
integer work bit for bit, float work within the stated tolerances."""
import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nesting as jn
from repro.core import packing as jp
from repro.core import quantizer as jq
from repro.core import recipe as jr
from repro.core import squant as js
from repro_torch.core import nesting as tn
from repro_torch.core import packing as tp
from repro_torch.core import quantizer as tq
from repro_torch.core import recipe as tr
from repro_torch.core import squant as ts

from torch_parity import KERNEL_TOL, j2n, t2n

SRC = Path(__file__).resolve().parents[1] / "src"


def _codes(k, shape, seed):
    lo, hi = -(2 ** (k - 1)), 2 ** (k - 1) - 1
    return np.random.default_rng(seed).integers(lo, hi + 1, size=shape, dtype=np.int64) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# flat slot-major packing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("k", [2, 3, 4, 6, 8, 16])
def test_pack_unpack_and_unpack_words_bit_for_bit(k, axis):
    K = 37                                   # no multiple of any slot count
    x = _codes(k, (K, 5) if axis == 0 else (5, K), k + axis)
    words = tp.pack(torch.from_numpy(x), k, axis=axis)
    ref = np.asarray(jp.pack(jnp.asarray(x), k, axis=axis))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy(), ref)
    got = tp.unpack(words, k, K, axis=axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.unpack(jnp.asarray(ref), k, K,
                                                                     axis=axis)))
    np.testing.assert_array_equal(got.numpy(), x)
    assert tp.unpack(words, k, K, axis=axis, dtype=torch.float32).dtype == torch.float32
    along0 = np.array(ref if axis == 0 else ref.T)
    for signed in (True, False):
        np.testing.assert_array_equal(
            tp.unpack_words(torch.from_numpy(along0), k, K, signed=signed).numpy(),
            np.asarray(jp.unpack_words(jnp.asarray(along0), k, K, signed=signed)))


@pytest.mark.parametrize("shape,k,axis", [((37, 5), 3, 0), ((5, 37), 6, 1),
                                          ((2, 64, 8), 4, 1), ((100,), 16, 0)])
def test_packed_nbytes_exact(shape, k, axis):
    want = jp.packed_nbytes(shape, k, axis)
    assert tp.packed_nbytes(shape, k, axis) == want
    x = _codes(k, shape, 0)
    assert tp.pack(torch.from_numpy(x), k, axis=axis).numel() * 4 == want


# ---------------------------------------------------------------------------
# Eq. 4, the CASE metric, recipe overrides
# ---------------------------------------------------------------------------
def test_perturbation_is_eq4():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    scale = (np.abs(w).max(axis=0, keepdims=True) / 127).astype(np.float32)
    w_int = np.clip(np.round(w / scale), -128, 127).astype(np.int32)
    got = tq.perturbation(torch.from_numpy(w), torch.from_numpy(w_int), torch.from_numpy(scale))
    want = np.asarray(jq.perturbation(jnp.asarray(w), jnp.asarray(w_int), jnp.asarray(scale)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_case_metric():
    rng = np.random.default_rng(5)
    v = (rng.normal(size=(3, 16, 200)) * 20).astype(np.float32)
    q = np.round(v).astype(np.int32)
    q[..., ::7] += 1                         # a CASE error to measure
    got = ts.case_metric(torch.from_numpy(v), torch.from_numpy(q)).numpy()
    want = np.asarray(js.case_metric(jnp.asarray(v), jnp.asarray(q)))
    assert got.shape == want.shape == (3, 16)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_with_overrides_prepends_in_the_same_order():
    def recipe(mod):
        base = mod.QuantRecipe(bits=(8, 4), overrides=(
            mod.LayerOverride(pattern="mlp", bits=(8, 6, 4)),))
        return base.with_overrides(mod.LayerOverride(pattern="q", dense=True),
                                   mod.LayerOverride(pattern="mlp", bits=(8, 5)))
    got, want = recipe(tr), recipe(jr)
    assert [(o.pattern, o.bits, o.dense) for o in got.overrides] == \
        [(o.pattern, o.bits, o.dense) for o in want.overrides] == \
        [("q", None, True), ("mlp", (5, 8), False), ("mlp", (4, 6, 8), False)]
    for path in ("['layers']['mlp']['up']['w']", "['layers']['attn']['q']['w']", "['head']"):
        spec, ref = got.resolve(path), want.resolve(path)
        assert (spec is None) == (ref is None)
        if spec is not None:
            assert (spec.bits, spec.rounding, spec.block, spec.group_size) == \
                (ref.bits, ref.rounding, ref.block, ref.group_size)
    assert got.to_json() == want.to_json()


# ---------------------------------------------------------------------------
# the two-level names of NestedTensor
# ---------------------------------------------------------------------------
LADDERS = [(4, 8), (4, 6, 8)]


def _pair(bits):
    w = (np.random.default_rng(sum(bits)).normal(size=(2, 128, 48)) * 0.05).astype(np.float32)
    return (jn.nest_quantize(jnp.asarray(w), bits=bits, rounding="rtn", block=64),
            tn.nest_quantize(torch.from_numpy(w), bits=bits, rounding="rtn", block=64))


@pytest.mark.parametrize("bits", LADDERS)
def test_two_level_names_equal_the_reference(bits):
    j, t = _pair(bits)
    assert (t.n, t.h, t.l, t.gaps) == (j.n, j.h, j.l, j.gaps)
    np.testing.assert_array_equal(t.w_high.numpy(), np.asarray(j.w_high))
    for name in ("codes_high", "codes_full"):
        np.testing.assert_array_equal(getattr(t, name)().numpy(), np.asarray(getattr(j, name)()))
    if len(bits) == 2:
        np.testing.assert_array_equal(t.w_low.numpy(), np.asarray(j.w_low))
        np.testing.assert_array_equal(t.codes_low().numpy(), np.asarray(j.codes_low()))
    else:                                    # one delta stream per level: ambiguous
        for obj, err in ((j, AssertionError), (t, ValueError)):
            with pytest.raises(err):
                obj.w_low
            with pytest.raises(err):
                obj.codes_low()
    np.testing.assert_array_equal(t.part_scale.numpy(), np.asarray(j.part_scale))
    for dtype, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        tdt, tol = getattr(torch, dtype), KERNEL_TOL[dtype]
        np.testing.assert_allclose(t2n(t.part_bit(tdt)), j2n(j.part_bit(jdt)), rtol=tol,
                                   atol=tol * 20)
        for mode in ["part", "full"] + [r for r in range(len(bits))]:
            jm = j.with_mode(mode) if isinstance(mode, str) else j.with_rung(mode)
            tm = t.with_mode(mode) if isinstance(mode, str) else t.with_rung(mode)
            assert (tm.rung, tm.mode) == (jm.rung, jm.mode)
            np.testing.assert_allclose(t2n(tm.dequant(tdt)), j2n(jm.dequant(jdt)), rtol=tol,
                                       atol=tol * 20)


def test_set_tree_mode_is_set_tree_rung_at_either_end():
    j2, t2 = _pair((4, 8))
    j3, t3 = _pair((4, 6, 8))
    tree = {"a": t2, "b": {"c": t3, "d": torch.ones(3)}}
    jtree = {"a": j2, "b": {"c": j3, "d": jnp.ones(3)}}

    def stamps(x):
        return (x["a"].rung, x["b"]["c"].rung)
    for mode, rung in (("full", -1), ("part", 0)):
        got = tn.set_tree_mode(tree, mode)
        assert stamps(got) == stamps(tn.set_tree_rung(tree, rung)) == \
            stamps(jn.set_tree_mode(jtree, mode))
        assert got["b"]["d"] is tree["b"]["d"]
    with pytest.raises(ValueError):
        tn.set_tree_mode(tree, "half")


# ---------------------------------------------------------------------------
# package exports
# ---------------------------------------------------------------------------
def _imported_names(init: Path):
    return sorted(a.asname or a.name for node in ast.parse(init.read_text()).body
                  if isinstance(node, ast.ImportFrom) for a in node.names)


@pytest.mark.parametrize("package", ["core"] + sorted(
    p.parent.name for p in (SRC / "repro" / "kernels").glob("*/__init__.py")))
def test_the_port_exports_every_public_name_the_reference_imports(package):
    sub = package if package == "core" else f"kernels.{package}"
    names = [n for n in _imported_names(SRC / "repro" / Path(*sub.split(".")) / "__init__.py")
             if not n.startswith("_")]
    assert names
    port = importlib.import_module(f"repro_torch.{sub}")
    assert [n for n in names if not hasattr(port, n)] == []
    if package == "core":
        assert set(names) <= set(port.__all__)
