"""Port parity: rounding, the ladder split, nest_quantize, recipes and the
store's ledger against the JAX package on the same inputs."""
import dataclasses
from pathlib import Path

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jd = importlib.import_module("repro.core.decompose")
jn = importlib.import_module("repro.core.nesting")
jr = importlib.import_module("repro.core.recipe")
js = importlib.import_module("repro.core.squant")
jsw = importlib.import_module("repro.core.switching")
# the packages export a function named decompose, which hides the module
td = importlib.import_module("repro_torch.core.decompose")
from repro_torch.core import nesting as tn
from repro_torch.core import recipe as tr
from repro_torch.core import squant as ts
from repro_torch.core import switching as tsw
from torch_parity import jax_tree_to_torch

ROOT = Path(__file__).resolve().parent.parent
# the ladders of tests/test_ladder.py
LADDERS = [(8, 6, 4), (8, 5, 3), (8, 7, 6, 4), (8, 6, 5, 4, 3)]


def test_numerical_error_table_equal():
    assert td.numerical_error_table(8) == jd.numerical_error_table(8)
    assert td.numerical_error_table(6) == jd.numerical_error_table(6)


def _raises(fn):
    try:
        fn()
    except (AssertionError, ValueError):
        return True
    return False


@pytest.mark.parametrize("bits", [(8,), (8, 8), (1, 8), (8, 33), (4, 4, 8)])
def test_bad_ladders_raise_in_both(bits):
    assert _raises(lambda: jd.normalize_bits(bits))
    assert _raises(lambda: td.normalize_bits(bits))


@pytest.mark.parametrize("shift", [0, 1, 2])
def test_validate_split_raises_on_the_same_splits(shift):
    """A split_fn that leaves the {floor, ceil} pair (shift >= 1 away from
    floor) must be rejected by both splitters; floor itself passes."""
    codes = np.arange(-128, 128, dtype=np.int32).reshape(16, 16)

    def jax_split(cur, b_hi, b_lo):
        return jnp.floor_divide(cur, 2 ** (b_hi - b_lo)) - shift

    def torch_split(cur, b_hi, b_lo):
        return torch.div(cur, 2 ** (b_hi - b_lo), rounding_mode="floor") - shift

    j = _raises(lambda: jd.chain_decompose(jnp.asarray(codes), (8, 4), split_fn=jax_split))
    t = _raises(lambda: td.chain_decompose(torch.from_numpy(codes), (8, 4),
                                           split_fn=torch_split))
    assert j == t == (shift > 0)


@pytest.mark.parametrize("method", ["bitshift", "rtn", "adaptive"])
def test_chain_decompose_every_int8_code(method):
    codes = np.arange(-128, 128, dtype=np.int32).reshape(-1, 1)
    for bits in LADDERS:
        jb, jds = jd.chain_decompose(jnp.asarray(codes), bits, method=method)
        tb, tds = td.chain_decompose(torch.from_numpy(codes), bits, method=method)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        for a, b in zip(tds, jds):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(td.chain_recompose(tb, tds, bits).numpy(), codes)


def _weight(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 0.05


@pytest.mark.parametrize("rounding", ["bitshift", "rtn"])
@pytest.mark.parametrize("bits", LADDERS + [(8, 4)])
def test_nest_quantize_streams_and_scales_exact(bits, rounding):
    for shape, block in (((256, 64), None), ((2, 128, 96), 64)):
        w = _weight(sum(bits) + len(shape), shape)
        j = jn.nest_quantize(jnp.asarray(w), bits=bits, rounding=rounding, block=block)
        t = tn.nest_quantize(torch.from_numpy(w), bits=bits, rounding=rounding, block=block)
        assert (t.shape, t.bits, t.block, t.rung) == (tuple(j.shape), j.bits, j.block, j.rung)
        np.testing.assert_array_equal(t.w_base.numpy(), np.asarray(j.w_base))
        assert len(t.deltas) == len(j.deltas)
        for a, b in zip(t.deltas, j.deltas):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        assert t.stream_nbytes() == j.stream_nbytes()
        assert t.nbytes_scales() == j.nbytes_scales()
        for r in range(len(bits)):
            np.testing.assert_array_equal(t.codes_at(r).numpy(), np.asarray(j.codes_at(r)))


@pytest.mark.parametrize("rounding", ["adaptive", "rtn", "bitshift"])
def test_large_weight_nests_in_column_slices_exactly(monkeypatch, rounding):
    """A 2-D weight above ``SLICE_ELEMS`` elements is nested in column
    slices (a ragged last one here): streams, scales and codes equal
    nesting it in one piece, and for rtn and bitshift the JAX package's."""
    w = _weight(5, (256, 100))
    whole = tn.nest_quantize(torch.from_numpy(w), bits=(8, 6, 4), rounding=rounding)
    monkeypatch.setattr(tn, "SLICE_ELEMS", 256 * 16)
    sliced = tn.nest_quantize(torch.from_numpy(w), bits=(8, 6, 4), rounding=rounding)
    assert (sliced.shape, sliced.bits, sliced.block) == (whole.shape, whole.bits, whole.block)
    for a, b in zip((sliced.w_base, sliced.scale) + sliced.deltas,
                    (whole.w_base, whole.scale) + whole.deltas):
        assert torch.equal(a, b)
    if rounding != "adaptive":
        j = jn.nest_quantize(jnp.asarray(w), bits=(8, 6, 4), rounding=rounding)
        np.testing.assert_array_equal(sliced.w_base.numpy(), np.asarray(j.w_base))
        for a, b in zip(sliced.deltas, j.deltas):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bits", [(8, 6, 4), (8, 4)])
def test_adaptive_rounding_holds_the_reference_rule(bits):
    """Adaptive codes: floor/ceil membership and |CASE| <= 0.5 hold, and
    codes equal the reference's on every row whose error sum is not within
    1e-6 of a .5 tie (where summation order may round E the other way)."""
    w = _weight(3, (512, 48))
    v = w / (np.abs(w).max(axis=0, keepdims=True) / 127.0)
    vt = np.ascontiguousarray(v.T)                     # flip group = K
    q_t = ts.adaptive_round(torch.from_numpy(vt), 8).numpy()
    q_j = np.asarray(js.adaptive_round(jnp.asarray(vt), 8))
    assert ts.is_floor_ceil(torch.from_numpy(vt), torch.from_numpy(q_t)).all()
    assert np.abs(ts.group_signed_error(torch.from_numpy(vt),
                                        torch.from_numpy(q_t)).numpy()).max() <= 0.5
    e = vt - np.clip(np.round(vt), -128, 127)
    tie = np.abs(np.abs(e.sum(axis=-1) % 1.0) - 0.5) < 1e-6
    np.testing.assert_array_equal(q_t[~tie], q_j[~tie])
    # through the whole ladder: the invariants at every split, exact rows
    t = tn.nest_quantize(torch.from_numpy(w), bits=bits, rounding="adaptive")
    j = jn.nest_quantize(jnp.asarray(w), bits=bits, rounding="adaptive")
    same = (t.codes_at(t.top).numpy() == np.asarray(j.codes_at(j.top))).all(axis=0)
    assert same[~tie].all()


def _params(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32) * 0.05
    return {"embed": {"table": f(256, 64)},
            "blocks": {"q": {"w": f(2, 64, 64), "b": f(2, 64)},
                       "attn_norm": {"scale": np.ones((2, 64), np.float32)},
                       "mlp": {"w_up": {"w": f(2, 64, 128)},
                               "w_down": {"w": f(2, 128, 64)}}},
            "lm_head": {"w": f(64, 256)}}


def test_recipe_json_loads_in_both_and_quantizes_alike():
    text = (ROOT / "examples" / "recipe.json").read_text()
    rj, rt = jr.QuantRecipe.from_json(text), tr.QuantRecipe.from_json(text)
    assert rt.to_json() == rj.to_json()
    # rtn keeps every code exact (adaptive is held to its own rule above)
    rj, rt = dataclasses.replace(rj, rounding="rtn"), dataclasses.replace(rt, rounding="rtn")
    params = _params()
    qj = jr.quantize(jax.tree_util.tree_map(jnp.asarray, params), rj)
    qt = tr.quantize(jax.tree_util.tree_map(torch.from_numpy, params), rt, device="cpu")
    assert tn.tree_ladder_bytes(qt) == jn.tree_ladder_bytes(qj)
    assert tn.tree_bytes(qt) == jn.tree_bytes(qj)
    conv = jax_tree_to_torch(qj)
    for (pa, a), (pb, b) in zip(_flat(conv), _flat(qt)):
        assert pa == pb
        if isinstance(a, tn.NestedTensor):
            np.testing.assert_array_equal(a.w_base.numpy(), b.w_base.numpy())
            for da, db in zip(a.deltas, b.deltas):
                np.testing.assert_array_equal(da.numpy(), db.numpy())


def _flat(tree):
    from repro_torch import tree as tt
    return tt.flatten_with_path(tree)


def test_store_walk_and_mixed_apply_ledger_equal():
    params = _params(1)
    qj = jr.quantize(jax.tree_util.tree_map(jnp.asarray, params),
                      jr.QuantRecipe(bits=(8, 6, 4), rounding="rtn"))
    sj = jsw.NestQuantStore(qj, mode="part", dtype=jnp.float32)
    st = tsw.NestQuantStore(jax_tree_to_torch(qj), mode="part", device="cpu")
    assert st.ladder_bytes() == sj.ladder_bytes()
    for r in (2, 0, 1, 2, 1):
        sj.to_rung(r)
        st.to_rung(r)
        assert (st.rung, st.mode, st.resident_bytes()) == (sj.rung, sj.mode, sj.resident_bytes())
    mixed_j = jsw.RungAssignment(default=0, overrides=((r"\['q'\]", 2),))
    mixed_t = tsw.RungAssignment(default=0, overrides=((r"\['q'\]", 2),))
    assert st.apply(mixed_t) == sj.apply(mixed_j)
    assert st.mode == sj.mode == "mixed"
    assert st.resident_bytes() == sj.resident_bytes()
    assert st.leaf_rungs() == sj.leaf_rungs()
    assert st.ledger.events == sj.ledger.events
    assert (st.ledger.page_in_bytes, st.ledger.page_out_bytes) == \
        (sj.ledger.page_in_bytes, sj.ledger.page_out_bytes)
