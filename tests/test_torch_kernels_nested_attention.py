"""Port parity of K4 (the nested KV cache's integer QK^T): the port's plain
version against the JAX kernel in interpret mode, bit for bit, at the
shapes and ladders of tests/test_kv_cache.py, and the whole
nested-attention op against the JAX op."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.nested_attention import nested_attention as jax_nested_attention
from repro.kernels.nested_attention import ref as jax_ref
from repro_torch.core import packing
from repro_torch.core.decompose import chain_decompose
from repro_torch.kernels.nested_attention import ops, ref
from repro_torch.serving.kv_cache import kv_stream_widths
from torch_parity import (KV_PAGE, j2n, jax_kv_streams, jax_nested_qk, kv_values,
                          t2n, to_torch)

LADDERS = [(4, 8), (4, 6, 8), (3, 5, 6, 8)]
Q_SHAPE, K_SHAPE = (3, 4, 16), (3, 4 * KV_PAGE, 16)


@pytest.mark.parametrize("bits,rungs", [(b, range(len(b))) for b in LADDERS]
                         + [((6, 8), (0,))])
def test_plain_qk_bit_exact_vs_jax_kernel_at_every_rung(bits, rungs):
    """Rung 0 of (6, 8) is the one-stream case (no recompose)."""
    streams, _ = jax_kv_streams(K_SHAPE, bits, KV_PAGE, 8)
    for rung in rungs:
        qc, want = jax_nested_qk(Q_SHAPE, K_SHAPE, bits, rung, KV_PAGE, 7)
        got = ops.ladder_qk_scores(to_torch(qc), [to_torch(s) for s in streams[:rung + 1]],
                                   bits=bits[:rung + 1], page=KV_PAGE)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(t2n(got), want, err_msg=f"bits {bits} rung {rung}")


@pytest.mark.parametrize("page", [16, 5, 1])
def test_plain_qk_any_page_matches_jax_reference(page):
    """Pages that leave word rows partly used (page 16 with the 1-bit
    component of a 3-bit delta, an odd page, a one-position page) against
    the JAX reference; the port's packing of the same codes is the JAX
    package's word for word."""
    bits = (4, 6, 8)
    shape = (2, 3 * page, 16)
    streams, _ = jax_kv_streams(shape, bits, page, 3)
    qc = np.random.default_rng(4).integers(-128, 128, size=(2, 5, 16)).astype(np.int32)
    tstreams = [to_torch(s) for s in streams]
    for rung in range(3):
        want = jax_ref.nested_qk_ref(jnp.asarray(qc), tuple(jnp.asarray(s) for s in streams[:rung + 1]),
                                     bits=bits[:rung + 1], page=page)
        got = ref.nested_qk_ref(to_torch(qc), tstreams[:rung + 1], bits=bits[:rung + 1],
                                page=page)
        np.testing.assert_array_equal(t2n(got), np.asarray(want))
    # the port's own quantize + split + pack gives the same words
    x = torch.from_numpy(kv_values(shape, 3))
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127
    codes = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int32)
    base, deltas = chain_decompose(codes, bits, method="rtn")
    for s, c, w in zip(streams, (base, *deltas), kv_stream_widths(bits)):
        np.testing.assert_array_equal(t2n(packing.pack_blocked(c, w, page, axis=1)), s)


@pytest.mark.parametrize("rung", [0, 1, 2])
def test_plain_qk_bit_exact_vs_jax_kernel_at_edge_shapes(rung):
    """D = 40 (no multiple of the CUDA kernel's 32-deep tensor-core step),
    M = 17 (a second, ragged 16-row query tile) and page 5 (pages that leave
    word rows partly used) against the JAX kernel in interpret mode."""
    bits, page = (4, 6, 8), 5
    q_shape, k_shape = (2, 17, 40), (2, 6 * page, 40)
    streams, _ = jax_kv_streams(k_shape, bits, page, 21)
    qc, want = jax_nested_qk(q_shape, k_shape, bits, rung, page, 20)
    got = ops.ladder_qk_scores(to_torch(qc), [to_torch(s) for s in streams[:rung + 1]],
                               bits=bits[:rung + 1], page=page)
    assert got.dtype == torch.int32 and got.shape == (2, 17, 6 * page)
    np.testing.assert_array_equal(t2n(got), want)


def test_plain_qk_wraps_like_jax_int32():
    """Query codes large enough that the int32 sums wrap: the port wraps
    exactly as JAX's int32 contraction."""
    bits = (8, 16)
    streams, _ = jax_kv_streams((2, 2 * KV_PAGE, 16), bits, KV_PAGE, 5)
    qc = np.random.default_rng(6).integers(2 ** 20, 2 ** 30, size=(2, 3, 16)).astype(np.int32)
    want = jax_ref.nested_qk_ref(jnp.asarray(qc), tuple(jnp.asarray(s) for s in streams),
                                 bits=bits, page=KV_PAGE)
    got = ref.nested_qk_ref(to_torch(qc), [to_torch(s) for s in streams], bits=bits,
                            page=KV_PAGE)
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


def test_nested_attention_op_matches_jax_and_improves_with_rung():
    """The whole op (integer scores, f32 scales, softmax, PV) within 1e-4
    of the JAX op at every rung, and its error against the dense oracle
    shrinks as deltas become resident (the reference's pinned limits)."""
    bits, tol = (4, 6, 8), {0: 0.2, 1: 0.05, 2: 0.02}
    shape = (4, 8 * KV_PAGE, 16)
    q = kv_values((4, 8, 16), 11)
    ks, k_scale = jax_kv_streams(shape, bits, KV_PAGE, 12)
    vs, v_scale = jax_kv_streams(shape, bits, KV_PAGE, 13)
    k, v = kv_values(shape, 12), kv_values(shape, 13)
    dense = t2n(ref.dense_attention_ref(*(torch.from_numpy(a) for a in (q, k, v))))
    np.testing.assert_allclose(
        dense, j2n(jax_ref.dense_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))),
        rtol=1e-5, atol=1e-5)
    prev = None
    for rung in range(3):
        want = jax_nested_attention(jnp.asarray(q), tuple(map(jnp.asarray, ks[:rung + 1])),
                                    jnp.asarray(k_scale), tuple(map(jnp.asarray, vs[:rung + 1])),
                                    jnp.asarray(v_scale), bits=bits, page=KV_PAGE, rung=rung)
        got = t2n(ops.nested_attention(torch.from_numpy(q), [to_torch(s) for s in ks[:rung + 1]],
                                       to_torch(k_scale), [to_torch(s) for s in vs[:rung + 1]],
                                       to_torch(v_scale), bits=bits, page=KV_PAGE, rung=rung))
        np.testing.assert_allclose(got, j2n(want), rtol=1e-4, atol=1e-4)
        rel = float(np.linalg.norm(got - dense) / np.linalg.norm(dense))
        assert rel < tol[rung], (rung, rel)
        if prev is not None:
            assert rel < prev
        prev = rel
