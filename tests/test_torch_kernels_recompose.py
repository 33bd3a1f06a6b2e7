"""Port parity of K6 (the page-in upgrade recompose): the port's plain
version against the JAX kernel in interpret mode, bit for bit, over the
(n, h) sweep of tests/test_kernels.py, against the JAX package's plain
recompose at the edge shapes the card's tests use (every (n, h), a column
count that is no multiple of 4, a pack block that is no multiple of 32
with a ragged K), and against the original codes."""
import numpy as np
import pytest
import torch

from repro_torch.core.nesting import nest_quantize
from repro_torch.kernels.nest_recompose import ops
from torch_parity import jax_recompose, jax_recompose_ref, t2n, to_torch


@pytest.mark.parametrize("nh", [(8, 3), (8, 4), (8, 5), (8, 6), (8, 7), (6, 4), (6, 5)])
def test_plain_recompose_bit_exact_vs_jax_kernel(nh):
    n, h = nh
    w_int, wph, wpl, want = jax_recompose(n, h, 1024, 256, 512, n * 10 + h)
    before = ops.COUNTER.plain_launches
    got = ops.nest_recompose(to_torch(wph), to_torch(wpl), n=n, h=h, K=1024, block_k=512)
    assert ops.COUNTER.plain_launches == before + 1
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(t2n(got), want)
    # compensation: the recomposed codes are the original ones
    np.testing.assert_array_equal(t2n(got).astype(np.int32), w_int)


@pytest.mark.parametrize("K,block", [(1000, 256), (96, 32)])
def test_plain_recompose_is_rung_one_of_the_served_ladder(K, block):
    """On a nested (8, 6, 4) weight, recomposing the base and the first
    delta (n=6, h=4) is chain_recompose at rung 1, also for a K that is
    no multiple of the pack block."""
    nt = nest_quantize(torch.randn(K, 40, generator=torch.Generator().manual_seed(K)),
                       bits=(8, 6, 4), rounding="rtn", block=block)
    got = ops.nest_recompose(nt.w_base, nt.deltas[0], n=6, h=4, K=K, block_k=block)
    assert torch.equal(got.to(torch.int32), nt.codes_at(1))


# every (n, h) with 1 <= h < n <= 8 at one small shape; N = 97 (no multiple
# of the CUDA kernel's 4-column group); pack block 48 (no multiple of 32)
# with a ragged K - the shapes tests/test_torch_gpu.py holds the kernel to
EDGE_CASES = ([(n, h, 96, 8, 32) for n in range(2, 9) for h in range(1, n)]
              + [(6, 4, 64, 97, 32), (6, 4, 100, 16, 48), (8, 1, 100, 16, 48)])


@pytest.mark.parametrize("n,h,K,N,block", EDGE_CASES)
def test_plain_recompose_bit_exact_vs_jax_ref_at_edge_shapes(n, h, K, N, block):
    w_int, wph, wpl, want = jax_recompose_ref(n, h, K, N, block, 100 * n + h + K + N)
    got = ops.nest_recompose(to_torch(wph), to_torch(wpl), n=n, h=h, K=K, block_k=block)
    assert got.dtype == torch.int8 and got.shape == (K, N)
    np.testing.assert_array_equal(t2n(got), want)
    # the range's two ends and every other code come back exactly
    np.testing.assert_array_equal(t2n(got).astype(np.int32), w_int)
