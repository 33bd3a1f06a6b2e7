"""Port parity of K6 (the page-in upgrade recompose): the port's plain
version against the JAX kernel in interpret mode, bit for bit, over the
(n, h) sweep of tests/test_kernels.py, and against the original codes."""
import numpy as np
import pytest
import torch

from repro_torch.core.nesting import nest_quantize
from repro_torch.kernels.nest_recompose import ops
from torch_parity import jax_recompose, t2n, to_torch


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
