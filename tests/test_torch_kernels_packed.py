"""K1 parity: the port's packed_matmul (its plain version, on the CPU)
against the JAX package's Pallas kernel run in interpret mode, at rung 0
of each ladder."""
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.packed_matmul import ops as jax_ops
from repro_torch.kernels.packed_matmul import ops
from torch_parity import (KERNEL_KS, KERNEL_MS, activations, assert_close,
                          stream_operands)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [(4, 8), (4, 6, 8), (2, 4, 6, 8)])
def test_packed_matmul_plain_matches_interpret_kernel(bits, dtype):
    for K in KERNEL_KS:
        b, words, scale, block = stream_operands(bits, 0, K, seed=K + sum(bits))
        for M in KERNEL_MS:
            xj, xt = activations(M, K, dtype, seed=M)
            ref = jax_ops.packed_matmul(xj, jnp.asarray(words[0]), jnp.asarray(scale),
                                        k=b[0], K=K, block_k=block, interpret=True)
            before = (ops.COUNTER.launches, ops.COUNTER.plain_launches)
            got = ops.packed_matmul(xt, torch.from_numpy(words[0]), torch.from_numpy(scale),
                                    k=b[0], K=K, block_k=block)
            assert (ops.COUNTER.launches, ops.COUNTER.plain_launches) == \
                (before[0], before[1] + 1)
            assert got.dtype == xt.dtype and tuple(got.shape) == (M, scale.shape[1])
            assert_close(got, ref, dtype)


def test_prepare_repacks_one_stream():
    """prepare(): the recomposed top rung as one n-bit stream reproduces
    the ladder's top-rung matmul."""
    from repro_torch.core.nesting import nest_quantize
    from repro_torch.kernels.nested_matmul import ops as nops

    w = torch.from_numpy(
        __import__("numpy").random.default_rng(0).normal(size=(384, 128)).astype("float32"))
    nt = nest_quantize(w, bits=(8, 6, 4), rounding="rtn", block=128)
    words, scale, k, K = ops.prepare(nt, "full", block_k=256)
    x = torch.randn(3, 384, generator=torch.Generator().manual_seed(0))
    x_pad = torch.cat([x, x.new_zeros(3, K - 384)], dim=1)
    y1 = ops.packed_matmul(x_pad, words, scale, k=k, K=K, block_k=256)
    y2 = nops.ladder_matmul(x, (nt.w_base,) + nt.deltas, nt.scale.reshape(1, -1),
                            bits=nt.bits, K=384, block_k=128)
    torch.testing.assert_close(y1, y2, rtol=1e-5, atol=1e-4)
