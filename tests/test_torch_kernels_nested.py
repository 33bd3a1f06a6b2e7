"""K2 parity: the port's dual-stream nested_matmul (its plain version, on
the CPU) against the JAX package's Pallas kernel in interpret mode, at
rung 1 of each ladder."""
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.nested_matmul import ops as jax_ops
from repro_torch.kernels.nested_matmul import ops
from torch_parity import (KERNEL_KS, KERNEL_MS, activations, assert_close,
                          stream_operands)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [(4, 8), (4, 6, 8), (2, 4, 6, 8)])
def test_nested_matmul_plain_matches_interpret_kernel(bits, dtype):
    for K in KERNEL_KS:
        b, words, scale, block = stream_operands(bits, 1, K, seed=K + 2 * sum(bits))
        for M in KERNEL_MS:
            xj, xt = activations(M, K, dtype, seed=M + 1)
            ref = jax_ops.nested_matmul(xj, jnp.asarray(words[0]), jnp.asarray(words[1]),
                                        jnp.asarray(scale), n=b[1], h=b[0], K=K,
                                        block_k=block, interpret=True)
            before = ops.NESTED_COUNTER.plain_launches
            got = ops.nested_matmul(xt, torch.from_numpy(words[0]),
                                    torch.from_numpy(words[1]), torch.from_numpy(scale),
                                    n=b[1], h=b[0], K=K, block_k=block)
            assert ops.NESTED_COUNTER.plain_launches == before + 1
            assert_close(got, ref, dtype)
