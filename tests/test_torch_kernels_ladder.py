"""K3 parity: the port's ladder_matmul (its plain version, on the CPU)
against the JAX package's Pallas kernel in interpret mode, at every rung
>= 1 it serves; plus the kernel route's operand checks."""
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.nested_matmul import ops as jax_ops
from repro_torch.kernels import dispatch
from repro_torch.kernels.nested_matmul import ops
from torch_parity import (KERNEL_KS, KERNEL_MS, activations, assert_close,
                          stream_operands)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,rung", [((4, 8), 1), ((4, 6, 8), 2),
                                       ((2, 4, 6, 8), 2), ((2, 4, 6, 8), 3)])
def test_ladder_matmul_plain_matches_interpret_kernel(bits, rung, dtype):
    for K in KERNEL_KS:
        b, words, scale, block = stream_operands(bits, rung, K, seed=K + 3 * rung)
        for M in KERNEL_MS:
            xj, xt = activations(M, K, dtype, seed=M + 2)
            ref = jax_ops.ladder_matmul(xj, tuple(jnp.asarray(w) for w in words),
                                        jnp.asarray(scale), bits=b, K=K,
                                        block_k=block, interpret=True)
            before = ops.LADDER_COUNTER.plain_launches
            got = ops.ladder_matmul(xt, tuple(torch.from_numpy(w) for w in words),
                                    torch.from_numpy(scale), bits=b, K=K, block_k=block)
            assert ops.LADDER_COUNTER.plain_launches == before + 1
            assert_close(got, ref, dtype)


def _operands(bits, K=512, N=256, block=256):
    from repro_torch.core.packing import blocked_rows
    widths = [bits[0]] + [c - b + 1 for b, c in zip(bits, bits[1:])]
    streams = tuple(torch.zeros((K // block * blocked_rows(block, w), N), dtype=torch.int32)
                    for w in widths)
    return torch.zeros(4, K), streams, torch.ones(1, N)


@pytest.mark.parametrize("case", ["five_streams", "wide_bits", "odd_block", "f16",
                                  "short_stream", "strided_x"])
def test_kernel_route_rejects_what_the_kernel_does_not_take(case):
    """The checks the CUDA route runs before a launch (the kernel itself
    cannot run here): each bad operand raises instead of falling back."""
    bits, block = (2, 4, 6, 8, 10), 256
    if case != "five_streams":
        bits = (4, 6, 8) if case != "wide_bits" else (8, 12, 20)
    x, streams, scale = _operands(bits, block=block)
    if case == "odd_block":
        block = 96
    if case == "f16":
        x = x.half()
    if case == "short_stream":
        streams = (streams[0][:-1],) + streams[1:]
    if case == "strided_x":
        x = torch.zeros(512, 4).t()
    with pytest.raises((ValueError, TypeError)):
        dispatch.check_operands(x, streams, bits, scale, K=512, block=block,
                                out_dtype=torch.float32)


def test_reference_pass_is_scoped():
    x = torch.zeros(2, 8)
    assert not dispatch.takes_kernel(x)
    with dispatch.reference_pass():
        assert not dispatch.takes_kernel(x)
        assert dispatch._route.reference
    assert not dispatch._route.reference
