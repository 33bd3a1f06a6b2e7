"""K1-K3 on the card: each CUDA kernel against its plain PyTorch version at
the main-path shapes of qwen2-1.5b, and the kernel route's refusals.

Marked ``gpu``: these need an NVIDIA H100 and nvcc, and skip elsewhere.
Whether a card is present is decided inside the fixture, never at import,
so every test worker collects the same tests.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the machine with the card has none.
"""
import math

import pytest
import torch

from repro_torch.core.nesting import nest_quantize
from repro_torch.kernels import dispatch
from repro_torch.kernels.nested_matmul import ops as nops
from repro_torch.kernels.packed_matmul import ops as pops

pytestmark = pytest.mark.gpu

# (K, N): q/o, k/v, gate/up, down, lm_head of qwen2-1.5b
SHAPES = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536), (1536, 151936)]
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100); this machine has none")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(name, nt, x, out_dtype):
    rung = {"packed_matmul": 0, "nested_matmul": 1, "ladder_matmul": 2}[name]
    scale = nt.rung_scale(rung).reshape(1, -1).contiguous()
    if name == "packed_matmul":
        return pops.packed_matmul(x, nt.w_base, scale, k=nt.bits[0], K=nt.K,
                                  block_k=nt.block, out_dtype=out_dtype)
    if name == "nested_matmul":
        return nops.nested_matmul(x, nt.w_base, nt.deltas[0], scale, n=nt.bits[1],
                                  h=nt.bits[0], K=nt.K, block_k=nt.block,
                                  out_dtype=out_dtype)
    return nops.ladder_matmul(x, (nt.w_base,) + nt.deltas, scale, bits=nt.bits,
                              K=nt.K, block_k=nt.block, out_dtype=out_dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", SHAPES)
def test_kernels_match_plain_versions_at_main_path_shapes(cuda, K, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(K + N)
    nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda) / math.sqrt(K),
                       bits=(8, 6, 4), rounding="rtn")
    out_dtype = torch.float32 if N == 151936 else dtype
    for M in (1, 4, 8, 32, 130):
        x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
        for name, counter in (("packed_matmul", pops.COUNTER),
                              ("nested_matmul", nops.NESTED_COUNTER),
                              ("ladder_matmul", nops.LADDER_COUNTER)):
            before = counter.launches
            got = _run(name, nt, x, out_dtype)
            assert counter.launches == before + 1
            with dispatch.reference_pass():
                ref = _run(name, nt, x, out_dtype)
            torch.cuda.synchronize()
            assert got.dtype == out_dtype and got.shape == (M, N)
            err = (got.float() - ref.float()).abs().max().item()
            peak = ref.float().abs().max().item()
            assert err <= TOL[dtype] * max(1.0, peak), (name, M, err, peak)


def test_ragged_k_n_and_small_blocks(cuda):
    """K not a multiple of the pack block (the last block is padded), N not
    a multiple of the 32-column tile, and blocks of 32/64 still match the
    plain version."""
    g = torch.Generator(device=cuda).manual_seed(1)
    for K, N, block in ((1000, 192, 64), (96, 100, 32), (200, 33, 128)):
        nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda),
                           bits=(2, 4, 6, 8), rounding="rtn", block=block)
        x = torch.randn(5, K, generator=g, device=cuda)
        got = nops.ladder_matmul(x, (nt.w_base,) + nt.deltas, nt.scale.reshape(1, -1),
                                 bits=nt.bits, K=K, block_k=block)
        with dispatch.reference_pass():
            ref = nops.ladder_matmul(x, (nt.w_base,) + nt.deltas,
                                     nt.scale.reshape(1, -1), bits=nt.bits, K=K,
                                     block_k=block)
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_kernel_route_raises_instead_of_falling_back(cuda):
    nt = nest_quantize(torch.randn(512, 256, device=cuda), bits=(8, 6, 4), rounding="rtn")
    scale = nt.scale.reshape(1, -1)
    x = torch.randn(4, 512, device=cuda)
    with pytest.raises(TypeError):
        pops.packed_matmul(x.half(), nt.w_base, scale, k=4, K=512, block_k=nt.block)
    with pytest.raises(ValueError):
        pops.packed_matmul(torch.randn(512, 4, device=cuda).t(), nt.w_base, scale,
                           k=4, K=512, block_k=nt.block)
    five = (nt.w_base,) + nt.deltas + nt.deltas
    with pytest.raises(ValueError):
        nops.ladder_matmul(x, five, scale, bits=(2, 4, 6, 8, 10), K=512, block_k=nt.block)
