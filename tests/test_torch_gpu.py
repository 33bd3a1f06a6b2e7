"""K1-K6 on the card: each CUDA kernel against its plain PyTorch version at
the shapes qwen2-1.5b gives it (the weight matmuls K1-K3 on their five
bodies - decode at M <= 8, the short prefill at bf16 M 9-63, the f32 body
above M 8, tensor cores at bf16 prefill M, the CUDA-core body by name -
the nested KV
cache's integer QK^T K4, long-prefill flash attention K5 and the page-in
recompose K6), the kernel routes' refusals, artifact fetches onto the card,
a serve after ``ServeEngine.warmup`` that builds nothing, the decode route's
rows independent of M (the speculative verify pass), speculative tokens
equal to plain greedy, and a corrupted fetch on the card rolled back.

Marked ``gpu``: these need an NVIDIA H100 and nvcc, and skip elsewhere.
Whether a card is present is decided inside the fixture, never at import,
so every test worker collects the same tests.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the machine with the card has none.
"""
import dataclasses
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


# ---------------------------------------------------------------------------
# K1-K3 tensor-core body (bf16 at M >= TC_MIN_M)
# ---------------------------------------------------------------------------
COUNTERS = {"packed_matmul": pops.COUNTER, "nested_matmul": nops.NESTED_COUNTER,
            "ladder_matmul": nops.LADDER_COUNTER}


def _run_rung(nt, rung, x, route=None, out_dtype=None):
    """The wrapper of rung ``rung`` of ``nt``'s ladder (K1 at 0, K2 at 1, K3
    above) with ``rung + 1`` resident streams; returns (output, counter)."""
    scale = nt.rung_scale(rung).reshape(1, -1).contiguous()
    streams, bits = ((nt.w_base,) + nt.deltas)[:rung + 1], nt.bits[:rung + 1]
    if rung == 0:
        return pops.packed_matmul(x, streams[0], scale, k=bits[0], K=nt.K, block_k=nt.block,
                                  route=route, out_dtype=out_dtype), pops.COUNTER
    if rung == 1:
        return nops.nested_matmul(x, streams[0], streams[1], scale, n=bits[1], h=bits[0],
                                  K=nt.K, block_k=nt.block, route=route,
                                  out_dtype=out_dtype), nops.NESTED_COUNTER
    return nops.ladder_matmul(x, streams, scale, bits=bits, K=nt.K, block_k=nt.block,
                              route=route, out_dtype=out_dtype), nops.LADDER_COUNTER


def _check_tensor_core_rungs(nt, x, out_dtype=None):
    """Every rung of ``nt`` on the tensor-core body (chosen by the route)
    within 2e-2 of max(1, max |y|) of the plain version, counted as a
    tensor-core launch."""
    for rung in range(len(nt.bits)):
        counter = COUNTERS[("packed_matmul", "nested_matmul", "ladder_matmul")[min(rung, 2)]]
        before = (counter.launches, counter.tc_launches)
        got, _ = _run_rung(nt, rung, x, out_dtype=out_dtype)
        assert (counter.launches, counter.tc_launches) == (before[0] + 1, before[1] + 1)
        with dispatch.reference_pass():
            want, _ = _run_rung(nt, rung, x, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == (out_dtype or x.dtype) and got.shape == want.shape
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        assert err <= TOL[torch.bfloat16] * max(1.0, peak), (nt.bits, rung, err, peak)


@pytest.mark.parametrize("M", [64, 65, 2200, 4096])
@pytest.mark.parametrize("bits", [(8, 6, 4), (3, 5, 6, 8)])
def test_tensor_core_body_matches_plain_at_every_rung(cuda, bits, M):
    """1-4 streams (rungs 0-3) at prefill M, ragged M included."""
    g = torch.Generator(device=cuda).manual_seed(M + len(bits))
    K, N = 1536, 1536
    nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda) / math.sqrt(K),
                       bits=bits, rounding="rtn")
    _check_tensor_core_rungs(nt, torch.randn(M, K, generator=g, device=cuda).bfloat16())


@pytest.mark.parametrize("K,N,block,bits", [
    (1000, 200, 64, (12, 16)),       # codes over 8 bits: the bf16 cast rounds
    (1536, 200, 512, (8, 6, 4)),     # N = 200: a ragged column tile
    (8960, 1536, 512, (8, 6, 4)),    # K = 8960 with block 512: a 256-element tail
    (8960, 256, 256, (8, 6, 4)),     # down's block, k/v's width (64-column tiles)
    (96, 100, 32, (2, 4, 6, 8)),     # block 32: 32-code steps, 4-byte x copies
    (999, 130, 64, (4, 8)),          # odd K: element-wise x loads; 8-byte word copies
])
def test_tensor_core_body_ragged_shapes_and_wide_codes(cuda, K, N, block, bits):
    g = torch.Generator(device=cuda).manual_seed(K + N)
    nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda) / math.sqrt(K),
                       bits=bits, rounding="rtn", block=block)
    for M in (70, 300):
        _check_tensor_core_rungs(nt, torch.randn(M, K, generator=g, device=cuda).bfloat16())


def test_tensor_core_body_f32_output(cuda):
    """The LM head's f32 output through the tensor-core body."""
    g = torch.Generator(device=cuda).manual_seed(5)
    nt = nest_quantize(torch.randn(1536, 4096, generator=g, device=cuda) / 40, bits=(8, 6, 4),
                       rounding="rtn")
    _check_tensor_core_rungs(nt, torch.randn(130, 1536, generator=g, device=cuda).bfloat16(),
                             out_dtype=torch.float32)


def test_route_counter_shows_which_body_ran(cuda):
    """M <= DEC_MAX_M takes the decode body in bf16 and f32; bf16 at M 9-63
    the short-prefill body; f32 above M 8 the f32 body; bf16 at TC_MIN_M
    the tensor-core one; a named route is honoured (the CUDA-core body is
    reached only so)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    nt = nest_quantize(torch.randn(512, 256, generator=g, device=cuda), bits=(8, 6, 4),
                       rounding="rtn")
    cases = [(dispatch.TC_MIN_M - 1, torch.bfloat16, None, 0, 0, 1, 0),
             (dispatch.DEC_MAX_M + 1, torch.bfloat16, None, 0, 0, 1, 0),
             (dispatch.TC_MIN_M, torch.bfloat16, None, 1, 0, 0, 0),
             (dispatch.TC_MIN_M, torch.float32, None, 0, 0, 0, 1),
             (dispatch.DEC_MAX_M + 1, torch.float32, None, 0, 0, 0, 1),
             (4, torch.bfloat16, None, 0, 1, 0, 0),
             (dispatch.DEC_MAX_M, torch.float32, None, 0, 1, 0, 0),
             (4, torch.bfloat16, dispatch.TENSOR_CORE, 1, 0, 0, 0),
             (4, torch.bfloat16, dispatch.MID, 0, 0, 1, 0),
             (dispatch.TC_MIN_M, torch.bfloat16, dispatch.MID, 0, 0, 1, 0),
             (4, torch.float32, dispatch.F32, 0, 0, 0, 1),
             (4, torch.float32, dispatch.CUDA_CORE, 0, 0, 0, 0),
             (dispatch.TC_MIN_M, torch.float32, dispatch.CUDA_CORE, 0, 0, 0, 0),
             (4096, torch.bfloat16, dispatch.CUDA_CORE, 0, 0, 0, 0)]
    for M, dtype, route, tc, dec, mid, f32 in cases:
        x = torch.randn(M, 512, generator=g, device=cuda).to(dtype)
        for rung, counter in enumerate(COUNTERS.values()):
            seen = lambda: (counter.launches, counter.tc_launches,  # noqa: E731
                            counter.dec_launches, counter.mid_launches, counter.f32_launches)
            before = seen()
            got, _ = _run_rung(nt, rung, x, route=route)
            assert seen() == (before[0] + 1, before[1] + tc, before[2] + dec, before[3] + mid,
                              before[4] + f32)
            with dispatch.reference_pass():
                want = _run_rung(nt, rung, x)[0]
            err = (got.float() - want.float()).abs().max().item()
            assert err <= TOL[dtype] * max(1.0, want.float().abs().max().item()), (M, route)


def test_tensor_core_route_raises_on_what_it_refuses(cuda):
    """The tensor-core body takes bf16 only: an f32 activation on a named
    tensor-core route raises instead of running the CUDA-core body, and
    counts no launch."""
    nt = nest_quantize(torch.randn(512, 256, device=cuda), bits=(8, 6, 4), rounding="rtn")
    x = torch.randn(128, 512, device=cuda)
    before = {n: (c.launches, c.tc_launches) for n, c in COUNTERS.items()}
    for rung in range(3):
        with pytest.raises(TypeError):
            _run_rung(nt, rung, x, route=dispatch.TENSOR_CORE)
    with pytest.raises(ValueError):
        _run_rung(nt, 2, x.bfloat16(), route="tensor")
    assert {n: (c.launches, c.tc_launches) for n, c in COUNTERS.items()} == before


# ---------------------------------------------------------------------------
# K1-K3 short-prefill body (bf16 at M 9-63)
# ---------------------------------------------------------------------------
def _check_mid_rungs(nt, x, rungs=None, out_dtype=None, streams=None):
    """Rungs of ``nt`` (every one by default) on the short-prefill body,
    chosen by the route: counted as one launch on it, within 2e-2 of max(1,
    max |y|) of the plain version, and bit-identical over two launches.
    ``streams`` replaces the leaf's own word streams."""
    assert dispatch.matmul_route(x.shape[0], x.dtype, x.device) == dispatch.MID
    for rung in range(len(nt.bits)) if rungs is None else rungs:
        src = nt if streams is None else nt._replace(w_base=streams[0],
                                                     deltas=tuple(streams[1:]))
        counter = COUNTERS[("packed_matmul", "nested_matmul", "ladder_matmul")[min(rung, 2)]]
        before = (counter.launches, counter.mid_launches)
        got, _ = _run_rung(src, rung, x, out_dtype=out_dtype)
        again, _ = _run_rung(src, rung, x, out_dtype=out_dtype)
        assert (counter.launches, counter.mid_launches) == (before[0] + 2, before[1] + 2)
        with dispatch.reference_pass():
            want, _ = _run_rung(src, rung, x, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == (out_dtype or x.dtype) and got.shape == want.shape
        assert torch.equal(got, again), (nt.bits, rung, "two launches differ")
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        assert err <= TOL[torch.bfloat16] * max(1.0, peak), (nt.bits, rung, x.shape, err, peak)


@pytest.mark.parametrize("bits", [(8, 6, 4), (3, 5, 6, 8)])
@pytest.mark.parametrize("K,N", SHAPES[:4])
def test_mid_body_matches_plain_at_every_rung(cuda, K, N, bits):
    """qwen2-1.5b's q/o, k/v, gate/up and down at M 9-63 (a multiple of 8
    and either side of one), 1-4 streams (every rung of each ladder)."""
    g = torch.Generator(device=cuda).manual_seed(K + N + len(bits))
    nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda) / math.sqrt(K),
                       bits=bits, rounding="rtn")
    for M in (9, 16, 31, 32, 33, 48, 63):
        _check_mid_rungs(nt, torch.randn(M, K, generator=g, device=cuda).bfloat16())


@pytest.mark.parametrize("K,N,block,bits", [
    (2560, 6448, 512, (8, 6, 4)),    # mamba2's in_proj: N no multiple of a tile
    (1000, 200, 64, (12, 16)),       # codes over 9 bits: the general path, bf16 rounding
    (96, 100, 32, (2, 4, 6, 8)),     # block 32: 2-row chunks, the general path
    (999, 130, 96, (3, 5, 6, 8)),    # block 96, odd K: element-wise x copies
    (520, 33, 64, (4, 8)),           # odd N: 4-byte word copies
    (8960, 256, 256, (8, 6, 4)),     # block 256, k/v's width
])
def test_mid_body_ragged_shapes_blocks_and_wide_codes(cuda, K, N, block, bits):
    g = torch.Generator(device=cuda).manual_seed(K + N + block)
    nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda) / math.sqrt(K),
                       bits=bits, rounding="rtn", block=block)
    for M in (9, 40, 63):
        _check_mid_rungs(nt, torch.randn(M, K, generator=g, device=cuda).bfloat16())


def test_mid_body_16_bit_stream_and_misaligned_views(cuda):
    """K1 on one 16-bit stream (two codes a word: ``prepare(..., "full")``
    of a (12, 16) ladder), and streams that start 4 or 8 bytes past a
    16-byte boundary (views into a larger buffer: narrower copies)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    nt = nest_quantize(torch.randn(999, 130, generator=g, device=cuda) / 30, bits=(12, 16),
                       rounding="rtn", block=64)
    words, scale, k, _ = pops.prepare(nt, "full", block_k=64)
    for M in (9, 40):
        x = torch.randn(M, 999, generator=g, device=cuda).bfloat16()
        before = pops.COUNTER.mid_launches
        got = pops.packed_matmul(x, words, scale.contiguous(), k=k, K=999, block_k=64)
        assert pops.COUNTER.mid_launches == before + 1
        with dispatch.reference_pass():
            want = pops.packed_matmul(x, words, scale.contiguous(), k=k, K=999, block_k=64)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[torch.bfloat16] * max(1.0, want.float().abs().max().item())
    nt = nest_quantize(torch.randn(1536, 256, generator=g, device=cuda) / 40, bits=(8, 6, 4),
                       rounding="rtn")
    for shift in (1, 2):
        views = []
        for s in (nt.w_base,) + nt.deltas:
            buf = torch.empty(s.numel() + shift, dtype=s.dtype, device=cuda)
            v = buf[shift:].view(s.shape)
            v.copy_(s)
            views.append(v)
        assert views[0].data_ptr() % 16 == 4 * shift
        _check_mid_rungs(nt, torch.randn(20, 1536, generator=g, device=cuda).bfloat16(),
                         streams=views)


def test_mid_body_f32_output_at_the_lm_head(cuda):
    """The LM head's f32 output (N 151936) through the short-prefill body."""
    g = torch.Generator(device=cuda).manual_seed(14)
    nt = nest_quantize(torch.randn(1536, 151936, generator=g, device=cuda) / 40,
                       bits=(8, 6, 4), rounding="rtn")
    _check_mid_rungs(nt, torch.randn(32, 1536, generator=g, device=cuda).bfloat16(),
                     out_dtype=torch.float32)


def test_mid_route_raises_on_what_it_refuses(cuda):
    """A named short-prefill route takes bf16 at most MID_MAX_M rows: an f32
    activation raises TypeError, 65 rows ValueError, before any launch (no
    other body runs, nothing is counted)."""
    nt = nest_quantize(torch.randn(512, 256, device=cuda), bits=(8, 6, 4), rounding="rtn")
    before = {n: (c.launches, c.mid_launches, c.plain_launches) for n, c in COUNTERS.items()}
    for rung in range(3):
        with pytest.raises(TypeError):
            _run_rung(nt, rung, torch.randn(32, 512, device=cuda), route=dispatch.MID)
        with pytest.raises(ValueError):
            _run_rung(nt, rung, torch.randn(dispatch.MID_MAX_M + 1, 512,
                                            device=cuda).bfloat16(), route=dispatch.MID)
    assert {n: (c.launches, c.mid_launches, c.plain_launches)
            for n, c in COUNTERS.items()} == before


@pytest.mark.parametrize("bits,N,K,block", [
    ((4,), 1536, 1536, 512), ((4, 6, 8), 256, 1536, 512), ((4, 6, 8), 8960, 1536, 512),
    ((4, 6, 8), 1536, 8960, 512), ((4, 6, 8), 151936, 1536, 512), ((4, 6, 8), 6448, 2560, 512),
    ((2, 4, 6, 8), 100, 96, 32), ((16,), 130, 999, 64), ((12, 16), 200, 1000, 64),
])
def test_mid_plan_mirror_is_the_library_s(cuda, bits, N, K, block):
    """The dry run's Python mirror of the short-prefill plan
    (``build.mid_workspace``) gives the library's partials per row and
    column tiles (``nq_mid_workspace``) on this card's SM count."""
    from repro_torch.kernels import build

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert build.mid_plan(cuda, bits, N, K, block) == build.mid_workspace(bits, N, K, block, sms)


# ---------------------------------------------------------------------------
# K1-K3 f32 body (f32 above M 8)
# ---------------------------------------------------------------------------
def _check_f32_rungs(nt, x, rungs=None, out_dtype=None, streams=None):
    """Rungs of ``nt`` (every one by default) on the f32 body, chosen by the
    route: counted as one launch on it, within 1e-4 of max(1, max |y|) of
    the plain version, and bit-identical over two launches.  ``streams``
    replaces the leaf's own word streams."""
    assert dispatch.matmul_route(x.shape[0], x.dtype, x.device) == dispatch.F32
    for rung in range(len(nt.bits)) if rungs is None else rungs:
        src = nt if streams is None else nt._replace(w_base=streams[0],
                                                     deltas=tuple(streams[1:]))
        counter = COUNTERS[("packed_matmul", "nested_matmul", "ladder_matmul")[min(rung, 2)]]
        before = (counter.launches, counter.f32_launches)
        got, _ = _run_rung(src, rung, x, out_dtype=out_dtype)
        again, _ = _run_rung(src, rung, x, out_dtype=out_dtype)
        assert (counter.launches, counter.f32_launches) == (before[0] + 2, before[1] + 2)
        with dispatch.reference_pass():
            want, _ = _run_rung(src, rung, x, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == (out_dtype or x.dtype) and got.shape == want.shape
        assert torch.equal(got, again), (nt.bits, rung, "two launches differ")
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        assert err <= TOL[torch.float32] * max(1.0, peak), (nt.bits, rung, x.shape, err, peak)


# (K, N): q/o, k/v, gate/up, down and lm_head of the reduced qwen2-1.5b
REDUCED_SHAPES = [(64, 64), (64, 32), (64, 128), (128, 64), (64, 256)]


@pytest.mark.parametrize("bits", [(8, 6, 4), (3, 5, 6, 8)])
@pytest.mark.parametrize("K,N", SHAPES[:4])
def test_f32_body_matches_plain_at_every_rung(cuda, K, N, bits):
    """qwen2-1.5b's q/o, k/v, gate/up and down in f32 above M 8: the short
    prefill (K split into runs), either side of the 32-, 64- and 128-row
    tiles, the ragged 2 x 1100 prefill and the 2 x 2048 one; 1-4 streams
    (every rung of each ladder)."""
    g = torch.Generator(device=cuda).manual_seed(K + N + len(bits))
    nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda) / math.sqrt(K),
                       bits=bits, rounding="rtn")
    for M in (9, 32, 33, 63, 64, 65, 130, 2200, 4096):
        _check_f32_rungs(nt, torch.randn(M, K, generator=g, device=cuda))


@pytest.mark.parametrize("K,N", REDUCED_SHAPES)
def test_f32_body_at_the_reduced_model_s_shapes(cuda, K, N):
    """The reduced qwen2-1.5b's five shapes (its pack blocks 64 and 128, N
    32 to 256) at the f32 prefill rows the CPU tests serve."""
    g = torch.Generator(device=cuda).manual_seed(K * N)
    nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda) / math.sqrt(K),
                       bits=(8, 6, 4), rounding="rtn")
    for M in (9, 16, 64, 130):
        _check_f32_rungs(nt, torch.randn(M, K, generator=g, device=cuda))


def test_f32_body_the_lm_head(cuda):
    """The LM head (N 151936, f32 out) at a prefill's last rows."""
    g = torch.Generator(device=cuda).manual_seed(15)
    nt = nest_quantize(torch.randn(1536, 151936, generator=g, device=cuda) / 40,
                       bits=(8, 6, 4), rounding="rtn")
    for M in (9, 32):
        _check_f32_rungs(nt, torch.randn(M, 1536, generator=g, device=cuda),
                         out_dtype=torch.float32)


@pytest.mark.parametrize("K,N,block,bits", [
    (2560, 6448, 512, (8, 6, 4)),    # mamba2's in_proj: N no multiple of a tile
    (1000, 200, 64, (12, 16)),       # codes over 9 bits: the general path
    (96, 100, 32, (2, 4, 6, 8)),     # block 32: one step a block, too few to split
    (999, 130, 96, (3, 5, 6, 8)),    # block 96, odd K: 4-byte x copies
    (520, 33, 64, (4, 8)),           # odd N: 4-byte word copies, scalar stores
    (8960, 256, 256, (8, 6, 4)),     # block 256, k/v's width
    (1536, 1536, 512, (2, 5, 9, 16)),  # a 16-bit top code, four streams
])
def test_f32_body_ragged_shapes_blocks_and_wide_codes(cuda, K, N, block, bits):
    g = torch.Generator(device=cuda).manual_seed(K + N + block)
    nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda) / math.sqrt(K),
                       bits=bits, rounding="rtn", block=block)
    for M in (9, 40, 100, 300):
        _check_f32_rungs(nt, torch.randn(M, K, generator=g, device=cuda))


def test_f32_body_16_bit_stream_and_misaligned_views(cuda):
    """K1 on one 16-bit stream (two codes a word: ``prepare(..., "full")``
    of a (12, 16) ladder), pack blocks 32 and 512, streams that start 4 or
    8 bytes past a 16-byte boundary and an x 4 bytes past one (narrower
    copies)."""
    g = torch.Generator(device=cuda).manual_seed(16)
    for block in (32, 512):
        nt = nest_quantize(torch.randn(1024, 130, generator=g, device=cuda) / 30,
                           bits=(12, 16), rounding="rtn", block=block)
        words, scale, k, _ = pops.prepare(nt, "full", block_k=block)
        for M in (9, 40, 200):
            x = torch.randn(M, 1024, generator=g, device=cuda)
            before = pops.COUNTER.f32_launches
            got = pops.packed_matmul(x, words, scale.contiguous(), k=k, K=1024, block_k=block)
            assert pops.COUNTER.f32_launches == before + 1
            with dispatch.reference_pass():
                want = pops.packed_matmul(x, words, scale.contiguous(), k=k, K=1024,
                                          block_k=block)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= TOL[torch.float32] * max(1.0, want.float().abs().max().item())
    nt = nest_quantize(torch.randn(1536, 256, generator=g, device=cuda) / 40, bits=(8, 6, 4),
                       rounding="rtn")
    for shift in (1, 2):
        views = []
        for s in (nt.w_base,) + nt.deltas:
            buf = torch.empty(s.numel() + shift, dtype=s.dtype, device=cuda)
            v = buf[shift:].view(s.shape)
            v.copy_(s)
            views.append(v)
        assert views[0].data_ptr() % 16 == 4 * shift
        xbuf = torch.randn(70 * 1536 + 1, generator=g, device=cuda)
        x = xbuf[1:].view(70, 1536)
        assert x.data_ptr() % 16 == 4
        _check_f32_rungs(nt, x, streams=views)


def test_f32_route_raises_on_what_it_refuses(cuda):
    """A named f32 route takes f32 only: a bf16 activation raises TypeError
    before any launch (no other body runs, nothing is counted)."""
    nt = nest_quantize(torch.randn(512, 256, device=cuda), bits=(8, 6, 4), rounding="rtn")
    before = {n: (c.launches, c.f32_launches, c.plain_launches) for n, c in COUNTERS.items()}
    for rung in range(3):
        with pytest.raises(TypeError):
            _run_rung(nt, rung, torch.randn(32, 512, device=cuda).bfloat16(),
                      route=dispatch.F32)
    assert {n: (c.launches, c.f32_launches, c.plain_launches)
            for n, c in COUNTERS.items()} == before


@pytest.mark.parametrize("bits,M,N,K,block", [
    ((4,), 32, 1536, 1536, 512), ((4, 6, 8), 63, 256, 1536, 512),
    ((4, 6, 8), 64, 8960, 1536, 512), ((4, 6, 8), 64, 1536, 8960, 256),
    ((4, 6, 8), 4096, 256, 1536, 512), ((4, 6, 8), 4096, 1536, 1536, 512),
    ((2, 4, 6, 8), 20, 100, 96, 32), ((16,), 40, 130, 999, 64), ((12, 16), 9, 151936, 1536, 512),
])
def test_f32_plan_mirror_is_the_library_s(cuda, bits, M, N, K, block):
    """The Python mirror of the f32 plan (``build.f32_workspace``, which the
    wrapper and the dry run size the partials with) gives the library's
    partials and tiles (``nq_f32_workspace``) on this card's SM count."""
    import ctypes

    from repro_torch.kernels import build

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    arr = (ctypes.c_int * len(bits))(*bits)
    tiles = ctypes.c_int(0)
    floats = build.library("nest_matmul_f32.cu").nq_f32_workspace(
        ctypes.addressof(arr), len(bits), M, N, K, block, ctypes.byref(tiles))
    assert (floats, tiles.value) == build.f32_workspace(M, N, K, block, sms)


# ---------------------------------------------------------------------------
# K1-K3 decode body (M <= DEC_MAX_M, bf16 and f32)
# ---------------------------------------------------------------------------
def _check_decode_rungs(nt, x, rungs=None, out_dtype=None, streams=None):
    """Rungs of ``nt`` (every one by default) on the decode body, chosen by
    the route: counted as a decode launch, within 2e-2 (bf16) or 1e-4
    (f32) of max(1, max |y|) of the plain version, and bit-identical over
    two launches.  ``streams`` replaces the leaf's own word streams."""
    tol = TOL[x.dtype]
    for rung in range(len(nt.bits)) if rungs is None else rungs:
        src = nt if streams is None else nt._replace(w_base=streams[0],
                                                     deltas=tuple(streams[1:]))
        counter = COUNTERS[("packed_matmul", "nested_matmul", "ladder_matmul")[min(rung, 2)]]
        before = (counter.launches, counter.dec_launches)
        got, _ = _run_rung(src, rung, x, out_dtype=out_dtype)
        again, _ = _run_rung(src, rung, x, out_dtype=out_dtype)
        assert (counter.launches, counter.dec_launches) == (before[0] + 2, before[1] + 2)
        with dispatch.reference_pass():
            want, _ = _run_rung(src, rung, x, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == (out_dtype or x.dtype) and got.shape == want.shape
        assert torch.equal(got, again), (nt.bits, rung, "two launches differ")
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        assert err <= tol * max(1.0, peak), (nt.bits, rung, x.shape, err, peak)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", SHAPES)
def test_decode_body_matches_plain_at_main_path_shapes(cuda, K, N, dtype):
    """Every main-path shape at rungs 0, 1 and 2, M in {1, 2, 3, 5, 8};
    the LM head with its f32 output."""
    g = torch.Generator(device=cuda).manual_seed(K * 3 + N)
    nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda) / math.sqrt(K),
                       bits=(8, 6, 4), rounding="rtn")
    out_dtype = torch.float32 if N == 151936 else None
    for M in (1, 2, 3, 5, 8):
        _check_decode_rungs(nt, torch.randn(M, K, generator=g, device=cuda).to(dtype),
                            out_dtype=out_dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N,block,bits", [
    (1000, 190, 32, (2, 4, 6, 8)),    # 4 streams, ragged K, N % 4 == 2: 8-byte loads
    (999, 130, 96, (3, 5, 6, 8)),     # block 96, odd K, codes wider than w_max
    (1536, 300, 256, (8, 6, 4)),      # block 256, a ragged column tile
    (520, 33, 64, (4, 8)),            # odd N: 4-byte loads
    (1536, 260, 512, (12, 16)),       # 16-bit codes: bf16 rounds them, as code_as
])
def test_decode_body_ragged_shapes_blocks_and_wide_codes(cuda, K, N, block, bits, dtype):
    g = torch.Generator(device=cuda).manual_seed(K + N + block)
    nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda) / math.sqrt(K),
                       bits=bits, rounding="rtn", block=block)
    for M in (1, 3, 8):
        _check_decode_rungs(nt, torch.randn(M, K, generator=g, device=cuda).to(dtype))
    _check_decode_rungs(nt, torch.randn(2, K, generator=g, device=cuda).to(dtype),
                        rungs=[len(bits) - 1], out_dtype=torch.float32)


@pytest.mark.parametrize("bits", [(4, 6, 8), (2, 5, 9, 16), (2, 3, 4)])
def test_decode_body_chain_edge_codes(cuda, bits):
    """Codes at the ladder's lo and hi (and every neighbour of them): the
    chain recompose's clip, on both the packed-field and the general path."""
    from repro_torch.core.decompose import chain_decompose
    from repro_torch.core.nesting import NestedTensor
    from repro_torch.core.packing import pack_blocked

    g = torch.Generator(device=cuda).manual_seed(len(bits))
    K, N, block, top = 512, 256, 512, bits[-1]
    lo, hi = -(1 << (top - 1)), (1 << (top - 1)) - 1
    codes = torch.randint(lo, hi + 1, (K, N), generator=g, device=cuda, dtype=torch.int32)
    edges = torch.tensor([lo, lo + 1, lo + 2, hi - 2, hi - 1, hi], device=cuda,
                         dtype=torch.int32)
    codes[:, ::7] = edges[torch.arange(K, device=cuda) % 6].unsqueeze(1)
    base, deltas = chain_decompose(codes, bits, method="rtn", validate=False)
    widths = (bits[0],) + tuple(b - a + 1 for a, b in zip(bits, bits[1:]))
    words = [pack_blocked(c, w, block, axis=0) for c, w in zip((base, *deltas), widths)]
    scale = torch.rand(1, N, generator=g, device=cuda) + 0.5
    nt = NestedTensor(w_base=words[0], deltas=tuple(words[1:]), scale=scale, bits=bits,
                      shape=(K, N), block=block)
    assert torch.equal(nt.codes_at(len(bits) - 1), codes)
    for dtype in (torch.bfloat16, torch.float32):
        for M in (1, 4):
            _check_decode_rungs(nt, torch.randn(M, K, generator=g, device=cuda).to(dtype))


def test_decode_body_misaligned_stream_views(cuda):
    """Word streams that start 4 or 8 bytes past a 16-byte boundary (views
    into a larger buffer) take narrower loads in the same body."""
    g = torch.Generator(device=cuda).manual_seed(11)
    nt = nest_quantize(torch.randn(1536, 256, generator=g, device=cuda) / 40, bits=(8, 6, 4),
                       rounding="rtn")
    for shift in (1, 2):
        views = []
        for s in (nt.w_base,) + nt.deltas:
            buf = torch.empty(s.numel() + shift, dtype=s.dtype, device=cuda)
            v = buf[shift:].view(s.shape)
            v.copy_(s)
            views.append(v)
        assert views[0].data_ptr() % 16 == 4 * shift
        _check_decode_rungs(nt, torch.randn(5, 1536, generator=g, device=cuda).bfloat16(),
                            streams=views)


def test_stacked_layer_views_stay_aligned(cuda):
    """``NestedTensor.layer(i)`` of a stacked leaf is a view at an offset of
    i layers: at qwen2's widths every such view starts on a 16-byte
    boundary, so the served decode path takes the 16-byte loads."""
    g = torch.Generator(device=cuda).manual_seed(12)
    nt = nest_quantize(torch.randn(3, 1536, 256, generator=g, device=cuda) / 40,
                       bits=(8, 6, 4), rounding="rtn")
    for i in range(3):
        lay = nt.layer(i)
        assert all(s.data_ptr() % 16 == 0 for s in (lay.w_base,) + lay.deltas)
        _check_decode_rungs(lay, torch.randn(2, 1536, generator=g, device=cuda).bfloat16(),
                            rungs=[2])


def test_decode_route_raises_on_what_it_refuses(cuda):
    """A named decode route raises on an activation the decode body does not
    take (f16, a non-contiguous view) and counts nothing, instead of running
    another body; above DEC_MAX_M rows it refuses nothing: it launches the
    decode body once per 8-row group, within tolerance of the plain version."""
    nt = nest_quantize(torch.randn(512, 256, device=cuda), bits=(8, 6, 4), rounding="rtn")
    before = {n: (c.launches, c.dec_launches) for n, c in COUNTERS.items()}
    for x, err in ((torch.randn(4, 512, device=cuda).half(), TypeError),
                   (torch.randn(512, 8, device=cuda).t(), ValueError)):
        for rung in range(3):
            with pytest.raises(err):
                _run_rung(nt, rung, x, route=dispatch.DECODE)
    assert {n: (c.launches, c.dec_launches) for n, c in COUNTERS.items()} == before
    for M, dtype in ((dispatch.DEC_MAX_M + 1, torch.float32), (64, torch.bfloat16)):
        x = torch.randn(M, 512, device=cuda).to(dtype)
        for rung in range(3):
            counter = COUNTERS[("packed_matmul", "nested_matmul", "ladder_matmul")[rung]]
            was = (counter.launches, counter.dec_launches)
            got, _ = _run_rung(nt, rung, x, route=dispatch.DECODE)
            groups = -(-M // dispatch.DEC_MAX_M)
            assert (counter.launches, counter.dec_launches) == (was[0] + groups, was[1] + groups)
            with dispatch.reference_pass():
                want = _run_rung(nt, rung, x)[0]
            err = (got.float() - want.float()).abs().max().item()
            assert err <= TOL[dtype] * max(1.0, want.float().abs().max().item()), (M, rung)


# ---------------------------------------------------------------------------
# K4-K6: the nested KV cache's integer QK^T, long-prefill flash attention and
# the page-in recompose, each against its plain version
# ---------------------------------------------------------------------------
def _kv_streams(x, bits, page):
    """(BH, S, D) values -> resident K streams packed along positions, the
    per-position scale, as the nested KV cache makes them."""
    from repro_torch.core.decompose import chain_decompose
    from repro_torch.core.packing import pack_blocked
    from repro_torch.serving.kv_cache import kv_stream_widths

    hi = 2 ** (bits[-1] - 1) - 1
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / hi
    codes = torch.clamp(torch.round(x / scale), -hi - 1, hi).to(torch.int32)
    base, deltas = chain_decompose(codes, bits, method="rtn", validate=False)
    streams = tuple(pack_blocked(c, w, page, axis=1)
                    for c, w in zip((base, *deltas), kv_stream_widths(bits)))
    return streams, scale


@pytest.mark.parametrize("bits,page", [((4, 6, 8), 16), ((3, 5, 6, 8), 16),
                                       ((4, 6, 8), 4), ((2, 8), 1), ((4, 6, 8), 48)])
def test_nested_qk_kernel_bit_exact_at_every_rung(cuda, bits, page):
    from repro_torch.kernels.nested_attention import ops as qk

    g = torch.Generator(device=cuda).manual_seed(page)
    BH, S, D = 4, 2048 if page == 16 else 96 * page, 128
    streams, _ = _kv_streams(torch.randn(BH, S, D, generator=g, device=cuda), bits, page)
    for M in (6, 48):
        qc, _ = qk.quantize_q(torch.randn(BH, M, D, generator=g, device=cuda), bits[-1])
        for rung in range(len(bits)):
            res = bits[:rung + 1]
            before = qk.COUNTER.launches
            got = qk.ladder_qk_scores(qc, streams[:rung + 1], bits=res, page=page)
            assert qk.COUNTER.launches == before + 1
            with dispatch.reference_pass():
                want = qk.ladder_qk_scores(qc, streams[:rung + 1], bits=res, page=page)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and got.shape == (BH, M, S)
            assert torch.equal(got, want), (bits, page, M, rung)


def test_nested_qk_wraps_like_int32(cuda):
    """Large query codes make the int32 sums wrap; the kernel wraps the
    same way as the plain version (JAX's int32 dot_general)."""
    from repro_torch.kernels.nested_attention import ops as qk

    g = torch.Generator(device=cuda).manual_seed(3)
    streams, _ = _kv_streams(torch.randn(2, 64, 128, generator=g, device=cuda), (8, 16), 16)
    qc = torch.randint(2 ** 20, 2 ** 30, (2, 3, 128), generator=g, device=cuda,
                       dtype=torch.int32)
    got = qk.ladder_qk_scores(qc, streams, bits=(8, 16), page=16)
    with dispatch.reference_pass():
        want = qk.ladder_qk_scores(qc, streams, bits=(8, 16), page=16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [(2, 2048, 12, 2, 128), (2, 1100, 12, 2, 128),
                                           (1, 65, 4, 4, 64), (1, 1, 2, 1, 8),
                                           (1, 300, 8, 2, 40)])
def test_flash_attention_kernel_matches_plain(cuda, B, S, Hq, Hkv, hd, dtype):
    from repro_torch.kernels.flash_attention import ops as fa

    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=cuda).to(dtype)
               for h in (Hq, Hkv, Hkv))
    before = fa.COUNTER.launches
    got = fa.flash_attention(q, k, v)
    assert fa.COUNTER.launches == before + 1
    with dispatch.reference_pass():
        want = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * want.float().abs().max().item(), err
    # every output row against its own norm: a late row's |o| is far below
    # max |o|, so the check above alone cannot see a fault in late rows
    rows = (got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1).clamp_min(1e-30)
    assert rows.max().item() <= TOL[dtype], rows.max().item()


@pytest.mark.parametrize("groups", [1, 6])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S", [1, 63, 65, 1100, 2048])
def test_flash_attention_tensor_core_body_bf16(cuda, S, hd, groups):
    """K5's bf16 body (mma.sync) against the plain version at ragged and
    tile-multiple S, both padded head widths and GQA groups 1 and 6, by
    max |o| and by every output row's own norm."""
    from repro_torch.kernels.flash_attention import ops as fa

    g = torch.Generator(device=cuda).manual_seed(S + hd + groups)
    B, Hkv = 2, 2
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=cuda).bfloat16()
               for h in (Hkv * groups, Hkv, Hkv))
    got = fa.flash_attention(q, k, v)
    with dispatch.reference_pass():
        want = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    tol = TOL[torch.bfloat16]
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err
    rows = (got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1).clamp_min(1e-30)
    assert rows.max().item() <= tol, rows.max().item()


@pytest.mark.parametrize("groups", [1, 6])
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("S,start", [(1, 0), (31, 0), (33, 0), (65, 0), (1100, 0),
                                     (2048, 0), (2048, 1792), (1100, 300)])
def test_flash_attention_f32_body(cuda, S, start, hd, groups):
    """K5's f32 body (CUDA-core FMAs, 64-row query tiles, 32-key K and V
    tiles double-buffered) against the plain blockwise version at ragged
    and tile-multiple S, the padded head widths 64 / 80 / 128, GQA groups 1
    and 6 and query blocks at an offset: within 1e-4 of max |o| and of
    every output row's own norm, its row statistics within 1e-5 of the
    plain forward's, and two launches bit-identical."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.attention import _flash_fwd_inner

    g = torch.Generator(device=cuda).manual_seed(S + start + hd + groups)
    B, Hkv = 2, 2
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=cuda)
               for h in (Hkv * groups, Hkv, Hkv))
    q = q[:, start:].contiguous()
    before = fa.COUNTER.launches
    got = fa.flash_attention(q, k, v, q_offset=start)
    o, m, l = fa.flash_attention_stats(q, k, v, q_offset=start)
    assert fa.COUNTER.launches == before + 2
    with dispatch.reference_pass():
        want = fa.flash_attention(q, k, v, q_offset=start)
    _, want_m, want_l = _flash_fwd_inner(q, k, v, True, S, start)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape and torch.equal(o, got)
    tol = TOL[torch.float32]
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err
    rows = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    assert rows.max().item() <= tol, rows.max().item()
    assert ((m - want_m).abs() / want_m.abs().clamp_min(1.0)).max().item() <= 1e-5
    assert ((l - want_l).abs() / want_l).max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("Skv,start,rows", [(2048, 1792, 256), (2048, 683, 683),
                                            (2048, 1366, 682), (1100, 300, 100),
                                            (2048, 0, 2048)])
def test_flash_attention_offset_block_matches_plain(cuda, Skv, start, rows, hd, dtype):
    """K5 on a block of query rows at an offset into the keys (a
    sequence-parallel rank's rows; blocks of 683, 682 and 100 rows are no
    multiple of the query tile) against its plain version, by max |o| and
    by every row's own norm, with and without its row statistics; the
    block's rows against the whole sequence's launch, the statistics
    against the plain forward's."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.attention import _flash_fwd_inner

    g = torch.Generator(device=cuda).manual_seed(Skv + start + hd)
    B, Hq, Hkv = 2, 12, 2
    q, k, v = (torch.randn(B, Skv, h, hd, generator=g, device=cuda).to(dtype)
               for h in (Hq, Hkv, Hkv))
    qb = q[:, start:start + rows].contiguous()
    before = fa.COUNTER.launches
    got = fa.flash_attention(qb, k, v, q_offset=start)
    o, m, l = fa.flash_attention_stats(qb, k, v, q_offset=start)
    assert fa.COUNTER.launches == before + 2
    with dispatch.reference_pass():
        want = fa.flash_attention(qb, k, v, q_offset=start)
    whole = fa.flash_attention(q, k, v)[:, start:start + rows]
    _, want_m, want_l = _flash_fwd_inner(qb, k, v, True, Skv, start)
    torch.cuda.synchronize()
    assert got.shape == qb.shape and torch.equal(o, got)
    for ref in (want, whole):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= TOL[dtype] * ref.float().abs().max().item(), err
        rel = (got.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1).clamp_min(1e-30)
        assert rel.max().item() <= TOL[dtype], rel.max().item()
    assert ((m - want_m).abs() / want_m.abs().clamp_min(1.0)).max().item() <= 1e-5
    assert ((l - want_l).abs() / want_l).max().item() <= 1e-5
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention(qb, k, v, q_offset=Skv - rows + 1)


@pytest.mark.parametrize("n,h", [(6, 4), (8, 6), (8, 4)])
@pytest.mark.parametrize("K,N", SHAPES + [(1000, 100), (151936, 1536)])
def test_nest_recompose_kernel_bit_exact(cuda, K, N, n, h):
    from repro_torch.kernels.nest_recompose import ops as nr

    g = torch.Generator(device=cuda).manual_seed(K + n)
    block = 256 if K == 8960 else 512
    nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda), bits=(n, h),
                       rounding="rtn", block=block)
    got = nr.nest_recompose(nt.w_base, nt.deltas[0], n=n, h=h, K=K, block_k=block)
    with dispatch.reference_pass():
        want = nr.nest_recompose(nt.w_base, nt.deltas[0], n=n, h=h, K=K, block_k=block)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert torch.equal(got.to(torch.int32), nt.codes_at(1))


def _recompose_words(codes, n, h, block):
    """INT-n codes -> (w_high, w_low) words packed along K with ``block``."""
    from repro_torch.core.decompose import decompose
    from repro_torch.core.packing import pack_blocked

    wh, wl = decompose(codes, n, h, method="adaptive")
    return pack_blocked(wh, h, block, axis=0), pack_blocked(wl, n - h + 1, block, axis=0)


def _check_recompose(codes, wh, wl, n, h, block):
    from repro_torch.kernels.nest_recompose import ops as nr

    K = codes.shape[0]
    before = nr.COUNTER.launches
    got = nr.nest_recompose(wh, wl, n=n, h=h, K=K, block_k=block)
    assert nr.COUNTER.launches == before + 1
    with dispatch.reference_pass():
        want = nr.nest_recompose(wh, wl, n=n, h=h, K=K, block_k=block)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and torch.equal(got, want), (n, h, tuple(codes.shape), block)
    assert torch.equal(got.to(torch.int32), codes), (n, h, tuple(codes.shape), block)


@pytest.mark.parametrize("n,h", [(n, h) for n in range(2, 9) for h in range(1, n)])
def test_nest_recompose_every_pair_block_and_edge_code(cuda, n, h):
    """Every (n, h) K6 takes, at pack blocks 1, 48 (the general path), 256
    and 512 (the fast path), with a ragged K, N = 97 (general) and 64
    (fast), and the range's two ends (-2^(n-1), 2^(n-1) - 1) in every
    column: bit-exact against the plain version and the original codes."""
    g = torch.Generator(device=cuda).manual_seed(16 * n + h)
    lo, hi = -(1 << (n - 1)), (1 << (n - 1)) - 1
    for block in (1, 48, 256, 512):
        for N in (97, 64):
            K = 2 * block + 7 if block > 1 else 37
            codes = torch.randint(lo, hi + 1, (K, N), generator=g, device=cuda, dtype=torch.int32)
            codes[0], codes[1], codes[-1] = lo, hi, lo
            _check_recompose(codes, *_recompose_words(codes, n, h, block), n, h, block)


@pytest.mark.parametrize("block", [48, 512])
def test_nest_recompose_misaligned_and_stacked_views(cuda, block):
    """Word streams that start one word past a 16-byte boundary (views into
    a larger buffer) take the general path; the per-layer views of a
    stacked leaf (the served tree's slices) stay 16-byte aligned, so at a
    pack block that is a multiple of 32 they take the fast one.  All
    bit-exact."""
    g = torch.Generator(device=cuda).manual_seed(block)
    for n, h in ((6, 4), (8, 1)):
        codes = torch.randint(-(1 << (n - 1)), 1 << (n - 1), (3 * block + 5, 256), generator=g,
                              device=cuda, dtype=torch.int32)
        views = []
        for w in _recompose_words(codes, n, h, block):
            buf = torch.empty(w.numel() + 1, dtype=w.dtype, device=cuda)
            v = buf[1:].view(w.shape)
            v.copy_(w)
            views.append(v)
        assert views[0].data_ptr() % 16 == 4
        _check_recompose(codes, *views, n, h, block)
    nt = nest_quantize(torch.randn(3, 1536, 256, generator=g, device=cuda), bits=(8, 6, 4),
                       rounding="rtn", block=block)
    for i in range(3):
        lay = nt.layer(i)
        assert lay.w_base.data_ptr() % 16 == 0 and lay.deltas[0].data_ptr() % 16 == 0
        _check_recompose(lay.codes_at(1), lay.w_base, lay.deltas[0], 6, 4, block)


def test_nest_recompose_two_launches_identical(cuda):
    from repro_torch.kernels.nest_recompose import ops as nr

    g = torch.Generator(device=cuda).manual_seed(7)
    for block in (512, 48):
        nt = nest_quantize(torch.randn(1536, 8960, generator=g, device=cuda), bits=(6, 4),
                           rounding="rtn", block=block)
        a = nr.nest_recompose(nt.w_base, nt.deltas[0], n=6, h=4, K=1536, block_k=block)
        b = nr.nest_recompose(nt.w_base, nt.deltas[0], n=6, h=4, K=1536, block_k=block)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def _check_qk(qc, streams, bits, page):
    from repro_torch.kernels.nested_attention import ops as qk

    before = qk.COUNTER.launches
    got = qk.ladder_qk_scores(qc, streams, bits=bits, page=page)
    assert qk.COUNTER.launches == before + 1
    with dispatch.reference_pass():
        want = qk.ladder_qk_scores(qc, streams, bits=bits, page=page)
    torch.cuda.synchronize()
    BH, M, _ = qc.shape
    assert got.dtype == torch.int32 and got.shape == want.shape and got.shape[:2] == (BH, M)
    assert torch.equal(got, want), (tuple(qc.shape), bits, page)
    return got


@pytest.mark.parametrize("page", [1, 4, 5, 16, 48])
@pytest.mark.parametrize("D", [40, 128, 256])
def test_nested_qk_tensor_core_path(cuda, D, page):
    """Every resident bitwidth <= 8 and query codes in int8 range: the
    int8 tensor-core path, at head widths 40 (padded to the 32-deep step),
    128 and 256, 1 to 65 query rows (ragged 16-row tiles; 65 takes a second
    64-row chunk) and pages of 1 to 48 positions, at every rung."""
    from repro_torch.kernels.nested_attention import ops as qk

    g = torch.Generator(device=cuda).manual_seed(D + page)
    bits = (4, 6, 8)
    streams, _ = _kv_streams(torch.randn(3, 37 * page, D, generator=g, device=cuda), bits, page)
    for M in (1, 6, 17, 48, 65):
        qc, _ = qk.quantize_q(torch.randn(3, M, D, generator=g, device=cuda), bits[-1])
        for rung in range(3):
            _check_qk(qc, streams[:rung + 1], bits[:rung + 1], page)


@pytest.mark.parametrize("bits,page", [((8, 16), 16), ((4, 10, 12), 5), ((3, 9), 100)])
def test_nested_qk_cuda_core_path_wide_codes(cuda, bits, page):
    """Codes over 8 bits (and page 100, above the staged 64 positions)
    take the CUDA-core path at every rung."""
    from repro_torch.kernels.nested_attention import ops as qk

    g = torch.Generator(device=cuda).manual_seed(page)
    streams, _ = _kv_streams(torch.randn(2, 7 * page, 128, generator=g, device=cuda), bits, page)
    for M in (6, 48):
        qc, _ = qk.quantize_q(torch.randn(2, M, 128, generator=g, device=cuda), bits[-1])
        for rung in range(len(bits)):
            _check_qk(qc, streams[:rung + 1], bits[:rung + 1], page)


def test_nested_qk_out_of_range_queries_and_mixed_paths(cuda):
    """Query codes outside [-128, 127] take the CUDA-core path, with the
    int32 wrap-around; in one launch the bh whose queries fit take the
    tensor cores and the others the CUDA cores.  Two launches give
    identical outputs."""
    from repro_torch.kernels.nested_attention import ops as qk

    g = torch.Generator(device=cuda).manual_seed(5)
    bits = (4, 6, 8)
    streams, _ = _kv_streams(torch.randn(4, 2048, 128, generator=g, device=cuda), bits, 16)
    qc, _ = qk.quantize_q(torch.randn(4, 6, 128, generator=g, device=cuda), 8)
    wide = torch.randint(2 ** 20, 2 ** 30, (4, 6, 128), generator=g, device=cuda,
                         dtype=torch.int32)
    mixed = qc.clone()
    mixed[1, 2, 5] = 300
    mixed[3, 0, 0] = -129
    for q in (qc * 256, wide, mixed):
        for rung in range(3):
            a = _check_qk(q, streams[:rung + 1], bits[:rung + 1], 16)
            b = qk.ladder_qk_scores(q, streams[:rung + 1], bits=bits[:rung + 1], page=16)
            torch.cuda.synchronize()
            assert torch.equal(a, b)


def test_nested_qk_misaligned_views_and_odd_head_width(cuda):
    """Streams and queries that start one word past a 16-byte boundary, and
    D = 33 (no multiple of 4), take the 4-byte staging copies."""
    from repro_torch.kernels.nested_attention import ops as qk

    g = torch.Generator(device=cuda).manual_seed(33)
    bits = (4, 6, 8)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    for D in (128, 33):
        streams, _ = _kv_streams(torch.randn(2, 64, D, generator=g, device=cuda), bits, 16)
        qc, _ = qk.quantize_q(torch.randn(2, 6, D, generator=g, device=cuda), 8)
        views = [shifted(s) for s in streams]
        assert views[0].data_ptr() % 16 == 4
        for rung in range(3):
            _check_qk(shifted(qc), views[:rung + 1], bits[:rung + 1], 16)


def test_new_kernel_routes_raise_instead_of_falling_back(cuda):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.nest_recompose import ops as nr
    from repro_torch.kernels.nested_attention import ops as qk

    q = torch.randn(1, 64, 4, 136, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    h16 = torch.randn(1, 64, 4, 64, device=cuda).half()
    with pytest.raises(TypeError):
        fa.flash_attention(h16, h16, h16)
    streams, _ = _kv_streams(torch.randn(2, 32, 16, device=cuda), (4, 6, 8), 16)
    qc = torch.zeros(2, 3, 16, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        qk.ladder_qk_scores(qc.float(), streams, bits=(4, 6, 8), page=16)
    with pytest.raises(ValueError):
        qk.ladder_qk_scores(qc, streams + streams[1:], bits=(4, 6, 8, 10, 12), page=16)
    nt = nest_quantize(torch.randn(512, 64, device=cuda), bits=(8, 4), rounding="rtn")
    with pytest.raises(ValueError):
        nr.nest_recompose(nt.w_base, nt.deltas[0], n=9, h=4, K=512, block_k=nt.block)


# ---------------------------------------------------------------------------
# storage and warm-up on the card
# ---------------------------------------------------------------------------
def test_file_pager_fetches_land_on_the_card_bit_exact(cuda, tmp_path):
    """Every FilePager fetch lands on the card equal to the in-memory
    pager's stream, and a store booted from the artifact climbs to the
    same packed tree."""
    from repro_torch.core.switching import NestQuantStore
    from repro_torch.storage import FilePager, InMemoryPager, load_store, save_artifact

    g = torch.Generator(device=cuda).manual_seed(11)
    tree = {"blocks": {"q": nest_quantize(torch.randn(3, 1536, 1536, generator=g,
                                                      device=cuda) / 40, bits=(8, 6, 4))},
            "head": nest_quantize(torch.randn(1536, 256, generator=g, device=cuda) / 40,
                                  bits=(8, 6, 4)),
            "norm": torch.randn(1536, generator=g, device=cuda).to(torch.bfloat16)}
    save_artifact(tree, str(tmp_path / "art"))
    mem = InMemoryPager.from_tree(tree)
    fp = FilePager(str(tmp_path / "art"), device="cuda")
    for (path, lvl), host in mem._streams.items():
        got = fp.fetch(path, lvl)
        assert got.is_cuda and torch.equal(got, mem.fetch(path, lvl))
        assert torch.equal(got.cpu(), host.cpu())
    store = load_store(str(tmp_path / "art"), device="cuda").to_rung(2)
    want = NestQuantStore(tree, mode="full", device="cuda")
    for (p, a), (q, b) in zip(store.nested_leaves(), want.nested_leaves()):
        assert p == q and torch.equal(a.w_base, b.w_base) and torch.equal(a.scale, b.scale)
        assert all(torch.equal(x, y) for x, y in zip(a.deltas, b.deltas))
    assert torch.equal(store.nested_params["norm"], tree["norm"])


def test_warmup_then_serve_builds_nothing_and_keeps_the_counters(cuda):
    """After ``warmup`` a generate at every rung loads no kernel library,
    fills no decode-body or short-prefill plan and keeps the arrival
    counters' buffer, with every packed_linear on a kernel (2 layers of
    qwen2-1.5b at full width; the 32-row prefill on the short-prefill
    body)."""
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import QuantRecipe, quantize
    from repro_torch.core.switching import NestQuantStore
    from repro_torch.kernels import build
    from repro_torch.models.model import init_params
    from repro_torch.serving import Request, ServeEngine

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2)
    store = NestQuantStore(quantize(init_params(cfg, seed=0, device=cuda),
                                    QuantRecipe(bits=(8, 6, 4)), device=cuda),
                           mode="part", device=cuda)
    engine = ServeEngine(cfg, store, max_batch=4, max_len=32)
    assert engine.warmup(8, batch=4) == 6
    key = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    libs, plans = sorted(build._libs), (dict(build._dec_plans), dict(build._mid_plans))
    buf = build._dec_counters[key]
    ptr, numel = buf.data_ptr(), buf.numel()
    need = [store.rung_resident_bytes(r) for r in range(3)]
    dispatch.reset_counters()
    for rung in (0, 1, 2, 1):
        budget = need[-1] * 2 if rung == 2 else need[rung]
        reqs = [Request(i, torch.arange(8, dtype=torch.int32).numpy() + i, max_new_tokens=4)
                for i in range(4)]
        engine.generate(reqs, memory_budget_bytes=budget)
        torch.cuda.synchronize()
        assert store.rung == rung
        assert sorted(build._libs) == libs
        assert (build._dec_plans, build._mid_plans) == plans
        assert build._dec_counters[key] is buf
        assert (buf.data_ptr(), buf.numel()) == (ptr, numel)
    assert all(c.plain_launches == 0 for c in dispatch.COUNTERS.values())
    assert all(dispatch.counter(n).launches > 0 and dispatch.counter(n).mid_launches > 0
               for n in ("packed_matmul", "nested_matmul", "ladder_matmul"))


# ---------------------------------------------------------------------------
# the decode route in row groups (the speculative verify pass)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", [(1536, 256), (8960, 1536), (1536, 151936)])
@pytest.mark.parametrize("rung", [0, 1, 2])
def test_decode_rows_route_rows_do_not_depend_on_m(cuda, rung, K, N, dtype):
    """Rows of a decode-route launch at M = 12 and 20 (batch 4, k = 2 and
    4) equal bit for bit the same rows of M = 4 and M = 1 decode launches:
    one decode-body launch per group of <= 8 rows, none on another body."""
    g = torch.Generator(device=cuda).manual_seed(K + N + rung)
    nt = nest_quantize(torch.randn(K, N, generator=g, device=cuda) / math.sqrt(K),
                       bits=(8, 6, 4), rounding="rtn")
    out_dtype = torch.float32 if N == 151936 else dtype
    x = torch.randn(20, K, generator=g, device=cuda).to(dtype)
    one = torch.cat([_run_rung(nt, rung, x[i:i + 1].contiguous(), out_dtype=out_dtype)[0]
                     for i in range(20)])
    four = torch.cat([_run_rung(nt, rung, x[i:i + 4].contiguous(), out_dtype=out_dtype)[0]
                      for i in range(0, 20, 4)])
    for M in (12, 20):
        counter = COUNTERS[("packed_matmul", "nested_matmul", "ladder_matmul")[rung]]
        before = (counter.launches, counter.dec_launches, counter.tc_launches)
        got, _ = _run_rung(nt, rung, x[:M], route=dispatch.DECODE, out_dtype=out_dtype)
        groups = -(-M // dispatch.DEC_MAX_M)
        assert (counter.launches, counter.dec_launches, counter.tc_launches) == \
            (before[0] + groups, before[1] + groups, before[2])
        torch.cuda.synchronize()
        assert torch.equal(got, one[:M]), (rung, K, N, dtype, M, "M = 1 rows")
        assert torch.equal(got, four[:M]), (rung, K, N, dtype, M, "M = 4 rows")


@pytest.mark.parametrize("bits,K,N,block", [
    ((8,), 1536, 1536, 512), ((4, 6), 1536, 256, 512), ((4, 6, 8), 8960, 1536, 512),
    ((4, 6, 8), 1536, 151936, 512), ((2, 5, 9, 16), 1000, 192, 64)])
def test_decode_plan_does_not_depend_on_m(cuda, bits, K, N, block):
    """The decode body's plan (partial floats per row, column tiles) is the
    same at every M from 1 to 8, and the wrapper's cache keys it without M."""
    import ctypes

    from repro_torch.kernels import build

    lib = build.library("nest_matmul.cu")
    arr = (ctypes.c_int * len(bits))(*bits)
    plans = set()
    for M in range(1, dispatch.DEC_MAX_M + 1):
        tiles = ctypes.c_int(0)
        n = lib.nq_dec_workspace(ctypes.addressof(arr), len(bits), M, N, K, block,
                                 ctypes.byref(tiles))
        plans.add((n, tiles.value))
    assert len(plans) == 1 and next(iter(plans))[0] > 0, plans
    assert build.dec_plan(cuda, bits, N, K, block) == next(iter(plans))


def _spec_engine(cuda, dtype, num_layers=2):
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import QuantRecipe, quantize
    from repro_torch.core.switching import NestQuantStore
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServeEngine, StaticRungPolicy

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=num_layers,
                              compute_dtype=dtype)
    store = NestQuantStore(quantize(init_params(cfg, seed=0, device=cuda),
                                    QuantRecipe(bits=(8, 6, 4)), device=cuda),
                           mode="full", device=cuda)
    return ServeEngine(cfg, store, max_batch=4, max_len=48, policy=StaticRungPolicy(-1))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_speculative_tokens_identical_to_plain_greedy_on_the_card(cuda, dtype):
    """Two layers of qwen2-1.5b at full width, rung 2: speculative decoding
    with drafts at rungs 0 and 1 emits the plain greedy tokens, every
    K1-K3 launch on the decode body and no plain version."""
    import numpy as np

    from repro_torch.serving import Request, SpecConfig

    engine = _spec_engine(cuda, dtype)

    def reqs():
        rng = np.random.default_rng(7)
        return [Request(i, rng.integers(0, engine.cfg.vocab_size, 8).astype(np.int32),
                        max_new_tokens=12) for i in range(4)]
    plain = [r.out_tokens for r in engine.generate(reqs())]
    for spec in (SpecConfig(k=4, draft=0), SpecConfig(k=2, draft=1)):
        dispatch.reset_counters()
        out = [r.out_tokens for r in engine.generate(reqs(), speculate=spec)]
        assert out == plain, (dtype, spec)
        p = engine.last_profile
        assert p.speculative and p.draft_steps == spec.k * p.verify_passes
        cs = [dispatch.counter(n) for n in ("packed_matmul", "nested_matmul",
                                            "ladder_matmul")]
        assert all(c.plain_launches == 0 for c in dispatch.COUNTERS.values())
        # the prefill (32 rows) takes the CUDA-core body, its LM head (4 rows)
        # and every draft step the decode body, each verify pass the decode
        # body once per group of 8 of its 4 * (k + 1) rows
        per_forward = 2 * 7 + 1
        groups = -(-4 * (spec.k + 1) // dispatch.DEC_MAX_M)
        assert sum(c.launches - c.dec_launches for c in cs) == per_forward - 1
        assert cs[spec.draft].launches == cs[spec.draft].dec_launches == \
            per_forward * p.draft_steps
        assert cs[2].launches == per_forward * (1 + groups * p.verify_passes)


def test_chaos_corruption_on_the_card_is_caught_and_rolled_back(cuda):
    """A ChaosPager flips a bit of a copy on the card: the ResilientPager's
    CRC catches it, a switch that cannot heal rolls back leaving every
    resident stream and the ledger as they were, and a retry heals."""
    from repro_torch.core.switching import NestQuantStore
    from repro_torch.storage import (ChaosPager, CorruptStreamError, InMemoryPager,
                                     ResilientPager, RetryPolicy)

    g = torch.Generator(device=cuda).manual_seed(3)
    tree = {"a": {"w": nest_quantize(torch.randn(1536, 256, generator=g, device=cuda),
                                     bits=(8, 6, 4))},
            "b": {"w": nest_quantize(torch.randn(512, 1536, generator=g, device=cuda),
                                     bits=(8, 6, 4))}}
    inner = InMemoryPager.from_tree(tree)
    path, level = next(iter(inner._streams))
    pristine = inner.fetch(path, level).clone()
    chaos = ChaosPager(inner, seed=0, p_corrupt=1.0)
    bad = chaos.fetch(path, level)
    assert bad.is_cuda and not torch.equal(bad, pristine)
    flips = torch.bitwise_xor(bad, pristine).reshape(-1).view(torch.uint8).cpu()
    assert int(sum(bin(int(b)).count("1") for b in flips.tolist())) == 1
    assert torch.equal(inner.fetch(path, level), pristine)

    def snapshot(store):
        return [(p, leaf.w_base.clone(), tuple(d.clone() for d in leaf.deltas if d is not None))
                for p, leaf in store.nested_leaves()]

    store = NestQuantStore(tree, mode="part", device=cuda, pager=ResilientPager(
        ChaosPager(InMemoryPager.from_tree(tree), seed=0, p_corrupt=1.0),
        RetryPolicy(max_attempts=2, backoff_base_s=0.0, quarantine_after=10 ** 6)))
    pre, events = snapshot(store), list(store.ledger.events)
    with pytest.raises(CorruptStreamError, match="CRC-32"):
        store.to_rung(2)
    assert store.rung == 0 and store.ledger.events == events
    for (p, w, ds), (q, w2, ds2) in zip(pre, snapshot(store)):
        assert p == q and torch.equal(w, w2) and len(ds) == len(ds2) == 0
    healing = ResilientPager(ChaosPager(InMemoryPager.from_tree(tree), seed=0, p_corrupt=0.5),
                             RetryPolicy(max_attempts=8, backoff_base_s=0.0,
                                         quarantine_after=10 ** 6))
    store = NestQuantStore(tree, mode="part", device=cuda, pager=healing).to_rung(2)
    assert sum(h.corrupt for h in healing.health.values()) > 0
    want = NestQuantStore(tree, mode="full", device=cuda)
    for (p, a), (q, b) in zip(store.nested_leaves(), want.nested_leaves()):
        assert p == q and all(torch.equal(x, y) for x, y in zip(a.deltas, b.deltas))


# ---------------------------------------------------------------------------
# the decode body on two streams at once; a fleet of replicas on the card
# ---------------------------------------------------------------------------
def test_decode_counters_are_per_stream_and_two_streams_agree(cuda):
    """Two CUDA streams launch decode-body K3 matmuls (rung 2, M = 4, the
    gate/up and LM-head shapes) at once, interleaved so that they overlap:
    each stream's outputs equal bit for bit the same calls made one after
    another on one stream, and the two streams count their CTAs' arrivals
    in two different buffers."""
    from repro_torch.kernels import build

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(19)
    nts = [(nest_quantize(torch.randn(K, N, generator=g, device=dev) / math.sqrt(K),
                          bits=(8, 6, 4), rounding="rtn"),
            torch.float32 if N == 151936 else torch.bfloat16)
           for K, N in ((1536, 8960), (1536, 151936))]
    calls = [(nts[(i // 2) % 2], torch.randn(4, 1536, generator=g, device=dev)
              .to(torch.bfloat16)) for i in range(16)]
    want = [_run_rung(nt, 2, x, out_dtype=odt)[0] for (nt, odt), x in calls]
    torch.cuda.synchronize()
    main = torch.cuda.current_stream()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(main)
    before = nops.LADDER_COUNTER.dec_launches
    got = []
    for i, ((nt, odt), x) in enumerate(calls):
        with torch.cuda.stream(streams[i % 2]):
            got.append(_run_rung(nt, 2, x, out_dtype=odt)[0])
    for s in streams:
        main.wait_stream(s)
    torch.cuda.synchronize()
    assert nops.LADDER_COUNTER.dec_launches == before + len(calls)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (i, (a.float() - b.float()).abs().max().item())
    bufs = []
    for s in streams:
        with torch.cuda.stream(s):
            bufs.append(build.dec_counters(dev, 1))
    assert bufs[0] is not bufs[1] and bufs[0].data_ptr() != bufs[1].data_ptr()
    assert all(int(b.abs().sum()) == 0 for b in bufs)


def test_two_replica_fleet_on_the_card_matches_the_cpu(cuda):
    """A 2-replica fleet of the reduced qwen2-1.5b on the card (chaos on
    replica 0, the rebalancing controller): its report equals the same
    fleet's on the CPU, every K1-K3 launch ran a kernel, and no replica's
    paging changed the shared tree's streams."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core.nesting import NestedTensor
    from repro_torch.core.recipe import QuantRecipe, quantize
    from repro_torch.fleet import ChaosProfile, FleetController, ReplicaSpec, build_fleet
    from repro_torch.models.model import init_params

    cfg = get_config("qwen2-1.5b").reduced()
    host = quantize(init_params(cfg, seed=0, device="cpu"), QuantRecipe(bits=(8, 6, 4)),
                    device="cpu")
    card = tree.map_with_path(lambda _, x: x.to(cuda), host)
    snap = [(p, x.w_base.clone(), [d.clone() for d in x.deltas]) if isinstance(x, NestedTensor)
            else (p, x.clone(), None) for p, x in tree.flatten_with_path(card)]
    specs = [ReplicaSpec(name=f"replica{i}", link_mbps=(100.0, 25.0)[i],
                         trace=("burst", "poisson")[i], n_requests=12, seed=i,
                         policy="failure", max_batch=4, new_tokens=2,
                         chaos=ChaosProfile(seed=i) if i == 0 else None) for i in range(2)]
    reports = []
    dispatch.reset_counters()
    for nested, device in ((card, cuda), (host, "cpu")):
        fleet = build_fleet(specs, cfg=cfg, nested_params=nested, device=device)
        top = fleet.replicas[0].store.rung_resident_bytes(2)
        fleet.controller = FleetController(int(1.5 * 2 * top), interval_s=0.002)
        reports.append(fleet.run())
        if device is cuda:
            torch.cuda.synchronize()
            launches = {n: dispatch.counter(n).launches
                        for n in ("packed_matmul", "nested_matmul", "ladder_matmul")}
            assert sum(launches.values()) > 0 and launches["packed_matmul"] > 0
            assert all(c.plain_launches == 0 for c in dispatch.COUNTERS.values())
    assert reports[0].to_dict() == reports[1].to_dict()
    assert reports[0].verify_ledgers() > 0
    assert all(len(r.requests) == 12 for r in reports[0].replicas.values())
    for (p, base, deltas), (q, leaf) in zip(snap, tree.flatten_with_path(card)):
        assert p == q
        if deltas is None:
            assert torch.equal(leaf, base), p
        else:
            assert torch.equal(leaf.w_base, base) and len(leaf.deltas) == len(deltas)
            assert all(d is not None and torch.equal(d, e) for d, e in zip(leaf.deltas, deltas))


# ---------------------------------------------------------------------------
# MoE: expert groups at dbrx-132b's full widths, expert views of a stacked
# (L, E, K, N) leaf, and the reduced MoE model's verify rows
# ---------------------------------------------------------------------------
# (K, N) of dbrx-132b's expert gate/up and down
MOE_EXPERT_SHAPES = [(6144, 10752), (10752, 6144)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", MOE_EXPERT_SHAPES)
def test_expert_groups_match_plain_on_each_route(cuda, K, N, dtype):
    """An expert's 2-D view of a stacked leaf through ``packed_linear`` at M
    1, 5, 8, 12, 40 and 130 (the decode body; at 12 and 40 the short-prefill
    body in bf16 and the CUDA cores in f32; for bf16 at 130 the tensor
    cores: the body M picks, counted there) within 2e-2 (bf16) or 1e-4
    (f32) of max(1, max |y|) of the plain version at every rung."""
    from repro_torch.models.layers import packed_linear

    g = torch.Generator(device=cuda).manual_seed(K + 3)
    stack = nest_quantize(torch.randn(2, K, N, generator=g, device=cuda) / math.sqrt(K),
                          bits=(8, 6, 4), rounding="rtn")
    view = stack.layer(1)
    for M in (1, 5, 8, 12, 40, 130):
        x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
        route = dispatch.matmul_route(M, dtype, cuda)
        for rung in range(3):
            nt = view.with_rung(rung)
            counter = COUNTERS[("packed_matmul", "nested_matmul", "ladder_matmul")[rung]]
            seen = lambda: (counter.launches, counter.dec_launches,  # noqa: E731
                            counter.tc_launches, counter.mid_launches)
            before = seen()
            got = packed_linear(x, nt)
            assert seen() == (
                before[0] + 1, before[1] + (route == dispatch.DECODE),
                before[2] + (route == dispatch.TENSOR_CORE),
                before[3] + (route == dispatch.MID)), (M, rung, route)
            with dispatch.reference_pass():
                want = packed_linear(x, nt)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            peak = want.float().abs().max().item()
            assert err <= TOL[dtype] * max(1.0, peak), (M, rung, route, err, peak)


@pytest.mark.parametrize("K,N", MOE_EXPERT_SHAPES)
def test_expert_views_of_a_full_width_stack_stay_aligned(cuda, K, N):
    """Every expert view of a (2, 16, K, N) stack (``NestedTensor.layer``
    twice) starts on a 16-byte boundary and launches the decode body at
    rung 2 without a misalignment error, within 2e-2 of the plain version."""
    from repro_torch.models.layers import packed_linear

    g = torch.Generator(device=cuda).manual_seed(N)
    w = torch.randn(2, 16, K, N, generator=g, device=cuda, dtype=torch.bfloat16)
    stack = nest_quantize(w, bits=(8, 6, 4), rounding="rtn")
    del w
    x = torch.randn(2, K, generator=g, device=cuda).bfloat16() / math.sqrt(K)
    for layer in range(2):
        for e in range(16):
            view = stack.layer(layer).layer(e)
            assert all(s.data_ptr() % 16 == 0 for s in (view.w_base,) + view.deltas)
            got = packed_linear(x, view, route=dispatch.DECODE)
            with dispatch.reference_pass():
                want = packed_linear(x, view)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= TOL[torch.bfloat16] * max(1.0, want.float().abs().max().item())


def test_moe_decode_chunk_rows_equal_decode_steps_bit_for_bit(cuda):
    """The reduced dbrx-132b in bf16 at rung 2 on the card: one decode_chunk
    over 5 positions equals 5 decode steps bit for bit (logits and cache),
    its expert groups on the decode body and nothing plain; two runs of a
    layer's MoE FFN give identical bytes."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.nesting import set_tree_rung
    from repro_torch.core.recipe import QuantRecipe, quantize
    from repro_torch.models import moe
    from repro_torch.models.model import init_params, layer_params, make_model

    cfg = dataclasses.replace(get_config("dbrx-132b").reduced(), dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = set_tree_rung(quantize(init_params(cfg, seed=0, device=cuda),
                                    QuantRecipe(bits=(8, 6, 4), rounding="rtn"),
                                    device=cuda), 2)
    model = make_model(cfg, device=cuda)
    rng = np.random.default_rng(5)
    B = 4
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 6))).to(cuda)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 5))).to(cuda)
    _, c = model.prefill(params, {"tokens": prompt})
    seq = model.make_cache(B, 16)
    seq["k"][:, :, :6], seq["v"][:, :, :6], seq["pos"] = c["k"], c["v"], 6
    par = {k: v.clone() if torch.is_tensor(v) else v for k, v in seq.items()}
    dispatch.reset_counters()
    with moe.record_groups() as log:
        got, par = model.decode_chunk(params, {"tokens": chunk}, par)
    ladder = dispatch.counter("ladder_matmul")
    assert ladder.launches == ladder.dec_launches > 0
    assert all(c.plain_launches == 0 for c in dispatch.COUNTERS.values())
    assert [g.route for g in log] == [dispatch.DECODE] * cfg.num_layers
    want = torch.cat([model.decode_step(params, {"tokens": chunk[:, j:j + 1]}, seq)[0]
                      for j in range(5)], dim=1)
    assert torch.equal(got, want)
    assert torch.equal(par["k"], seq["k"]) and torch.equal(par["v"], seq["v"])
    lp = layer_params(params["blocks"], 1)["moe"]
    x = torch.randn(B, 5, cfg.d_model, device=cuda).bfloat16()
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k, capacity_factor=1.0,
              act=cfg.act, dropless=True, route=dispatch.DECODE)
    a, _ = moe.moe_ffn(x, lp, **kw)
    b, _ = moe.moe_ffn(x, lp, **kw)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_decode_instantiation_rows_are_the_library_s(cuda):
    """The rows ``dispatch.dec_rows`` records for an M-row decode-body launch
    (in ``DEC_INSTANCES``, which the warm-up checks read) are those of the
    instantiation the library launches (``nq_dec_rows``, its ``dec_mb``), at
    every M the decode body takes; the library refuses an M above it."""
    from repro_torch.kernels import build

    lib = build.library("nest_matmul.cu")
    Ms = range(1, dispatch.DEC_MAX_M + 1)
    assert [dispatch.dec_rows(M) for M in Ms] == [lib.nq_dec_rows(M) for M in Ms]
    assert {lib.nq_dec_rows(M) for M in Ms} == set(dispatch.DEC_ROWS)
    assert lib.nq_dec_rows(0) == lib.nq_dec_rows(dispatch.DEC_MAX_M + 1) == -1


def test_moe_warmup_then_serve_makes_no_first_decode_launch(cuda):
    """After ``warmup`` a reduced-dbrx serve (bf16) at every rung, with 1 to
    4 requests, launches no decode-body instantiation (streams, rows) that
    warm-up did not: warm-up launches the decode route at every row count
    of the instantiations on an expert view, where an expert group's rows
    depend on the routing.  It loads no library and fills no plan either."""
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import QuantRecipe, quantize
    from repro_torch.core.switching import NestQuantStore
    from repro_torch.kernels import build
    from repro_torch.models.model import init_params
    from repro_torch.serving import Request, ServeEngine

    cfg = dataclasses.replace(get_config("dbrx-132b").reduced(), dtype="bfloat16",
                              compute_dtype="bfloat16")
    store = NestQuantStore(quantize(init_params(cfg, seed=0, device=cuda),
                                    QuantRecipe(bits=(8, 6, 4), rounding="rtn"), device=cuda),
                           mode="part", device=cuda)
    engine = ServeEngine(cfg, store, max_batch=4, max_len=32)
    dispatch.DEC_INSTANCES.clear()
    engine.warmup(8, batch=4)
    warmed = set(dispatch.DEC_INSTANCES)
    assert {(s, r) for s in (1, 2, 3) for r in dispatch.DEC_ROWS} <= warmed
    libs, plans = sorted(build._libs), dict(build._dec_plans)
    need = [store.rung_resident_bytes(r) for r in range(3)]
    for rung in (0, 1, 2, 1):
        budget = need[-1] * 2 if rung == 2 else need[rung]
        for n in (1, 3, 4):
            reqs = [Request(i, torch.arange(8, dtype=torch.int32).numpy() * (i + 1) + rung,
                            max_new_tokens=4) for i in range(n)]
            engine.generate(reqs, memory_budget_bytes=budget)
            assert store.rung == rung
            assert dispatch.DEC_INSTANCES == warmed, (rung, n)
    assert sorted(build._libs) == libs and build._dec_plans == plans


# ---------------------------------------------------------------------------
# training: K5 with its row statistics, the blockwise backward, a train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [(2, 2048, 12, 2, 128), (2, 1100, 12, 2, 128),
                                           (1, 65, 4, 4, 64), (1, 300, 8, 2, 40)])
def test_flash_attention_stats_match_plain_forward(cuda, B, S, Hq, Hkv, hd, dtype):
    """K5 with statistics: o as without them (bit for bit) and within the
    K5 limits of the plain forward; each row's running max m and
    denominator l within 1e-5 of the plain forward's (m against max(1,
    |m|), l relative)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.attention import _flash_fwd_inner

    g = torch.Generator(device=cuda).manual_seed(S + 1)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=cuda).to(dtype)
               for h in (Hq, Hkv, Hkv))
    before = fa.COUNTER.launches
    o, m, l = fa.flash_attention_stats(q, k, v)
    assert fa.COUNTER.launches == before + 1
    assert torch.equal(o, fa.flash_attention(q, k, v))
    want_o, want_m, want_l = _flash_fwd_inner(q, k, v, True, S)
    torch.cuda.synchronize()
    assert m.shape == want_m.shape == (B, Hkv, Hq // Hkv, S) and l.dtype == torch.float32
    err = (o.float() - want_o.float()).abs().max().item()
    assert err <= TOL[dtype] * want_o.float().abs().max().item(), err
    assert ((m - want_m).abs() / want_m.abs().clamp_min(1.0)).max().item() <= 1e-5
    assert ((l - want_l).abs() / want_l).max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,kv_block", [(1024, 256), (1100, 256)])
def test_blockwise_attention_grads_with_k5_match_plain(cuda, S, kv_block, dtype):
    """The differentiable blockwise attention on the card (K5 forward with
    statistics, the blockwise backward) against the same Function on the
    plain path, and, at a ragged S, the plain path's own gradient (direct
    attention's).  Gradients within 1e-4 (f32) / 2e-2 (bf16) of each
    input's max |g|."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.attention import blockwise_attention

    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(2, S, h, 64, generator=g, device=cuda).to(dtype)
               for h in (6, 2, 2))
    do = torch.randn(2, S, 6, 64, generator=g, device=cuda).to(dtype)

    def grads():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = blockwise_attention(*leaves, True, kv_block)
        return torch.autograd.grad(out, leaves, do)

    before = fa.COUNTER.launches
    got = grads()
    assert fa.COUNTER.launches == before + 1
    with dispatch.reference_pass():
        want = grads()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item(), err


def test_train_step_gives_every_leaf_a_gradient(cuda):
    """One train step of the reduced qwen2 at 2 x 1100 tokens in bf16 on the
    card (K5 in the forward and the remat recompute): every leaf gets a
    nonzero gradient, the loss is finite and every parameter moves."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import make_model
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), dtype="bfloat16",
                              compute_dtype="bfloat16", remat=True)
    model = make_model(cfg, device=cuda)
    params = model.init(0)
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 1101), generator=g, device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    flat = tree.flatten_with_path(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    before = fa.COUNTER.launches
    loss = model.loss_fn(tree.unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    assert fa.COUNTER.launches == before + 2 * cfg.num_layers
    assert math.isfinite(loss.item())
    for (key, _), gr in zip(flat, grads):
        assert bool((gr != 0).any()), key
    step = make_train_step(model, peak_lr=1e-3, warmup=0, total=10)
    new, _, metrics = step(params, adamw.init_state(params), batch, 1)
    assert math.isfinite(metrics["loss"].item())
    for (key, a), b in zip(flat, tree.leaves(new)):
        assert not torch.equal(a, b), key


def test_train_step_gradients_repeat_bit_for_bit(cuda):
    """Full-width qwen2-1.5b cut to 2 layers, 2 x 2048 tokens, bf16: three
    identical gradient computations agree leaf for leaf, bit for bit,
    without ``torch.use_deterministic_algorithms`` (the train CLI turns it
    on as well)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import to_device
    from repro_torch.models import make_model

    assert not torch.are_deterministic_algorithms_enabled()
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2)
    model = make_model(cfg, device=cuda)
    params = model.init(0)
    batch = to_device(SyntheticLM(DataConfig(cfg.vocab_size, 2048, 2)).batch(0), cuda)

    def grads():
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss = model.loss_fn(tree.unflatten(params, leaves), batch)
        return torch.autograd.grad(loss, leaves)

    first = grads()
    for _ in range(2):
        assert all(torch.equal(a, b) for a, b in zip(first, grads()))


def test_sharded_nested_decode_on_two_ranks_sharing_the_card(cuda, tmp_path):
    """The reduced qwen2-1.5b's (4, 8) rtn tree served by the sharded
    prefill and decode steps on a (1, 2) mesh: a gloo world of two rank
    processes on the one card (``tests/torch_dist.py``), at rungs 0 and
    1.  Each rank launches K1 (rung 0) or K2 (rung 1) on its column blocks
    (q, o, gate/up, down and the LM head are nested at this size: 11 a
    forward), none plain; its logits are within 1e-4 of the one-card step
    on the card and its greedy tokens equal."""
    import torch_dist as td
    from repro_torch.configs import get_config
    from repro_torch.core.nesting import default_predicate
    from repro_torch.core.recipe import QuantRecipe, quantize
    from repro_torch.launch.mesh import shape_only
    from repro_torch.models.model import init_params

    cfg = get_config("qwen2-1.5b").reduced()

    def pred(path, leaf):
        return "embed" not in path.lower() and default_predicate(path, leaf)

    nested = quantize(init_params(cfg, seed=0, device="cpu"),
                      QuantRecipe(bits=(4, 8), rounding="rtn", predicate=pred), device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (td.DEC_BATCH, td.DEC_PROMPT),
                           generator=torch.Generator().manual_seed(3))
    p = {"nested": nested, "prompt": prompt}
    torch.save(p, tmp_path / "inputs.pt")
    ranks = td.run_world("gpu2", 2, tmp_path, device="cuda", timeout=600)
    kernel = {0: "packed_matmul", 1: "nested_matmul"}
    per_run = 11 * (1 + td.DEC_NEW)
    for rung in (0, 1):
        want = td.serve_run(p, shape_only((1, 1), device="cuda"), cfg, "nested", "nested",
                            "cuda", rung=rung)
        w = want["logits"]
        for r in ranks:
            got = r[rung]
            launched = {n: c for n, c in got["counts"].items() if c[0] or c[1]}
            assert launched == {kernel[rung]: (per_run, 0)}, (rung, launched)
            gap = float((got["logits"] - w).abs().max() / w.abs().max())
            assert gap <= 1e-4, (rung, gap)
            assert torch.equal(got["tokens"], want["tokens"])
