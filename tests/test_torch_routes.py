"""The K1-K3 route choice (plain, decode body, short-prefill body, f32
body or tensor-core body; the CUDA-core body only by name) as a pure
function of M, dtype and device; the decode route in row groups; the
per-route launch counters; the short-prefill and f32 bodies' plan
mirrors; and
the plain route at prefill-like M against the JAX package (its Pallas
kernels in interpret mode, its flash op at a ragged S)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_op
from repro.kernels.nested_matmul import ops as jax_ops
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.nested_matmul import ops
from torch_parity import activations, assert_close, flash_inputs, j2n, stream_operands, t2n

TC, CC, PLAIN = dispatch.TENSOR_CORE, dispatch.CUDA_CORE, dispatch.PLAIN
DEC, MID, F32 = dispatch.DECODE, dispatch.MID, dispatch.F32


@pytest.mark.parametrize("M,dtype,device,want", [
    (1, torch.bfloat16, "cuda", DEC),                      # decode, both dtypes
    (4, torch.bfloat16, "cuda", DEC),
    (dispatch.DEC_MAX_M, torch.bfloat16, "cuda", DEC),
    (1, torch.float32, "cuda", DEC),
    (4, torch.float32, "cuda:0", DEC),
    (dispatch.DEC_MAX_M, torch.float32, "cuda", DEC),
    (dispatch.DEC_MAX_M + 1, torch.bfloat16, "cuda", MID),  # M 9-63 in bf16
    (dispatch.DEC_MAX_M + 1, torch.float32, "cuda", F32),  # f32 above M 8
    (32, torch.bfloat16, "cuda", MID),                     # the short prefill
    (dispatch.TC_MIN_M - 1, torch.bfloat16, "cuda", MID),
    (dispatch.TC_MIN_M, torch.bfloat16, "cuda", TC),
    (4096, torch.bfloat16, "cuda:0", TC),                   # the long prefill
    (4096, torch.float32, "cuda", F32),                     # f32: no TF32, CUDA cores
    (63, torch.float32, "cuda", F32),                       # either side of BM 64
    (dispatch.TC_MIN_M, torch.float32, "cuda", F32),
    (65, torch.float32, "cuda:0", F32),
    (2200, torch.float32, "cuda", F32),                     # ragged against BM 128
    (4096, torch.bfloat16, "cpu", PLAIN),
    (1, torch.float32, "cpu", PLAIN),
    (4, torch.bfloat16, "cpu", PLAIN),
])
def test_matmul_route_is_a_function_of_m_dtype_and_device(M, dtype, device, want):
    assert dispatch.matmul_route(M, dtype, device) == want
    assert dispatch.matmul_route(M, dtype, torch.device(device)) == want


def test_matmul_route_refuses_other_devices():
    with pytest.raises(ValueError):
        dispatch.matmul_route(128, torch.bfloat16, "meta")


def test_kernel_route_names_and_refusals():
    """A named route is taken as named; the tensor-core body takes bf16
    only, the decode route any M (in groups of at most DEC_MAX_M rows), and
    an unknown name raises - none falls back to another."""
    x16 = torch.zeros(4, 8, dtype=torch.bfloat16)
    assert dispatch.kernel_route(x16, TC) == TC
    assert dispatch.kernel_route(x16, CC) == CC
    assert dispatch.kernel_route(x16, DEC) == DEC
    assert dispatch.kernel_route(x16.float(), DEC) == DEC
    assert dispatch.kernel_route(x16, None) == PLAIN         # a CPU tensor
    with pytest.raises(TypeError):
        dispatch.kernel_route(x16.float(), TC)
    for x in (torch.zeros(dispatch.DEC_MAX_M, 8), torch.zeros(dispatch.DEC_MAX_M + 1, 8),
              torch.zeros(64, 8, dtype=torch.bfloat16)):       # any M, bf16 or f32
        assert dispatch.kernel_route(x, DEC) == DEC
    assert [dispatch.BODY[r] for r in (CC, TC, DEC)] == [0, 1, 2]
    for bad in ("tensor", PLAIN):
        with pytest.raises(ValueError):
            dispatch.kernel_route(x16, bad)


def test_launch_counts_per_route_and_reset():
    c = dispatch.LaunchCounter("probe")
    dispatch.count_launch(c, CC)
    dispatch.count_launch(c, TC)
    dispatch.count_launch(c, TC)
    dispatch.count_launch(c, DEC)
    assert (c.launches, c.tc_launches, c.dec_launches, c.plain_launches) == (4, 2, 1, 0)
    probe = dispatch.counter("route_probe")
    dispatch.count_launch(probe, TC)
    dispatch.count_launch(probe, DEC)
    dispatch.reset_counters()
    assert (probe.launches, probe.tc_launches, probe.dec_launches) == (0, 0, 0)
    del dispatch.COUNTERS["route_probe"]


def test_body_has_an_entry_per_kernel_route():
    """Five bodies, numbered as the C entry points take them; the
    short-prefill and f32 bodies' numbers are the ones their bindings
    dispatch on."""
    from repro_torch.kernels import build

    assert dispatch.BODY == {CC: 0, TC: 1, DEC: 2, MID: 3, F32: 4}
    assert dispatch.BODY[MID] == build.MID_BODY
    assert dispatch.BODY[F32] == build.F32_BODY
    assert set(build.SIGNATURES) >= {"nest_matmul.cu", "nest_matmul_mid.cu",
                                     "nest_matmul_f32.cu"}


def test_mid_route_refuses_f32_and_counts_its_launches():
    """A named short-prefill route takes bf16 only, at most MID_MAX_M rows
    (TypeError / ValueError, never another body); its launches count in
    ``mid_launches`` and reset with the rest."""
    for M in (dispatch.DEC_MAX_M + 1, 32, dispatch.TC_MIN_M - 1):
        assert dispatch.kernel_route(torch.zeros(M, 8, dtype=torch.bfloat16), MID) == MID
        with pytest.raises(TypeError):
            dispatch.kernel_route(torch.zeros(M, 8), MID)
    with pytest.raises(ValueError):
        dispatch.kernel_route(torch.zeros(dispatch.MID_MAX_M + 1, 8, dtype=torch.bfloat16),
                              MID)
    probe = dispatch.counter("mid_probe")
    dispatch.count_launch(probe, MID)
    dispatch.count_launch(probe, MID)
    dispatch.count_launch(probe, TC)
    assert (probe.launches, probe.mid_launches, probe.tc_launches, probe.dec_launches) == \
        (3, 2, 1, 0)
    dispatch.reset_counters()
    assert (probe.launches, probe.mid_launches) == (0, 0)
    del dispatch.COUNTERS["mid_probe"]


def test_f32_route_refuses_bf16_and_counts_its_launches():
    """A named f32 route takes f32 only, at any M (TypeError on bf16, never
    another body); its launches count in ``f32_launches`` and reset with
    the rest; ``BODY_LAUNCHES`` counts every launch by body and no reset
    clears it."""
    for M in (1, dispatch.DEC_MAX_M + 1, 64, 4096):
        assert dispatch.kernel_route(torch.zeros(M, 8), F32) == F32
        with pytest.raises(TypeError):
            dispatch.kernel_route(torch.zeros(M, 8, dtype=torch.bfloat16), F32)
    bodies = dict(dispatch.BODY_LAUNCHES)
    probe = dispatch.counter("f32_probe")
    dispatch.count_launch(probe, F32)
    dispatch.count_launch(probe, F32)
    dispatch.count_launch(probe, CC)
    dispatch.count_launch(probe, DEC)
    assert (probe.launches, probe.f32_launches, probe.dec_launches, probe.mid_launches,
            probe.tc_launches) == (4, 2, 1, 0, 0)
    dispatch.reset_counters()
    assert (probe.launches, probe.f32_launches) == (0, 0)
    assert dispatch.BODY_LAUNCHES == {**bodies, F32: bodies[F32] + 2, CC: bodies[CC] + 1,
                                      DEC: bodies[DEC] + 1}
    del dispatch.COUNTERS["f32_probe"]


def test_cuda_core_body_is_reached_only_by_name():
    """No M or dtype routes to the CUDA-core body; named, it is taken as
    named in both dtypes (the chip check's "before" rows)."""
    for dtype in (torch.bfloat16, torch.float32):
        assert {dispatch.matmul_route(M, dtype, "cuda") for M in range(1, 5000)} <= \
            {DEC, MID, TC, F32}
        for M in (4, 32, 4096):
            assert dispatch.kernel_route(torch.zeros(M, 8, dtype=dtype), CC) == CC


@pytest.mark.parametrize("M,N,K,block,want", [
    # qwen2-1.5b q/o, k/v, gate/up, down (blocks 512 and 256): BM 32 / 64 /
    # 128 x 128-column tiles, 32-column ones (BM 32 or 64) where 128-wide
    # tiles cover under a quarter of 132 SMs and a CTA keeps at most 3x the
    # steps; K split into runs of >= 4 steps of 32 codes where the tiles
    # fill fewer than the SMs, at most 2 x 132 CTAs and 512 KB of slots a
    # tile
    (32, 1536, 1536, 512, (5 * 32 * 1536, 48)),       # 48 32-column tiles
    (63, 256, 1536, 512, (12 * 63 * 256, 8)),         # 48 steps: 12 runs
    (64, 8960, 1536, 512, (3 * 64 * 8960, 70)),       # 264 // 70 = 3 runs
    (64, 1536, 8960, 256, (16 * 64 * 1536, 12)),      # 32 columns: 56 steps a CTA;
    #                                                   16 slots of 32 KB: 512 KB
    (65, 256, 1536, 512, (12 * 65 * 256, 16)),        # k/v above M 64: 64 x 32 tiles
    (256, 256, 1536, 512, (8 * 256 * 256, 32)),
    (65, 1536, 1536, 512, (8 * 65 * 1536, 12)),       # 8 slots of 64 KB: 512 KB
    (16, 1536, 1536, 512, (5 * 16 * 1536, 48)),
    (4096, 256, 1536, 512, (4 * 4096 * 256, 64)),     # k/v at the long prefill
    (4096, 1536, 1536, 512, (0, 384)),                # enough tiles: no split
    (4096, 8960, 1536, 512, (0, 2240)),
    (2200, 1536, 8960, 256, (0, 216)),
    (9, 151936, 1536, 512, (0, 1187)),                # the LM head
    (20, 100, 96, 32, (0, 4)),                        # 3 steps: too few to split
    (40, 130, 999, 64, (8 * 40 * 130, 5)),            # 32 steps: 8 runs
])
def test_f32_workspace_mirror_of_the_plan(M, N, K, block, want):
    """The f32 body's partials and output tiles, as the Python mirror of its
    plan computes them on an H100's 132 SMs (a gpu test holds the mirror
    equal to the library): one (M, N) slot per run of K steps where K is
    split, none where the tiles fill the SMs."""
    from repro_torch.kernels import build, costs

    assert build.f32_workspace(M, N, K, block, costs.SMS) == want


@pytest.mark.parametrize("bits,N,K,block,want", [
    # qwen2-1.5b q/o, k/v, gate/up, down and the LM head (block 512): the
    # widest tile of 64 / 32 / 16 columns with tiles * nk >= 132 items (else
    # 16), CTAs = min(items, 2 * 132), one slot per tile and per CTA
    ((4,), 1536, 1536, 512, ((48 + 264) * 32, 48)),           # 32 columns, 288 items
    ((4, 6, 8), 1536, 1536, 512, ((48 + 264) * 32, 48)),
    ((4,), 256, 1536, 512, ((16 + 192) * 16, 16)),            # 16 columns, 192 items
    ((4, 6, 8), 256, 1536, 512, ((16 + 192) * 16, 16)),
    ((4, 6, 8), 8960, 1536, 512, ((140 + 264) * 64, 140)),    # 64 columns, 1680 items
    ((4, 6, 8), 1536, 8960, 512, ((24 + 264) * 64, 24)),
    ((4, 6, 8), 151936, 1536, 512, ((2374 + 264) * 64, 2374)),
    ((2, 4, 6, 8), 100, 96, 32, ((7 + 21) * 16, 7)),          # block 32: a block a chunk
    ((16,), 130, 999, 64, ((9 + 144) * 16, 9)),               # 2 slots a word
])
def test_mid_workspace_mirror_of_the_plan(bits, N, K, block, want):
    """The short-prefill body's partials per row and column tiles, as the
    Python mirror of its plan computes them on an H100's 132 SMs (a gpu test
    holds the mirror equal to the library): one tile-wide slot per tile and
    per CTA (a tile's CTAs p0 .. p1 write slots T + p), the CTAs at most two
    per SM."""
    from repro_torch.kernels import build, costs

    assert build.mid_workspace(bits, N, K, block, costs.SMS) == want


@pytest.mark.parametrize("M", [1, 4, 8, 12, 20, 17])
def test_decode_rows_route_launches_once_per_group_of_8_rows(M):
    """The decode route launches the decode body once per group of at most
    DEC_MAX_M rows, each into its row slice of one output, counting each
    launch as a decode-body launch and recording its (streams, rows)
    instantiation; another body launches once and records none."""
    x = torch.arange(M * 3, dtype=torch.float32).reshape(M, 3)
    calls = []

    def launch(xs, out, body):
        calls.append((xs.data_ptr(), xs.shape[0], body, xs.is_contiguous()))
        out.copy_(xs[:, :2] * 2)

    c = dispatch.LaunchCounter("probe")
    seen = set(dispatch.DEC_INSTANCES)
    dispatch.DEC_INSTANCES.clear()
    y = dispatch.launch_matmul(x, 2, torch.float32, DEC, c, launch, streams=3)
    groups = -(-M // dispatch.DEC_MAX_M)
    assert [n for _, n, _, _ in calls] == \
        [min(dispatch.DEC_MAX_M, M - g * dispatch.DEC_MAX_M) for g in range(groups)]
    assert all(b == dispatch.BODY[DEC] and cont for _, _, b, cont in calls)
    assert [p for p, _, _, _ in calls] == \
        [x[g * dispatch.DEC_MAX_M:].data_ptr() for g in range(groups)]
    assert torch.equal(y, x[:, :2] * 2)
    assert (c.launches, c.dec_launches, c.tc_launches) == (groups, groups, 0)
    instances = {(3, dispatch.dec_rows(n)) for _, n, _, _ in calls}
    assert dispatch.DEC_INSTANCES == instances
    assert {dispatch.dec_rows(n) for n in range(1, 9)} == set(dispatch.DEC_ROWS)
    calls.clear()
    dispatch.launch_matmul(x, 2, torch.float32, CC, c, launch, streams=1)
    assert len(calls) == 1 and calls[0][1:3] == (M, dispatch.BODY[CC])
    assert (c.launches, c.dec_launches) == (groups + 1, groups)
    assert dispatch.DEC_INSTANCES == instances
    dispatch.DEC_INSTANCES.clear()
    dispatch.DEC_INSTANCES.update(seen)


@pytest.mark.parametrize("bits,rung", [((4, 6, 8), 2), ((2, 4, 6, 8), 3)])
def test_prefill_m_plain_route_matches_interpret_ladder(bits, rung):
    """bf16 at a prefill-like M (130 >= TC_MIN_M) on a CPU tensor: the
    wrapper runs its plain version (no kernel launch of either body) and
    equals the JAX ladder kernel in interpret mode."""
    M, K = 130, 512
    assert dispatch.matmul_route(M, torch.bfloat16, "cpu") == PLAIN
    b, words, scale, block = stream_operands(bits, rung, K, seed=41 + rung)
    xj, xt = activations(M, K, "bfloat16", seed=M)
    ref = jax_ops.ladder_matmul(xj, tuple(jnp.asarray(w) for w in words), jnp.asarray(scale),
                                bits=b, K=K, block_k=block, interpret=True)
    c = ops.LADDER_COUNTER
    before = (c.launches, c.tc_launches, c.plain_launches)
    got = ops.ladder_matmul(xt, tuple(torch.from_numpy(w) for w in words),
                            torch.from_numpy(scale), bits=b, K=K, block_k=block)
    assert (c.launches, c.tc_launches, c.plain_launches) == (before[0], before[1], before[2] + 1)
    assert got.dtype == torch.bfloat16
    assert_close(got, ref, "bfloat16")


@pytest.mark.parametrize("S", [77, 1100])
def test_flash_plain_route_matches_jax_op_at_ragged_s_bf16(S):
    """bf16 q/k/v at an S that is no multiple of any block: the port's op
    (its plain route on the CPU) against the JAX op (its reference route
    there), at K5's bf16 limit of 2e-2."""
    dims = (1, S, 4, 2, 32)
    (qj, q), (kj, k), (vj, v) = flash_inputs(dims, "bfloat16", S)
    want = j2n(jax_flash_op(qj, kj, vj, interpret=True))
    got = fa.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(t2n(got), want, rtol=2e-2, atol=2e-2)
