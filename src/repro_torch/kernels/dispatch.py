"""Where a kernel wrapper runs its work, the launch counters, and the
operand checks of the CUDA kernels.

The rule is the tensor's device: a CPU tensor takes the kernel's plain
PyTorch version, a CUDA tensor launches the hand-written kernel or raises
on a shape, dtype or contiguity the kernel does not take.  There is no
fallback from one to the other, and the JAX package's "non-tiling shape ->
jnp reference" route (``repro/kernels/dispatch.py`` ``plan``) is not
copied.

One explicit, scoped switch exists: :func:`reference_pass` sends CUDA
tensors through the plain versions, for a reference run on the card to
hold the kernels against.  It is never read from the environment, never
entered on an error, and shows in the counters: each wrapper counts its
kernel launches in ``launches`` and its plain runs in ``plain_launches``.

An abstract tensor (:func:`is_abstract`: a ``FakeTensor`` on either
device, or a meta tensor) has shapes and dtypes but no storage, so no
kernel can run on it and no real tensor can take its route: the dry run
(``launch/dryrun.py``) passes such tensors through the wrappers.  On one,
a wrapper runs its operand checks, picks the route the card would take
(:func:`matmul_route` asked for ``"cuda"``, the decode route once per
group of at most ``DEC_MAX_M`` rows), allocates its outputs and
workspace with ``torch.empty`` and counts the launch it would make in
``dry_launches`` with the kernel's work from ``costs.py``
(:func:`count_abstract`).  There is no build and no ctypes call on that
route, and ``launches`` and ``plain_launches`` do not move.

The weight matmuls (K1-K3) have five kernel bodies.  Which one a CUDA
tensor takes is :func:`matmul_route`, a function of M and the dtype alone,
decided before the launch: M <= ``DEC_MAX_M`` (decode) takes the decode
body in bf16 and f32, bf16 with M >= ``TC_MIN_M`` the tensor-core body,
bf16 in between (the short prefill) the short-prefill body, and f32 above
M 8 the f32 body.  The fifth, the CUDA-core body, is reached only by name
(``route="cuda_core"``: the "before" of the chip check's rows).  A launch
that the chosen body refuses raises; it never runs another body.

The decode phase names its route instead (``DECODE``, the wrappers'
``route=``), whatever M: a named decode route launches the decode body
once per group of at most ``DEC_MAX_M`` rows (one launch, as
:func:`matmul_route` picks it, at M <= ``DEC_MAX_M``).  The decode body's
plan does not depend on M, so a row of a group is bit for bit that row of
any other decode-body launch: a decode step (B rows) and the speculative
verify pass (B * (k + 1) rows) give a position the same logits.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import costs


@dataclass
class LaunchCounter:
    """Launch counts of one wrapper: ``launches`` goes up by one where the
    wrapper launches its kernel and nowhere else."""
    name: str
    launches: int = 0
    plain_launches: int = 0
    tc_launches: int = 0       # of ``launches``: those on the tensor-core body
    dec_launches: int = 0      # of ``launches``: those on the decode body
    mid_launches: int = 0      # of ``launches``: those on the short-prefill body
    f32_launches: int = 0      # of ``launches``: those on the f32 body
    # launches on abstract tensors, split by body like ``launches``, and
    # their work (``costs.py``)
    dry_launches: int = 0
    dry_tc_launches: int = 0
    dry_dec_launches: int = 0
    dry_mid_launches: int = 0
    dry_f32_launches: int = 0
    dry_flops: float = 0.0
    dry_bytes: float = 0.0


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    return COUNTERS.setdefault(name, LaunchCounter(name))


def reset_counters() -> None:
    for c in COUNTERS.values():
        for f in dataclasses.fields(c):
            if f.name != "name":
                setattr(c, f.name, f.default)


class _Route:
    reference = False


_route = _Route()


@contextlib.contextmanager
def reference_pass():
    """Run CUDA tensors through the plain versions inside this block."""
    before = _route.reference
    _route.reference = True
    try:
        yield
    finally:
        _route.reference = before


def is_abstract(x: torch.Tensor) -> bool:
    """True for a tensor without storage: a ``FakeTensor`` (whatever device
    it names) or a meta tensor.  Checked before :func:`takes_kernel`."""
    return isinstance(x, FakeTensor) or x.is_meta


def takes_kernel(x: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel or plain route for device {x.device}")
    return not _route.reference


PLAIN, CUDA_CORE, TENSOR_CORE, DECODE = "plain", "cuda_core", "tensor_core", "decode"
MID, F32 = "mid", "f32"
# the C entry points' ``body`` argument of each kernel route (the
# short-prefill and f32 bodies have entry points of their own,
# ``build.STREAMS_ENTRY``)
BODY = {CUDA_CORE: 0, TENSOR_CORE: 1, DECODE: 2, MID: 3, F32: 4}
# Largest M the K1-K3 decode body takes (bf16 and f32): one 8-row x tile
# per CTA, each packed word unpacked once for all rows.
DEC_MAX_M = 8
# Smallest M that takes the K1-K3 tensor-core body in bf16; below it (M
# 9-63, the short prefill: M 32) bf16 takes the short-prefill body, the
# fastest of the four bodies summed over a qwen2-1.5b layer's seven
# matmuls at M 16, 32, 48 and 63 at every rung on the H100
# (chip_smoke.py's phase 1 measures them, its [mid-layer] lines; PERF.md
# keeps them, with the bodies at M = 64).
TC_MIN_M = 64
# Most rows the K1-K3 short-prefill body takes (bf16; 8 token tiles of 8).
MID_MAX_M = 64


def matmul_route(M: int, dtype: torch.dtype, device) -> str:
    """The body a K1-K3 wrapper runs for an (M, K) activation of ``dtype``
    on ``device``: ``"plain"`` on the CPU, else ``"decode"`` for M <=
    ``DEC_MAX_M`` (bf16 or f32), ``"tensor_core"`` for bf16 with M >=
    ``TC_MIN_M``, ``"mid"`` for bf16 in between and ``"f32"`` for f32
    above ``DEC_MAX_M``.  Nothing routes to ``"cuda_core"`` unasked."""
    kind = torch.device(device).type
    if kind == "cpu":
        return PLAIN
    if kind != "cuda":
        raise ValueError(f"no kernel or plain route for device {device}")
    if M <= DEC_MAX_M and dtype in KERNEL_DTYPES:
        return DECODE
    if dtype == torch.bfloat16:
        return TENSOR_CORE if M >= TC_MIN_M else MID
    return F32


def kernel_route(x: torch.Tensor, route) -> str:
    """The kernel route a K1-K3 wrapper launches for ``x`` (a CUDA tensor
    outside ``reference_pass``): ``route`` where the caller names one (the
    decode phase names ``DECODE``; the chip check and the tests compare
    the bodies at one shape), else :func:`matmul_route`.  A named
    tensor-core or short-prefill route takes bf16 only (the short-prefill
    body at most ``MID_MAX_M`` rows), a named f32 route f32 only; a named
    decode route takes any M, in groups of at most ``DEC_MAX_M`` rows
    (:func:`launch_matmul`)."""
    if route is None:
        return matmul_route(x.shape[0], x.dtype, x.device)
    if route not in BODY:
        raise ValueError(f"route must be one of {sorted(BODY)}, got {route!r}")
    if route in (TENSOR_CORE, MID) and x.dtype != torch.bfloat16:
        raise TypeError(f"the {route} body takes bf16 activations, got {x.dtype}")
    if route == F32 and x.dtype != torch.float32:
        raise TypeError(f"the f32 body takes f32 activations, got {x.dtype}")
    if route == MID and x.shape[0] > MID_MAX_M:
        raise ValueError(f"the mid body takes at most {MID_MAX_M} rows, got {x.shape[0]}")
    return route


# K1-K3 launches per body route in this process, over every wrapper:
# ``reset_counters`` leaves them as they are, so a run can show that no
# launch reached a body (the CUDA-core one, reached only by name) between
# two readings, whatever was reset in between.
BODY_LAUNCHES: Dict[str, int] = dict.fromkeys(BODY, 0)


def count_launch(counter: LaunchCounter, route: str) -> None:
    BODY_LAUNCHES[route] += 1
    counter.launches += 1
    counter.tc_launches += int(route == TENSOR_CORE)
    counter.dec_launches += int(route == DECODE)
    counter.mid_launches += int(route == MID)
    counter.f32_launches += int(route == F32)


def count_abstract(counter: LaunchCounter, route: str, cost) -> None:
    """One launch the card would make on an abstract tensor, and its work
    ``cost`` = (bytes, operations)."""
    counter.dry_launches += 1
    counter.dry_tc_launches += int(route == TENSOR_CORE)
    counter.dry_dec_launches += int(route == DECODE)
    counter.dry_mid_launches += int(route == MID)
    counter.dry_f32_launches += int(route == F32)
    counter.dry_bytes += cost[0]
    counter.dry_flops += cost[1]


def abstract_route(x: torch.Tensor, route) -> str:
    """:func:`kernel_route` of an abstract (M, K) activation as the card
    would take it: a named route as given (checked alike), else
    :func:`matmul_route` asked for ``"cuda"``."""
    if route is None:
        return matmul_route(x.shape[0], x.dtype, "cuda")
    return kernel_route(x, route)


# The decode body's instantiations: one per (streams, rows) with rows in
# ``DEC_ROWS``; a launch of M rows runs the instantiation of ``dec_rows(M)``
# (``dec_mb`` in csrc/nest_matmul.cu, which the library reports through
# ``nq_dec_rows``: tests/test_torch_gpu.py holds the two equal).  Each opts into large shared memory
# at its first launch in the process; ``DEC_INSTANCES`` holds the (streams,
# rows) pairs launched so far (``reset_counters`` leaves it as it is).
DEC_ROWS = (1, 2, 4, 8)
DEC_INSTANCES: set = set()


def dec_rows(M: int) -> int:
    """Rows of the decode-body instantiation an M-row launch runs."""
    return next(r for r in DEC_ROWS if M <= r)


def launch_matmul(x: torch.Tensor, N: int, out_dtype, route: str,
                  counter: LaunchCounter, launch, streams: int) -> torch.Tensor:
    """Run ``launch(x_rows, out_rows, body)`` (one K1-K3 kernel launch of
    ``streams`` packed streams into a row slice of the (M, N) output) on
    ``route``: once, or on the decode body once per group of at most
    ``DEC_MAX_M`` rows; each launch is counted, and each decode-body
    launch's instantiation recorded in ``DEC_INSTANCES``."""
    out = torch.empty((x.shape[0], N), dtype=out_dtype, device=x.device)
    step = DEC_MAX_M if route == DECODE else x.shape[0]
    for g in range(0, x.shape[0], step):
        rows = x[g:g + step]
        launch(rows, out[g:g + step], BODY[route])
        count_launch(counter, route)
        if route == DECODE:
            DEC_INSTANCES.add((streams, dec_rows(rows.shape[0])))
    return out


def launch_abstract(x: torch.Tensor, N: int, out_dtype, route: str,
                    counter: LaunchCounter, streams, bits, block: int) -> torch.Tensor:
    """:func:`launch_matmul` on an abstract x: the (M, N) output and, per
    launch, the CUDA-core body's (nk, rows, N), the short-prefill body's
    (``build.mid_workspace``) and the f32 body's (``build.f32_workspace``,
    none where it does not split K) f32 partials, both on an H100's
    ``costs.SMS``, as the wrappers allocate them (the decode body's
    partials are sized by the library from the card's occupancy, and are
    left out), each launch counted with :func:`costs.matmul_cost`."""
    from . import build

    M, K = x.shape
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    step = DEC_MAX_M if route == DECODE else M
    nk = -(-K // block)
    for g in range(0, M, step):
        rows = x[g:g + step]
        shape = None                          # held for the launch, as on the card
        if route == CUDA_CORE and nk > 1:
            shape = (nk, rows.shape[0], N)
        elif route == MID:
            shape = (build.mid_workspace(bits, N, K, block, costs.SMS)[0] * rows.shape[0],)
        elif route == F32:
            floats = build.f32_workspace(rows.shape[0], N, K, block, costs.SMS)[0]
            shape = (floats,) if floats else None
        if shape is not None:
            partial = torch.empty(shape, dtype=torch.float32, device=x.device)
            del partial
        count_abstract(counter, route, costs.matmul_cost(rows, streams, N, out_dtype))
    return out


KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_STREAMS = 4
MAX_BITS = 16
MAX_BLOCK = 512


def check_operands(x: torch.Tensor, streams, bits, scale: torch.Tensor, *,
                   K: int, block: int, out_dtype: torch.dtype) -> None:
    """Raise on anything the stream-matmul kernel does not take.

    x (M, K) bf16/f32 contiguous; ``streams`` int32 (nk * rows_pb_i, N)
    contiguous word streams whose widths follow from ``bits`` (base
    bits[0], then each level's gap + 1); scale f32 with N elements;
    1..4 streams, bitwidths <= 16, pack block a multiple of 32, <= 512."""
    from ..core.packing import blocked_rows

    if x.dtype not in KERNEL_DTYPES or out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"kernel takes bf16/f32 activations and outputs, got "
                        f"x {x.dtype}, out {out_dtype}")
    if x.ndim != 2 or x.shape[1] != K or x.shape[0] < 1 or not x.is_contiguous():
        raise ValueError(f"kernel needs a contiguous (M>=1, K={K}) activation, "
                         f"got {tuple(x.shape)} contiguous={x.is_contiguous()}")
    if not 1 <= len(streams) <= MAX_STREAMS or len(bits) != len(streams):
        raise ValueError(f"kernel takes 1..{MAX_STREAMS} streams with one "
                         f"bitwidth each, got {len(streams)} streams, bits {bits}")
    if bits[-1] > MAX_BITS or any(b >= c for b, c in zip(bits, bits[1:])):
        raise ValueError(f"kernel takes ascending bitwidths <= {MAX_BITS}, got {bits}")
    if block % 32 or not 32 <= block <= MAX_BLOCK:
        raise ValueError(f"kernel takes a pack block that is a multiple of 32 "
                         f"and <= {MAX_BLOCK}, got {block}")
    widths = [bits[0]] + [c - b + 1 for b, c in zip(bits, bits[1:])]
    nk = -(-K // block)
    N = streams[0].shape[-1]
    for s, w in zip(streams, widths):
        want = (nk * blocked_rows(block, w), N)
        if (s.dtype != torch.int32 or tuple(s.shape) != want
                or not s.is_contiguous() or s.device != x.device):
            raise ValueError(f"word stream of width {w} must be contiguous int32 "
                             f"{want} on {x.device}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")
    if (scale.dtype != torch.float32 or scale.numel() != N
            or not scale.is_contiguous() or scale.device != x.device):
        raise ValueError(f"scale must be contiguous f32 with {N} elements on "
                         f"{x.device}, got {scale.dtype} {tuple(scale.shape)}")


MAX_HEAD_DIM = 128
MAX_QK_DIM = 256


def check_flash_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_offset: int = 0) -> None:
    """Raise on anything K5 does not take: q (B,Sq,Hq,hd), k/v (B,Skv,Hkv,hd)
    contiguous, one dtype (bf16 or f32), one device; hd <= 128 and a
    multiple of 8; Hq a multiple of Hkv; the query block at key positions
    ``q_offset`` .. ``q_offset + Sq - 1`` inside k/v."""
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or f32 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention needs q (B,Sq,Hq,hd) and k/v (B,Skv,Hkv,hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (B, hd) or Hq % Hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (Hq must be a multiple of Hkv)")
    if q_offset < 0 or q_offset + Sq > Skv:
        raise ValueError(f"flash_attention: {Sq} query rows at offset {q_offset} do not "
                         f"fit in {Skv} keys")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a head dim that is a multiple of 8 "
                         f"and <= {MAX_HEAD_DIM}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be contiguous on "
                             f"{q.device}, got {t.device} contiguous={t.is_contiguous()}")


def check_qk_operands(q_codes: torch.Tensor, streams, bits, page: int) -> None:
    """Raise on anything K4 does not take: int32 contiguous queries
    (BH, M, D <= 256); 1..4 int32 contiguous streams (BH, npages *
    rows_i, D) on the queries' device, their widths following from the
    resident ``bits`` (ascending, checked by the caller; <= 16); any page
    >= 1."""
    from ..core.packing import blocked_rows

    if q_codes.dtype != torch.int32 or q_codes.ndim != 3 or not q_codes.is_contiguous():
        raise TypeError(f"nested_qk takes contiguous int32 (BH, M, D) query codes, got "
                        f"{q_codes.dtype} {tuple(q_codes.shape)}")
    BH, M, D = q_codes.shape
    if not 1 <= len(streams) <= MAX_STREAMS or len(bits) != len(streams):
        raise ValueError(f"nested_qk takes 1..{MAX_STREAMS} streams with one "
                         f"bitwidth each, got {len(streams)} streams, bits {bits}")
    if bits[-1] > MAX_BITS or D > MAX_QK_DIM or page < 1 or M < 1:
        raise ValueError(f"nested_qk takes bitwidths <= {MAX_BITS}, D <= {MAX_QK_DIM} "
                         f"and page >= 1, got bits {bits}, D {D}, page {page}")
    widths = (bits[0],) + tuple(c - b + 1 for b, c in zip(bits, bits[1:]))
    npages = streams[0].shape[1] // blocked_rows(page, bits[0])
    for s, w in zip(streams, widths):
        want = (BH, npages * blocked_rows(page, w), D)
        if (s.dtype != torch.int32 or tuple(s.shape) != want or npages < 1
                or not s.is_contiguous() or s.device != q_codes.device):
            raise ValueError(f"K stream of width {w} must be contiguous int32 {want} on "
                             f"{q_codes.device}, got {s.dtype} {tuple(s.shape)} on "
                             f"{s.device}")


def check_recompose_operands(words_high: torch.Tensor, words_low: torch.Tensor, *,
                             n: int, h: int, K: int, block_k: int) -> None:
    """Raise on anything K6 does not take: 1 <= h < n <= 8 (int8 output);
    contiguous int32 streams (nk * rows_h, N) and (nk * rows_l, N) on one
    device, packed along K with ``block_k >= 1``."""
    from ..core.packing import blocked_rows

    if not 1 <= h < n <= 8:
        raise ValueError(f"nest_recompose takes 1 <= h < n <= 8, got n={n} h={h}")
    if block_k < 1 or K < 1:
        raise ValueError(f"nest_recompose needs K >= 1 and block_k >= 1, got {K}, {block_k}")
    nk = -(-K // block_k)
    N = words_high.shape[-1]
    for s, w in ((words_high, h), (words_low, n - h + 1)):
        want = (nk * blocked_rows(block_k, w), N)
        if (s.dtype != torch.int32 or tuple(s.shape) != want or not s.is_contiguous()
                or s.device != words_high.device):
            raise ValueError(f"word stream of width {w} must be contiguous int32 {want} "
                             f"on {words_high.device}, got {s.dtype} {tuple(s.shape)} "
                             f"on {s.device}")
