"""Build and load the port's CUDA kernels.

The sources under ``src/repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into shared libraries with a plain C interface, loaded with
``ctypes`` (seconds to build; nothing includes PyTorch's headers).  A
build happens at first use, into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``); the library name carries a hash of
its source, of the shared ``csrc/*.cuh`` headers and of its flags, so an
edited source is rebuilt and a stale library is never loaded.  Nothing
here runs at import time: the CPU tests import every module of the port
on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]
# flags of one source: nest_matmul.cu's 33 kernels and nest_matmul_f32.cu's
# 20 are the build's long poles, so nvcc optimizes their kernels in
# parallel on every core it finds (each kernel keeps its registers and
# spills; the other sources, which build several times faster beside them,
# keep one thread: the flag changes nest_recompose.cu's register counts)
SOURCE_FLAGS: Dict[str, List[str]] = {"nest_matmul.cu": ["--split-compile=0"],
                                      "nest_matmul_f32.cu": ["--split-compile=0"]}

_P, _I = ctypes.c_void_p, ctypes.c_int
# exported C entry points of each source: name -> argtypes (all return int:
# the cudaError_t of a launch, or the count a query asks for)
SIGNATURES: Dict[str, Dict[str, List]] = {
    "nest_matmul.cu": {
        "nq_packed_matmul": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I,
                             _I, _I, _I, _I, _I, _P],
        "nq_nested_matmul": [_P, _I, _P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _I,
                             _I, _I, _I, _I, _I, _P],
        "nq_ladder_matmul": [_P, _I, _P, _P, _I, _P, _P, _I, _P, _I, _P, _I,
                             _I, _I, _I, _I, _I, _P],
        "nq_dec_workspace": [_P, _I, _I, _I, _I, _I, _P],
        "nq_dec_rows": [_I],
    },
    "nest_matmul_mid.cu": {
        "nq_mid_matmul": [_P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _I,
                          _I, _I, _I, _I, _P],
        "nq_mid_workspace": [_P, _I, _I, _I, _I, _P],
    },
    "nest_matmul_f32.cu": {
        "nq_f32_matmul": [_P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _I,
                          _I, _I, _I, _I, _P],
        "nq_f32_workspace": [_P, _I, _I, _I, _I, _I, _P],
    },
    "flash_attention.cu": {
        "nq_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P],
    },
    "nested_qk.cu": {
        "nq_nested_qk": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    },
    "nest_recompose.cu": {
        "nq_nest_recompose": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory / spill report of each build, by source
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise KernelBuildError("nvcc not found: the CUDA kernels build only on "
                               "a machine with the CUDA toolkit")
    return found


def _start_build(source: str):
    """Start nvcc on one source; returns (library path, process or None)."""
    src = CSRC / source
    flags = [*ARCH_FLAGS, *NVCC_FLAGS, *SOURCE_FLAGS.get(source, [])]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # sources share these headers
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}-{digest}.so"
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return lib, (proc, tmp)


def build_all(sources=None) -> Dict[str, Path]:
    """Compile every source (one nvcc each, all started together) and
    return the library paths.  Already-built libraries are reused."""
    sources = list(SIGNATURES) if sources is None else list(sources)
    started = {s: _start_build(s) for s in sources}
    paths = {}
    for source, (lib, job) in started.items():
        if job is not None:
            proc, tmp = job
            out, _ = proc.communicate()
            build_logs[source] = out
            if proc.returncode != 0:
                raise KernelBuildError(f"nvcc failed on {source}:\n{out}")
            os.replace(tmp, lib)
        paths[source] = lib
    return paths


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``.  The first use of any kernel
    builds every source, in parallel; later uses reuse the libraries."""
    with _lock:
        if source not in _libs:
            lib = ctypes.CDLL(str(build_all()[source]))
            for name, argtypes in SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[source] = lib
        return _libs[source]


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


# the decode body's plan per (device, bits, N, K, block): f32 partials per
# activation row and column tiles; and the per-column-tile arrival
# counters per (device, stream) the decode and short-prefill bodies share
# (int32, 0 between launches: the last CTA of a tile resets its own)
_dec_plans: Dict[tuple, tuple] = {}
_dec_counters: Dict[Tuple[int, int], "object"] = {}
DEC_COUNTERS_MIN = 8192


def dec_plan(device, bits, N: int, K: int, block: int):
    """(partial floats per activation row, column tiles) of a decode-body
    launch (``nq_dec_workspace``, the plan the launch itself follows);
    cached per shape.  The plan does not depend on M, so every row count
    up to ``DEC_MAX_M`` shares it (the entry point is asked at M = 1)."""
    key = (device.index, tuple(bits), N, K, block)
    if key not in _dec_plans:
        arr = (ctypes.c_int * len(bits))(*bits)
        tiles = ctypes.c_int(0)
        n = library("nest_matmul.cu").nq_dec_workspace(
            ctypes.addressof(arr), len(bits), 1, N, K, block, ctypes.byref(tiles))
        if n < 1:
            raise ValueError(f"the decode body refuses bits {tuple(bits)}, N={N}, "
                             f"K={K}, block={block}")
        _dec_plans[key] = (n, tiles.value)
    return _dec_plans[key]


def dec_counters(device, tiles: int, stream=None):
    """The arrival counters of ``stream`` (a ``cuda_stream`` handle;
    default the device's current stream), at least ``tiles`` of them.
    Each (device, stream) has its own buffer: launches on one stream run
    one after another and each leaves the counters at 0, while launches on
    two streams may overlap and must not count each other's arrivals."""
    import torch

    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    buf = _dec_counters.get(key)
    if buf is None or buf.numel() < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the decode body's counters must be allocated before "
                               "a CUDA graph capture: launch once outside it first")
        buf = torch.zeros(max(tiles, DEC_COUNTERS_MIN), dtype=torch.int32, device=device)
        _dec_counters[key] = buf
    return buf


# the C entry points' ``body`` of the short-prefill and f32 bodies
# (``dispatch.BODY``), whose kernels live in sources and entry points of
# their own, taking the streams as an array: body -> (source, entry point)
MID_BODY, F32_BODY = 3, 4
STREAMS_ENTRY = {MID_BODY: ("nest_matmul_mid.cu", "nq_mid_matmul"),
                 F32_BODY: ("nest_matmul_f32.cu", "nq_f32_matmul")}
# the short-prefill body's plan constants (csrc/nest_matmul_mid.cu): the
# ring stage (a chunk's words and its x at 64 token rows), the items per SM
# the plan aims for and the CTAs per SM it takes at most
MID_STAGE_BYTES, MID_ITEMS, MID_CTAS_PER_SM = 48 * 1024, 1, 2
_mid_plans: Dict[tuple, tuple] = {}


def mid_workspace(bits, N: int, K: int, block: int, sms: int):
    """(f32 partials per activation row, column tiles) of a short-prefill
    launch on a card of ``sms`` SMs: ``mid_plan`` and ``mid_workspace`` of
    ``csrc/nest_matmul_mid.cu`` in Python, for the dry run, which has no
    library (a gpu test holds the two equal).  One tile-wide slot per run
    of items of one tile: the tiles plus the CTAs."""
    widths = [bits[0]] + [b - a + 1 for a, b in zip(bits, bits[1:])]
    comps = [1 << i for w in widths for i in range(4, -1, -1) if (w >> i) & 1]
    wmax, wmin = max(comps), min(comps)
    rmin, umax, slots = block * wmin // 32, wmax // wmin, 32 // wmax
    wpu = sum(c // wmin for c in comps)
    nk, want = -(-K // block), MID_ITEMS * sms
    bn = 64
    while bn > 16 and -(-N // bn) * nk < want:
        bn //= 2
    tiles = -(-N // bn)

    def stage_bytes(g):          # a chunk's words and its x at 64 token rows
        return 4 * (wpu * (1 << g) * (bn + 4) + 64 * (((umax << g) * slots + 8) // 2))
    g = 0
    while rmin % (2 << g) == 0:
        g += 1
        if stage_bytes(g) > MID_STAGE_BYTES:
            g -= 1
            break
    while (umax << g) * slots < 16:
        g += 1

    def items():
        return tiles * nk * (rmin >> g)
    while (g > 1 and items() < want and (umax << (g - 1)) >= 8
           and (umax << (g - 1)) * slots >= 32):
        g -= 1
    return (tiles + min(items(), MID_CTAS_PER_SM * sms)) * bn, tiles


def mid_plan(device, bits, N: int, K: int, block: int):
    """(partial floats per activation row, column tiles) of a short-prefill
    launch (``nq_mid_workspace``, the plan the launch itself follows);
    cached per shape.  The plan does not depend on M."""
    key = (device.index, tuple(bits), N, K, block)
    if key not in _mid_plans:
        arr = (ctypes.c_int * len(bits))(*bits)
        tiles = ctypes.c_int(0)
        n = library("nest_matmul_mid.cu").nq_mid_workspace(
            ctypes.addressof(arr), len(bits), N, K, block, ctypes.byref(tiles))
        if n < 1:
            raise ValueError(f"the short-prefill body refuses bits {tuple(bits)}, N={N}, "
                             f"K={K}, block={block}")
        _mid_plans[key] = (n, tiles.value)
    return _mid_plans[key]


# the f32 body's plan constants (csrc/nest_matmul_f32.cu): CTAs per SM its
# split plan counts on, K steps (32 codes each) a split run takes at least,
# and a tile's split slots at most (bytes)
F32_CTAS_PER_SM, F32_MIN_STEPS, F32_SLOT_BYTES = 2, 4, 512 * 1024


def f32_workspace(M: int, N: int, K: int, block: int, sms: int):
    """(f32 partials, output tiles) of an f32-body launch of M rows on a card
    of ``sms`` SMs: ``f32_bn``, ``f32_runs`` and ``f32_workspace`` of
    ``csrc/nest_matmul_f32.cu`` in Python (a gpu test holds the two equal).
    BM x BN tiles: BN 128, or 32 where 128-wide tiles would fill fewer
    than a quarter of the SMs and 32-wide ones leave a CTA at most 3x the K
    steps; BM 32 to M 32, 64 to M 64 and at BN 32, else 128.  Where the
    tiles fill fewer than the SMs, K (block / 32 steps a pack block) is
    split into runs of at least ``F32_MIN_STEPS`` steps, as many as keep
    the CTAs within ``F32_CTAS_PER_SM`` per SM and a tile's slots within
    ``F32_SLOT_BYTES``, each run a (M, N) slot; none otherwise."""
    nsteps = -(-K // block) * (block // 32)

    def bm(bn):
        return 32 if M <= 32 else 64 if M <= 64 or bn == 32 else 128

    def tiles(bn):
        return -(-M // bm(bn)) * -(-N // bn)

    def runs(bn):
        if tiles(bn) >= sms:
            return 1
        return max(1, min(F32_CTAS_PER_SM * sms // tiles(bn), nsteps // F32_MIN_STEPS,
                          F32_SLOT_BYTES // (4 * bm(bn) * bn)))
    bn = 128
    if 4 * tiles(128) <= sms and -(-nsteps // runs(32)) <= 3 * -(-nsteps // runs(128)):
        bn = 32
    splits = runs(bn)
    return (splits * M * N if splits > 1 else 0), tiles(bn)


_sms: Dict[int, int] = {}


def device_sms(device) -> int:
    """SMs of a CUDA device (132 on an H100 SXM), read once per device."""
    import torch

    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device.index]


def stream_matmul_buffers(x, N: int, K: int, block: int, out_dtype, body: int, bits,
                          out=None):
    """Output (``out`` where the caller gives one: a row slice of a larger
    output), f32 partials, arrival counters and the current stream handle
    for one stream-matmul launch on ``body`` (0 CUDA cores, 1 tensor cores,
    2 decode, 3 short prefill, 4 f32; ``dispatch.BODY``).  The CUDA-core
    body splits K over every pack block: (nk, M, N) partials added by a
    second pass.  The decode and short-prefill bodies' CTAs each take an
    equal run of (pack block, column tile, chunk) items: one partial row
    per run of one tile, added by the tile's last CTA.  The f32 body splits
    K into runs of steps where its tiles fill fewer than the SMs: one (M,
    N) slot per run, added by the tile's last run (``f32_workspace``).
    The three share the stream's arrival counters.  The tensor-core body
    (and the f32 body where it does not split K) takes no workspace
    (None).  The kernel allocates nothing itself."""
    import torch

    M = x.shape[0]
    if out is None:
        out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    partial = counters = None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    nk = -(-K // block)
    if body == 0 and nk > 1:
        partial = torch.empty((nk, M, N), dtype=torch.float32, device=x.device)
    elif body in (2, MID_BODY):
        plan = dec_plan if body == 2 else mid_plan
        per_row, tiles = plan(x.device, bits, N, K, block)
        partial = torch.empty(per_row * M, dtype=torch.float32, device=x.device)
        counters = dec_counters(x.device, tiles, stream)
    elif body == F32_BODY:
        floats, tiles = f32_workspace(M, N, K, block, device_sms(x.device))
        if floats:
            partial = torch.empty(floats, dtype=torch.float32, device=x.device)
            counters = dec_counters(x.device, tiles, stream)
    return out, partial, counters, stream


def streams_matmul(x, streams, bits, scale, *, K: int, block: int, out_dtype, body: int,
                   out=None, what: str = "streams_matmul"):
    """One launch of the short-prefill body (``nq_mid_matmul``, body 3:
    bf16 ``x``, M <= 64) or the f32 body (``nq_f32_matmul``, body 4: f32
    ``x``) on the word streams of ascending ``bits``: the launch K1, K2 and
    K3 make on that body."""
    import torch

    N = streams[0].shape[1]
    out, partial, counters, stream = stream_matmul_buffers(x, N, K, block, out_dtype, body,
                                                           bits, out)
    ptrs = (ctypes.c_void_p * len(streams))(*[s.data_ptr() for s in streams])
    bit_arr = (ctypes.c_int * len(bits))(*bits)
    source, entry = STREAMS_ENTRY[body]
    err = getattr(library(source), entry)(
        ptr(x), ctypes.addressof(ptrs), ctypes.addressof(bit_arr), len(streams), ptr(scale),
        ptr(out), int(out_dtype == torch.float32), ptr(partial), numel(partial),
        ptr(counters), numel(counters), x.shape[0], N, K, block, stream)
    check(err, what)
    return out


def ptr(t) -> int:
    """Device address of a tensor (0 for None), for a ``c_void_p`` argument."""
    return 0 if t is None else t.data_ptr()


def numel(t) -> int:
    """Elements of a tensor (0 for None), for a ``c_int`` argument."""
    return 0 if t is None else t.numel()
