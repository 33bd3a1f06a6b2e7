"""Build and load the port's CUDA kernels.

The sources under ``src/repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into shared libraries with a plain C interface, loaded with
``ctypes`` (seconds to build; nothing includes PyTorch's headers).  A
build happens at first use, into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``); the library name carries a hash of
its source and of the shared ``csrc/*.cuh`` headers, so an edited source
is rebuilt and a stale library is never loaded.  Nothing here runs at import time: the CPU tests import every
module of the port on a machine without ``nvcc``.
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
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # sources share these headers
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}-{digest}.so"
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)]
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
# activation row and column tiles; and its per-column-tile arrival
# counters per (device, stream) (int32, 0 between launches: the last CTA of
# a tile resets its own)
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


def stream_matmul_buffers(x, N: int, K: int, block: int, out_dtype, body: int, bits,
                          out=None):
    """Output (``out`` where the caller gives one: a row slice of a larger
    output), f32 partials, arrival counters and the current stream handle
    for one stream-matmul launch on ``body`` (0 CUDA cores, 1 tensor cores,
    2 decode; ``dispatch.BODY``).  The CUDA-core body splits K over every
    pack block: (nk, M, N) partials added by a second pass.  The decode
    body's CTAs each take an equal run of (pack block, column tile, chunk)
    items: one partial row per run of one tile, added by the tile's last
    CTA.  The tensor-core body takes no workspace (None).  The kernel
    allocates nothing itself."""
    import torch

    M = x.shape[0]
    if out is None:
        out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    partial = counters = None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    nk = -(-K // block)
    if body == 0 and nk > 1:
        partial = torch.empty((nk, M, N), dtype=torch.float32, device=x.device)
    elif body == 2:
        per_row, tiles = dec_plan(x.device, bits, N, K, block)
        partial = torch.empty(per_row * M, dtype=torch.float32, device=x.device)
        counters = dec_counters(x.device, tiles, stream)
    return out, partial, counters, stream


def ptr(t) -> int:
    """Device address of a tensor (0 for None), for a ``c_void_p`` argument."""
    return 0 if t is None else t.data_ptr()


def numel(t) -> int:
    """Elements of a tensor (0 for None), for a ``c_int`` argument."""
    return 0 if t is None else t.numel()
