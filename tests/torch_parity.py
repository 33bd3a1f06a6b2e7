"""Helpers for the port's parity tests: move the JAX package's arrays and
trees to the port through numpy, bit for bit, and back."""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.nesting import NestedTensor as JaxNested
from repro_torch import convert


def to_numpy_leaf(x):
    """A JAX array -> numpy, bf16 as its uint16 bits (``Bf16Array``)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return convert.Bf16Array(a.view(np.uint16))
    return a


def jax_tree_to_numpy(params):
    """A JAX parameter tree (possibly nested) -> the numpy handover format."""
    def leaf(x):
        if isinstance(x, JaxNested):
            return convert.NestedArrays(
                w_base=np.asarray(x.w_base),
                deltas=tuple(None if d is None else np.asarray(d) for d in x.deltas),
                scale=np.asarray(x.scale), shape=tuple(x.shape),
                bits=tuple(x.bits), block=x.block, rung=x.rung)
        return to_numpy_leaf(x)
    return jax.tree_util.tree_map(leaf, params,
                                  is_leaf=lambda x: isinstance(x, JaxNested))


def jax_tree_to_torch(params, device="cpu"):
    return convert.params_from_numpy(jax_tree_to_numpy(params), device)


def t2n(t: torch.Tensor) -> np.ndarray:
    """A torch tensor -> numpy (bf16 widened to f32, exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def j2n(x) -> np.ndarray:
    """A JAX array -> numpy (bf16 widened to f32, exactly)."""
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


@functools.lru_cache(maxsize=None)
def reduced_qwen2(seed: int = 0):
    """Reduced qwen2-1.5b in the JAX package: (config, dense params, their
    rtn (8, 6, 4) nesting).  Cached: the model and engine tests share one
    JAX quantization in a process.  It runs under ``jax.jit`` (one compile
    instead of hundreds of eager ones); XLA may round a few scales one ulp
    away from the eager result, and the codes are the same.  The tree is
    the input of both packages here, and eager quantization is held bit for
    bit in tests/test_torch_quant.py."""
    from repro.configs import get_config
    from repro.core.recipe import QuantRecipe, quantize
    from repro.models import make_model

    cfg = get_config("qwen2-1.5b").reduced()
    dense = make_model(cfg).init(jax.random.PRNGKey(seed))
    recipe = QuantRecipe(bits=(8, 6, 4), rounding="rtn")
    return cfg, dense, jax.jit(lambda p: quantize(p, recipe))(dense)


@contextlib.contextmanager
def shared_jax_compiles():
    """Inside this block the JAX package's engines, fleets and CLIs share one
    model per config and one jitted function per (function, options), as
    the JAX package's own ``build_fleet`` shares one jitted triple across
    replicas: a test module that runs many fleets and CLIs compiles each
    (rung, shape) once instead of once per run.  Nothing the JAX package
    computes changes; only its ``make_model`` and ``jax.jit`` are wrapped,
    and only for the block."""
    import pytest

    import repro.launch.fleet as jfleet_cli
    import repro.launch.serve as jserve_cli
    import repro.models as jmodels
    import repro.serving.engine as jengine

    make_model = functools.lru_cache(maxsize=None)(jmodels.make_model)
    real_jit, jitted = jax.jit, {}

    def jit(fun, **kw):
        try:
            key = (fun, tuple(sorted(kw.items())))
            hash(key)
        except TypeError:
            return real_jit(fun, **kw)
        if key not in jitted:
            jitted[key] = real_jit(fun, **kw)
        return jitted[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", jit)
        for mod in (jmodels, jengine, jserve_cli, jfleet_cli):
            mp.setattr(mod, "make_model", make_model)
        yield


# ---------------------------------------------------------------------------
# kernel cases: the plain versions of K1-K3 against the JAX kernels
# ---------------------------------------------------------------------------
KERNEL_MS = (1, 5, 8, 130)
KERNEL_KS = (512, 1024)
KERNEL_N = 256
# the reference's own tolerances (tests/test_kernels.py:34)
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def stream_operands(bits, rung, K, seed):
    """Random packed streams of rung ``rung`` of ladder ``bits`` (base and
    deltas at their stored widths), a per-column scale and the pack block;
    numpy words packed by the JAX package."""
    from repro.core import packing as jp

    rng = np.random.default_rng(seed)
    b = tuple(sorted(bits))[:rung + 1]
    widths = [b[0]] + [b[i] - b[i - 1] + 1 for i in range(1, len(b))]
    block = 256 if K == 512 else 512
    words = []
    for w in widths:
        codes = rng.integers(-(2 ** (w - 1)), 2 ** (w - 1), size=(K, KERNEL_N))
        words.append(np.asarray(jax.jit(jp.pack_blocked, static_argnums=(1, 2))(
            jnp.asarray(codes, jnp.int32), w, block)))
    scale = rng.uniform(0.01, 0.1, size=(1, KERNEL_N)).astype(np.float32)
    return b, words, scale, block


def activations(M, K, dtype, seed):
    """The same activations for both packages: (jax array, torch tensor)."""
    x = np.random.default_rng(seed).normal(size=(M, K)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return xj, convert.tensor_from_numpy(to_numpy_leaf(xj), "cpu")


def assert_close(port: torch.Tensor, ref, dtype: str):
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(t2n(port), j2n(ref), rtol=tol, atol=tol * 20)


def to_torch(x) -> torch.Tensor:
    """A JAX array -> a CPU torch tensor, bit for bit (int32 words and codes
    through ``convert.words_from_numpy``)."""
    a = to_numpy_leaf(x)
    if isinstance(a, np.ndarray) and a.dtype == np.int32:
        return convert.words_from_numpy(a, "cpu")
    return convert.tensor_from_numpy(a, "cpu")


# ---------------------------------------------------------------------------
# K4-K6 cases: the JAX kernels in interpret mode, one compile per shape and
# ladder in a process (the test files share these)
# ---------------------------------------------------------------------------
KV_PAGE = 4


@functools.lru_cache(maxsize=None)
def kv_values(shape, seed):
    """(BH, S, D) f32 normal values from a numpy seed."""
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_kv_streams(shape, bits, page, seed):
    """Per-position INT-bits[-1] codes of ``kv_values`` split down the
    ladder and packed along positions (block = page) by the JAX package,
    as its kernel tests make them: (streams, scale) as numpy."""
    from repro.core import packing as jp
    from repro.core.decompose import chain_decompose, int_range
    from repro.serving.kv_cache import kv_stream_widths

    x = jnp.asarray(kv_values(shape, seed))
    lo, hi = int_range(bits[-1])
    scale = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True), 1e-8) / hi
    codes = jnp.clip(jnp.round(x / scale), lo, hi).astype(jnp.int32)
    base, deltas = chain_decompose(codes, bits, "rtn")
    streams = tuple(np.asarray(jp.pack_blocked(c, w, page, axis=1))
                    for c, w in zip((base, *deltas), kv_stream_widths(bits)))
    return streams, np.asarray(scale)


@functools.lru_cache(maxsize=None)
def jax_nested_qk(q_shape, k_shape, bits, rung, page, seed):
    """The JAX K4 kernel in interpret mode on seeded queries and K pages:
    (query codes, raw int32 scores) as numpy."""
    from repro.kernels.nested_attention.kernel import nested_qk
    from repro.kernels.nested_attention.ops import quantize_q

    streams, _ = jax_kv_streams(k_shape, bits, page, seed + 1)
    qc, _ = quantize_q(jnp.asarray(kv_values(q_shape, seed)), bits[-1])
    out = nested_qk(qc, tuple(jnp.asarray(s) for s in streams[:rung + 1]),
                    bits=bits[:rung + 1], page=page, interpret=True)
    return np.asarray(qc), np.asarray(out)


@functools.lru_cache(maxsize=None)
def flash_inputs(dims, dtype, seed):
    """Seeded q, k, v (B,S,H,hd) for both packages: JAX arrays and torch
    tensors of the same values."""
    B, S, Hq, Hkv, hd = dims
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out = []
    for h in (Hq, Hkv, Hkv):
        x = jnp.asarray(rng.normal(size=(B, S, h, hd)).astype(np.float32), jdt)
        out.append((x, to_torch(x)))
    return out


@functools.lru_cache(maxsize=None)
def jax_flash(dims, dtype, seed, block):
    """The JAX K5 kernel in interpret mode (``block`` = block_q = block_kv)."""
    from repro.kernels.flash_attention import kernel as fa_kernel

    (q, _), (k, _), (v, _) = flash_inputs(dims, dtype, seed)
    return j2n(fa_kernel.flash_attention(q, k, v, block_q=block, block_kv=block,
                                         interpret=True))


@functools.lru_cache(maxsize=None)
def jax_recompose(n, h, K, N, block, seed):
    """Seeded INT-n codes split into (w_high, w_low), packed by the JAX
    package, and the JAX K6 kernel's int8 output in interpret mode: numpy
    (codes, words_high, words_low, out)."""
    from repro.core import packing as jp
    from repro.core.decompose import decompose, int_range
    from repro.kernels.nest_recompose import kernel as nr_kernel

    lo, hi = int_range(n)
    w_int = jnp.asarray(np.random.default_rng(seed).integers(lo, hi + 1, size=(K, N)),
                        jnp.int32)
    wh, wl = decompose(w_int, n, h, method="adaptive")
    wph = jp.pack_blocked(wh, h, block, axis=0)
    wpl = jp.pack_blocked(wl, n - h + 1, block, axis=0)
    out = nr_kernel.nest_recompose(wph, wpl, n=n, h=h, K=K, block_k=block, interpret=True)
    return np.asarray(w_int), np.asarray(wph), np.asarray(wpl), np.asarray(out)


@functools.lru_cache(maxsize=None)
def jax_recompose_ref(n, h, K, N, block, seed):
    """Seeded INT-n codes (the range's two ends in the first rows) split into
    (w_high, w_low) and packed by the JAX package, and the output of the
    JAX package's plain recompose (``repro/kernels/nest_recompose/ref.py``),
    which takes any K, N and pack block: numpy (codes, words_high,
    words_low, out)."""
    from repro.core import packing as jp
    from repro.core.decompose import decompose, int_range
    from repro.kernels.nest_recompose import ref as nr_ref

    lo, hi = int_range(n)
    codes = np.random.default_rng(seed).integers(lo, hi + 1, size=(K, N))
    codes[0], codes[1] = lo, hi
    w_int = jnp.asarray(codes, jnp.int32)
    wh, wl = decompose(w_int, n, h, method="adaptive")
    wph = jp.pack_blocked(wh, h, block, axis=0)
    wpl = jp.pack_blocked(wl, n - h + 1, block, axis=0)
    out = nr_ref.recompose_ref(wph, wpl, n=n, h=h, K=K, block_k=block)
    return np.asarray(w_int), np.asarray(wph), np.asarray(wpl), np.asarray(out)
