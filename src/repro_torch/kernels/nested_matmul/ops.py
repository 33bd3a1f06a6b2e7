"""Public wrappers of the dual-stream (K2) and ladder (K3) matmuls: device
dispatch; counterpart of ``repro/kernels/nested_matmul/ops.py``.  An
abstract tensor (``dispatch.is_abstract``) takes neither: each wrapper
counts the launches the card would make (``dispatch.launch_abstract``)."""
from __future__ import annotations

from .. import dispatch
from . import kernel, ref

DEFAULT_BLOCK_K = 512
NESTED_COUNTER = dispatch.counter("nested_matmul")
LADDER_COUNTER = dispatch.counter("ladder_matmul")


def nested_matmul(x, words_high, words_low, scale, *, n: int, h: int, K: int,
                  block_k: int = DEFAULT_BLOCK_K, out_dtype=None, route=None):
    """y = x @ dequant(recompose(words_high, words_low)), x (..., K).  A
    CUDA tensor launches the K2 kernel (or raises) on the body
    ``dispatch.kernel_route`` picks (``route`` as in K1's wrapper); a CPU
    tensor runs the plain version."""
    out_dtype = out_dtype or x.dtype
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1])
    if dispatch.is_abstract(x2):
        route = dispatch.abstract_route(x2, route)
        dispatch.check_operands(x2, (words_high, words_low), (h, n), scale,
                                K=K, block=block_k, out_dtype=out_dtype)
        y = dispatch.launch_abstract(x2, words_high.shape[1], out_dtype, route,
                                     NESTED_COUNTER, (words_high, words_low), (h, n),
                                     block_k)
    elif dispatch.takes_kernel(x2):
        route = dispatch.kernel_route(x2, route)
        dispatch.check_operands(x2, (words_high, words_low), (h, n), scale,
                                K=K, block=block_k, out_dtype=out_dtype)
        y = dispatch.launch_matmul(
            x2, words_high.shape[1], out_dtype, route, NESTED_COUNTER,
            lambda xs, out, body: kernel.nested_matmul(
                xs, words_high, words_low, scale, n=n, h=h, K=K, block_k=block_k,
                out_dtype=out_dtype, body=body, out=out), streams=2)
    else:
        y = ref.nested_matmul_ref(x2, words_high, words_low, scale, n=n, h=h,
                                  K=K, block_k=block_k, out_dtype=out_dtype)
        NESTED_COUNTER.plain_launches += 1
    return y.reshape(lead + (y.shape[-1],))


def ladder_matmul(x, streams, scale, *, bits, K: int,
                  block_k: int = DEFAULT_BLOCK_K, out_dtype=None, route=None):
    """y = x @ dequant(chain-recompose(streams)) for a rung with
    ``len(streams)`` resident streams (bits ascending, one per stream;
    scale = the rung scale).  A CUDA tensor launches the K3 kernel, which
    takes up to 4 streams (a 4-rung ladder) and raises above, on the body
    ``dispatch.kernel_route`` picks (``route`` as in K1's wrapper); a CPU
    tensor runs the plain version."""
    out_dtype = out_dtype or x.dtype
    streams, bits = tuple(streams), tuple(bits)
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1])
    if dispatch.is_abstract(x2):
        route = dispatch.abstract_route(x2, route)
        dispatch.check_operands(x2, streams, bits, scale, K=K, block=block_k,
                                out_dtype=out_dtype)
        y = dispatch.launch_abstract(x2, streams[0].shape[1], out_dtype, route,
                                     LADDER_COUNTER, streams, bits, block_k)
    elif dispatch.takes_kernel(x2):
        route = dispatch.kernel_route(x2, route)
        dispatch.check_operands(x2, streams, bits, scale, K=K, block=block_k,
                                out_dtype=out_dtype)
        y = dispatch.launch_matmul(
            x2, streams[0].shape[1], out_dtype, route, LADDER_COUNTER,
            lambda xs, out, body: kernel.ladder_matmul(
                xs, streams, scale, bits=bits, K=K, block_k=block_k,
                out_dtype=out_dtype, body=body, out=out), streams=len(streams))
    else:
        y = ref.ladder_matmul_ref(x2, streams, scale, bits=bits, K=K,
                                  block_k=block_k, out_dtype=out_dtype)
        LADDER_COUNTER.plain_launches += 1
    return y.reshape(lead + (y.shape[-1],))
