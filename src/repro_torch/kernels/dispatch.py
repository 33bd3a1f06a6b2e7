"""Where a matmul wrapper runs its work, and the launch counters.

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
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict

import torch


@dataclass
class LaunchCounter:
    """Launch counts of one wrapper: ``launches`` goes up by one where the
    wrapper launches its kernel and nowhere else."""
    name: str
    launches: int = 0
    plain_launches: int = 0


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    return COUNTERS.setdefault(name, LaunchCounter(name))


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.launches = 0
        c.plain_launches = 0


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


def takes_kernel(x: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel or plain route for device {x.device}")
    return not _route.reference


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
