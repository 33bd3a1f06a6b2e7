"""What one sharded step costs on one rank, counted on fake tensors;
counterpart of ``repro/launch/hlo_analysis.py``.

The reference compiles each step with XLA and parses the partitioned,
optimized HLO (``compiled.as_text()``): that text is the program the TPU
runs, so its dots, fusions and collectives are the step's work.  The
port has no compiler between the step and the card: the step is eager
PyTorch, and the ops it dispatches, one by one, are what the card runs.
So this module parses nothing.  It runs the step once, on one rank of a
fake world (``launch/mesh.py::fake_world``: collectives return at once)
over fake tensors (``FakeTensorMode``: shapes, dtypes and a device, no
storage, nothing launched), and counts with torch's own tools:

* aten FLOPs: ``FlopCounterMode`` (matmuls, convolutions and attention
  ops; elementwise ops count 0, as the reference counts dots and
  convolutions only);
* HBM bytes: :class:`_Tally`, a ``TorchDispatchMode`` that adds each aten
  op's input and output bytes.  Views, ``detach``, aliases, metadata ops
  and allocations move nothing and are left out (the reference's
  ``_SKIP_BYTES``); an op that overwrites its first argument without
  reading it (``copy_``, ``fill_``, ``zero_``) is not charged the read.
  A copy between host and card crosses the host link, not HBM: it is
  counted apart (``transfer_bytes``), so a step on fake CUDA tensors
  counts the same HBM bytes as on fake CPU tensors, where its host
  scalars (the learning rate) need no copy.  There is no fusion: every
  op reads and writes HBM, as eager PyTorch does on the card;
* the hand-written kernels: on a fake tensor each wrapper takes its
  abstract route (``kernels/dispatch.py``) and counts the launches the
  card would make (``dry_launches``, by body) and their work from
  ``kernels/costs.py``, which is added to the aten counts;
* collectives: ``comm.COUNTS``, reset first: calls, payload and wire
  bytes per collective.  Wire follows the port's ring convention
  (``distributed/comm.py``): 2 (n - 1) / n of the tensor for an
  all-reduce, where the reference counts 2x, and the n - 1 parts received
  for an all-gather;
* memory: ``MemTracker``'s peak over the call, the arguments (tracked
  before it) included; the local shards' bytes are ``argument_bytes``.

Eager Python runs every layer and microbatch, so no count is multiplied
by a loop's trip count, and a remat recompute is counted as it runs.
Every count is that rank's and per card; ``launch/dryrun.py`` picks the
ranks whose work differs and sums them for a global total.  The tally
behind :func:`top_contributors` keys each op by where the port's code
called it (``file:function``, or the autograd node in a backward).
"""
from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..core.nesting import NestedTensor
from ..distributed import comm
from ..kernels import costs as card
from ..kernels import dispatch

# ops that move no bytes: aliases, metadata and allocations (views are
# found by their schema, ``OpOverload.is_view``)
_SKIP_BYTES = {
    "detach", "alias", "lift_fresh", "_unsafe_view", "_reshape_alias", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "_local_scalar_dense", "resize_", "set_", "scalar_tensor",
}
# ops that overwrite their first argument without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_"}
# the copies that may move a tensor between host and card
_COPIES = {"_to_copy", "copy_"}
_PKG = str(Path(__file__).resolve().parents[1])
# files whose frames are plumbing between the model code and an op
_PLUMBING = tuple(str(Path(_PKG, f)) for f in (
    "launch/step_analysis.py", "distributed/comm.py", "distributed/ctx.py",
    "models/layers.py", "kernels"))


@dataclass
class StepCosts:
    """Rank 0's counts of one step call (the counterpart of ``HloCosts``)."""
    chips: int = 1
    flops: float = 0.0               # aten + kernels
    aten_flops: float = 0.0
    kernel_flops: float = 0.0
    bytes: float = 0.0               # aten + kernels
    aten_bytes: float = 0.0
    kernel_bytes: float = 0.0
    transfer_bytes: float = 0.0      # copies between host and card
    collective_bytes: float = 0.0    # wire
    per_collective: Dict[str, float] = field(default_factory=dict)    # wire
    num_collectives: Dict[str, int] = field(default_factory=dict)
    payload_bytes: Dict[str, int] = field(default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    trace_s: float = 0.0
    # (kind, op, where) -> flops, bytes, wire or transfer bytes
    tally: Dict[Tuple[str, str, str], float] = field(default_factory=dict)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _distinct(leaves):
    """The tensors among ``leaves``, each once."""
    out, seen = [], set()
    for t in leaves:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


_FILES: Dict[str, str] = {}     # a frame's file -> its name in the package, or ""


def _where() -> str:
    """The port's code that called the op being counted: the autograd node
    in a backward, else the innermost frame of the package that is no
    plumbing (``file:function``)."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"backward:{node.name()}"
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        name = _FILES.get(path)
        if name is None:
            name = _FILES[path] = (str(Path(path).relative_to(_PKG)) if path.startswith(_PKG)
                                   and not path.startswith(_PLUMBING) else "")
        if name:
            return f"{name}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


class _Tally(TorchDispatchMode):
    """Adds each aten op's bytes (and, from ``FlopCounterMode``'s formulas,
    its FLOPs) to the tally under (kind, op, where)."""

    def __init__(self, tally):
        super().__init__()
        self.tally = tally
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        name = func.overloadpacket.__name__
        packet = func.overloadpacket
        where = None
        if packet in self.flop_registry:
            flops = self.flop_registry[packet](*args, **kwargs, out_val=out)
            if flops:
                where = _where()
                self.tally[("flops", name, where)] += flops
        if func.is_view or name in _SKIP_BYTES:
            return out
        ins = _distinct(tree_leaves((args, kwargs)))
        if name in _WRITE_ONLY:
            ins = ins[1:]
        outs = _distinct(tree_leaves(out))
        # an in-place op's output is its first argument: read, then written
        nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        kind = "bytes"
        if name in _COPIES and len({t.device for t in ins + outs}) > 1:
            kind = "transfer"          # between host and card: the link's bytes, not HBM's
        if nbytes:
            self.tally[(kind, name, where or _where())] += nbytes
        return out

    def collective(self, op: str, payload: int, wire: float) -> None:
        self.tally[("collective", op, _where())] += wire


def _map(obj, fn):
    """``obj`` with every tensor (NestedTensor streams included) mapped by
    ``fn``: dicts, lists, tuples and named tuples rebuilt."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, NestedTensor):
        return obj._replace(w_base=fn(obj.w_base),
                            deltas=tuple(None if d is None else fn(d) for d in obj.deltas),
                            scale=fn(obj.scale))
    if isinstance(obj, dict):
        return {k: _map(v, fn) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map(v, fn) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(v, fn) for v in obj)
    return obj


def tensors(obj):
    """Every tensor in ``obj`` (as :func:`_map` walks it), in order."""
    out = []
    _map(obj, lambda t: out.append(t) or t)
    return out


def _dry_counts():
    return {name: (c.dry_launches, c.dry_dec_launches, c.dry_tc_launches, c.dry_mid_launches,
                   c.dry_f32_launches, c.dry_flops, c.dry_bytes)
            for name, c in dispatch.COUNTERS.items()}


def _real_counts():
    return {name: (c.launches, c.plain_launches) for name, c in dispatch.COUNTERS.items()}


def analyze(step, args, mesh, device, memory: bool = True) -> StepCosts:
    """Run ``step(*args)`` once under ``FakeTensorMode`` and count it.

    ``args``: the step's arguments with abstract tensors (meta tensors of
    this rank's local shapes and dtypes, the counterpart of the
    reference's ``ShapeDtypeStruct``s) and plain Python values; each
    tensor becomes an empty fake tensor on ``device`` ("cuda" or "cpu":
    neither needs a card, but a torch built without CUDA aborts the
    process in a fake CUDA backward).  ``mesh`` is this rank's mesh of a
    ``fake_world``.  ``comm.COUNTS`` is reset first and holds this call's
    collectives after it; the launch counters' ``dry_*`` fields grow by
    this call's launches (the real counts do not move).  ``memory=False``
    leaves the memory tracker out (about 40 % of the time; ``peak_bytes``
    then stays 0)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    device = torch.device(device)
    out = StepCosts(chips=mesh.size)
    tally = defaultdict(float)
    comm.reset_counts()
    before, real = _dry_counts(), _real_counts()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = _map(args, lambda t: torch.empty(t.shape, dtype=t.dtype, device=device))
        leaves = tensors(fake)
        out.argument_bytes = sum(_nbytes(t) for t in leaves)
        mem = MemTracker() if memory else None
        if mem is not None:
            mem.track_external(*leaves)
        flop = FlopCounterMode(display=False)
        counter = _Tally(tally)
        prev, comm.TALLY = comm.TALLY, counter.collective
        try:
            with mem or contextlib.nullcontext(), flop, counter:
                result = step(*fake)
        finally:
            comm.TALLY = prev
        ids = {id(t) for t in leaves}
        out.output_bytes = sum(_nbytes(t) for t in tensors(result) if id(t) not in ids)
        del result
    out.trace_s = time.perf_counter() - t0
    moved = {k: v for k, v in _real_counts().items() if v != real.get(k, (0, 0))}
    if moved:
        raise RuntimeError(f"a fake tensor took a kernel's real or plain route: {moved}")
    if mem is not None:
        out.peak_bytes = int(sum(v["Total"] for v in mem.get_tracker_snapshot("peak").values()))
    out.aten_flops = float(flop.get_total_flops())
    out.aten_bytes = sum(v for (kind, _, _), v in tally.items() if kind == "bytes")
    out.transfer_bytes = sum(v for (kind, _, _), v in tally.items() if kind == "transfer")
    for name, now in _dry_counts().items():
        was = before.get(name, (0, 0, 0, 0, 0, 0.0, 0.0))
        d = [a - b for a, b in zip(now, was)]
        if d[0]:
            out.kernels[name] = {"dry_launches": d[0], "decode": d[1], "tensor_core": d[2],
                                 "mid": d[3], "f32": d[4], "flops": d[5], "bytes": d[6]}
            tally[("flops", f"kernel:{name}", "")] += d[5]
            tally[("bytes", f"kernel:{name}", "")] += d[6]
    out.kernel_flops = sum(k["flops"] for k in out.kernels.values())
    out.kernel_bytes = sum(k["bytes"] for k in out.kernels.values())
    out.flops = out.aten_flops + out.kernel_flops
    out.bytes = out.aten_bytes + out.kernel_bytes
    for op, c in comm.COUNTS.items():
        out.per_collective[op] = c.wire
        out.num_collectives[op] = c.calls
        out.payload_bytes[op] = c.payload
    out.collective_bytes = sum(out.per_collective.values())
    out.tally = dict(tally)
    return out


def roofline_terms(costs: StepCosts) -> Dict[str, Any]:
    """Seconds per step on one card, the three-term roofline of one rank's
    counts at the H100's published rates (``kernels/costs.py``): FLOPs at
    the dense bf16 tensor-core peak (as the reference takes one peak),
    bytes at the HBM rate, wire bytes at NVLink 4's per-direction rate.
    A collective over more than one node's 8 cards (a model axis of 16)
    runs partly over the slower network between nodes, which this term
    does not model: it is a lower bound there."""
    t_compute = costs.flops / card.PEAK_FLOPS[torch.bfloat16]
    t_memory = costs.bytes / card.HBM_BYTES_PER_S
    t_collective = costs.collective_bytes / card.NVLINK_BYTES_PER_S
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_collective), key=lambda kv: kv[1])[0]
    return {"compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_collective, "dominant": dominant}


def top_contributors(costs: StepCosts, kind: str = "bytes", n: int = 15):
    """The tally's largest ``n`` entries of ``kind`` ("bytes", "flops",
    "collective" or "transfer"), as (amount, op, where), largest first."""
    rows = [(v, op, where) for (k, op, where), v in costs.tally.items() if k == kind]
    return sorted(rows, reverse=True)[:n]
