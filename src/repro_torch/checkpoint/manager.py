"""Fault-tolerant checkpoint manager; counterpart of
``repro/checkpoint/manager.py``, in its on-disk layout.

A checkpoint of step s is the directory ``step_%010d`` holding
``arrays.npz`` (one array ``a{i}`` per leaf, in sorted key order; bf16
widened to f32, exactly, since npz has no bf16) and ``manifest.json``
(``step``, ``time``, ``keys``, ``extra``).  A save writes a
``.tmp_{step}_*`` directory and renames it into place with ``os.replace``,
so a crash leaves either the old checkpoint or the new one; only the
newest ``keep`` are kept.

Keys are the reference's ``jax.tree_util.keystr`` paths: a dict key is
``tree.keystr``'s ``['name']``, a NamedTuple field (``AdamWState``)
``.name``, and a ``NestedTensor``'s packed words and scale its pytree
children ``[<flat index i>]`` (base stream, deltas, scale; a paged-out
delta has none).  So a tree shaped as the reference's restores from the
reference's checkpoint, and packed trees round-trip their int32 words and
f32 scales without densifying.  ``restore(template, step, device)`` puts
each leaf on ``device`` (default: the template leaf's), in the template's
dtype.

Mesh-reshardable, as the reference's (the elastic-scaling path):
``save(..., mesh, pspecs)`` takes a tree of this rank's blocks (laid out
as ``pspecs`` on ``mesh``), gathers the whole arrays and writes them from
one rank in the format above, so a checkpoint written sharded, on one
card or by the JAX package is one format; ``restore(..., mesh, pspecs)``
gives each rank its own block of every leaf, on any mesh shape.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tree
from ..core.nesting import NestedTensor


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _flatten(t, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) pairs of a tree of dicts, NamedTuples and
    NestedTensors."""
    if isinstance(t, dict):
        return [kv for k in sorted(t) for kv in _flatten(t[k], prefix + tree.keystr((k,)))]
    if _is_namedtuple(t):
        return [kv for f in t._fields for kv in _flatten(getattr(t, f), f"{prefix}.{f}")]
    if isinstance(t, NestedTensor):
        children = (t.w_base,) + tuple(t.deltas) + (t.scale,)
        return [(f"{prefix}[<flat index {i}>]", c) for i, c in enumerate(children)
                if c is not None]
    if t is None:
        return []
    return [(prefix, t)]


def _rebuild(t, get, prefix: str = ""):
    """``t``'s structure with each leaf replaced by ``get(keystr, leaf)``."""
    if isinstance(t, dict):
        return {k: _rebuild(t[k], get, prefix + tree.keystr((k,))) for k in t}
    if _is_namedtuple(t):
        return type(t)(*(_rebuild(getattr(t, f), get, f"{prefix}.{f}") for f in t._fields))
    if isinstance(t, NestedTensor):
        n = 1 + len(t.deltas)
        kids = [None if c is None else get(f"{prefix}[<flat index {i}>]", c)
                for i, c in enumerate((t.w_base,) + tuple(t.deltas) + (t.scale,))]
        return t._replace(w_base=kids[0], deltas=tuple(kids[1:n]), scale=kids[n])
    if t is None:
        return None
    return get(prefix, t)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            # npz has no bf16; widen losslessly (restore() re-casts to the
            # template's dtype)
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _read_npz(path: str, keys: List[str]) -> Dict[str, np.ndarray]:
    """Every array ``a{i}`` of an npz, by key, read by a pool of threads
    (one array per task, each on its own file handle: reading a member and
    checking its CRC-32 release the GIL, and one thread reads ~0.5 GB/s)."""
    def read(i):
        with np.load(path) as data:
            return data[f"a{i}"]

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return dict(zip(keys, pool.map(read, range(len(keys)))))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree_, extra: Optional[Dict] = None, mesh=None,
             pspecs=None) -> str:
        """Atomic save of a tree at ``step``.  With (``mesh``, ``pspecs``)
        ``tree_`` is this rank's blocks: every rank of the mesh calls this,
        the whole arrays are gathered and mesh rank 0 writes them; the
        others wait for it."""
        final = os.path.join(self.dir, f"step_{step:010d}")
        if mesh is not None and mesh.size > 1:
            import torch.distributed as dist

            from ..distributed.sharding import gather_tree
            tree_ = gather_tree(tree_, pspecs, mesh)
            if mesh.coord(tuple(mesh.axis_names)) == 0:
                self._write(step, tree_, extra)
            dist.barrier(group=mesh.group(tuple(mesh.axis_names)))
            return final
        self._write(step, tree_, extra)
        return final

    def _write(self, step: int, tree_, extra: Optional[Dict]) -> None:
        flat = dict(_flatten(tree_))
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=f".tmp_{step}_")
        try:
            keys = sorted(flat)
            arrays = {f"a{i}": _to_numpy(flat[k]) for i, k in enumerate(keys)}
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            del arrays
            manifest = {"step": step, "time": time.time(), "keys": keys,
                        "extra": extra or {}}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.dir, f"step_{step:010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def restore(self, template, step: Optional[int] = None, device=None, mesh=None,
                pspecs=None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``template`` -> (tree, manifest).
        Each leaf takes its template leaf's dtype and lands on ``device``
        (default: the template leaf's device; with a mesh, the mesh's).

        With (``mesh``, ``pspecs``) each leaf is this rank's block of it
        under its spec (the template holds whole shapes; meta tensors
        will do) - the mesh-reshard path for elastic scaling."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = _read_npz(os.path.join(path, "arrays.npz"), manifest["keys"])
        n_leaves = len(_flatten(template))

        def get(key, tmpl):
            if key not in by_key:
                raise KeyError(
                    f"checkpoint step {step} has no entry for {key!r} "
                    f"(template has {n_leaves} leaves, checkpoint "
                    f"{len(by_key)}) - wrong template structure?")
            arr = by_key[key]
            if isinstance(tmpl, torch.Tensor):
                out = torch.from_numpy(np.array(arr, order="C"))   # 0-d stays 0-d
                if mesh is not None:              # cut on the host, then placed
                    return out.to(dtype=tmpl.dtype)
                return out.to(device=tmpl.device if device is None else device,
                              dtype=tmpl.dtype)
            if hasattr(tmpl, "dtype"):
                return arr.astype(tmpl.dtype)
            return arr

        restored = _rebuild(template, get)
        if mesh is not None:
            from ..distributed.sharding import shard_tree
            dev = mesh.device if device is None else device
            restored = _rebuild(shard_tree(restored, pspecs, mesh),
                                lambda _, x: x.to(dev) if isinstance(x, torch.Tensor) else x)
        return restored, manifest
