"""On-disk NestQuant artifacts; counterpart of ``repro/storage/artifact.py``,
the same format byte for byte.

An artifact is one directory:

* ``manifest.json`` - format version, the ladder depth, per-leaf metadata
  (pytree path, logical shape, bits, block), the recipe that produced the
  tree, per-segment byte sizes and SHA-256s, per-array offsets and CRC-32s;
* ``base.seg`` - every leaf's packed base words, the f32 scales and the
  dense (non-nested) leaves: everything rung 0 needs;
* ``delta_<k>.seg`` - every leaf's packed level-k delta stream: exactly
  what the rung k -> k+1 upgrade pages in.

Arrays are raw little-endian bytes in the JAX package's leaf order, so for
the same tree both packages write segment files with equal SHA-256s and
each reads the other's.  A bfloat16 leaf is written as its raw 16-bit
patterns under the dtype name ``"bfloat16"`` and read back as a
``torch.bfloat16`` view.  The port's trees are nested dicts, so a path is a
list of ``{"k": key}`` elements; a sequence element (``{"i": index}``,
which the JAX package writes for list nodes) is refused.

A cold boot reads only ``manifest.json`` and ``base.seg``; delta segments
are read on demand by a :class:`~repro_torch.storage.pager.FilePager`, and
may arrive on disk later (progressive delivery, ``ServeEngine.poll_delivery``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tree
from ..core.nesting import NestedTensor
from ..device import resolve_device

MANIFEST = "manifest.json"
FORMAT = "nestquant-artifact"
VERSION = 1

# dtype names in the manifest (numpy's, and ``bfloat16`` as ml_dtypes names it)
_DTYPES = {
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class ArtifactError(RuntimeError):
    """Malformed, corrupted, or not-yet-delivered artifact content."""


def _resolve_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ArtifactError(f"unsupported array dtype {name!r} in the "
                            "artifact") from None


def _host_bytes(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor's raw little-endian bytes as a host uint8 array (one copy
    off the device), and its dtype name in the manifest."""
    try:
        name = _NAMES[t.dtype]
    except KeyError:
        raise ArtifactError(f"unsupported leaf dtype {t.dtype}") from None
    host = t.detach().to("cpu").contiguous()
    return host.reshape(-1).view(torch.uint8).numpy(), name


def _flatten(params) -> List[Tuple[Tuple[str, ...], Any]]:
    """(dict keys, leaf) pairs in ``tree.flatten_with_path`` order."""
    out: List[Tuple[Tuple[str, ...], Any]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (k,))
        elif isinstance(node, (list, tuple)):
            raise ArtifactError(
                f"sequence node at {tree.keystr(prefix)}: the port's "
                "parameter trees are dicts only")
        else:
            out.append((prefix, node))
    walk(params, ())
    return out


def _build_tree(items: List[Tuple[List[dict], Any]]):
    if len(items) == 1 and not items[0][0]:
        return items[0][1]                    # a bare single-leaf artifact
    root: Dict[str, Any] = {}
    for elems, value in items:
        cur = root
        for j, e in enumerate(elems):
            if "k" not in e:
                raise ArtifactError(
                    f"path element {e!r}: sequence nodes are not supported "
                    "(the port's parameter trees are dicts only)")
            if j == len(elems) - 1:
                cur[e["k"]] = value
            else:
                cur = cur.setdefault(e["k"], {})
    return root


class _SegmentWriter:
    """Streams arrays into one segment file, accumulating the SHA-256 and
    recording per-array (offset, nbytes, dtype, shape, crc32)."""

    def __init__(self, dirpath: str, name: str):
        self.name = name
        self.file = f"{name}.seg"
        self._f = open(os.path.join(dirpath, self.file), "wb")
        self._sha = hashlib.sha256()
        self.nbytes = 0

    def put(self, t: torch.Tensor) -> dict:
        raw, dtype = _host_bytes(t)
        spec = {"segment": self.name, "offset": self.nbytes,
                "nbytes": int(raw.size), "dtype": dtype,
                # at least 1-d, as numpy.ascontiguousarray writes a scalar
                "shape": [int(d) for d in t.shape] or [1],
                "crc32": zlib.crc32(raw)}
        self._f.write(raw.data)
        self._sha.update(raw.data)
        self.nbytes += int(raw.size)
        return spec

    def close(self) -> dict:
        self._f.close()
        return {"file": self.file, "nbytes": self.nbytes,
                "sha256": self._sha.hexdigest()}


def save_artifact(nested_params, path: str, recipe=None) -> dict:
    """Serialize a quantized tree (and its recipe) to an artifact directory.

    Every nested leaf must be fully resident (no paged-out delta streams).
    Written atomically: a temp dir beside ``path``, then ``os.replace``.
    Returns the manifest dict."""
    flat = _flatten(nested_params)
    depth = max([1] + [leaf.num_rungs for _, leaf in flat
                       if isinstance(leaf, NestedTensor)])
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".tmp_artifact_")
    writers: List[_SegmentWriter] = []
    try:
        base = _SegmentWriter(tmp, "base")
        writers.append(base)
        deltas = [_SegmentWriter(tmp, f"delta_{i}") for i in range(depth - 1)]
        writers.extend(deltas)
        leaves = []
        for keys, leaf in flat:
            entry: Dict[str, Any] = {"path": tree.keystr(keys),
                                     "elems": [{"k": str(k)} for k in keys]}
            if isinstance(leaf, NestedTensor):
                if leaf.resident_levels != len(leaf.deltas):
                    raise ArtifactError(
                        f"{entry['path']}: delta streams are paged out; "
                        "save_artifact needs the fully resident tree")
                entry.update(
                    kind="nested", shape=list(leaf.shape),
                    bits=list(leaf.bits), block=int(leaf.block),
                    arrays={"base": base.put(leaf.w_base),
                            "scale": base.put(leaf.scale),
                            "deltas": [deltas[i].put(d)
                                       for i, d in enumerate(leaf.deltas)]})
            else:
                entry.update(kind="dense", arrays={"value": base.put(leaf)})
            leaves.append(entry)
        manifest = {
            "format": FORMAT, "version": VERSION,
            "num_delta_levels": depth - 1,
            "recipe": (json.loads(recipe.to_json())
                       if recipe is not None else None),
            "segments": {w.name: w.close() for w in writers},
            "leaves": leaves,
        }
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        final = os.path.abspath(path)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        for w in writers:
            w._f.close()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return manifest


def _read_into(f, nbytes: int, pin: bool) -> torch.Tensor:
    """``nbytes`` from the file's position into a fresh writable host uint8
    tensor (page-locked when ``pin``, so a copy to the card runs at the
    link's rate)."""
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
    got = f.readinto(buf.numpy()) if nbytes else 0
    return buf[:got]


class Artifact:
    """An opened artifact: manifest in memory, segments on disk.

    Counts the bytes actually read per segment (:attr:`bytes_read`,
    :attr:`segments_read`), so a deployment - and the cold-boot tests -
    can assert what really went over the wire."""

    def __init__(self, path: str):
        self.dir = os.path.abspath(path)
        mpath = os.path.join(self.dir, MANIFEST)
        if not os.path.exists(mpath):
            raise FileNotFoundError(f"no {MANIFEST} in {self.dir}")
        with open(mpath) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ArtifactError(f"{mpath} is not a {FORMAT}")
        self._by_path = {l["path"]: l for l in self.manifest["leaves"]}
        self.bytes_read: Dict[str, int] = {"manifest": os.path.getsize(mpath)}
        self.segments_read: set = set()

    # -- manifest-level views ------------------------------------------
    @property
    def num_delta_levels(self) -> int:
        return int(self.manifest["num_delta_levels"])

    @property
    def recipe_dict(self) -> Optional[dict]:
        return self.manifest.get("recipe")

    def leaf(self, path: str) -> dict:
        try:
            return self._by_path[path]
        except KeyError:
            raise KeyError(f"artifact has no leaf {path!r}") from None

    def delta_segment(self, level: int) -> str:
        return f"delta_{level}"

    def segment_nbytes(self, name: str) -> int:
        return int(self.manifest["segments"][name]["nbytes"])

    def total_nbytes(self) -> int:
        """Manifest + every segment: the full artifact on the wire."""
        return (self.bytes_read["manifest"]
                + sum(int(s["nbytes"]) for s in self.manifest["segments"].values()))

    def segment_path(self, name: str) -> str:
        return os.path.join(self.dir, self.manifest["segments"][name]["file"])

    def segment_available(self, name: str) -> bool:
        """Segment file present on disk (delta segments may arrive after
        the base)."""
        return os.path.exists(self.segment_path(name))

    # -- byte-level reads ----------------------------------------------
    def _count(self, name: str, n: int):
        self.bytes_read[name] = self.bytes_read.get(name, 0) + n
        self.segments_read.add(name)

    def read_segment(self, name: str, pin: bool = False) -> torch.Tensor:
        """One whole segment as a host uint8 tensor, verified against its
        SHA-256."""
        if not self.segment_available(name):
            raise ArtifactError(f"segment {name!r} not delivered yet "
                                f"({self.segment_path(name)} missing)")
        meta = self.manifest["segments"][name]
        size = os.path.getsize(self.segment_path(name))
        if size != meta["nbytes"]:
            raise ArtifactError(f"segment {name!r}: {size} bytes on "
                                f"disk, manifest says {meta['nbytes']}")
        with open(self.segment_path(name), "rb") as f:
            raw = _read_into(f, size, pin)
        if hashlib.sha256(raw.numpy().data).hexdigest() != meta["sha256"]:
            raise ArtifactError(f"segment {name!r}: SHA-256 mismatch "
                                "(corrupted artifact)")
        self._count(name, raw.numel())
        return raw

    def read_array(self, spec: dict, verify: bool = True,
                   buf: Optional[torch.Tensor] = None, device="cpu") -> torch.Tensor:
        """One array on ``device`` - from ``buf`` if the caller already
        holds the whole segment, else just that byte range of the segment
        file (through page-locked memory when ``device`` is the card)."""
        device = torch.device(device)
        if buf is not None:
            raw = buf[spec["offset"]:spec["offset"] + spec["nbytes"]]
        else:
            if not self.segment_available(spec["segment"]):
                raise ArtifactError(
                    f"segment {spec['segment']!r} not delivered yet")
            with open(self.segment_path(spec["segment"]), "rb") as f:
                f.seek(spec["offset"])
                raw = _read_into(f, spec["nbytes"], device.type == "cuda")
            self._count(spec["segment"], raw.numel())
        if raw.numel() != spec["nbytes"]:
            raise ArtifactError(f"short read in {spec['segment']!r} at "
                                f"offset {spec['offset']}")
        if verify:
            observed = zlib.crc32(raw.numpy().data)
            if observed != spec["crc32"]:
                from .pager import CorruptStreamError   # lazy: no cycle
                raise CorruptStreamError(
                    f"CRC-32 mismatch in {spec['segment']!r} at offset "
                    f"{spec['offset']}: expected {spec['crc32']:#010x}, "
                    f"observed {observed:#010x} (corrupted artifact)")
        # a fresh, aligned copy on the target (the buffer is uint8 at any offset)
        out = raw.to(device, copy=True)
        return out.view(_resolve_dtype(spec["dtype"])).reshape(tuple(spec["shape"]))

    def verify(self):
        """Check every delivered segment against its SHA-256."""
        for name in self.manifest["segments"]:
            if self.segment_available(name):
                self.read_segment(name)

    # -- boot ----------------------------------------------------------
    def load_base_tree(self, device=None):
        """The nested tree from the manifest and the base segment ONLY, on
        ``device`` (default: the card).

        Nested leaves come back at rung 0 with every delta slot ``None``
        (a pager supplies them on upgrade); dense leaves come back whole."""
        device = resolve_device(device)
        buf = self.read_segment("base", pin=device.type == "cuda")
        items = []
        for entry in self.manifest["leaves"]:
            a = entry["arrays"]
            if entry["kind"] == "nested":
                leaf = NestedTensor(
                    w_base=self.read_array(a["base"], buf=buf, device=device),
                    deltas=(None,) * len(a["deltas"]),
                    scale=self.read_array(a["scale"], buf=buf, device=device),
                    shape=tuple(entry["shape"]), bits=tuple(entry["bits"]),
                    block=int(entry["block"]), rung=0)
            else:
                leaf = self.read_array(a["value"], buf=buf, device=device)
            items.append((entry["elems"], leaf))
        return _build_tree(items)

    def recipe(self):
        """The saved QuantRecipe (default predicate), or None."""
        if self.recipe_dict is None:
            return None
        from ..core.recipe import QuantRecipe
        return QuantRecipe.from_json(json.dumps(self.recipe_dict))


def open_artifact(path: str) -> Artifact:
    """Open an artifact directory, reading ONLY the manifest."""
    return Artifact(path)


def load_store(path, mode="part", pager=None, verify: bool = True,
               device=None, **store_kwargs):
    """Cold-boot a :class:`~repro_torch.core.switching.NestQuantStore` on
    ``device`` (default: the card) from an artifact: the manifest and the
    base segment are read now, delta streams page in through a
    :class:`~repro_torch.storage.pager.FilePager` on demand."""
    from ..core.switching import NestQuantStore
    from .pager import FilePager
    device = resolve_device(device)
    art = path if isinstance(path, Artifact) else open_artifact(path)
    base_tree = art.load_base_tree(device)
    if pager is None:
        pager = FilePager(art, verify=verify, device=device)
    return NestQuantStore(base_tree, mode=mode, pager=pager, device=device,
                          **store_kwargs)
