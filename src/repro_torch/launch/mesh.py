"""Mesh construction; counterpart of ``repro/launch/mesh.py``.

FUNCTIONS, not module-level constants: importing this module touches no
process group.

Single pod:  (data=16, model=16)            = 256 ranks
Multi-pod:   (pod=2, data=16, model=16)     = 512 ranks

A :class:`Mesh` is a ``torch.distributed`` device mesh
(``init_device_mesh``) with the reference's axis names, plus one process
group per set of axes that a collective runs over (the data-parallel axes
together, every axis alone, ...).  The backend is always the caller's:
``"gloo"`` for ranks on the CPU and for ranks that share one card,
``"nccl"`` for one card per rank.  :class:`MeshShape` is the shape alone
(axis names and sizes, no process group): the spec functions of
``distributed/sharding.py`` take either, so they run in one process, and
a mesh whose every axis has size 1 runs the sharded steps without any
process group at all (the one-card control).  :func:`fake_world` and
:func:`make_fake_mesh` give any one rank of a production-sized world
inside one process, for the dry run.
"""
from __future__ import annotations

import contextlib
import itertools
import sys
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Axes = Union[str, Tuple[str, ...]]


class MeshShape:
    """Axis names and sizes, nothing else (this process is coordinate 0 of
    every axis).  ``shape`` is a dict ``{axis: size}`` in axis order, as a
    JAX mesh's."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device="cpu"):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ "
                             "in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(n) for a, n in zip(axis_names, shape)}
        self.device = torch.device(device)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def axes(self, axes: Optional[Axes]) -> Tuple[str, ...]:
        """``axes`` (a name, a tuple of names or None) as a tuple."""
        if axes is None:
            return ()
        return tuple(axes) if isinstance(axes, tuple) else (axes,)

    def axis_size(self, axes: Optional[Axes]) -> int:
        n = 1
        for a in self.axes(axes):
            n *= self.shape[a]
        return n

    def coord(self, axes: Optional[Axes]) -> int:
        """This rank's index along ``axes`` (row-major over a tuple)."""
        return 0

    def group(self, axes: Optional[Axes]):
        """The process group of this rank's slice along ``axes``; None when
        that slice holds this rank alone (nothing to communicate)."""
        if self.axis_size(axes) > 1:
            raise RuntimeError(f"a shape-only mesh {self.shape} has no process group for "
                               f"{axes!r}; build the mesh with make_test_mesh or "
                               "make_production_mesh")
        return None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


class Mesh(MeshShape):
    """A mesh over the ranks of the default process group (``world size =
    prod(shape)``), built with ``init_device_mesh``; ``device`` is this
    rank's device: the card current in this process for ``device_type``
    "cuda" unless ``device`` names it (a fake world's mesh names it: its
    tensors need no card)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device_type: str,
                 device=None):
        from torch.distributed.device_mesh import init_device_mesh

        self.device_mesh = init_device_mesh(device_type, tuple(shape),
                                            mesh_dim_names=tuple(axis_names))
        if device is not None:
            device = torch.device(device)
        elif device_type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device(device_type)
        super().__init__(shape, axis_names, device)
        self._coords = dict(zip(self.axis_names, self.device_mesh.get_coordinate()))
        self._groups = self._make_groups()

    def _make_groups(self):
        """One group per nonempty set of axes, for this rank: every rank
        calls ``new_group`` for every slice, in one order, as it must."""
        import torch.distributed as dist

        ranks = self.device_mesh.mesh
        groups = {}
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for sub in itertools.combinations(names, n):
                if self.axis_size(sub) == 1:
                    continue
                if len(sub) == 1:
                    groups[sub] = self.device_mesh.get_group(sub[0])
                    continue
                if len(sub) == len(names):
                    groups[sub] = dist.group.WORLD
                    continue
                keep = [names.index(a) for a in sub]
                rest = [i for i in range(len(names)) if i not in keep]
                moved = ranks.permute(rest + keep).reshape(-1, self.axis_size(sub))
                for row in moved.tolist():
                    g = dist.new_group(row)
                    if dist.get_rank() in row:
                        groups[sub] = g
        return groups

    def coord(self, axes: Optional[Axes]) -> int:
        idx = 0
        for a in self.axes(axes):
            idx = idx * self.shape[a] + self._coords[a]
        return idx

    def group(self, axes: Optional[Axes]):
        sub = tuple(a for a in self.axis_names if a in self.axes(axes))
        return self._groups.get(sub)


def init_world(backend: str, *, init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None) -> None:
    """Start the default process group with ``backend`` unless one runs
    (``init_method``/``rank``/``world_size`` as ``init_process_group``
    takes them; None reads the ``env://`` variables).  A running group of
    another backend raises: the mesh never picks one silently."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()!r}, "
                               f"not {backend!r}")
        return
    kw = {}
    if init_method is not None:
        kw["init_method"] = init_method
    if rank is not None:
        kw["rank"] = rank
    if world_size is not None:
        kw["world_size"] = world_size
    dist.init_process_group(backend=backend, **kw)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """Inside this block this process is rank ``rank`` of a world of
    ``world_size`` ranks that exist nowhere else: torch's ``"fake"``
    process-group backend, whose collectives return at once and move
    nothing (the dry run's world, ``launch/dryrun.py``).  Refuses a rank
    outside the world and a start inside a running process group; the
    group is destroyed on the way out."""
    import torch.distributed as dist
    # torch's own fake backend: importing the module registers "fake"
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size} ranks")
    if dist.is_initialized():
        raise RuntimeError(f"a process group of {dist.get_world_size()} ranks "
                           f"({dist.get_backend()!r}) runs already; a fake world starts "
                           "only outside one")
    hook = sys.excepthook           # init_process_group wraps it with a rank prefix
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook


def make_fake_mesh(shape, axes, device) -> Mesh:
    """This rank's mesh of ``shape`` over a running :func:`fake_world` of
    ``prod(shape)`` ranks, its tensors on ``device`` (which needs no card:
    the dry run's tensors are fake).  The rank's coordinates are its place
    in the row-major mesh (``init_device_mesh``'s), as in a real world."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_backend() != "fake":
        raise RuntimeError("make_fake_mesh needs a running fake_world")
    return Mesh(shape, axes, "cpu", device=device)


def production_shape(multi_pod: bool):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, backend: str,
                         device_type: str = "cuda", **world) -> Mesh:
    shape, axes = production_shape(multi_pod)
    init_world(backend, **world)
    return Mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), *, backend: str,
                   device_type: str = "cpu", **world) -> Mesh:
    """A small mesh over ``prod(shape)`` ranks (gloo worlds on the CPU in
    the tests; gloo ranks sharing one card in ``chip_smoke.py``)."""
    init_world(backend, **world)
    return Mesh(shape, axes, device_type)


def shape_only(shape=(2, 4), axes=("data", "model"), device="cpu") -> MeshShape:
    """The shape alone, for the spec functions (no process group)."""
    return MeshShape(shape, axes, device)
