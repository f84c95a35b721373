"""Device meshes over torch.distributed (the port's counterpart of
paddle_tpu/parallel/mesh.py).

A JAX mesh names the devices one program spans. In the port each rank of a
torch.distributed process group is one device of the mesh: `make_mesh`
lays the group's ranks out row-major over the named axes. With no process
group initialized the mesh is this process's one device (world size 1),
which is the one-card path; with a group it spans `dist.get_world_size()`
ranks, gloo between CPU processes (the tests) or between processes that
share a card, NCCL between cards.

Each axis, and each tuple of axes, has its own sub-group: the ranks that
share this rank's coordinates on every other axis. `make_mesh` makes them
all with `dist.new_group`, in one order on every rank (new_group is a
collective call), and `Mesh.group_of(axes)` hands out this rank's. A
collective over an axis tuple (parallel/_collectives.py) runs on that
sub-group.

The executor runs a program tagged with a mesh of a process group SPMD
(parallel/spmd.py): each rank keeps its rows of the fed batch, and the
collectives of the sharded run post over these sub-groups.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "NamedSharding", "make_mesh", "set_mesh", "get_mesh",
           "replicated", "data_parallel_mesh", "batch_sharding",
           "axes_tuple"]


def axes_tuple(ent) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names: None -> (), "dp" -> ("dp",),
    ("fsdp", "tp") as it is."""
    if not ent:
        return ()
    if isinstance(ent, (tuple, list)):
        return tuple(a for a in ent if a)
    return (ent,)


@dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of `group` (None: one process, no
    group). `rank` is this process's rank in the group and `device` the
    device its tensors live on. `groups` maps each sorted axis tuple to
    (the sub-group, its ranks in order) of this rank."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    group: Optional[object]
    rank: int
    device: torch.device
    groups: Dict[Tuple[str, ...], Tuple[object, Tuple[int, ...]]] = \
        field(default_factory=dict, compare=False, hash=False, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend() if self.group is not None else None

    def axis_size(self, axis) -> int:
        """The ranks `axis` spans: one axis name, or a tuple (their
        product)."""
        if isinstance(axis, (tuple, list)):
            return math.prod(self.axis_size(a) for a in axis)
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis) -> int:
        """This rank's coordinate along `axis` (row-major layout); over a
        tuple of axes, the row-major index of its coordinates in the
        tuple's order."""
        if isinstance(axis, (tuple, list)):
            idx = 0
            for a in axis:
                idx = idx * self.axis_size(a) + self.axis_index(a)
            return idx
        i = self.axis_names.index(axis)
        return (self.rank // math.prod(self.shape[i + 1:])) % self.shape[i]

    def group_of(self, axes) -> Tuple[Optional[object], Tuple[int, ...]]:
        """(process group, its ranks) of this rank over `axes` (a name or a
        tuple); (None, (rank,)) with no process group. The ranks are in the
        row-major order of their coordinates along `axes` in the order
        given, which is the order `axis_index` counts."""
        axes = axes_tuple(axes)
        if self.group is None or not axes:
            return None, (self.rank,)
        grp, _ = self.groups[tuple(sorted(axes))]
        return grp, _ranks_over(self, axes)


def _coords(mesh_shape, rank):
    out = []
    for i in range(len(mesh_shape)):
        out.append((rank // math.prod(mesh_shape[i + 1:])) % mesh_shape[i])
    return out


def _rank_of(mesh_shape, coords):
    r = 0
    for s, c in zip(mesh_shape, coords):
        r = r * s + c
    return r


def _ranks_over(mesh: Mesh, axes: Tuple[str, ...]) -> Tuple[int, ...]:
    """The ranks sharing this rank's coordinates off `axes`, ordered
    row-major over `axes` in the order given."""
    base = _coords(mesh.shape, mesh.rank)
    idx = [mesh.axis_names.index(a) for a in axes]
    out = []
    for cs in itertools.product(*(range(mesh.shape[i]) for i in idx)):
        c = list(base)
        for i, v in zip(idx, cs):
            c[i] = v
        out.append(_rank_of(mesh.shape, c))
    return tuple(out)


def _make_groups(shape, axis_names, rank, world_group):
    """Every sub-group of every non-empty axis subset, created in one
    order on every rank. The subset of all axes is the world group."""
    groups = {}
    n = len(axis_names)
    for k in range(1, n + 1):
        for subset in itertools.combinations(range(n), k):
            key = tuple(sorted(axis_names[i] for i in subset))
            if k == n:
                groups[key] = (world_group, tuple(range(math.prod(shape))))
                continue
            others = [i for i in range(n) if i not in subset]
            for oc in itertools.product(*(range(shape[i]) for i in others)):
                ranks = []
                for sc in itertools.product(*(range(shape[i])
                                              for i in subset)):
                    c = [0] * n
                    for i, v in zip(others, oc):
                        c[i] = v
                    for i, v in zip(subset, sc):
                        c[i] = v
                    ranks.append(_rank_of(shape, c))
                ranks = sorted(ranks)
                grp = dist.new_group(ranks)
                if rank in ranks:
                    groups[key] = (grp, tuple(ranks))
    return groups


_current_mesh: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]):
    global _current_mesh
    _current_mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _current_mesh


def _local_device(device=None) -> torch.device:
    """The device this rank's tensors live on: `device` when the caller
    names one; else the card `executor.default_place` gives this rank on an
    NCCL group or with no group, the CPU on a gloo group or a host with no
    card."""
    if device is not None:
        return torch.device(device)
    if (dist.is_initialized() and dist.get_backend() != "nccl") or \
            not torch.cuda.is_available():
        return torch.device("cpu")
    from ..executor import default_place
    return torch.device("cuda", default_place().device_id)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices=None, device=None) -> Mesh:
    """N-D mesh, e.g. make_mesh((2, 2), ("fsdp", "tp")), over the
    initialized process group, or over this process alone when none is.
    Raises unless the mesh holds exactly the group's ranks. `devices` is
    the JAX signature's and may only be None. `device` keeps this rank's
    tensors on that device (a card, on a gloo group of processes sharing
    it: the collectives then stage through pinned host memory)."""
    if devices is not None:
        raise ValueError("the port's meshes span the process group's "
                         "ranks; pass no devices")
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ "
                         f"in length")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axes {axis_names} repeat a name")
    if dist.is_initialized():
        group, rank, world = (dist.group.WORLD, dist.get_rank(),
                              dist.get_world_size())
    else:
        group, rank, world = None, 0, 1
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    groups = _make_groups(shape, axis_names, rank, group) \
        if group is not None else {}
    return Mesh(axis_names, shape, group, rank, _local_device(device),
                groups)


def data_parallel_mesh(n_devices: Optional[int] = None, devices=None,
                       device=None) -> Mesh:
    """1-D 'dp' mesh over the process group's ranks (JAX mesh.py:30). A
    rank count other than the group's raises; `devices` is the JAX
    signature's and may only be None."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((world if n_devices is None else int(n_devices),),
                     ("dp",), devices, device=device)


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "dp") -> NamedSharding:
    """The layout of a fed batch: dim 0 over `axis` (JAX mesh.py:49)."""
    spec = [None] * ndim
    if ndim > 0:
        spec[0] = axis
    return NamedSharding(mesh, tuple(spec))


@dataclass(frozen=True)
class NamedSharding:
    """A value's layout on a mesh: `spec` names, per dim, the mesh axis it
    is split over, or None (the JAX NamedSharding's PartitionSpec)."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
