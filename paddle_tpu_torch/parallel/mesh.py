"""Device meshes over torch.distributed (the port's counterpart of
paddle_tpu/parallel/mesh.py).

A JAX mesh names the devices one program spans. In the port each rank of a
torch.distributed process group is one device of the mesh: `make_mesh`
lays the group's ranks out row-major over the named axes. With no process
group initialized the mesh is this process's one device (world size 1),
which is the one-card path; with a group it spans `dist.get_world_size()`
ranks, gloo between CPU processes (the tests), NCCL between cards.

Programs stay global-view, as in the JAX package: a rank holds whole
tensors, and an op that runs sequence-parallel (ring attention) splits and
gathers inside itself (parallel/ring_attention.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "NamedSharding", "make_mesh", "set_mesh", "get_mesh",
           "replicated"]


@dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of `group` (None: one process, no
    group). `rank` is this process's rank in the group and `device` the
    device its tensors live on."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    group: Optional[object]
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (row-major layout)."""
        i = self.axis_names.index(axis)
        return (self.rank // math.prod(self.shape[i + 1:])) % self.shape[i]


@dataclass(frozen=True)
class NamedSharding:
    """A value's layout on a mesh: `spec` names, per dim, the mesh axis it
    is split over, or None (the JAX NamedSharding's PartitionSpec)."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


_current_mesh: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]):
    global _current_mesh
    _current_mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _current_mesh


def _local_device() -> torch.device:
    """The card `executor.default_place` gives this rank, the one rule for
    both; the CPU on a gloo group or a host with no card."""
    if (dist.is_initialized() and dist.get_backend() != "nccl") or \
            not torch.cuda.is_available():
        return torch.device("cpu")
    from ..executor import default_place
    return torch.device("cuda", default_place().device_id)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """N-D mesh, e.g. make_mesh((4,), ("sp",)), over the initialized
    process group, or over this process alone when none is. Raises unless
    the mesh holds exactly the group's ranks."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ "
                         f"in length")
    if dist.is_initialized():
        group, rank, world = (dist.group.WORLD, dist.get_rank(),
                              dist.get_world_size())
    else:
        group, rank, world = None, 0, 1
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    return Mesh(axis_names, shape, group, rank, _local_device())


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
