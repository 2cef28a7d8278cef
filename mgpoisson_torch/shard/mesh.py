"""The process mesh of a domain-decomposed solve (port of
``mgpoisson/shard/mesh.py``).

One process per block: the grid's first two axes are cut over an (x, y)
mesh of the processes of a ``torch.distributed`` group, rank = x * my + y
(the order of ``np.asarray(devices).reshape(shape)`` in the JAX package).
A 3D grid keeps its third axis whole.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch.distributed as dist


def mesh_shape_for(n_devices: int, ndim: int = 2) -> Tuple[int, int]:
    """Balanced 2-axis factorization of n_devices (e.g. 8 -> (4, 2)); the
    JAX package's factorization, whatever ndim (3D grids shard their first
    two axes)."""
    best = (n_devices, 1)
    a = math.isqrt(n_devices)
    while a > 0:
        if n_devices % a == 0:
            b = n_devices // a
            best = (max(a, b), min(a, b))
            break
        a -= 1
    return best


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """An (x, y) mesh over the processes of a group.

    shape: (mx, my); rank: this process's rank in the group; ranks: the
    global rank of each group rank (what point-to-point calls address);
    backend: the group's backend ("gloo" or "nccl"), which decides whether
    card tensors are staged through host memory for a collective."""

    shape: Tuple[int, int]
    rank: int
    ranks: Tuple[int, ...]
    backend: str
    group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coords(self) -> Tuple[int, int]:
        return divmod(self.rank, self.shape[1])

    def neighbour(self, axis: int, step: int) -> Optional[int]:
        """Global rank of the neighbour `step` (+1 or -1) along mesh axis
        `axis`, or None past the grid's edge (the mesh does not wrap)."""
        c = list(self.coords)
        c[axis] += step
        if not 0 <= c[axis] < self.shape[axis]:
            return None
        return self.ranks[c[0] * self.shape[1] + c[1]]


def build_mesh(mesh_shape: Optional[Tuple[int, int]] = None,
               group: Optional[dist.ProcessGroup] = None) -> ProcessMesh:
    """The mesh over `group` (the default group if None), balanced when no
    shape is given.  Raises unless the process group is initialized and its
    size is the product of the shape."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh: torch.distributed is not initialized; "
                           "start the ranks with mgpoisson_torch.shard.multihost."
                           "initialize (or torchrun) first")
    world = dist.get_world_size(group)
    shape = mesh_shape_for(world) if mesh_shape is None else tuple(mesh_shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} processes, the "
                         f"group has {world}")
    ranks = tuple(dist.get_global_rank(group, r) if group is not None else r
                  for r in range(world))
    return ProcessMesh(shape=shape, rank=dist.get_rank(group), ranks=ranks,
                       backend=dist.get_backend(group), group=group)
