"""Starting the ranks of a sharded solve, and moving whole grids in and
out of it (port of ``mgpoisson/shard/multihost.py``).

One process per block.  Start them with torchrun, ``torch.multiprocessing``
or by hand; in each, before the solver:

    from mgpoisson_torch.shard import multihost
    multihost.initialize("nccl", "tcp://host:port", world_size, rank)
    mg = MultigridPoisson(Spec(size=16384, mesh_shape=(2, 2), stop="residual"))
    res = mg.solve()                    # res.psi: this rank's block

The backend is the caller's: "nccl" for one card per rank, "gloo" for
ranks on the CPU, or several ranks sharing one card (NCCL refuses two ranks
on one GPU), where the halo strips go through host memory.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from mgpoisson_torch.shard import spmd
from mgpoisson_torch.shard.mesh import ProcessMesh


def initialize(backend: str, init_method: str, world_size: int, rank: int,
               timeout: datetime.timedelta = datetime.timedelta(seconds=300)) -> None:
    """torch.distributed.init_process_group for one rank.  The finite
    timeout ends the run when a rank fails instead of leaving the others
    waiting in a collective.  Under NCCL the rank's card is made current
    first (``device_for``)."""
    if backend == "nccl":
        torch.cuda.set_device(device_for(rank))
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank, timeout=timeout)


def device_for(rank: int) -> torch.device:
    """The card of a rank: cuda:{rank % device_count}, so that ranks share
    the cards round-robin (all on cuda:0 with one card)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_for: torch.cuda.is_available() is False")
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


def local_block(global_array, mesh: ProcessMesh):
    """This rank's block of a whole grid (a numpy array or a tensor) in the
    solver's layout, axes 0 and 1 cut over the mesh, axis 2 whole: a copy
    of the numpy array, a view of the tensor."""
    block = global_array[spmd.block_slices(global_array.shape[0], mesh)]
    return np.array(block) if isinstance(block, np.ndarray) else block


def gather_global(block: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """The whole grid on every rank, tiled from every rank's block."""
    return spmd.gather_full(block, mesh)
