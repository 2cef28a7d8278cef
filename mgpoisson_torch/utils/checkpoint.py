"""Checkpoint and resume (port of ``mgpoisson/utils/checkpoint.py``).

A solve's state is psi, and a cycle restarts from any iterate, so a
checkpoint is (psi, f, iteration, error history) and a resume passes psi
back as psi0.  The npz layout is the JAX package's, so each package
loads the other's files:

- single file (no mesh): the keys ``psi``, ``f``, ``iteration``, ``errs``
  and ``meta_<k>``, psi and f whole;
- per process (under a mesh, or ``sharded=True``): ``<path>.proc<K>.npz``
  with ``<name>_global_shape``, ``<name>_shard<k>`` and
  ``<name>_shard<k>_start`` (the shard's global index) beside the scalars.
  The port's ranks each hold one block (``shard.spmd``): rank K writes
  its block as ``shard0``, its start the block origin
  (``spmd.block_origin``, 0 on the uncut axis in 3D).  A file of the JAX
  package holds all of a process's addressable shards; the loader
  stitches them back into the process's block.

bf16: numpy has no bf16, and ``np.savez`` writes the JAX package's bf16
arrays (ml_dtypes' bfloat16) as raw two-byte voids, ``|V2``.  The port
writes and reads the same bytes: a bf16 tensor's bits as ``|V2``, and a
``|V2`` array back as a torch.bfloat16 tensor of the same bits.

Tensors on the card are copied to the host to be saved; a load under a
mesh puts the rank's blocks on the given device.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mgpoisson_torch.shard import spmd
from mgpoisson_torch.shard.multihost import device_for

_BF16_VOID = np.dtype("V2")


def _proc_path(path: str, proc: int) -> str:
    return f"{path}.proc{proc}.npz"


def _proc_index(mesh) -> int:
    """This process's file index: its global rank (0 outside a process
    group), as jax.process_index() names the JAX package's files."""
    if mesh is not None:
        return mesh.ranks[mesh.rank]
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _to_host(x) -> np.ndarray:
    """x as a numpy array on the host: a tensor copied off its device, a
    bf16 one as its bits in the |V2 layout numpy writes for the JAX
    package's bf16 arrays."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_VOID)
        return t.numpy()
    return np.asarray(x)


def _from_host(a):
    """A loaded array as the port takes it: |V2 (bf16 bits) as a
    torch.bfloat16 tensor on the CPU, anything else as numpy."""
    if isinstance(a, np.ndarray) and a.dtype == _BF16_VOID:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return a


def _save_sharded(path: str, arrays: dict, scalars: dict, mesh) -> None:
    payload = dict(scalars)
    for name, block in arrays.items():
        g = block.shape[0] * mesh.shape[0]
        payload[f"{name}_global_shape"] = np.asarray((g,) * block.ndim)
        payload[f"{name}_shard0"] = _to_host(block)
        payload[f"{name}_shard0_start"] = np.asarray(
            spmd.block_origin(g, mesh) + (0,) * (block.ndim - 2))
    np.savez(_proc_path(path, _proc_index(mesh)), **payload)


def save_state(path: str, psi, f=None, iteration: int = 0,
               errs=None, meta: Optional[dict] = None,
               sharded: Optional[bool] = None, mesh=None) -> None:
    """Persist solver state.

    mesh: a ``shard.mesh.ProcessMesh`` when psi and f are this rank's
    blocks of a sharded solve; every rank of the mesh calls save_state.
    sharded: None (per-process files iff a mesh is given), or force with
    True/False.  sharded=False under a mesh gathers the whole grid and
    the mesh's rank 0 writes one file (a collective: every rank calls
    it); sharded=True needs a mesh."""
    if sharded is None:
        sharded = mesh is not None
    if sharded and mesh is None:
        raise TypeError("sharded=True needs a mesh (shard.mesh.ProcessMesh) "
                        f"whose block psi is; got {type(psi).__name__}")
    scalars = {"iteration": np.asarray(iteration)}
    if errs is not None:
        scalars["errs"] = _to_host(errs)
    if meta:
        for k, v in meta.items():
            scalars[f"meta_{k}"] = np.asarray(v)
    arrays = {"psi": psi}
    if f is not None:
        arrays["f"] = f
    if sharded:
        _save_sharded(path, arrays, scalars, mesh)
        return
    if mesh is not None:
        arrays = {k: spmd.gather_full(v, mesh) for k, v in arrays.items()}
        if mesh.rank != 0:
            return
    payload = dict(scalars)
    payload.update({k: _to_host(v) for k, v in arrays.items()})
    np.savez(path, **payload)


def _stitch_local(z, name: str):
    """Reassemble this process's contiguous local block from its saved
    shards (offsets are rebased to the process-local origin)."""
    gshape = tuple(int(s) for s in z[f"{name}_global_shape"])
    ks = sorted(
        int(k.split("shard")[-1].split("_")[0])
        for k in z.files
        if k.startswith(f"{name}_shard") and not k.endswith("_start"))
    shards = [(z[f"{name}_shard{k}_start"], z[f"{name}_shard{k}"])
              for k in ks]
    ndim = len(gshape)
    lo = [min(int(s[0][d]) for s in shards) for d in range(ndim)]
    hi = [max(int(s[0][d]) + s[1].shape[d] for s in shards)
          for d in range(ndim)]
    block = np.zeros([h - l for l, h in zip(lo, hi)], shards[0][1].dtype)
    for starts, data in shards:
        idx = tuple(slice(int(starts[d]) - lo[d],
                          int(starts[d]) - lo[d] + data.shape[d])
                    for d in range(ndim))
        block[idx] = data
    # the shards must tile the bounding box exactly: a process whose
    # shards are non-adjacent would otherwise get silent zero-filled gaps
    n_filled = sum(d.size for _, d in shards)
    if n_filled != block.size:
        raise ValueError(
            f"checkpoint shards for '{name}' do not tile this process's "
            f"bounding box ({n_filled} elements over a {block.shape} "
            f"block): the saving mesh gave this process non-contiguous "
            f"shards, which this loader does not support")
    return block, gshape


def load_state(path: str, mesh=None, device="cuda") -> dict:
    """Load solver state.

    A single-file checkpoint loads as the JAX package loads it, numpy
    arrays (a bf16 one as a torch.bfloat16 CPU tensor).  A per-process
    checkpoint loads this process's stitched block: without a mesh as
    numpy, with ``<name>_global_shape`` beside it; with the mesh as a
    tensor on `device` (the rank's card by default), checked to be the
    mesh's block (``spmd.block_shape``)."""
    if os.path.exists(path):
        with np.load(path) as z:
            out = {k: _from_host(z[k]) for k in z.files}
        out["iteration"] = int(out.get("iteration", 0))
        return out

    proc_file = _proc_path(path, _proc_index(mesh))
    if not os.path.exists(proc_file):
        raise FileNotFoundError(
            f"no checkpoint at {path} (or {proc_file}); found: "
            f"{glob.glob(path + '.proc*.npz')}")
    if mesh is not None and torch.device(device) == torch.device("cuda"):
        device = device_for(mesh.rank)
    with np.load(proc_file) as z:
        out = {k: _from_host(z[k]) for k in z.files
               if "_shard" not in k and not k.endswith("_global_shape")}
        names = {k.split("_global_shape")[0] for k in z.files
                 if k.endswith("_global_shape")}
        for name in sorted(names):
            block, gshape = _stitch_local(z, name)
            block = _from_host(block)
            if mesh is not None:
                want = spmd.block_shape(gshape[0], len(gshape), mesh)
                if tuple(block.shape) != want:
                    raise ValueError(
                        f"checkpoint block '{name}' of {proc_file} has shape "
                        f"{tuple(block.shape)}; this rank's block of a "
                        f"{gshape} grid on a {mesh.shape} mesh is {want}")
                out[name] = torch.as_tensor(block).to(device)
            else:
                out[name] = block
                out[f"{name}_global_shape"] = gshape
    out["iteration"] = int(out.get("iteration", 0))
    return out


def resume_solve(solver, path: str, **solve_kw):
    """Continue a checkpointed solve: load psi (and f if saved) and run
    solver.solve from that iterate.  Per-process checkpoints load the
    rank's blocks on the solver's mesh; a whole grid from a single file
    is cut to the rank's block under a mesh."""
    mesh = getattr(solver, "mesh", None)
    state = load_state(path, mesh=mesh, device=solver.device)
    psi, f = state["psi"], state.get("f")
    if mesh is not None:
        whole = tuple(solver.spec.shape)
        psi, f = [spmd.slice_local(torch.as_tensor(a), mesh)
                  if a is not None and tuple(a.shape) == whole else a for a in (psi, f)]
    return solver.solve(f, psi0=psi, **solve_kw)
