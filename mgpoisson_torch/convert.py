"""Carries configuration and state across from the JAX package.

Works on plain data (a dict of Spec fields, numpy arrays), so the port
never imports ``mgpoisson`` or JAX:

    from dataclasses import asdict
    spec_t = spec_from_jax(asdict(jax_spec))
    psi_t, f_t = state_from_numpy(np.asarray(psi), np.asarray(f), "cuda")

Under a mesh, state_from_numpy(..., mesh=mesh) gives this rank's block.
"""

from __future__ import annotations

import numpy as np
import torch

from mgpoisson_torch.core.spec import Spec
from mgpoisson_torch.shard.multihost import local_block

BACKEND_FROM_JAX = {"auto": "auto", "xla": "torch", "pallas": "cuda"}


def spec_from_jax(fields: dict) -> Spec:
    """Map ``dataclasses.asdict`` of an ``mgpoisson.Spec`` to the port's
    Spec: backend xla -> torch, pallas -> cuda, auto -> auto, and
    pallas_min_size -> kernel_min_size.  An unknown backend is passed on,
    so the port's Spec rejects it as the JAX one would."""
    fields = dict(fields)
    if "pallas_min_size" in fields:
        fields["kernel_min_size"] = fields.pop("pallas_min_size")
    if "backend" in fields:
        fields["backend"] = BACKEND_FROM_JAX.get(fields["backend"],
                                                 fields["backend"])
    if fields.get("mesh_shape") is not None:
        fields["mesh_shape"] = tuple(fields["mesh_shape"])
    return Spec(**fields)


def state_from_numpy(psi, f, device="cuda", dtype=torch.float32, mesh=None):
    """The JAX package's psi and f, as numpy arrays, as the port's
    tensors: (psi, f) in `dtype` on `device` (the card unless told
    otherwise), each a fresh dense row-major copy (a Fortran-order array
    too); with a ``shard.mesh.ProcessMesh``, this rank's blocks of them
    (``shard.multihost.local_block``).  A
    packed array of the JAX package's fast solve comes across the same
    way; ``kernels.ops.unpack_grid`` gives its grid.  A bf16 array of the
    JAX package (numpy dtype ``bfloat16`` from ml_dtypes, which torch does
    not read) comes across bit for bit."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    arrays = [np.asarray(a) for a in (psi, f)]
    if mesh is not None:
        arrays = [local_block(a, mesh) for a in arrays]
    return tuple(_tensor(a).to(dtype=dtype, device=device) for a in arrays)


def _tensor(a) -> torch.Tensor:
    """A fresh dense row-major CPU tensor of the numpy array `a`, in its
    dtype.  numpy has no bf16 of its own: the JAX package's bf16 arrays
    carry ml_dtypes' ``bfloat16`` (2 bytes), which torch.tensor refuses, so
    their bits go across as int16 and are viewed as torch.bfloat16 (this
    module does not import ml_dtypes, which comes with JAX)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return torch.tensor(a.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(a)
