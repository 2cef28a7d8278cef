"""Kernel layer: the grid-point ops, two ways behind one interface
(port of ``mgpoisson/kernels/__init__.py``):

- ``mgpoisson_torch.kernels.ops``  — plain torch, rank-polymorphic (2D/3D),
  any device;
- ``mgpoisson_torch.kernels.cuda`` — hand-written CUDA kernels for the hot
  2D and 3D ops on Hopper.

``get_ops(spec, level_size, device)`` picks one per level by
``use_kernels``, the one dispatch rule of the unpacked levels;
``use_packed`` is the one rule of the fast scheme's packed fine level,
``use_sharded_kernels`` that of a sharded level's strip kernels, and
``use_packed_sharded`` that of the packed fine level under a row-sharded
mesh.
"""

from __future__ import annotations

import os

import torch

from mgpoisson_torch.kernels import cuda, ops


def use_kernels(spec, level_size: int, device) -> bool:
    """The dispatch rule: a level runs the CUDA kernels iff its tensors are
    on a CUDA device, the backend is not 'torch', the level has side >=
    spec.kernel_min_size, its dtype has kernels (f32, or bf16: the bf16
    forms of K1-K6, in 2D and 3D), and both of its sweep counts are
    within the kernels' cap for its rank (``cuda.supports``: 2D nu <= 8,
    <= 4 for rbgs; 3D a halo of radius*nu + 1 <= 8).  Every other level
    runs the plain ops; this is the only way a CUDA tensor reaches the
    plain version of an op that has a kernel.  (The ops without one —
    the metrics, coarse_solve, and the transfer ops of the traced cycle —
    are plain on every device.)  backend='cuda' with CPU tensors is an
    error.

    For cubes at the default kernel_min_size of 256 this picks the levels
    the JAX package's byte gate picks for its 3D kernels (pallas.py
    ``_supported3``: arrays of >= 32 MiB): 256^3 runs the kernels and
    128^3 does not, in f32 (64 and 8 MiB) and in bf16 (32 MiB, exactly the
    gate, and 4 MiB)."""
    device = torch.device(device)
    if spec.backend == "torch":
        return False
    if device.type != "cuda":
        if spec.backend == "cuda":
            raise ValueError("backend='cuda' needs CUDA tensors, got device "
                             f"{device}; use backend='auto' or 'torch'")
        return False
    smoother = spec.smoother_resolved
    return (level_size >= spec.kernel_min_size
            and all(cuda.supports(level_size, getattr(torch, spec.dtype), nu,
                                  smoother, spec.ndim)
                    for nu in (spec.nu_pre, spec.nu_post)))


def get_ops(spec, level_size: int, device):
    """Return the op module to use for a level of side `level_size`."""
    return cuda if use_kernels(spec, level_size, device) else ops


def exchange_depth(spec) -> int:
    """Depth D of a sharded level's u and f strips: the deeper leg's kernel
    halo, radius * nu + 1 (the down-leg's residual, or the fine up-leg's
    sum(r^2), reads one ring past the sweeps)."""
    return ops.sweep_radius(spec.smoother_resolved) * max(spec.nu_pre, spec.nu_post) + 1


def use_sharded_kernels(spec, global_side: int, local_shape, device) -> bool:
    """The dispatch rule of a sharded level (``shard.spmd``): its two legs
    run the strip kernels K9-K12 iff ``use_kernels`` holds for the level's
    GLOBAL side (on the card, backend not 'torch', side >=
    kernel_min_size, sweep counts within the caps), a strip kernel takes
    the level's dtype (``cuda.sharded_supports``: f32 or bf16, in 2D and
    3D; the bf16 forms of K9-K12 exist in both ranks), and every sharded
    axis of the rank's block is deep enough for the strips from its
    immediate neighbours: >= D, and its coarse half >= the coarse strips'
    depth ops.coarse_depth(D).  Every other sharded level runs the plain
    versions (kernels.ops)."""
    if (not use_kernels(spec, global_side, device)
            or not cuda.sharded_supports(spec.ndim, getattr(torch, spec.dtype))):
        return False
    return min(local_shape[:2]) >= 2 * ops.coarse_depth(exchange_depth(spec))


def use_packed(spec, device) -> bool:
    """Whether a solve keeps its fine level checkerboard-packed and runs it
    on K7/K8, or their bf16 forms (``mgpoisson_torch.cycle.packed``); the
    rule of the JAX package's ``mgpoisson.cycle.packed.supported``:

    - MGPOISSON_PACKED is not "0";
    - 2D, no mesh, the rbgs smoother (any cycle: with 'fmg' the FMG pass
      runs unpacked and the solver packs its result);
    - backend not 'torch';
    - the fine side above coarse_size and >= kernel_min_size;
    - the JAX plan's own conditions: n >= 256, n % 256 == 0 and
      1 <= nu_pre, nu_post <= 3;
    - float32 or bfloat16;
    - no other sweep_dtype: the JAX solver never packs a mixed-precision
      solve (its refinement branch comes before the packed one), whose
      inner bf16 cycle runs unpacked;
    - a CUDA device, or MGPOISSON_PACKED=1 on the CPU, which runs the
      plain packed ops as the JAX flag does."""
    flag = _packed_flag()
    n = spec.size
    if (flag == "0" or spec.ndim != 2 or spec.mesh_shape is not None
            or spec.smoother_resolved != "rbgs" or spec.backend == "torch"
            or n <= spec.coarse_size or n < spec.kernel_min_size
            or n < 256 or n % 256
            or not all(1 <= nu <= cuda.PACKED_MAX_NU
                       for nu in (spec.nu_pre, spec.nu_post))
            or spec.dtype not in ("float32", "bfloat16")
            or spec.sweep_dtype not in (None, spec.dtype)):
        return False
    return torch.device(device).type == "cuda" or flag == "1"


def _packed_flag() -> str:
    return os.environ.get("MGPOISSON_PACKED", "auto")


def use_packed_sharded(spec, mesh, device) -> bool:
    """Whether a sharded solve of `spec` on `mesh` (a ``shard.mesh.
    ProcessMesh``) keeps its fine level checkerboard-packed per rank and
    runs it on K13/K14 (``shard.spmd.SpmdCycle.cycle_packed``); the rule of
    the JAX package's ``mgpoisson.cycle.packed.supported_spmd``:

    - MGPOISSON_PACKED is not "0";
    - 2D, the rbgs smoother, any cycle (FMG's pass runs unpacked),
      backend not 'torch', float32 and no other sweep_dtype;
    - a mesh of one column (mx, 1), so that a rank's block is whole rows;
    - 1 <= nu_pre, nu_post <= 3;
    - the fine level sharded: side above replicate_below, and both it and
      its half split evenly over the mesh (``shard.spmd.shardable``);
    - the JAX plan's own conditions (pallas.py packed_sharded_plan):
      n % 256 == 0 and blocks of nl = n / mx >= 32 rows, nl % 16 == 0;
    - the port's own: side >= kernel_min_size, and a CUDA device, or
      MGPOISSON_PACKED=1 on the CPU, which runs the plain packed ops."""
    from mgpoisson_torch.shard.spmd import shardable   # shard imports this module

    flag = _packed_flag()
    n = spec.size
    mx, my = mesh.shape
    nl = n // mx
    if (flag == "0" or spec.ndim != 2 or spec.smoother_resolved != "rbgs"
            or spec.backend == "torch"
            or spec.dtype != "float32" or spec.sweep_dtype not in (None, spec.dtype)
            or my != 1
            or not all(1 <= nu <= cuda.PACKED_MAX_NU for nu in (spec.nu_pre, spec.nu_post))
            or n <= spec.replicate_below or not shardable(n, mesh)
            or not shardable(n // 2, mesh)
            or n % 256 or nl < 32 or nl % 16
            or n < spec.kernel_min_size):
        return False
    return torch.device(device).type == "cuda" or flag == "1"
