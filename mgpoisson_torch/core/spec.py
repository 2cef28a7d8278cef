"""Problem / solver configuration (port of ``mgpoisson/core/spec.py``).

The fields, ``SCHEMES`` and the resolved properties are those of the JAX
package, so a configuration moves between the two unchanged apart from
the backend names (see ``mgpoisson_torch.convert.spec_from_jax``).
Validation raises the same ``ValueError``s as the JAX ``Spec``.  Features
the port does not have yet raise ``NotImplementedError`` naming the
ROADMAP slice that brings them; none is silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# scheme -> (coarse-level bc, prolongation kind, default smoother,
#            default pre/post sweeps)
SCHEMES = {
    "reference": ("ghost0", "inject", "jacobi", 7),
    "tuned": ("face", "bilinear", "wjacobi", 3),
    "fast": ("face", "bilinear", "rbgs", 1),
}

BACKENDS = ("auto", "torch", "cuda")


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class Spec:
    """Static configuration for a multigrid Poisson solve.

    The attributes mean what they mean in ``mgpoisson.core.spec.Spec``;
    two differ:

      backend: 'auto' | 'torch' | 'cuda'.
        'auto'  — the hand-written CUDA kernels for CUDA tensors at
                  levels of side >= kernel_min_size, plain torch ops
                  below that and for CPU tensors;
        'torch' — plain torch ops everywhere (the comparison run on the
                  card);
        'cuda'  — the kernels wherever the dispatch rule
                  (``mgpoisson_torch.kernels.use_kernels``) allows them;
                  CPU tensors are an error.
      kernel_min_size: level side below which the kernels give way to the
        plain ops (``pallas_min_size`` in the JAX package).
      partition: under a mesh, 'auto' and 'spmd' are the explicit partition
        on torch.distributed (``mgpoisson_torch.shard``); 'gspmd' has no
        torch counterpart and raises.

    bf16 runs on one device and under a mesh, in 2D and 3D:
    dtype='bfloat16' (the pure bf16 solve, its fine level packed where the
    JAX package packs it: on one device only) and a sweep_dtype other than
    dtype (mixed-precision refinement, e.g. the bf16 V-cycle of an f32
    solve); sweep_dtype == dtype is the plain solve, as in the JAX package.
    Under a mesh both run on the bf16 strip kernels.

    cycle='fmg' (a full-multigrid pass supplies the initial iterate, then
    V-cycles) and stop_check='adaptive' run on one device and under a
    mesh.  smoother='gs_lex' (the reference's lexicographic Gauss-Seidel,
    with scheme='reference' on one device) runs the plain ops at every
    level, on the card too.  As in the JAX package, adaptive stopping under mixed precision
    is a valid Spec that ``MultigridPoisson`` refuses.
    """

    size: int
    ndim: int = 2
    dtype: str = "float32"
    sweep_dtype: Optional[str] = None
    scheme: str = "tuned"
    smoother: str = "auto"
    pre_smooth: Optional[int] = None
    post_smooth: Optional[int] = None
    tol: float = 1e-10
    stop: str = "update"
    stop_check: str = "every"
    maxiter: int = 1000
    h: Optional[float] = None
    cycle: str = "v"
    backend: str = "auto"
    kernel_min_size: int = 256
    coarse_size: int = 1
    mesh_shape: Optional[Tuple[int, ...]] = None
    partition: str = "auto"
    replicate_below: int = 64

    def __post_init__(self):
        # the JAX package's validation, message for message
        # (mgpoisson/core/spec.py:165-208)
        if not _is_pow2(self.size):
            raise ValueError(f"size must be a power of two, got {self.size}")
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.smoother not in ("auto", "jacobi", "wjacobi", "rbgs",
                                 "gs_lex"):
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if self.smoother == "gs_lex" and self.mesh_shape is not None:
            raise ValueError("smoother='gs_lex' is sequential; use "
                             "'rbgs' under a device mesh")
        if self.smoother == "gs_lex" and self.scheme != "reference":
            raise ValueError("smoother='gs_lex' requires "
                             "scheme='reference' (ghost0 bc only)")
        if self.cycle not in ("v", "w", "fmg"):
            raise ValueError(f"unknown cycle {self.cycle!r}")
        if self.stop not in ("update", "residual"):
            raise ValueError(f"unknown stop criterion {self.stop!r}")
        if self.stop_check not in ("every", "adaptive"):
            raise ValueError(f"unknown stop_check {self.stop_check!r}")
        if self.stop_check == "adaptive" and self.stop != "residual":
            raise ValueError("stop_check='adaptive' requires "
                             "stop='residual' (the update metric is a "
                             "byproduct of the cycle, never worth "
                             "skipping)")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.partition not in ("auto", "gspmd", "spmd"):
            raise ValueError(f"unknown partition {self.partition!r}")
        if not _is_pow2(self.coarse_size) or self.coarse_size > self.size:
            raise ValueError(f"bad coarse_size {self.coarse_size}")
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.sweep_dtype not in (None, "float32", "float64", "bfloat16"):
            raise ValueError(f"unsupported sweep_dtype {self.sweep_dtype!r}")

        if self.partition == "gspmd":
            raise NotImplementedError(
                "partition='gspmd' is a feature of XLA's SPMD partitioner, with "
                "no torch counterpart; mgpoisson_torch runs the explicit "
                "partition, 'spmd' (ROADMAP slice 7, Queue 1 item 12)")

    # ------------------------------------------------- resolved parameters

    @property
    def coarse_bc(self) -> str:
        return SCHEMES[self.scheme][0]

    @property
    def prolong_kind(self) -> str:
        return SCHEMES[self.scheme][1]

    @property
    def smoother_resolved(self) -> str:
        return SCHEMES[self.scheme][2] if self.smoother == "auto" else self.smoother

    @property
    def nu_pre(self) -> int:
        return SCHEMES[self.scheme][3] if self.pre_smooth is None else self.pre_smooth

    @property
    def nu_post(self) -> int:
        return SCHEMES[self.scheme][3] if self.post_smooth is None else self.post_smooth

    @property
    def fine_h(self) -> float:
        """Grid spacing at the finest level (reference: 1/size)."""
        return self.h if self.h is not None else 1.0 / self.size

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.size,) * self.ndim

    def with_(self, **kw) -> "Spec":
        return dataclasses.replace(self, **kw)
