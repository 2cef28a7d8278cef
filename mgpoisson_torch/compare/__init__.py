"""The independent solver family multigrid is held against (port of
``mgpoisson/compare``): matrix-free Krylov solvers on the same operator."""

from mgpoisson_torch.compare.krylov import (bicgstab, cg, conjugate_residual, gmres,
                                            mg_preconditioner, pcg)

__all__ = ["cg", "bicgstab", "conjugate_residual", "gmres", "pcg",
           "mg_preconditioner"]
