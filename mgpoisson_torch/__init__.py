"""mgpoisson_torch — the mgpoisson geometric multigrid Poisson solver on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``mgpoisson`` (which stays the reference): the
same Spec, the same V-cycle and the same solver surface, with the hot 2D
and 3D half-levels as CUDA kernels (``mgpoisson_torch.kernels.cuda``) and
plain torch ops everywhere else.  It imports torch and numpy, never JAX.
The solver runs on the card unless given device="cpu".

    from mgpoisson_torch import MultigridPoisson, Spec
    res = MultigridPoisson(Spec(size=4096, stop="residual")).solve()
    res3 = MultigridPoisson(Spec(size=256, ndim=3, stop="residual")).solve()
"""

from mgpoisson_torch.core.spec import Spec
from mgpoisson_torch.core.rhs import point_charge_rhs, initial_guess
from mgpoisson_torch.solver.multigrid import MultigridPoisson, SolveResult

__version__ = "0.1.0"

__all__ = [
    "Spec",
    "point_charge_rhs",
    "initial_guess",
    "MultigridPoisson",
    "SolveResult",
]
