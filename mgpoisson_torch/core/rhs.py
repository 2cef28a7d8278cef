"""Right-hand side and initial guess (port of ``mgpoisson/core/rhs.py``).

    f[i,j] = -charge/epsilon0 = -1e6 at the centre cell (size // 2), 0
             elsewhere
    psi0   = -f
"""

from __future__ import annotations

import torch

CHARGE = 1.0e6
EPSILON0 = 1.0


def point_charge_rhs(size: int, ndim: int = 2, dtype=torch.float32,
                     device="cuda", charge: float = CHARGE,
                     epsilon0: float = EPSILON0) -> torch.Tensor:
    """Delta-function RHS: -charge/epsilon0 at the centre cell, 0 elsewhere;
    on the card unless `device` says otherwise."""
    f = torch.zeros((size,) * ndim, dtype=dtype, device=device)
    f[(size // 2,) * ndim] = -charge / epsilon0
    return f


def point_charge_block(size: int, origin, shape, dtype=torch.float32,
                       device="cuda") -> torch.Tensor:
    """The block of point_charge_rhs(size, len(shape)) whose first cell is
    at global index `origin` (the sharded axes; the others start at 0),
    made without the whole grid."""
    f = torch.zeros(tuple(shape), dtype=dtype, device=device)
    origin = tuple(origin) + (0,) * (len(shape) - len(origin))
    local = tuple(size // 2 - o for o in origin)
    if all(0 <= c < s for c, s in zip(local, shape)):
        f[local] = -CHARGE / EPSILON0
    return f


def initial_guess(f: torch.Tensor) -> torch.Tensor:
    """psi0 = -f."""
    return -f
