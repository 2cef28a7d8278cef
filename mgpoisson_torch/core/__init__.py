from mgpoisson_torch.core.spec import Spec
from mgpoisson_torch.core.rhs import point_charge_rhs, initial_guess
from mgpoisson_torch.core.hierarchy import level_sizes, level_spacings, num_levels

__all__ = [
    "Spec",
    "point_charge_rhs",
    "initial_guess",
    "level_sizes",
    "level_spacings",
    "num_levels",
]
