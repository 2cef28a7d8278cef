from mgpoisson_torch.cycle.packed import make_packed_cycle
from mgpoisson_torch.cycle.vcycle import make_cycle, v_cycle, v_cycle_rnorm, w_cycle

__all__ = ["make_cycle", "make_packed_cycle", "v_cycle", "v_cycle_rnorm", "w_cycle"]
