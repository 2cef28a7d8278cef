from mgpoisson_torch.cycle.vcycle import make_cycle, v_cycle, v_cycle_rnorm, w_cycle

__all__ = ["make_cycle", "v_cycle", "v_cycle_rnorm", "w_cycle"]
