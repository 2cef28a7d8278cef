"""Debug tools and checkpoints (port of ``mgpoisson.utils``)."""

from mgpoisson_torch.utils.debug import (check_finite, compare_traces, dump_trace,
                                         validate_cycle)
from mgpoisson_torch.utils.checkpoint import load_state, resume_solve, save_state

__all__ = ["check_finite", "compare_traces", "dump_trace", "validate_cycle",
           "save_state", "load_state", "resume_solve"]
