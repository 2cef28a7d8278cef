"""Compare smoother schemes on solve time at one size (port of
``tools/tune_scheme.py``).

    python3 -m mgpoisson_torch.bench.tune_scheme [size]

For each (smoother, nu) candidate of the tuned scheme (backend 'auto',
f32, stop 'residual', tol 1e-10): the time of one V-cycle, the full solve
to tol, and the amortized cost cycles x cycle time, one JSON row each.
Pick the scheme whose cycles x cycle time is smallest, not the one with
the fewest sweeps.

``vcycle_ms`` is the device's busy time of one unpacked
``cycle.vcycle.v_cycle`` (``bench.profile.device_ms``, what the JAX
package's ``chain_time`` measured), ``vcycle_wall_ms`` its wall by CUDA
events beside it; ``solve_wall_s`` is the best of two solves by the host
clock, each ending in its last readback.  On the CPU both cycle times are
the host clock's.  The rbgs candidates' solves keep their fine level
packed on the card (``kernels.use_packed`` takes any rbgs 2D solve, as
the JAX package's ``cycle/packed.py`` does), so at 4096^2 they run K7/K8
there while their ``vcycle_ms`` times the unpacked cycle, as the JAX
tool's does.  A candidate that raises gets "error" in its row.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from mgpoisson_torch.bench.profile import _sync, call_ms, wall_ms
from mgpoisson_torch.core.spec import Spec
from mgpoisson_torch.cycle.vcycle import v_cycle
from mgpoisson_torch.solver.multigrid import MultigridPoisson

# (smoother, pre, post): the tuned default first
CANDIDATES = (("wjacobi", 3, 3), ("wjacobi", 2, 2), ("rbgs", 2, 2), ("rbgs", 1, 1))
REPS = 10


def tune(size: int = 4096, *, dtype: str = "float32", tol: float = 1e-10, device="cuda"):
    """One row per candidate (printed as a JSON line as it completes):
    smoother, nu, vcycle_ms, vcycle_wall_ms, cycles (-1 if the solve did
    not converge), solve_wall_s, cycles_x_vcycle_ms; or smoother, nu and
    error."""
    device = torch.device(device)
    rows = []
    for sm, pre, post in CANDIDATES:
        spec = Spec(size=size, dtype=dtype, scheme="tuned", smoother=sm, pre_smooth=pre,
                    post_smooth=post, backend="auto", stop="residual", tol=tol)
        row = {"smoother": sm, "nu": f"{pre}+{post}"}
        try:
            mg = MultigridPoisson(spec, device=device)
            f = mg.rhs()
            psi = mg.init_state(f)
            cycle = lambda: v_cycle(psi, f, spec.fine_h, spec)
            row["vcycle_ms"] = call_ms(cycle, device, REPS)
            row["vcycle_wall_ms"] = wall_ms(cycle, device, REPS)
            res = mg.solve(f)
            row["cycles"] = res.iterations if res.converged else -1
            best = float("inf")
            for _ in range(2):
                psi0 = mg.init_state(f)
                _sync(device)
                t0 = time.perf_counter()
                mg.solve(f, psi0=psi0)
                _sync(device)
                best = min(best, time.perf_counter() - t0)
            row["solve_wall_s"] = best
            row["cycles_x_vcycle_ms"] = row["cycles"] * row["vcycle_ms"]
        except Exception as e:   # one failing candidate must not hide the others
            row["error"] = f"{type(e).__name__}: {str(e)[:160]}"
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    tune(int(sys.argv[1]) if len(sys.argv) > 1 else 4096)
