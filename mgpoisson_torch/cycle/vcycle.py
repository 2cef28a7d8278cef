"""Multigrid cycles (port of ``mgpoisson/cycle/vcycle.py``).

The recursion runs eagerly over the level sides, one op module per level
from ``kernels.get_ops``.  Coarse operators are rediscretized (h doubles
per level); the coarsest level gets one smoother application, exact at
1x1.  The fine level always uses the zero-ghost operator; coarse-level bc
and the prolongation kind come from spec.scheme.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from mgpoisson_torch.kernels import get_ops, ops as plain_ops

Trace = List[Tuple[str, int, torch.Tensor]]


def _cycle(u, f, h, spec, gamma: int, fine_level: bool, trace: Optional[Trace],
           rnorm: bool = False):
    """gamma=1 -> V-cycle, gamma=2 -> W-cycle.

    rnorm (fine level only): also return sum(r^2) of the result, fused
    into the up-leg kernel on the kernel path.

    u=None means u IS IDENTICALLY ZERO (every coarse V-cycle entry): the
    down-leg runs the from-zero form, which neither writes a zeros array
    nor reads one back (2.25 array passes instead of 4.25 on the kernel
    path; the values are the same either way)."""
    n = f.shape[0]
    ops = get_ops(spec, n, f.device)
    bc = "ghost0" if fine_level else spec.coarse_bc
    smoother = spec.smoother_resolved
    rnorm = rnorm and fine_level

    def rec(name, arr):
        if trace is not None:
            trace.append((name, arr.shape[0], arr))

    if n <= spec.coarse_size:
        rec("f", f)
        if u is None:
            u = torch.zeros_like(f)
        u = ops.coarse_solve(u, f, h, smoother, bc)
        rec("u", u)
        if rnorm:
            return u, plain_ops.residual_sq_sum(u, f, h)
        return u

    if trace is not None:
        # granular path with per-stage snapshots (the reference's debug
        # dump mode)
        if u is None:
            u = torch.zeros_like(f)
        u = ops.smooth(u, f, h, spec.nu_pre, smoother, bc)
        rec("u_pre", u)
        R = ops.residual_restrict(u, f, h, bc)
        rec("r", ops.residual(u, f, h, bc))
        rec("R", R)
    elif u is None:
        u, R = ops.smooth_residual_restrict_zero(f, h, spec.nu_pre,
                                                 smoother, bc)
    else:
        u, R = ops.smooth_residual_restrict(u, f, h, spec.nu_pre,
                                            smoother, bc)

    # the first coarse visit starts from V=0 (from-zero down-leg); a
    # W-cycle's second visit carries the first's result
    V = _cycle(None, R, 2 * h, spec, gamma, False, trace)
    for _ in range(gamma - 1):
        V = _cycle(V, R, 2 * h, spec, gamma, False, trace)
    rec("V", V)

    r2 = None
    if trace is not None:
        u = ops.prolong_correct(u, V, spec.prolong_kind)
        rec("v", ops.prolong(V, spec.prolong_kind))
        rec("u_corr", u)
        u = ops.smooth(u, f, h, spec.nu_post, smoother, bc)
    elif rnorm:
        u, r2 = ops.prolong_correct_smooth_rnorm(
            u, f, V, h, spec.nu_post, smoother, bc, spec.prolong_kind)
    else:
        u = ops.prolong_correct_smooth(u, f, V, h, spec.nu_post,
                                       smoother, bc, spec.prolong_kind)
    rec("u_post", u)
    if rnorm:
        if r2 is None:     # trace path: separate pass, correctness only
            r2 = plain_ops.residual_sq_sum(u, f, h)
        return u, r2
    return u


def v_cycle(u, f, h, spec, trace: Optional[Trace] = None):
    """One V-cycle — the reference's twoGrid."""
    return _cycle(u, f, h, spec, gamma=1, fine_level=True, trace=trace)


def v_cycle_rnorm(u, f, h, spec):
    """One V-cycle returning (u, sum(r^2)) with the squared residual norm
    fused into the fine-level up-leg."""
    return _cycle(u, f, h, spec, gamma=1, fine_level=True, trace=None,
                  rnorm=True)


def w_cycle(u, f, h, spec, trace: Optional[Trace] = None):
    """One W-cycle (two coarse-grid visits per level)."""
    return _cycle(u, f, h, spec, gamma=2, fine_level=True, trace=trace)


def fmg(f, h, spec, n_vcycles: int = 1):
    """Full multigrid: restrict f to the coarsest level, solve there from
    zero, then at each level going up prolong the solution and run
    `n_vcycles` V-cycles on it.  Reaches discretization accuracy in one
    O(N) pass; the solver's initial iterate under cycle='fmg'."""
    fs = [f]
    while fs[-1].shape[0] > spec.coarse_size:
        fs.append(get_ops(spec, fs[-1].shape[0], f.device).restrict(fs[-1]))
    hs = [h * (2 ** i) for i in range(len(fs))]

    bc = "ghost0" if len(fs) == 1 else spec.coarse_bc
    u = get_ops(spec, fs[-1].shape[0], f.device).coarse_solve(
        torch.zeros_like(fs[-1]), fs[-1], hs[-1], spec.smoother_resolved, bc)
    for lvl in range(len(fs) - 2, -1, -1):
        u = get_ops(spec, fs[lvl].shape[0], f.device).prolong(u, spec.prolong_kind)
        for _ in range(n_vcycles):
            u = _cycle(u, fs[lvl], hs[lvl], spec, 1, lvl == 0, None)
    return u


def make_cycle(spec, rnorm: bool = False):
    """Return the per-step cycle function selected by spec.cycle,
    signature (u, f, h) -> u, or (u, f, h) -> (u, sum(r^2)) with
    rnorm=True.  'fmg' iterates V-cycles after the FMG pass the solver
    runs for the initial iterate."""
    gamma = {"v": 1, "fmg": 1, "w": 2}.get(spec.cycle)
    if gamma is None:
        raise ValueError(f"unknown cycle {spec.cycle!r}")
    return lambda u, f, h: _cycle(u, f, h, spec, gamma=gamma,
                                  fine_level=True, trace=None, rnorm=rnorm)
