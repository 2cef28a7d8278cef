"""Matrix-free Krylov solvers (port of ``mgpoisson/compare/krylov.py``): the
independent solver family the reference compares multigrid against
(`test/converge-multigrid-vs-krylov.lua`).

CG, conjugate residual (CR), BiCGStab, restarted GMRES and CG
preconditioned by one multigrid V-cycle (MGCG), all matrix-free against
the plain ``kernels.ops.apply_operator``, on the device of the caller's
tensors.  The operator A = del^2 (zero-ghost) is negative definite, so
CG, PCG and CR run on (-A)u = (-f); BiCGStab and GMRES run on A.  Every
solver starts from x0 = -f unless given one.

The JAX package runs each loop on the device in a ``lax.while_loop``;
this port runs it on the host: one device->host read before the first
iteration and one after each (the stop test and ``converged`` in one
scalar, through ``solver.multigrid.read_scalar``), so iterations + 1 per
solve; the histories stay on the device.  The stop
rule is the JAX package's, taken in the arrays' dtype: iterate while
it < maxiter, ||r|| > tol * ||b|| and ||r|| is finite; converged is
||r|| <= tol * ||b||.  GMRES reads each restart cycle's residual norms
and the iterate's L-inf norm once per cycle, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from mgpoisson_torch.cycle.vcycle import make_cycle
from mgpoisson_torch.kernels import ops
from mgpoisson_torch.solver import multigrid


@dataclasses.dataclass
class KrylovResult:
    x: torch.Tensor
    iterations: int
    converged: bool
    residuals: torch.Tensor   # ||r||/||b|| history, length `iterations`
    # per-iteration ||x||_inf, what the reference harness records from its
    # Krylov errorCallback(err, iter, psi, ...) hook; for gmres the iterate
    # only exists at restart boundaries, so each cycle's end value is
    # repeated for its inner steps
    xnorms: Optional[torch.Tensor] = None


def _dot(a, b):
    return torch.sum(a * b)


def _tiny(dtype) -> float:
    """The JAX package's 1e-300 clamp, a weak-typed Python float, in
    `dtype`: 1e-300 in f64, 0 in f32 and bf16."""
    return float(torch.tensor(1e-300, dtype=dtype))


def poisson_operator(h: float, bc: str = "ghost0") -> Callable:
    """The same matrix-free operator the reference harness builds
    (`test/converge-multigrid-vs-krylov.lua:46-58`)."""
    return lambda u: ops.apply_operator(u, h, bc)


def _run_loop(body, init, maxiter, tol, bnorm, rnorm0):
    """The shared loop; state[0] is the iterate x, whose L-inf norm is
    recorded per iteration.  Returns (state, it, converged, hist, xhist),
    the histories of length maxiter, NaN past it."""
    state, rnorm, it = tuple(init), rnorm0, 0
    hist = torch.full((maxiter,), math.nan, dtype=rnorm0.dtype, device=rnorm0.device)
    xhist = hist.clone()
    thresh = tol * bnorm
    while True:
        # bit 0: go on; bit 1: converged; one read for both
        code = int(multigrid.read_scalar(
            ((rnorm > thresh) & torch.isfinite(rnorm)).int() + 2 * (rnorm <= thresh).int()))
        if it >= maxiter or not code & 1:
            return state, it, bool(code & 2), hist, xhist
        state, rnorm = body(state)
        hist[it] = rnorm / bnorm
        xhist[it] = torch.max(torch.abs(state[0]))
        it += 1


def cg(A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
       tol: float = 1e-10, maxiter: int = 10000,
       error_callback=None) -> KrylovResult:
    """Conjugate gradients on the (negated, SPD) Poisson system."""
    An = lambda u: -A(u)
    x = -b if x0 is None else x0      # reference: x = -f (`:44`)
    return _krylov_common("cg", An, -b, x, tol, maxiter, error_callback)


def pcg(A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
        M: Callable, tol: float = 1e-10, maxiter: int = 10000,
        error_callback=None) -> KrylovResult:
    """Preconditioned CG.  M(r) ~ A^-1 r must be (near-)symmetric; with
    `M = mg_preconditioner(spec)` this is MGCG."""
    An = lambda u: -A(u)
    Mn = lambda r: -M(r)    # M approximates A^-1; An = -A
    x = -b if x0 is None else x0
    return _krylov_common("pcg", An, -b, x, tol, maxiter, error_callback, M=Mn)


def mg_preconditioner(spec) -> Callable:
    """One zero-initial-guess multigrid V-cycle as M(r) ~ A^-1 r, with
    symmetric weighted-Jacobi smoothing (nu = max(nu_pre, nu_post, 1)
    sweeps each way), the spec's other choices kept; for the tuned scheme
    this is the tuned cycle itself.  The fine level runs the from-zero
    down-leg (u=None), which gives the values of a zeros iterate."""
    nu = max(spec.nu_pre, spec.nu_post, 1)
    pspec = spec.with_(smoother="wjacobi", pre_smooth=nu, post_smooth=nu)
    cyc = make_cycle(pspec)
    h = pspec.fine_h
    return lambda r: cyc(None, r, h)


def conjugate_residual(A, b, x0=None, *, tol=1e-10, maxiter=10000,
                       error_callback=None) -> KrylovResult:
    An = lambda u: -A(u)
    return _krylov_common("cr", An, -b, -b if x0 is None else x0,
                          tol, maxiter, error_callback)


def bicgstab(A, b, x0=None, *, tol=1e-10, maxiter=10000,
             error_callback=None) -> KrylovResult:
    # BiCGStab does not need SPD; run on A directly
    return _krylov_common("bicgstab", A, b, -b if x0 is None else x0,
                          tol, maxiter, error_callback)


def _krylov_common(kind, A, b, x0, tol, maxiter, error_callback, M=None):
    x0 = torch.as_tensor(x0)
    b = torch.as_tensor(b, dtype=x0.dtype, device=x0.device)
    solve = _LOOPS[kind]
    if kind == "pcg":
        x, it, converged, hist, xhist = solve(A, M, b, x0, tol, maxiter)
    else:
        x, it, converged, hist, xhist = solve(A, b, x0, tol, maxiter)
    res = KrylovResult(x=x, iterations=it, converged=converged,
                       residuals=hist[:it], xnorms=xhist[:it])
    if error_callback is not None:
        # replay the recorded history through the reference-style hook;
        # a True return ends the replay only
        for k, r in enumerate(res.residuals.tolist(), start=1):
            if error_callback(k, r):
                break
    return res


def _cg_loop(A, b, x0, tol, maxiter):
    r0 = b - A(x0)
    p0 = r0

    def body(state):
        x, r, p, rs = state
        Ap = A(p)
        alpha = rs / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _dot(r, r)
        p = r + (rs_new / rs) * p
        return (x, r, p, rs_new), torch.sqrt(rs_new)

    bnorm = torch.sqrt(_dot(b, b))
    rnorm0 = torch.sqrt(_dot(r0, r0))
    (x, *_), it, converged, hist, xhist = _run_loop(
        body, (x0, r0, p0, _dot(r0, r0)), maxiter, tol, bnorm, rnorm0)
    return x, it, converged, hist, xhist


def _pcg_loop(A, M, b, x0, tol, maxiter):
    r0 = b - A(x0)
    z0 = M(r0)
    p0 = z0

    def body(state):
        x, r, p, rz = state
        Ap = A(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, p, rz_new), torch.sqrt(_dot(r, r))

    bnorm = torch.sqrt(_dot(b, b))
    rnorm0 = torch.sqrt(_dot(r0, r0))
    (x, *_), it, converged, hist, xhist = _run_loop(
        body, (x0, r0, p0, _dot(r0, z0)), maxiter, tol, bnorm, rnorm0)
    return x, it, converged, hist, xhist


def _cr_loop(A, b, x0, tol, maxiter):
    r0 = b - A(x0)
    p0 = r0
    Ar0 = A(r0)
    Ap0 = Ar0

    def body(state):
        x, r, p, Ar, Ap, rAr = state
        alpha = rAr / _dot(Ap, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        Ar = A(r)
        rAr_new = _dot(r, Ar)
        beta = rAr_new / rAr
        p = r + beta * p
        Ap = Ar + beta * Ap
        return (x, r, p, Ar, Ap, rAr_new), torch.sqrt(_dot(r, r))

    bnorm = torch.sqrt(_dot(b, b))
    rnorm0 = torch.sqrt(_dot(r0, r0))
    (x, *_), it, converged, hist, xhist = _run_loop(
        body, (x0, r0, p0, Ar0, Ap0, _dot(r0, Ar0)), maxiter, tol, bnorm, rnorm0)
    return x, it, converged, hist, xhist


def _bicgstab_loop(A, b, x0, tol, maxiter):
    r0 = b - A(x0)
    rhat = r0

    def body(state):
        x, r, p, v, rho, alpha, omega = state
        rho_new = _dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = A(p)
        alpha = rho_new / _dot(rhat, v)
        s = r - alpha * v
        t = A(s)
        omega = _dot(t, s) / _dot(t, t)
        x = x + alpha * p + omega * s
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega), torch.sqrt(_dot(r, r))

    one = torch.ones((), dtype=x0.dtype, device=x0.device)
    bnorm = torch.sqrt(_dot(b, b))
    rnorm0 = torch.sqrt(_dot(r0, r0))
    (x, *_), it, converged, hist, xhist = _run_loop(
        body, (x0, r0, torch.zeros_like(b), torch.zeros_like(b), one, one, one),
        maxiter, tol, bnorm, rnorm0)
    return x, it, converged, hist, xhist


def gmres(A, b, x0=None, *, tol=1e-10, maxiter=10000, restart=100,
          error_callback=None) -> KrylovResult:
    """Restarted GMRES(m).  The reference's solver table carries
    `restart = 100` for its (commented-out) gmres entry
    (`test/converge-multigrid-vs-krylov.lua:41`).  A True from
    error_callback(it, rel), called inside the restart loop, ends the
    solve as converged."""
    x0 = -b if x0 is None else x0
    x0 = torch.as_tensor(x0)
    b = torch.as_tensor(b, dtype=x0.dtype, device=x0.device)
    bnorm = multigrid.read_scalar(torch.sqrt(_dot(b, b)))
    shape = b.shape

    def flat_A(v):
        return A(v.reshape(shape)).reshape(-1)

    x = x0.reshape(-1)
    bf = b.reshape(-1)
    residuals = []
    xnorms = []
    it = 0
    converged = False
    while it < maxiter and not converged:
        steps_before = it
        x, rnorms = _gmres_cycle(flat_A, bf, x, restart)
        for rn in rnorms.tolist():
            it += 1
            rel = rn / bnorm
            residuals.append(rel)
            if error_callback is not None and error_callback(it, rel):
                converged = True
                break
            if rel < tol or not math.isfinite(rel):
                converged = rel < tol
                break
            if it >= maxiter:
                break
        # the iterate only materializes at restart boundaries; repeat
        # its norm for the cycle's inner steps (see KrylovResult.xnorms)
        xnorms.extend([multigrid.read_scalar(torch.max(torch.abs(x)))] * (it - steps_before))
    # the host's floats, kept in f64 (the JAX package's jnp.asarray of them)
    residuals, xnorms = (torch.tensor(v, dtype=torch.float64, device=b.device)
                         for v in (residuals, xnorms))
    return KrylovResult(x=x.reshape(shape), iterations=it, converged=converged,
                        residuals=residuals, xnorms=xnorms)


def _gmres_cycle(A, b, x0, m):
    """One GMRES(m) cycle via Arnoldi (modified Gram-Schmidt, row by row)
    and Givens rotations, all m steps on the device; returns the updated
    iterate and the m per-step residual norms."""
    n = x0.shape[0]
    like = dict(dtype=x0.dtype, device=x0.device)
    tiny = _tiny(x0.dtype)
    r0 = b - A(x0)
    beta = torch.sqrt(torch.sum(r0 * r0))
    Q = torch.zeros((m + 1, n), **like)
    Q[0] = r0 / torch.clamp_min(beta, tiny)
    H = torch.zeros((m + 1, m), **like)
    cs = torch.zeros((m,), **like)
    sn = torch.zeros((m,), **like)
    g = torch.zeros((m + 1,), **like)
    g[0] = beta
    rnorms = torch.zeros((m,), **like)

    for k in range(m):
        w = A(Q[k])
        # modified Gram-Schmidt against rows 0..k (the rows above are zero)
        hcol = torch.zeros((m + 1,), **like)
        for j in range(k + 1):
            hj = torch.sum(w * Q[j])
            w = w - hj * Q[j]
            hcol[j] = hj
        hk1 = torch.sqrt(torch.sum(w * w))
        hcol[k + 1] = hk1
        Q[k + 1] = w / torch.clamp_min(hk1, tiny)

        # apply the previous Givens rotations to the new column
        for j in range(k):
            hj = cs[j] * hcol[j] + sn[j] * hcol[j + 1]
            hj1 = -sn[j] * hcol[j] + cs[j] * hcol[j + 1]
            hcol[j] = hj
            hcol[j + 1] = hj1
        denom = torch.sqrt(hcol[k] * hcol[k] + hcol[k + 1] * hcol[k + 1])
        ck = hcol[k] / torch.clamp_min(denom, tiny)
        sk = hcol[k + 1] / torch.clamp_min(denom, tiny)
        hcol[k] = denom
        hcol[k + 1] = 0.0
        cs[k] = ck
        sn[k] = sk
        gk, gk1 = ck * g[k], -sk * g[k]
        g[k] = gk
        g[k + 1] = gk1
        H[:, k] = hcol
        rnorms[k] = torch.abs(g[k + 1])

    # back-substitute H y = g (upper triangular after the rotations)
    y = torch.zeros((m,), **like)
    for k in range(m - 1, -1, -1):
        s = g[k] - torch.sum(H[k, :] * y)
        y[k] = s / torch.where(H[k, k] != 0, H[k, k], 1.0)
    return x0 + Q[:m].T @ y, rnorms


_LOOPS = {"cg": _cg_loop, "cr": _cr_loop, "bicgstab": _bicgstab_loop, "pcg": _pcg_loop}
