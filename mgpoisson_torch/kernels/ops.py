"""Plain torch ops, rank-polymorphic 2D/3D (port of
``mgpoisson/kernels/xla.py``).

These are the semantics every kernel of ``mgpoisson_torch.kernels.cuda``
is held to, the ops below the kernel threshold, and the whole solver on a
CPU tensor or under ``backend='torch'``.  Each function keeps the JAX
function's name, signature and order of floating-point operations.

All stencil ops take `bc`:
  'ghost0' — out-of-range neighbours read 0: the problem's operator,
             always used on the fine level.
  'face'   — ghost = -u_edge of the current iterate (Dirichlet at the
             cell face): the tuned scheme's coarse-level operator.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F


def _sl(nd, ax, s):
    """Index tuple taking slice `s` on axis `ax` and everything elsewhere."""
    return tuple(s if a == ax else slice(None) for a in range(nd))


def neighbor_sum(u: torch.Tensor, bc: str = "ghost0") -> torch.Tensor:
    """Zero-ghost / face-Dirichlet sum of the 2*ndim face neighbours."""
    nd = u.ndim
    pad = F.pad(u, (1, 1) * nd)
    s = None
    for ax in range(nd):
        idx_lo = tuple(slice(1, -1) if a != ax else slice(0, -2)
                       for a in range(nd))
        idx_hi = tuple(slice(1, -1) if a != ax else slice(2, None)
                       for a in range(nd))
        term = pad[idx_lo] + pad[idx_hi]
        s = term if s is None else s + term
        if bc == "face":
            first, last = _sl(nd, ax, slice(0, 1)), _sl(nd, ax, slice(-1, None))
            s[first] -= u[first]
            s[last] -= u[last]
    return s


def jacobi_sweep(u, f, h, bc: str = "ghost0"):
    """One out-of-place Jacobi sweep."""
    hsq = h * h
    askew = neighbor_sum(u, bc) / hsq
    adiag = -2.0 * u.ndim / hsq
    return (f - askew) / adiag


def wjacobi_sweep(u, f, h, bc: str = "ghost0"):
    """Damped Jacobi, omega = 2d/(2d+1)."""
    omega = 2.0 * u.ndim / (2.0 * u.ndim + 1.0)
    return u + omega * (jacobi_sweep(u, f, h, bc) - u)


def _parity_mask(shape, device):
    """(sum of the global indices) % 2 — the red/black colour."""
    idx = torch.zeros(shape, dtype=torch.int64, device=device)
    for ax, n in enumerate(shape):
        view = [1] * len(shape)
        view[ax] = n
        idx = idx + torch.arange(n, device=device).view(view)
    return idx % 2


def rbgs_sweep(u, f, h, bc: str = "ghost0"):
    """Red-black Gauss-Seidel sweep (colour 0 first, then colour 1)."""
    hsq = h * h
    adiag = -2.0 * u.ndim / hsq
    parity = _parity_mask(u.shape, u.device)
    for p in (0, 1):
        upd = (f - neighbor_sum(u, bc) / hsq) / adiag
        u = torch.where(parity == p, upd, u)
    return u


_SWEEPS = {"jacobi": jacobi_sweep, "wjacobi": wjacobi_sweep,
           "rbgs": rbgs_sweep}


def smooth(u, f, h, nu: int, smoother: str = "jacobi", bc: str = "ghost0"):
    """nu smoother sweeps."""
    sweep = _SWEEPS[smoother]
    for _ in range(nu):
        u = sweep(u, f, h, bc)
    return u


def residual(u, f, h, bc: str = "ghost0"):
    """r = f - A u."""
    hsq = h * h
    askew = neighbor_sum(u, bc) / hsq
    adiag = -2.0 * u.ndim / hsq
    return f - (askew + adiag * u)


def apply_operator(u, h, bc: str = "ghost0"):
    """Matrix-free A u = (sum nbrs - 2*ndim*u)/h^2."""
    hsq = h * h
    return (neighbor_sum(u, bc) - 2.0 * u.ndim * u) / hsq


def restrict(r):
    """2^ndim-cell average restriction (exact 1/4, 1/8 weights)."""
    nd = r.ndim
    split = []
    for n in r.shape:
        split += [n // 2, 2]
    s = r.reshape(split).sum(dim=tuple(range(1, 2 * nd, 2)))
    return s * (0.5 ** nd)


def _inject(V):
    for ax in range(V.ndim):
        V = torch.repeat_interleave(V, 2, dim=ax)
    return V


def prolong(V, kind: str = "inject"):
    """Prolongation coarse -> fine.

    kind='inject': piecewise-constant 2x upsample (the reference's
    operator).  kind='bilinear': cell-centred bi/trilinear with
    face-Dirichlet boundary weights: per axis out = a*R + b*S(R) on the
    injected array R, S the parity-dependent +-2 shift with zero fill,
    (a, b) = (0.75, 0.25) inside and (0.5, 0) at the global edges,
    expanded into 3^ndim taps summed in the JAX package's order."""
    nd = V.ndim
    R = _inject(V)
    if kind == "inject":
        return R
    assert kind == "bilinear"

    def shifted(x, ax):
        """Parity-dependent +-2 shift along ax with zero fill."""
        n2 = x.shape[ax]
        pad_lo = [0, 0] * nd
        pad_lo[2 * (nd - 1 - ax)] = 2
        pad_hi = [0, 0] * nd
        pad_hi[2 * (nd - 1 - ax) + 1] = 2
        xm = F.pad(x, pad_lo)[_sl(nd, ax, slice(0, n2))]
        xp = F.pad(x, pad_hi)[_sl(nd, ax, slice(2, None))]
        view = [1] * nd
        view[ax] = n2
        even = (torch.arange(n2, device=x.device) % 2 == 0).view(view)
        return torch.where(even, xm, xp)

    def weights(ax):
        n2 = R.shape[ax]
        view = [1] * nd
        view[ax] = n2
        idx = torch.arange(n2, device=R.device).view(view)
        bdry = (idx == 0) | (idx == n2 - 1)
        a = torch.where(bdry, 0.5, 0.75).to(R.dtype)
        b = torch.where(bdry, 0.0, 0.25).to(R.dtype)
        return a, b

    out = None
    ws = [weights(ax) for ax in range(nd)]
    for picks in itertools.product((0, 1), repeat=nd):
        term = R
        w = None
        for ax, p in enumerate(picks):
            if p:
                term = shifted(term, ax)
            wax = ws[ax][p]
            w = wax if w is None else w * wax
        t = w * term
        out = t if out is None else out + t
    return out


def prolong_correct(u, V, kind: str = "inject"):
    """Coarse-grid correction u += P(V)."""
    return u + prolong(V, kind)


def residual_restrict(u, f, h, bc: str = "ghost0"):
    """restrict(residual(u, f))."""
    return restrict(residual(u, f, h, bc))


def coarse_solve(u, f, h, smoother: str = "jacobi", bc: str = "ghost0"):
    """Coarsest-level solve: one smoother application, exact at 1x1 for
    bc='ghost0'; for bc='face' the 1x1 solve u = f*h^2/(-4*ndim) is
    exact."""
    if bc == "face" and u.shape[0] == 1:
        return f * (h * h) / (-4.0 * u.ndim)
    return _SWEEPS[smoother](u, f, h, bc)


# ------------------------------------------------- composite (fused) ops
# One call per V-cycle half-level; kernels.cuda replaces these with one
# kernel each.

def smooth_residual_restrict(u, f, h, nu, smoother="jacobi", bc="ghost0"):
    """pre-smooth x nu, then R = restrict(residual). Returns (u, R)."""
    u = smooth(u, f, h, nu, smoother, bc)
    return u, residual_restrict(u, f, h, bc)


def smooth_residual_restrict_zero(f, h, nu, smoother="jacobi", bc="ghost0"):
    """Down-leg from u identically zero (every coarse V-cycle entry)."""
    return smooth_residual_restrict(torch.zeros_like(f), f, h, nu,
                                    smoother, bc)


def prolong_correct_smooth(u, f, V, h, nu, smoother="jacobi", bc="ghost0",
                           kind="inject"):
    """u += P(V), then post-smooth x nu."""
    u = prolong_correct(u, V, kind)
    return smooth(u, f, h, nu, smoother, bc)


def _acc_dtype(dtype):
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def residual_sq_sum(u, f, h):
    """sum(r^2) of the fine-level zero-ghost operator, accumulated in at
    least f32: the stopping-metric accumulation rule."""
    r = residual(u, f, h, "ghost0").to(_acc_dtype(u.dtype))
    return torch.sum(r * r)


def prolong_correct_smooth_rnorm(u, f, V, h, nu, smoother="jacobi",
                                 bc="ghost0", kind="inject"):
    """Up-leg + the squared zero-ghost residual norm of the result:
    (u, sum(r^2)).  The norm uses the zero-ghost operator whatever `bc`
    is: it is the solver's stopping metric."""
    u = prolong_correct_smooth(u, f, V, h, nu, smoother, bc, kind)
    return u, residual_sq_sum(u, f, h)


# ------------------------------------------------------------------- metrics

def rms_update(psi, psi_old):
    """sqrt(sum((psi-psi_old)^2)/N)."""
    d = (psi - psi_old).to(_acc_dtype(psi.dtype))
    return torch.sqrt(torch.sum(d * d) / psi.numel())


def rel_err(psi, psi_old):
    """Masked mean |1 - psi/psi_old| with the cl.obj count normalization
    (ROADMAP Queue 3: the contract, kept as it is)."""
    mask = (psi_old != 0) & (psi_old != psi)
    vals = torch.where(mask, torch.abs(1.0 - psi / torch.where(mask, psi_old, 1.0)),
                       0.0)
    cnt = torch.sum(mask)
    return torch.where(cnt > 0, torch.sum(vals) / torch.clamp(cnt, min=1), 0.0)


def residual_norm(u, f, h):
    """L2 norm of the true fine-level residual (zero-ghost operator)."""
    r = residual(u, f, h, "ghost0")
    return torch.sqrt(torch.sum(r * r))
