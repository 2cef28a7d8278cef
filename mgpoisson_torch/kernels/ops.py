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

import functools
import itertools

import torch
import torch.nn.functional as F


def _sl(nd, ax, s):
    """Index tuple taking slice `s` on axis `ax` and everything elsewhere."""
    return tuple(s if a == ax else slice(None) for a in range(nd))


def neighbor_sum(u: torch.Tensor, bc: str = "ghost0", edges=None) -> torch.Tensor:
    """Zero-ghost / face-Dirichlet sum of the 2*ndim face neighbours.

    edges: for a block of a larger grid (the sharded ops below), per axis
    the (first, last) masks of the cells on the GRID's edges, where face
    subtracts u; by default the array's own first and last lines."""
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
        if bc == "face" and edges is None:
            first, last = _sl(nd, ax, slice(0, 1)), _sl(nd, ax, slice(-1, None))
            s[first] -= u[first]
            s[last] -= u[last]
        elif bc == "face":
            for edge in edges[ax]:
                s = s - torch.where(edge, u, 0.0)
    return s


def jacobi_sweep(u, f, h, bc: str = "ghost0"):
    """One out-of-place Jacobi sweep."""
    hsq, adiag, _, _ = _level(h, u.ndim, u.dtype)
    askew = neighbor_sum(u, bc) / hsq
    return (f - askew) / adiag


@functools.cache
def _omega(ndim: int, dtype: torch.dtype) -> float:
    """The damped-Jacobi weight 2d/(2d+1) rounded to `dtype`, as the JAX
    package's weak-typed Python scalar is: in bf16 0.80078125 (2D), the
    value torch then takes in f32; in f32 and f64 the value it had."""
    return float(torch.tensor(2.0 * ndim / (2.0 * ndim + 1.0), dtype=dtype))


@functools.cache
def _level(h: float, ndim: int, dtype: torch.dtype) -> tuple[float, float, float, float]:
    """The constants of a level of spacing h: h^2 and adiag = -2*ndim/h^2,
    which the unpacked and sharded ops divide by, and -h^2/4 and 1/h^2,
    which the packed ops multiply by.  Each is computed in double from the
    unrounded h^2 and rounded to `dtype`, as the JAX package rounds them
    (xla's weak-typed scalars; the Pallas packed kernels'
    ``jnp.asarray(..., dtype)``): in bf16 the values torch then takes in
    f32 (a Python scalar would stay f32, unrounded), bf16 values at every
    h; in f32 and f64 the values torch took before."""
    hsq = h * h
    return tuple(float(torch.tensor(c, dtype=dtype))
                 for c in (hsq, -2.0 * ndim / hsq, -hsq * 0.25, 1.0 / hsq))


def wjacobi_sweep(u, f, h, bc: str = "ghost0"):
    """Damped Jacobi, omega = 2d/(2d+1) in u's dtype."""
    return u + _omega(u.ndim, u.dtype) * (jacobi_sweep(u, f, h, bc) - u)


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
    hsq, adiag, _, _ = _level(h, u.ndim, u.dtype)
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
    hsq, adiag, _, _ = _level(h, u.ndim, u.dtype)
    askew = neighbor_sum(u, bc) / hsq
    return f - (askew + adiag * u)


def apply_operator(u, h, bc: str = "ghost0"):
    """Matrix-free A u = (sum nbrs - 2*ndim*u)/h^2."""
    hsq = _level(h, u.ndim, u.dtype)[0]
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


def prolong(V, kind: str = "inject", edges=None):
    """Prolongation coarse -> fine.

    kind='inject': piecewise-constant 2x upsample (the reference's
    operator).  kind='bilinear': cell-centred bi/trilinear with
    face-Dirichlet boundary weights: per axis out = a*R + b*S(R) on the
    injected array R, S the parity-dependent +-2 shift with zero fill,
    (a, b) = (0.75, 0.25) inside and (0.5, 0) at the global edges,
    expanded into 3^ndim taps summed in the JAX package's order.  `edges`
    (per axis the fine (first, last) edge masks) places the global edges
    for a block of a larger grid; by default they are the array's own."""
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
        if edges is None:
            n2 = R.shape[ax]
            view = [1] * nd
            view[ax] = n2
            idx = torch.arange(n2, device=R.device).view(view)
            bdry = (idx == 0) | (idx == n2 - 1)
        else:
            bdry = edges[ax][0] | edges[ax][1]
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
        return f * _level(h, u.ndim, u.dtype)[0] / (-4.0 * u.ndim)
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


def _up_leg_correct(u, V, kind):
    """u + P(V) of the fused up-leg.  In a sub-f32 dtype P(V) is blended in
    f32 and rounded once, as the Pallas up-leg blends
    (mgpoisson/kernels/pallas.py _bilinear_blend_2d) and the bf16 form of
    K3 does; ``prolong``, the traced cycle's transfer op, blends in the
    dtype, as the JAX package's xla.prolong does."""
    acc = _acc_dtype(u.dtype)
    if acc == u.dtype:
        return prolong_correct(u, V, kind)
    return u + prolong(V.to(acc), kind).to(u.dtype)


def prolong_correct_smooth(u, f, V, h, nu, smoother="jacobi", bc="ghost0",
                           kind="inject"):
    """u += P(V), then post-smooth x nu."""
    u = _up_leg_correct(u, V, kind)
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


# --------------------------------------------- one block of a sharded level
# The explicit partition (mgpoisson_torch.shard.spmd) gives each rank a
# block of the global grid, its first cell at global index `origin` on the
# two sharded axes 0 and 1 (a 3D grid keeps axis 2 whole).  The block's
# halo arrives as strips, the neighbours' edge lines as shard.spmd.strips
# exchanges them, zeros where the neighbour would lie outside the grid:
#
#   2D: top, bot (D, ml); left, right (nl + 2D, D);
#   3D: top, bot (D, nyl, nx); left, right (nzl + 2D, D, nx);
#
# left/right are row-extended (the sequential per-axis exchange carries
# the corners) and None on a mesh of one column, where only the grid's
# edge lies beside the block.  These are the plain versions of the strip
# kernels K9-K12 (kernels.cuda.smooth_rr_sharded, pc_smooth_sharded),
# which compute what the JAX package's strip kernels compute
# (mgpoisson/kernels/pallas.py smooth_rr_sharded, pc_smooth_sharded and
# their 3D forms): the block and its strips concatenated into an extended
# block, the sweeps run there with the boundary decided from the GLOBAL
# index (the fix_ghost of mgpoisson/shard/spmd.py: cells outside the grid
# hold 0, face subtracts u on the grid's edge lines), then the block cut
# back out.  A sweep loses one ring of exact halo per radius (the deep-halo
# trapezoid), so the strips must be at least as deep as the sweeps and the
# residual reach: D >= radius * nu (+ 1 where a residual follows).

def sweep_radius(smoother: str) -> int:
    """Cells one sweep reaches: one per red-black colour half-sweep."""
    return 2 if smoother == "rbgs" else 1


def coarse_depth(depth: int) -> int:
    """Depth of the coarse strips an up-leg with fine strips of `depth`
    reads: the bilinear +-1 coarse neighbour of the halo's outer cell."""
    return (depth + 1) // 2 + 1


def extend(x, strips):
    """The block x with its (top, bot, left, right) strips around it."""
    top, bot, left, right = strips
    x = torch.cat([top, x, bot], dim=0)
    if left is None:
        left = right = x.new_zeros((x.shape[0], top.shape[0], *x.shape[2:]))
    return torch.cat([left, x, right], dim=1)


def _trim(xe, d):
    """The block of an extended block with d halo lines per sharded side
    (contiguous, as every op returns its result)."""
    return xe[d:xe.shape[0] - d, d:xe.shape[1] - d].contiguous()


def _geometry(shape, origin, n, device):
    """For an array covering global cells origin + [0, shape) per axis
    (origin 0 on the unsharded axes) of a grid of side n: the mask of cells
    inside the grid, per axis the (first, last) masks of the grid's edge
    lines, and the red/black colour from the global index."""
    nd = len(shape)
    origin = tuple(origin) + (0,) * (nd - len(origin))
    inside, edges, parity = None, [], 0
    for ax in range(nd):
        view = [1] * nd
        view[ax] = shape[ax]
        g = (torch.arange(shape[ax], device=device) + origin[ax]).view(view)
        m = (g >= 0) & (g < n)
        inside = m if inside is None else inside & m
        edges.append((g == 0, g == n - 1))
        parity = parity + g
    return inside, edges, parity % 2


def _block_sweeps(ue, fe, geo, h, nu, smoother, bc):
    """nu sweeps of an extended block, in the plain sweeps' operation
    order (the damped-Jacobi weight rounded to the dtype, as
    wjacobi_sweep's); cells outside the grid stay 0 (before each red-black
    colour too: the second colour reads what the first wrote)."""
    inside, edges, parity = geo
    hsq, adiag, _, _ = _level(h, ue.ndim, ue.dtype)
    if smoother == "rbgs":
        for _ in range(nu):
            for p in (0, 1):
                upd = (fe - neighbor_sum(ue, bc, edges) / hsq) / adiag
                ue = torch.where(inside & (parity == p), upd, ue)
        return ue
    omega = _omega(ue.ndim, ue.dtype)
    for _ in range(nu):
        jac = (fe - neighbor_sum(ue, bc, edges) / hsq) / adiag
        ue = torch.where(inside, jac if smoother == "jacobi" else ue + omega * (jac - ue),
                         0.0)
    return ue


def _block_residual(ue, fe, geo, h, bc):
    hsq, adiag, _, _ = _level(h, ue.ndim, ue.dtype)
    return fe - (neighbor_sum(ue, bc, geo[1]) / hsq + adiag * ue)


def _strip_depth(strips, need, what):
    d = strips[0].shape[0]
    if d < need:
        raise ValueError(f"{what}: strips of depth {d}, the sweeps reach {need}")
    return d


def _ext_origin(origin, d):
    return tuple(o - d for o in origin)


def smooth_rr_sharded(u, f, ustrips, fstrips, origin, n_global, h, nu,
                      smoother="jacobi", bc="ghost0", zero=False):
    """The down-leg of one block (K9, K11): nu sweeps, the residual with the
    level's bc and the 2^ndim-mean restriction of the block; returns (u,
    R).  zero: u is identically 0 (u and ustrips unused)."""
    d = _strip_depth(fstrips, sweep_radius(smoother) * nu + 1, "smooth_rr_sharded")
    fe = extend(f, fstrips)
    ue = torch.zeros_like(fe) if zero else extend(u, ustrips)
    geo = _geometry(fe.shape, _ext_origin(origin, d), n_global, fe.device)
    ue = _block_sweeps(ue, fe, geo, h, nu, smoother, bc)
    return _trim(ue, d), restrict(_trim(_block_residual(ue, fe, geo, h, bc), d))


def prolong_sharded(V, vstrips, origin, n_global, kind="inject", d=0):
    """P(V) over one block of a sharded level of side n_global, extended by
    d fine lines per sharded side: V the coarse block, vstrips its coarse
    strips (at least coarse_depth(d) deep; one line for d = 0), the global
    edges placed from `origin`, the block's first fine cell.  Blends in
    V's dtype, as ``prolong`` does."""
    dv = vstrips[0].shape[0]
    # the prolonged extended coarse block covers 2*dv fine halo lines per side
    Ve = extend(V, vstrips)
    _, p_edges, _ = _geometry([2 * s for s in Ve.shape], _ext_origin(origin, 2 * dv),
                              n_global, Ve.device)
    return _trim(prolong(Ve, kind, p_edges), 2 * dv - d)


def pc_smooth_sharded(u, f, V, ustrips, fstrips, vstrips, origin, n_global, h,
                      nu, smoother="jacobi", bc="ghost0", kind="inject",
                      rnorm=False):
    """The up-leg of one block (K10, K12): u += P(V) with V the coarse
    block and vstrips its coarse strips, then nu sweeps; with rnorm also
    the block's sum(r^2) of the zero-ghost residual, accumulated in at
    least f32: u, or (u, sum(r^2))."""
    reach = sweep_radius(smoother) * nu + bool(rnorm)
    d = _strip_depth(fstrips, reach, "pc_smooth_sharded")
    dv = _strip_depth(vstrips, coarse_depth(reach), "pc_smooth_sharded (coarse)")
    if 2 * dv < d:
        raise ValueError(f"pc_smooth_sharded: coarse strips of depth {dv} do not "
                         f"cover fine strips of depth {d}")
    ue, fe = extend(u, ustrips), extend(f, fstrips)
    geo = _geometry(ue.shape, _ext_origin(origin, d), n_global, ue.device)
    # P(V) blended in at least f32 and rounded once, as _up_leg_correct
    acc = _acc_dtype(V.dtype)
    PV = prolong_sharded(V.to(acc), [None if s is None else s.to(acc) for s in vstrips],
                         origin, n_global, kind, d).to(u.dtype)
    ue = torch.where(geo[0], ue + PV, 0.0)
    ue = _block_sweeps(ue, fe, geo, h, nu, smoother, bc)
    out = _trim(ue, d)
    if not rnorm:
        return out
    r = _trim(_block_residual(ue, fe, geo, h, "ghost0"), d).to(_acc_dtype(u.dtype))
    return out, torch.sum(r * r)


# ------------------------------------------------ packed-persistent fine level
# Port of the packed section of mgpoisson/kernels/pallas.py (:2940-3072 and
# the whole-grid form of :362-452).  The fast scheme keeps psi and f
# checkerboard-packed for the whole solve:
#
#   up[:, :n/2] = xr (red, parity 0),  up[:, n/2:] = xb (black),
#   xr[i, j] = u[i, 2j + i%2],  xb[i, j] = u[i, 2j + 1 - i%2],
#
# so a colour half-sweep evaluates the stencil once per cell of that colour
# instead of on every cell with half discarded.  Neighbours of xr[i, j]:
# xb[i-1, j] and xb[i+1, j] vertically, xb[i, j] and xb[i, j-1] (even rows)
# or xb[i, j+1] (odd rows) horizontally; black the mirror.  Coarse column J
# is packed lane J, so the restriction gives the UNPACKED coarse rhs and the
# prolongation takes the unpacked coarse correction.  ghost0 only, the fine
# level's bc: out-of-range neighbours read 0.

def _rows(start, count, device):
    """The global row index of `count` rows from row `start`, as a column."""
    return torch.arange(start, start + count, device=device).view(count, 1)


def _pack_views(u, up):
    """u as [row pair, row parity, lane, column parity] and up as [row
    pair, row parity, colour, lane]: red is the even column on even rows
    and the odd column on odd rows."""
    n, m = u.shape
    return u.view(n // 2, 2, m // 2, 2), up.view(n // 2, 2, 2, m // 2)


def pack_grid(u):
    """(n, m) -> (n, m) packed [xr | xb], n and m even.  Exact data
    movement: four strided copies, one pass over the array.  Rows stay
    rows, so on a mesh of one column the pack of a rank's block (first row
    even) is that block of the packed grid."""
    u = u.contiguous()
    up = torch.empty_like(u)
    v, p = _pack_views(u, up)
    for row, colour, col in ((0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0)):
        p[:, row, colour] = v[:, row, :, col]
    return up


def unpack_grid(up):
    """Inverse of pack_grid (exact roundtrip)."""
    up = up.contiguous()
    u = torch.empty_like(up)
    v, p = _pack_views(u, up)
    for row, colour, col in ((0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0)):
        v[:, row, :, col] = p[:, row, colour]
    return u


def _rows_dn(x):   # out[i] = x[i-1], zero row in at the top
    return F.pad(x, (0, 0, 1, 0))[:-1]


def _rows_up(x):   # out[i] = x[i+1]
    return F.pad(x, (0, 0, 0, 1))[1:]


def _lane_r(x):    # out[:, j] = x[:, j-1]
    return F.pad(x, (1, 0))[:, :-1]


def _lane_l(x):    # out[:, j] = x[:, j+1]
    return F.pad(x, (0, 1))[:, 1:]


def _packed_core(xr, xb, cr, cb, nu, rows=None, n=None):
    """nu red-black sweeps on the packed planes (cr, cb = -h^2/4 * f
    packed alike): per colour X = (V + H) / 4 + c, V the vertical and H
    the horizontal neighbour pair, in the Pallas kernel's order.

    rows: the global row of each row (``_rows``; by default the array is
    the whole grid), which decides the colour pattern; with the grid's side
    n, rows outside the grid stay 0 (a block extended by its strips)."""
    if rows is None:
        rows = _rows(0, xr.shape[0], xr.device)
    er = rows % 2 == 0
    inside = None if n is None else (rows >= 0) & (rows < n)

    def colour_update(Y, cX, red):
        V = _rows_dn(Y) + _rows_up(Y)
        a, b = _lane_r(Y), _lane_l(Y)
        H = Y + (torch.where(er, a, b) if red else torch.where(er, b, a))
        X = (V + H) * 0.25 + cX
        return X if inside is None else torch.where(inside, X, 0.0)

    for _ in range(nu):
        xr = colour_update(xb, cr, red=True)
        xb = colour_update(xr, cb, red=False)
    return xr, xb


def _packed_residual(xr, xb, fr, fb, inv_hsq, rows=None):
    """Packed 5-point residual r = f - (nbr - 4u)/h^2 per colour (rows as
    in ``_packed_core``)."""
    if rows is None:
        rows = _rows(0, xr.shape[0], xr.device)
    er = rows % 2 == 0
    nr = (_rows_dn(xb) + _rows_up(xb) + xb
          + torch.where(er, _lane_r(xb), _lane_l(xb)))
    nb = (_rows_dn(xr) + _rows_up(xr) + xr
          + torch.where(er, _lane_l(xr), _lane_r(xr)))
    return fr - (nr - 4.0 * xr) * inv_hsq, fb - (nb - 4.0 * xb) * inv_hsq


def _planes(up):
    w = up.shape[1] // 2
    return up[:, :w], up[:, w:]


def _edge_weights(edge, dtype):
    """(a, b) = (0.5, 0) on the global edge, (0.75, 0.25) inside."""
    return (torch.where(edge, 0.5, 0.75).to(dtype),
            torch.where(edge, 0.0, 0.25).to(dtype))


def _packed_prolong(V, kind, rows=None, n_global=None):
    """The unpacked (n/2, n/2) coarse correction as the packed red and
    black planes (pallas.py _packed_prolong_stripe, whole grid): 'inject'
    is a row double; 'bilinear' the face-adapted row blend, then a +-1
    packed-lane blend whose direction flips with row parity and colour.
    For rows of a larger grid of side n_global, `rows` gives the global
    fine row of each output row (``_rows``), which places the grid's first
    and last rows, where the row blend takes the edge weights."""
    v2 = torch.repeat_interleave(V, 2, dim=0)      # fine rows, packed lanes
    if kind == "inject":
        return v2, v2
    assert kind == "bilinear"
    n, w = v2.shape
    if rows is None:
        rows, n_global = _rows(0, n, V.device), n
    er = rows % 2 == 0
    vm = F.pad(v2, (0, 0, 2, 0))[:-2]
    vp = F.pad(v2, (0, 0, 0, 2))[2:]
    a0, b0 = _edge_weights((rows == 0) | (rows == n_global - 1), V.dtype)
    B = a0 * v2 + b0 * torch.where(er, vm, vp)
    bl, br = _lane_r(B), _lane_l(B)
    cols = torch.arange(w, device=V.device).view(1, w)
    first, last = cols == 0, cols == w - 1

    def blend(red):
        s1 = torch.where(er, bl, br) if red else torch.where(er, br, bl)
        edge = (er & first) | (~er & last) if red else (er & last) | (~er & first)
        a1, b1 = _edge_weights(edge, V.dtype)
        return a1 * B + b1 * s1

    return blend(True), blend(False)


def packed_smooth_residual_restrict(up, fp, h, nu):
    """Packed down-leg: nu rbgs sweeps, the residual and the 2x2
    restriction (red plus black, summed over row pairs).  Returns (up',
    Rc), Rc the UNPACKED (n/2, n/2) coarse rhs."""
    xr, xb = _planes(up)
    fr, fb = _planes(fp)
    _, _, mhq, inv_hsq = _level(h, 2, up.dtype)
    xr, xb = _packed_core(xr, xb, fr * mhq, fb * mhq, nu)
    r_r, r_b = _packed_residual(xr, xb, fr, fb, inv_hsq)
    n, w = xr.shape
    Rc = (r_r + r_b).reshape(n // 2, 2, w).sum(dim=1) * 0.25
    return torch.cat([xr, xb], dim=1), Rc


def _packed_correction(V, kind):
    """The packed planes of P(V) that the packed up-leg adds.  In a sub-f32
    dtype they are blended in f32 and rounded once, as the Pallas packed
    up-leg blends (mgpoisson/kernels/pallas.py _packed_prolong_stripe) and
    the bf16 form of K8 does; inject, a row double, is exact either way."""
    acc = _acc_dtype(V.dtype)
    if acc == V.dtype or kind == "inject":
        return _packed_prolong(V, kind)
    return tuple(p.to(V.dtype) for p in _packed_prolong(V.to(acc), kind))


def packed_prolong_correct_smooth(up, fp, V, h, nu, kind="inject"):
    """Packed up-leg: up += P(V) with V the unpacked coarse correction,
    then nu rbgs sweeps."""
    pr, pb = _packed_correction(V, kind)
    xr, xb = _planes(up)
    fr, fb = _planes(fp)
    mhq = _level(h, 2, up.dtype)[2]
    xr, xb = _packed_core(xr + pr, xb + pb, fr * mhq, fb * mhq, nu)
    return torch.cat([xr, xb], dim=1)


def packed_prolong_correct_smooth_rnorm(up, fp, V, h, nu, kind="inject"):
    """The packed up-leg and sum(r^2) of the result's zero-ghost residual,
    accumulated in at least f32: (up', sum(r^2))."""
    up = packed_prolong_correct_smooth(up, fp, V, h, nu, kind)
    r_r, r_b = _packed_residual(*_planes(up), *_planes(fp), _level(h, 2, up.dtype)[3])
    r = torch.cat([r_r, r_b], dim=1).to(_acc_dtype(up.dtype))
    return up, torch.sum(r * r)


# ------------------------- the packed fine level on one block of a row-sharded mesh
# On a mesh of one column (mx, 1) a rank's block is nl whole rows from an
# even row r0, and its pack is rows r0..r0+nl of the packed grid
# (pack_grid keeps rows), so the packed fine level runs per rank on packed
# blocks whose halo is plain row strips of the neighbours' packed blocks:
# top/bot (D, n), zeros beyond the grid's edge (shard.spmd.strips).  These
# are the plain versions of the packed strip kernels K13/K14
# (kernels.cuda.packed_rr_sharded, packed_pc_sharded) and compute what the
# JAX package's packed_rr_sharded / packed_pc_sharded compute: the block
# and its row strips concatenated, the packed legs above run there with the
# colour pattern, the cells inside the grid and the bilinear edge rows
# decided from the GLOBAL row (the strips are D = 2 nu + 1 deep, odd, so
# the extended block's own row parity is the opposite of the global one),
# then the block cut back out.  The JAX package exchanges 8-deep strips
# instead; the values are the same.

def _packed_r0(origin, what):
    if origin[1] != 0:
        raise ValueError(f"{what}: a packed block spans every column, got origin {origin}")
    return origin[0]


def _extend_rows(x, strips):
    return torch.cat([strips[0], x, strips[1]], dim=0)


def packed_rr_sharded(up, fp, ustrips, fstrips, origin, n_global, h, nu):
    """The packed down-leg of one rank's block (K13): nu red-black sweeps,
    the residual and the 2x2 restriction of the packed block up at global
    `origin` (row, 0) of a grid of side n_global, its halo from the row
    strips.  Returns (up', Rc), Rc the UNPACKED (nl/2, n/2) coarse rhs of
    the block."""
    d = _strip_depth(fstrips, 2 * nu + 1, "packed_rr_sharded")
    r0 = _packed_r0(origin, "packed_rr_sharded")
    ue, fe = _extend_rows(up, ustrips), _extend_rows(fp, fstrips)
    rows = _rows(r0 - d, ue.shape[0], up.device)
    (xr, xb), (fr, fb) = _planes(ue), _planes(fe)
    _, _, mhq, inv_hsq = _level(h, 2, up.dtype)
    xr, xb = _packed_core(xr, xb, fr * mhq, fb * mhq, nu, rows, n_global)
    r_r, r_b = _packed_residual(xr, xb, fr, fb, inv_hsq, rows)
    nl, w = up.shape[0], xr.shape[1]
    Rc = (r_r + r_b)[d:d + nl].reshape(nl // 2, 2, w).sum(dim=1) * 0.25
    return torch.cat([xr, xb], dim=1)[d:d + nl].contiguous(), Rc


def packed_pc_sharded(up, fp, V, ustrips, fstrips, vstrips, origin, n_global, h, nu,
                      kind="inject", rnorm=False):
    """The packed up-leg of one rank's block (K14): up += P(V), V the
    block's UNPACKED (nl/2, n/2) coarse correction with its coarse row
    strips, then nu red-black sweeps; with rnorm also the block's sum(r^2)
    of the zero-ghost residual, accumulated in at least f32: up', or (up',
    sum(r^2))."""
    reach = 2 * nu + bool(rnorm)
    d = _strip_depth(fstrips, reach, "packed_pc_sharded")
    dv = _strip_depth(vstrips, coarse_depth(reach), "packed_pc_sharded (coarse)")
    if 2 * dv < d:
        raise ValueError(f"packed_pc_sharded: coarse strips of depth {dv} do not "
                         f"cover fine strips of depth {d}")
    r0 = _packed_r0(origin, "packed_pc_sharded")
    ue, fe = _extend_rows(up, ustrips), _extend_rows(fp, fstrips)
    rows = _rows(r0 - d, ue.shape[0], up.device)
    inside = (rows >= 0) & (rows < n_global)
    # the prolonged extended coarse block covers 2*dv fine halo rows per side
    Ve = _extend_rows(V, vstrips)
    pr, pb = _packed_prolong(Ve, kind, _rows(r0 - 2 * dv, 2 * Ve.shape[0], V.device),
                             n_global)
    lo = 2 * dv - d
    (xr, xb), (fr, fb) = _planes(ue), _planes(fe)
    xr = torch.where(inside, xr + pr[lo:lo + ue.shape[0]], 0.0)
    xb = torch.where(inside, xb + pb[lo:lo + ue.shape[0]], 0.0)
    _, _, mhq, inv_hsq = _level(h, 2, up.dtype)
    xr, xb = _packed_core(xr, xb, fr * mhq, fb * mhq, nu, rows, n_global)
    nl = up.shape[0]
    out = torch.cat([xr, xb], dim=1)[d:d + nl].contiguous()
    if not rnorm:
        return out
    r_r, r_b = _packed_residual(xr, xb, fr, fb, inv_hsq, rows)
    r = torch.cat([r_r, r_b], dim=1)[d:d + nl].to(_acc_dtype(up.dtype))
    return out, torch.sum(r * r)


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
