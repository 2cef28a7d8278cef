"""The packed legs K7/K8 and their strip entries K13/K14 on the 2D register
tile, on the CPU.

The kernels run only on the card, so two things are held here:

- the launch: kernels.cuda.packed_rnorm_partials, which sizes the Sigma
  r^2 partials of K8 (the whole grid) and K14 (a block of whole rows),
  against the launch derived warp by warp from the tile constants of
  csrc/stencil.cuh, at every power-of-two side 256 ... 32768, nu 1 ... 3,
  with and without rnorm: the warps' interiors cover the array once and
  every block owns a cell of it; and the down-leg's launch (K7, K13, at
  the halo 2 nu + 1), whose warps write every cell of the unpacked coarse
  rhs Rc exactly once;
- the tile's steps: a model of csrc/stencil_packed.cuh in f32 torch, warp
  by warp (the pair mapping with its odd-row swap, Hr rows and columns of
  halo, zeros beyond the grid and beyond the strips, shuffles that return
  a lane's own value at the warp's edge, the trapezoid of the colour
  steps, the owned interior, the down-leg's restriction in the packed
  ops' sum order), which must equal the plain packed ops bit for bit at
  sides below one tile (8), of about one (64) and of several (256), on
  the whole grid and on every block of (2, 1) and (4, 1) meshes with the
  solver's strips (2 nu + 1 deep, one row short of the tile's even halo
  with a residual).  The bf16 forms of K7/K8 run the packed word tile,
  held in tests/test_torch_bf16x2_packed.py."""

import math
import re
from pathlib import Path

import pytest
import torch

from mgpoisson_torch.kernels import cuda, ops
from mgpoisson_torch.shard.spmd import block_from_grid

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

HEADER = (Path(cuda.__file__).parents[1] / "csrc" / "stencil.cuh").read_text()


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", HEADER).group(1))


COLS, WARPS = _define("MG2_COLS"), _define("MG2_WARPS")
ROWS = (_define("MG2_ROWS_SMALL"), _define("MG2_ROWS_SHALLOW"), _define("MG2_ROWS_DEEP"))
SHALLOW_HALO, FILL_WARPS = _define("MG2_SHALLOW_HALO"), _define("MG2_FILL_WARPS")
SIDES = [2 ** k for k in range(8, 16)]
MESHES = {"K8": 1, "K14 (2, 1)": 2, "K14 (4, 1)": 4}


def _loaded_rows(nl, n, halo):
    """(R, Hr): the loaded rows of a warp and the even halo, from the tile
    table of csrc/stencil.cuh (mg2_rows) on an (nl, n) packed block."""
    hr = halo + (halo & 1)
    if hr > SHALLOW_HALO:
        return ROWS[2], hr
    warps = -(-n // (COLS - 2 * hr)) * -(-nl // (ROWS[1] - 2 * hr))
    return (ROWS[1] if warps >= FILL_WARPS else ROWS[0]), hr


def _owned(extent, origins, span, hr):
    """The cells each warp of these origins owns along one axis, checked to
    cover [0, extent) once; returns the number of warps that own any."""
    seen, owners = [], 0
    for o in origins:
        cells = [c for c in range(o + hr, o + span - hr) if 0 <= c < extent]
        seen += cells
        owners += bool(cells)
    assert seen == list(range(extent))
    return owners


def _launch(nl, n, halo):
    """The launch of the packed up-leg on an (nl, n) packed block at this
    halo, warp by warp: checks its geometry and returns its blocks."""
    R, hr = _loaded_rows(nl, n, halo)
    assert hr % 2 == 0 and hr >= halo and R - 2 * hr >= 2
    gx = -(-n // (COLS - 2 * hr))
    gy = -(-nl // (WARPS * (R - 2 * hr)))
    # every block row's first warp and every block column owns cells
    rows = [(by * WARPS + w) * (R - 2 * hr) - hr for by in range(gy) for w in range(WARPS)]
    assert _owned(nl, rows, R, hr) >= gy and all(r + hr < nl for r in rows[::WARPS])
    assert _owned(n, [bx * (COLS - 2 * hr) - hr for bx in range(gx)], COLS, hr) == gx
    assert cuda.tile2d(nl, n, halo) == (WARPS * (R - 2 * hr), COLS - 2 * hr)
    return gx * gy


@pytest.mark.parametrize("launch", sorted(MESHES))
@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("rnorm", [False, True])
def test_packed_partials_match_the_launch(launch, nu, rnorm):
    mx = MESHES[launch]
    for n in SIDES:
        assert cuda.packed_supports(n, torch.float32, nu)
        blocks = _launch(n // mx, n, 2 * nu + rnorm)
        if rnorm:
            assert cuda.packed_rnorm_partials(n // mx, n, nu) == blocks


def _coarse_owned(extent, origins, span, hr):
    """The coarse cells (fine pairs 2I, 2I + 1) each warp of these origins
    writes along one axis, checked to cover [0, extent / 2) once."""
    seen = []
    for o in origins:
        seen += [(o + c) // 2 for c in range(hr, span - hr, 2) if 0 <= o + c < extent]
    assert sorted(seen) == list(range(extent // 2)) and len(seen) == extent // 2


@pytest.mark.parametrize("launch", ["K7", "K13 (2, 1)", "K13 (4, 1)"])
@pytest.mark.parametrize("nu", [1, 2, 3])
def test_packed_down_leg_writes_every_coarse_cell_once(launch, nu):
    """K7/K13's launch (mg2_grid at the halo 2 nu + 1) writes the unpacked
    (nl/2, n/2) coarse rhs: a lane's pair over each owned row pair is one
    coarse cell, coarse column J = its packed lane."""
    mx = {"K7": 1, "K13 (2, 1)": 2, "K13 (4, 1)": 4}[launch]
    for n in SIDES:
        nl, halo = n // mx, 2 * nu + 1
        _launch(nl, n, halo)
        R, hr = _loaded_rows(nl, n, halo)
        gx, gy = -(-n // (COLS - 2 * hr)), -(-nl // (WARPS * (R - 2 * hr)))
        rows = [(by * WARPS + w) * (R - 2 * hr) - hr for by in range(gy) for w in range(WARPS)]
        _coarse_owned(nl, rows, R, hr)
        _coarse_owned(n, [bx * (COLS - 2 * hr) - hr for bx in range(gx)], COLS, hr)


# ----------------------------------------------------------- the tile's steps

def _c(x):
    """An f32 constant, as the kernel's."""
    return torch.tensor(x, dtype=torch.float32)


def _from_left(x):
    """__shfl_up_sync by one lane: lane 0 keeps its own value."""
    return torch.cat([x[..., :1], x[..., :-1]], dim=-1)


def _from_right(x):
    """__shfl_down_sync by one lane: lane 31 keeps its own value."""
    return torch.cat([x[..., 1:], x[..., -1:]], dim=-1)


def _extended(x, strips, pad):
    """x (nl, m) with its (top, bot) strips, `pad` rows and columns of zeros
    around: what a tile's fetch returns for block rows -pad ... nl+pad-1
    (zero beyond the strips); rows outside the grid are zero in the strips
    already."""
    e, d = x, 0
    if strips is not None:
        e, d = torch.cat([strips[0], x, strips[1]]), strips[0].shape[0]
    return torch.nn.functional.pad(e, (pad, pad, pad - d, pad - d)), pad


class _Warps:
    """The warps of a packed leg on the block up (nl whole rows from global
    row r0 of a grid of side n) at this halo, with the index of every
    (warp, loaded row, lane)."""

    def __init__(self, nl, n, halo, r0):
        self.nl, self.n, self.w = nl, n, n // 2
        self.R, self.hr = R, hr = _loaded_rows(nl, n, halo)
        gx, gy = -(-n // (COLS - 2 * hr)), -(-nl // (WARPS * (R - 2 * hr)))
        self.li0 = torch.tensor([(by * WARPS + wy) * (R - 2 * hr) - hr
                                 for by in range(gy) for wy in range(WARPS) for _ in range(gx)])
        lj0 = torch.tensor([bx * (COLS - 2 * hr) - hr
                            for _ in range(gy) for _ in range(WARPS) for bx in range(gx)])
        self.pad = R + COLS
        self.i = i = torch.arange(R)
        self.rows = self.li0.view(-1, 1, 1) + i.view(1, R, 1)          # block row of (warp, i)
        self.J = lj0.view(-1, 1, 1) // 2 + torch.arange(32).view(1, 1, 32)  # packed lane
        self.r0 = r0
        self.gi = r0 + self.rows
        assert bool(((self.gi % 2) == (i % 2).view(1, R, 1)).all())  # even origins: swap per i
        self.odd = (i % 2 == 1).view(1, R, 1)
        self.in_grid = (self.gi >= 0) & (self.gi < n) & (self.J >= 0) & (self.J < self.w)
        lane = torch.arange(32).view(1, 1, 32)
        # the lanes that own their pair: interior columns inside the block
        self.lanes = (2 * lane >= hr) & (2 * lane < COLS - hr) & (self.J >= 0) & (self.J < self.w)

    def load(self, x, s):
        """The warps' (x0, x1) of the packed x: red and black lane J, swapped
        on odd rows; zero outside the grid and beyond the strips s."""
        e, p = _extended(x, s, self.pad)
        J, w, pad = self.J, self.w, self.pad
        red = e[self.rows + p, J.clamp(-pad, w - 1 + pad) + p]
        black = e[self.rows + p, (w + J).clamp(-pad, self.n - 1 + pad) + p]
        red, black = (torch.where(self.in_grid, t, _c(0.0)) for t in (red, black))
        return torch.where(self.odd, black, red), torch.where(self.odd, red, black)

    def sweeps(self, x0, x1, f0, f1, h, nu):
        """2 nu colour steps on rows 1 .. R-2; rows 0 and R-1 and the lanes'
        own values at the warp's edge turn the halo inexact, step by step."""
        R, mhq = self.R, _c(-(h * h) * 0.25)
        mid = slice(1, R - 1)
        par = (self.i[mid] % 2).view(1, R - 2, 1)
        upd = self.in_grid[:, mid]
        for _ in range(nu):
            for P in (0, 1):
                n0 = ((x0[:, :-2] + x0[:, 2:]) + (x1[:, mid] + _from_left(x1[:, mid]))) \
                    * _c(0.25) + f0[:, mid] * mhq
                x0 = torch.cat([x0[:, :1], torch.where(upd & (par == P), n0, x0[:, mid]),
                                x0[:, -1:]], dim=1)
                n1 = ((x1[:, :-2] + x1[:, 2:]) + (x0[:, mid] + _from_right(x0[:, mid]))) \
                    * _c(0.25) + f1[:, mid] * mhq
                x1 = torch.cat([x1[:, :1], torch.where(upd & (par != P), n1, x1[:, mid]),
                                x1[:, -1:]], dim=1)
        return x0, x1

    def own(self):
        """The (warp, i, lane) cells the warps own and store."""
        R, hr = self.R, self.hr
        rows = ((self.i >= hr) & (self.i < R - hr)).view(1, R, 1)
        return rows & (self.rows >= 0) & (self.rows < self.nl) & self.lanes

    def store(self, x0, x1):
        """The owned interior as the packed (nl, n) block, the swap undone;
        checks that every cell is stored once."""
        own = self.own()
        out = torch.full((self.nl, self.n), float("nan"), dtype=x0.dtype)
        red, black = torch.where(self.odd, x1, x0), torch.where(self.odd, x0, x1)
        _scatter_once(out, self.rows, (self.J, red), (self.w + self.J, black), own)
        return out

    def residual(self, x0, x1, f0, f1, h):
        """The ghost0 residual of rows 1 .. R-2 (a lane's own value at the
        warp's edge, as the shuffles give it)."""
        inv_hsq, mid = _c(1.0 / (h * h)), slice(1, self.R - 1)
        xm0, xm1 = x0[:, mid], x1[:, mid]
        return (f0[:, mid] - ((((x0[:, :-2] + x0[:, 2:]) + xm1) + _from_left(xm1))
                              - _c(4.0) * xm0) * inv_hsq,
                f1[:, mid] - ((((x1[:, :-2] + x1[:, 2:]) + xm0) + _from_right(xm0))
                              - _c(4.0) * xm1) * inv_hsq)


def _scatter_once(out, rows, *cols_vals_own):
    """out[rows, col] = vals where own, for each (col, vals) pair; checks
    that every cell of out is written exactly once."""
    *pairs, own = cols_vals_own
    count = torch.zeros(out.shape, dtype=torch.int64)
    at_rows = rows.expand_as(own)[own]
    for col, vals in pairs:
        at = (at_rows, col.expand_as(own)[own])
        out[at] = vals[own]
        count.index_put_(at, torch.ones(int(own.sum()), dtype=torch.int64), accumulate=True)
    assert bool((count == 1).all())


def _tile_model(up, fp, V, h, nu, kind, rnorm, r0=0, n=None, strips=(None, None, None)):
    """csrc/stencil_packed.cuh's up-leg on the packed block up (nl whole rows
    from global row r0 of a grid of side n), warp by warp in f32: returns
    (up', sum(r^2) of the owned cells, accumulated in f64)."""
    nl, n = up.shape[0], up.shape[1] if n is None else n
    g = _Warps(nl, n, 2 * nu + rnorm, r0)
    R, w, J, gi = g.R, g.w, g.J, g.gi
    x0, x1 = g.load(up, strips[0])
    f0, f1 = g.load(fp, strips[1])

    # the correction: coarse rows li0/2 - 1 + k, lanes J - 1, J, J + 1
    Ve, p = _extended(V, strips[2], g.pad)
    K = R // 2 + 2
    I = g.li0.view(-1, 1, 1) // 2 - 1 + torch.arange(K).view(1, K, 1)
    gI = r0 // 2 + I

    def coarse(dj):
        Jc = J + dj
        v = Ve[I + p, Jc.clamp(-g.pad, w - 1 + g.pad) + p]
        return torch.where((gI >= 0) & (gI < w) & (Jc >= 0) & (Jc < w), v, _c(0.0))

    vl, vc, vr = coarse(-1), coarse(0), coarse(1)
    k = g.i // 2 + 1
    if kind == "inject":
        p0 = p1 = vc[:, k]
    else:
        d = (g.i % 2).view(1, R, 1)
        row_edge = (gi == 0) | (gi == n - 1)
        a0, b0 = torch.where(row_edge, _c(0.5), _c(0.75)), torch.where(row_edge, _c(0.0), _c(0.25))
        S = lambda v: torch.where(d == 1, v[:, k + 1], v[:, k - 1])
        B, Bl, Br = (a0 * v[:, k] + b0 * S(v) for v in (vc, vl, vr))
        lo, hi = 2 * J == 0, 2 * J + 1 == n - 1
        a1l, b1l = torch.where(lo, _c(0.5), _c(0.75)), torch.where(lo, _c(0.0), _c(0.25))
        a1r, b1r = torch.where(hi, _c(0.5), _c(0.75)), torch.where(hi, _c(0.0), _c(0.25))
        p0, p1 = a1l * B + b1l * Bl, a1r * B + b1r * Br
    x0 = torch.where(g.in_grid, x0 + p0, x0)
    x1 = torch.where(g.in_grid, x1 + p1, x1)

    x0, x1 = g.sweeps(x0, x1, f0, f1, h, nu)
    out = g.store(x0, x1)
    rsq = 0.0
    if rnorm:
        r0_, r1_ = g.residual(x0, x1, f0, f1, h)
        o = g.own()[:, 1:R - 1]
        rsq = float((r0_[o].double() ** 2).sum() + (r1_[o].double() ** 2).sum())
    return out, rsq


def _rr_model(up, fp, h, nu, r0=0, n=None, strips=(None, None)):
    """csrc/stencil_packed.cuh's down-leg on the packed block up, warp by
    warp in f32: nu sweeps at the halo 2 nu + 1, the store, the residual
    and mg2p_restrict (each row's red plus black, then the row pair, then
    the quarter) into the UNPACKED (nl/2, n/2) coarse rhs, every coarse
    cell written once: returns (up', Rc)."""
    nl, n = up.shape[0], up.shape[1] if n is None else n
    g = _Warps(nl, n, 2 * nu + 1, r0)
    x0, x1 = g.load(up, strips[0])
    f0, f1 = g.load(fp, strips[1])
    x0, x1 = g.sweeps(x0, x1, f0, f1, h, nu)
    out = g.store(x0, x1)
    r0_, r1_ = g.residual(x0, x1, f0, f1, h)   # row i at index i - 1
    rows = r0_ + r1_                             # r_red + r_black, either order
    even = torch.arange(2, g.R - 2, 2)           # the row pairs (i, i + 1), i even
    cells = (rows[:, even - 1] + rows[:, even]) * _c(0.25)
    own = g.own()[:, even]
    Rc = torch.full((nl // 2, g.w), float("nan"), dtype=up.dtype)
    _scatter_once(Rc, (g.li0.view(-1, 1, 1) + even.view(1, -1, 1)) // 2, (g.J, cells), own)
    return out, Rc


def _data(n, seed):
    g = torch.Generator().manual_seed(seed)
    u, f, V = (torch.randn((s, s), generator=g) for s in (n, n, n // 2))
    return ops.pack_grid(u), ops.pack_grid(f), V


MODEL_CASES = [(n, nu, kind) for n in (8, 64, 256) for nu in (1, 3)
               for kind in ("inject", "bilinear")]


@pytest.mark.parametrize("n,nu,kind", MODEL_CASES)
def test_tile_model_equals_the_plain_packed_leg(n, nu, kind):
    up, fp, V = _data(n, 3 * n + nu)
    h = 1.0 / n
    got, _ = _tile_model(up, fp, V, h, nu, kind, rnorm=False)
    assert torch.equal(got, ops.packed_prolong_correct_smooth(up, fp, V, h, nu, kind))
    got, rsq = _tile_model(up, fp, V, h, nu, kind, rnorm=True)
    want, want_r2 = ops.packed_prolong_correct_smooth_rnorm(up, fp, V, h, nu, kind)
    assert torch.equal(got, want)
    assert math.isclose(rsq, float(want_r2), rel_tol=1e-5)


@pytest.mark.parametrize("n,nu,kind", MODEL_CASES)
@pytest.mark.parametrize("mx", [2, 4])
def test_tile_model_equals_the_plain_packed_block_leg(n, nu, kind, mx):
    up, fp, V = _data(n, 5 * n + nu + mx)
    h, nl, d = 1.0 / n, n // mx, 2 * nu + 1
    for r0 in range(0, n, nl):
        ub, us = block_from_grid(up, (r0, 0), (nl, n), d, cols=False)
        fb, fs = block_from_grid(fp, (r0, 0), (nl, n), d, cols=False)
        vb, vs = block_from_grid(V, (r0 // 2, 0), (nl // 2, n // 2), ops.coarse_depth(d),
                                 cols=False)
        strips = (us[:2], fs[:2], vs[:2])
        b = ((r0, 0), n, h, nu, kind)
        got, _ = _tile_model(ub, fb, vb, h, nu, kind, False, r0, n, strips)
        assert torch.equal(got, ops.packed_pc_sharded(ub, fb, vb, us, fs, vs, *b))
        got, rsq = _tile_model(ub, fb, vb, h, nu, kind, True, r0, n, strips)
        want, want_r2 = ops.packed_pc_sharded(ub, fb, vb, us, fs, vs, *b, rnorm=True)
        assert torch.equal(got, want)
        assert math.isclose(rsq, float(want_r2), rel_tol=1e-5)


RR_CASES = [(n, nu) for n in (8, 64, 256) for nu in (1, 3)]


@pytest.mark.parametrize("n,nu", RR_CASES)
@pytest.mark.parametrize("mx", [1, 2, 4])
def test_tile_model_equals_the_plain_packed_down_leg(n, nu, mx):
    """K7's steps on the whole grid (mx = 1) and K13's on every block of an
    (mx, 1) mesh with the solver's strips (2 nu + 1 deep: the row beyond
    them reads 0), against the plain packed down-legs."""
    up, fp, _ = _data(n, 7 * n + nu + mx)
    h, nl, d = 1.0 / n, n // mx, 2 * nu + 1
    if mx == 1:
        got = _rr_model(up, fp, h, nu)
        want = ops.packed_smooth_residual_restrict(up, fp, h, nu)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    for r0 in range(0, n, nl):
        ub, us = block_from_grid(up, (r0, 0), (nl, n), d, cols=False)
        fb, fs = block_from_grid(fp, (r0, 0), (nl, n), d, cols=False)
        got = _rr_model(ub, fb, h, nu, r0, n, (us[:2], fs[:2]))
        want = ops.packed_rr_sharded(ub, fb, us, fs, (r0, 0), n, h, nu)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
