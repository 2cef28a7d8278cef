"""The packed word tile of the bf16 forms of K7/K8 (mgpoisson_torch/csrc/
stencil_packed_w.cuh), on the CPU, no kernel.

The kernels run only on the card, so two things are held here:

- the launch: kernels.cuda.packed_rnorm_partials in bf16, which sizes
  K8.bf16's Sigma r^2 partials, against the word tile's launch derived warp
  by warp from the header's constants, at every power-of-two side 256 ...
  32768 and at sides n % 4 == 2, nu 1 ... 3, with and without rnorm: the
  warps' interiors cover the array once and every block owns a cell; and
  K7.bf16's warps write every cell of the unpacked coarse rhs Rc once;
- the tile's steps: a torch model of the tile, warp by warp (the red and
  black words of a lane's two packed columns, the halo rounded up to whole
  lanes, the partner word from a shuffle that returns a lane's own word
  at the warp's edge and a byte permute, zeros beyond the grid and in the
  half of a word beyond it, the trapezoid of the whole-word colour steps,
  the word residual and restriction, the bilinear blend in f32 rounded
  once to a word and added as one, u's red plane never loaded nor
  corrected (the first red step overwrites it), the products by -h^2/4
  and 1/h^2 as words, bf16 values at every h), each bf16x2
  instruction one bf16 op of torch (one rounding: tests/test_torch_bf16x2.py).
  It must equal the plain packed ops in bf16 bit for bit (signed zeros
  too) at sides 6 and 10 (n % 4 == 2: the last word of a plane half
  outside the grid), 8 (below one warp), 64 and 256, nu 1 ... 3, inject
  and bilinear, rnorm on and off, at h = 1/n, 0.01 and 0.3 and on inputs
  x 2^-120."""

import math
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from mgpoisson_torch.kernels import cuda, ops

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

CSRC = Path(cuda.__file__).parents[1] / "csrc"
HEADER = (CSRC / "stencil.cuh").read_text() + (CSRC / "stencil_packed_w.cuh").read_text()


def _define(name):
    return int(re.search(rf"#define {name} (0x[0-9a-f]+u|\d+)", HEADER).group(1).rstrip("u"), 0)


COLS, WARPS = _define("MG2W_COLS"), _define("MG2_WARPS")
ROWS = (_define("MG2W_ROWS_SHALLOW"), _define("MG2W_ROWS_DEEP"))
SHALLOW_HALO = _define("MG2_SHALLOW_HALO")
BF16 = torch.bfloat16


def _word(bits):
    """A bf16x2 word constant of the header as one bf16 value (both halves
    are the same)."""
    return torch.tensor([bits & 0xFFFF], dtype=torch.int16).view(BF16)[0]


QUARTER, FOUR = _word(_define("MG2W_QUARTER")), _word(_define("MG2W_FOUR"))


def test_the_header_words_are_a_quarter_and_four():
    assert float(QUARTER) == 0.25 and float(FOUR) == 4.0
    for name in ("MG2W_QUARTER", "MG2W_FOUR"):
        bits = _define(name)
        assert bits >> 16 == bits & 0xFFFF


def _geometry(halo):
    """(R, hr, hp): the loaded rows of a warp, the row halo (even) and the
    column halo in packed columns (whole lanes) of the word tile at this
    halo (mg2w_rows, mg2w_hp)."""
    hr, hp = halo + (halo & 1), (halo + 3) // 4 * 2
    return ROWS[hr > SHALLOW_HALO], hr, hp


def _origins(n, halo):
    """The warps' (row, packed column) origins, block by block."""
    R, hr, hp = _geometry(halo)
    gx = -(-(n // 2) // (COLS - 2 * hp))
    gy = -(-n // (WARPS * (R - 2 * hr)))
    rows = [(by * WARPS + wy) * (R - 2 * hr) - hr for by in range(gy) for wy in range(WARPS)]
    cols = [bx * (COLS - 2 * hp) - hp for bx in range(gx)]
    return rows, cols, gx, gy


# ------------------------------------------------------------- the launch

def _owned(extent, origins, span, halo, step):
    """The cells each warp of these origins owns along one axis (interior
    [halo, span - halo), in units of `step`), checked to cover [0, extent)
    once; returns the number of warps that own any."""
    seen, owners = [], 0
    for o in origins:
        cells = [c for s in range(halo, span - halo, step) for c in range(o + s, o + s + step)
                 if 0 <= c < extent]
        seen += cells
        owners += bool(cells)
    assert seen == list(range(extent))
    return owners


SIDES = [2 ** k for k in range(8, 16)] + [6, 10, 258, 4098]


@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("rnorm", [False, True])
def test_bf16_packed_partials_match_the_word_tile_launch(nu, rnorm):
    for n in SIDES:
        halo = 2 * nu + rnorm
        R, hr, hp = _geometry(halo)
        assert hr % 2 == 0 and hr >= halo and 2 * hp >= halo and hp % 2 == 0
        rows, cols, gx, gy = _origins(n, halo)
        assert _owned(n, rows, R, hr, 1) >= gy and all(r + hr < n for r in rows[::WARPS])
        assert _owned(n // 2, cols, COLS, hp, 1) == gx
        assert cuda.tile_packed_w(halo) == (WARPS * (R - 2 * hr), COLS - 2 * hp)
        assert cuda.packed_supports(n, BF16, nu)
        if rnorm:
            assert cuda.packed_rnorm_partials(n, n, nu, BF16) == gx * gy


@pytest.mark.parametrize("nu", [1, 2, 3])
def test_bf16_packed_down_leg_writes_every_coarse_cell_once(nu):
    """K7.bf16 writes the unpacked (n/2, n/2) Rc: a lane's words over an
    owned row pair are its coarse word (Rc[I][J], Rc[I][J + 1]), the half
    beyond the grid not written."""
    for n in SIDES:
        rows, cols, _, _ = _origins(n, 2 * nu + 1)
        R, hr, hp = _geometry(2 * nu + 1)
        seen = []
        for o in rows:   # coarse rows: the owned row pairs (i, i + 1), i even
            seen += [(o + i) // 2 for i in range(hr, R - hr, 2) if 0 <= o + i < n]
        assert sorted(seen) == list(range(n // 2)) and len(seen) == n // 2
        # coarse columns: the owned lanes' words, a column per packed column
        _owned(n // 2, cols, COLS, hp, 2)


# ----------------------------------------------------------- the tile's steps

def _shfl_up(x):
    """__shfl_up_sync by one lane (dim -2): lane 0 keeps its own word."""
    return torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)


def _shfl_down(x):
    """__shfl_down_sync by one lane: lane 31 keeps its own word."""
    return torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)


def _partner(y, left):
    """mg2w_partner of words y (..., lane, half): (the left lane's high
    half, y's low half) where `left`, else (y's high half, the right lane's
    low half)."""
    lft = torch.stack([_shfl_up(y)[..., 1], y[..., 0]], dim=-1)
    rgt = torch.stack([y[..., 1], _shfl_down(y)[..., 0]], dim=-1)
    return torch.where(left, lft, rgt)


class _K:
    """Mg2wK: the products by -h^2/4 and 1/h^2 as kernels.cuda passes them
    to the bf16 kernels, bf16 values at every h (mg2w_launch refuses
    others): word products."""

    def __init__(self, h):
        self.mhq, self.inv_hsq = (c.value for c in cuda._packed_scalars(h, BF16))
        assert all(float(torch.tensor(c, dtype=BF16)) == c for c in (self.mhq, self.inv_hsq))

    def by_mhq(self, x):
        return x * torch.tensor(self.mhq, dtype=BF16)

    def by_inv_hsq(self, x):
        return x * torch.tensor(self.inv_hsq, dtype=BF16)


def _c(x):
    return torch.tensor(x, dtype=torch.float32)


class _Tile:
    """The warps of the word tile on an n x n packed level at this halo:
    words as (warp, row, lane, half) tensors, the index of every cell."""

    def __init__(self, n, halo):
        self.n, self.w = n, n // 2
        self.R, self.hr, self.hp = R, hr, hp = _geometry(halo)
        rows, cols, _, _ = _origins(n, halo)
        i0 = torch.tensor([r for r in rows for _ in cols]).view(-1, 1, 1, 1)
        j0 = torch.tensor([c for _ in rows for c in cols]).view(-1, 1, 1, 1)
        self.i0, self.i = i0, torch.arange(R).view(1, R, 1, 1)
        self.gi = i0 + self.i                                      # (warp, row)
        lane = torch.arange(32).view(1, 1, 32, 1)
        self.lane, self.Jl = lane, j0 + 2 * lane                   # the lane's J
        self.J = self.Jl + torch.arange(2).view(1, 1, 1, 2)        # each half's column
        self.col_in = (self.J >= 0) & (self.J < self.w)
        self.in_grid = (self.gi >= 0) & (self.gi < n) & self.col_in
        self.even = self.i % 2 == 0
        self.pad = 2 * R + COLS

    def gather(self, plane, rows, cols):
        """plane[rows, cols], 0 outside the plane (the checked loads)."""
        p = self.pad
        e = F.pad(plane, (p, p, p, p))
        inside = (rows >= 0) & (rows < plane.shape[0]) & (cols >= 0) & (cols < plane.shape[1])
        v = e[(rows + p).clamp(0, e.shape[0] - 1), (cols + p).clamp(0, e.shape[1] - 1)]
        return torch.where(inside, v, torch.zeros((), dtype=plane.dtype))

    def load(self, x, red=True):
        """(red, black) words of the packed x; without `red` the red words
        are 0 (u's red plane, dead on input: mg2w_load)."""
        black = self.gather(x[:, self.w:], self.gi, self.J)
        return self.gather(x[:, :self.w], self.gi, self.J) if red else torch.zeros_like(
            black), black

    def colour(self, x, y, fx, red, k):
        """mg2w_colour: plane x from plane y, rows 1 .. R-2 of every lane;
        cells outside the grid keep 0."""
        mid = slice(1, self.R - 1)
        v = y[:, :-2] + y[:, 2:]
        h = y[:, mid] + _partner(y[:, mid], self.even[:, mid] == red)
        s = (v + h) * QUARTER + k.by_mhq(fx[:, mid])
        s = torch.where(self.in_grid[:, mid], s, torch.zeros((), dtype=BF16))
        return torch.cat([x[:, :1], s, x[:, -1:]], dim=1)

    def sweeps(self, ur, ub, fr, fb, nu, k):
        for _ in range(nu):
            ur = self.colour(ur, ub, fr, True, k)
            ub = self.colour(ub, ur, fb, False, k)
        return ur, ub

    def resid(self, x, y, fx, red, k):
        """mg2w_resid of rows 1 .. R-2 (row i at index i - 1)."""
        mid = slice(1, self.R - 1)
        nbr = ((y[:, :-2] + y[:, 2:]) + y[:, mid]) + _partner(y[:, mid], self.even[:, mid] == red)
        return fx[:, mid] - k.by_inv_hsq(nbr - FOUR * x[:, mid])

    def owned(self):
        """The (warp, row, lane, half) cells the warps own and store."""
        R, hr, hp = self.R, self.hr, self.hp
        rows = (self.i >= hr) & (self.i < R - hr)
        lanes = (2 * self.lane >= hp) & (2 * self.lane + 2 <= COLS - hp)
        return rows & lanes & self.in_grid

    def correct(self, ub, V, kind):
        """mg2w_correct, of the black plane: the lane's coarse words of rows
        i0/2 - 1 + k, then inject, or the f32 bilinear blend rounded once to
        a word ("left" on odd rows, "right" on even ones)."""
        K = self.R // 2 + 2
        I = self.i0 // 2 - 1 + torch.arange(K).view(1, K, 1, 1)
        vc = self.gather(V, I, self.J)                             # (warp, k, lane, half)
        idx = self.i.view(-1) // 2 + 1
        if kind == "inject":
            return ub + vc[:, idx]
        # the coarse columns J - 1 and J + 2: from the words beside, lanes 0
        # and 31 load their own
        lane = self.lane[..., 0]
        e0 = self.gather(V, I[..., 0], self.Jl[..., 0] - 1).float()
        e31 = self.gather(V, I[..., 0], self.Jl[..., 0] + 2).float()
        left = torch.where(lane == 0, e0, _shfl_up(vc)[..., 1].float())
        right = torch.where(lane == 31, e31, _shfl_down(vc)[..., 0].float())
        vf = vc.float()
        d = (self.i.view(-1) % 2 == 1)
        other = torch.where(d, idx + 1, idx - 1)                    # the row blend's other row
        row_edge = ((self.gi == 0) | (self.gi == self.n - 1))[..., 0]
        a0, b0 = torch.where(row_edge, _c(0.5), _c(0.75)), torch.where(row_edge, _c(0.0),
                                                                        _c(0.25))
        mix = lambda a, x, b, y: a * x + b * y
        B0 = mix(a0, vf[:, idx, :, 0], b0, vf[:, other, :, 0])
        B1 = mix(a0, vf[:, idx, :, 1], b0, vf[:, other, :, 1])
        Bl = mix(a0, left[:, idx], b0, left[:, other])
        Br = mix(a0, right[:, idx], b0, right[:, other])
        Jl = self.Jl[..., 0]
        w8 = lambda edge: (torch.where(edge, _c(0.5), _c(0.75)), torch.where(edge, _c(0.0),
                                                                               _c(0.25)))
        (aL, bL), (aR0, bR0), (aR1, bR1) = w8(Jl == 0), w8(Jl == self.w - 1), \
            w8(Jl + 1 == self.w - 1)
        lw = torch.stack([mix(aL, B0, bL, Bl), mix(_c(0.75), B1, _c(0.25), B0)], -1).to(BF16)
        rw = torch.stack([mix(aR0, B0, bR0, B1), mix(aR1, B1, bR1, Br)], -1).to(BF16)
        odd = d.view(1, -1, 1, 1)
        return ub + torch.where(self.in_grid, torch.where(odd, lw, rw),
                                torch.zeros((), dtype=BF16))


def _scatter_once(out, rows, cols, vals, own):
    """out[rows, cols] = vals where own; checks that every cell of out is
    written exactly once."""
    count = torch.zeros(out.shape, dtype=torch.int64)
    shape = own.shape
    at = (rows.expand(shape)[own], cols.expand(shape)[own])
    out[at] = vals[own]
    count.index_put_(at, torch.ones(int(own.sum()), dtype=torch.int64), accumulate=True)
    assert bool((count == 1).all())


def _store(t, ur, ub):
    out = torch.zeros((t.n, t.n), dtype=BF16)
    own = t.owned()
    _scatter_once(out[:, :t.w], t.gi, t.J, ur, own)
    _scatter_once(out[:, t.w:], t.gi, t.J, ub, own)
    return out


def _pc_model(up, fp, V, h, nu, kind, rnorm):
    """K8.bf16 on the word tile: (up', sum(r^2) over the owned cells, each
    bf16 residual squared in f32, summed in f64)."""
    t, k = _Tile(up.shape[0], 2 * nu + rnorm), _K(h)
    ur, ub = t.load(up, red=False)
    ub = t.correct(ub, V, kind)
    fr, fb = t.load(fp)
    ur, ub = t.sweeps(ur, ub, fr, fb, nu, k)
    out, rsq = _store(t, ur, ub), 0.0
    if rnorm:
        own = t.owned()[:, 1:t.R - 1]
        for r in (t.resid(ur, ub, fr, True, k), t.resid(ub, ur, fb, False, k)):
            rsq += float((r[own].float() ** 2).double().sum())
    return out, rsq


def _rr_model(up, fp, h, nu):
    """K7.bf16 on the word tile: (up', Rc), the coarse word (((r_red +
    r_black) on row 2I + the same on 2I + 1) + 0) * 0.25, every coarse cell
    written once."""
    t, k = _Tile(up.shape[0], 2 * nu + 1), _K(h)
    fr, fb = t.load(fp)
    ur, ub = t.sweeps(*t.load(up, red=False), fr, fb, nu, k)
    out = _store(t, ur, ub)
    s = t.resid(ur, ub, fr, True, k) + t.resid(ub, ur, fb, False, k)   # row i at i - 1
    pairs = torch.arange(2, t.R - 2, 2)
    zero = torch.zeros((), dtype=BF16)
    rc = ((s[:, pairs - 1] + s[:, pairs]) + zero) * QUARTER
    Rc = torch.zeros((t.n // 2, t.w), dtype=BF16)
    _scatter_once(Rc, t.gi[:, pairs] // 2, t.J, rc, t.owned()[:, pairs])
    return out, Rc


def _bits(x):
    return x.contiguous().view(torch.int16)


def _same(a, b):
    """Bit-equal bf16 tensors (signed zeros told apart)."""
    return a.dtype == b.dtype == BF16 and torch.equal(_bits(a), _bits(b))


# (input scale, spacing h or None for 1/n)
DATA = {"h=1/n": (1.0, None), "x2^-120": (2.0 ** -120, None), "h=0.01": (1.0, 0.01),
        "h=0.3": (1.0, 0.3)}
MODEL_SIDES = (6, 8, 10, 64, 256)


def _data(n, seed, data):
    scale, h = DATA[data]
    g = torch.Generator().manual_seed(seed)
    u, f, V = ((torch.randn((s, s), generator=g) * scale).to(BF16) for s in (n, n, n // 2))
    return ops.pack_grid(u), ops.pack_grid(f), V, 1.0 / n if h is None else h


@pytest.mark.parametrize("n", MODEL_SIDES)
@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("kind", ["inject", "bilinear"])
@pytest.mark.parametrize("data", sorted(DATA))
def test_word_tile_equals_the_plain_packed_bf16_up_leg(n, nu, kind, data):
    up, fp, V, h = _data(n, 17 * n + nu, data)
    got, _ = _pc_model(up, fp, V, h, nu, kind, rnorm=False)
    assert _same(got, ops.packed_prolong_correct_smooth(up, fp, V, h, nu, kind))
    got, rsq = _pc_model(up, fp, V, h, nu, kind, rnorm=True)
    want, want_r2 = ops.packed_prolong_correct_smooth_rnorm(up, fp, V, h, nu, kind)
    assert _same(got, want)
    assert math.isclose(rsq, float(want_r2), rel_tol=1e-5)


@pytest.mark.parametrize("n", MODEL_SIDES)
@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("data", sorted(DATA))
def test_word_tile_equals_the_plain_packed_bf16_down_leg(n, nu, data):
    up, fp, _, h = _data(n, 19 * n + nu, data)
    got = _rr_model(up, fp, h, nu)
    want = ops.packed_smooth_residual_restrict(up, fp, h, nu)
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", [8, 10])
def test_word_tile_keeps_the_plain_legs_signed_zeros(n):
    """All -0 in: torch's bf16 sum over the row pair starts from +0, so Rc
    is +0 where a -0 + -0 word add alone would give -0 (the + 0 of
    mg2w_restrict); every other output keeps torch's signs."""
    up, fp = (torch.full((n, n), -0.0, dtype=BF16) for _ in range(2))
    V = torch.full((n // 2, n // 2), -0.0, dtype=BF16)
    h = 1.0 / n
    for nu in (1, 3):
        want = ops.packed_smooth_residual_restrict(up, fp, h, nu)
        assert not torch.signbit(want[1]).any()
        assert all(_same(a, b) for a, b in zip(_rr_model(up, fp, h, nu), want))
        for kind in ("inject", "bilinear"):
            got, _ = _pc_model(up, fp, V, h, nu, kind, rnorm=True)
            assert _same(got, ops.packed_prolong_correct_smooth(up, fp, V, h, nu, kind))


@pytest.mark.parametrize("h", [2.0 ** -k for k in range(1, 15)] + [0.01, 0.3])
def test_word_products_by_the_packed_constants_need_bf16_values(h):
    """-h^2/4 and 1/h^2 as kernels.cuda passes them to the bf16 kernels
    (ops._level: rounded to bf16, as the Pallas packed kernels round them)
    are bf16 values at every h, so the tile's word products equal torch's
    product by them in f32.  The same constants rounded to f32 only (the
    f32 forms', and the bf16 ones' before the reference's rounding) are
    bf16 values at h = 1/2^k alone: at 0.01 and 0.3 a word rounded from
    them gives other products than torch's by the f32 constant."""
    k = _K(h)
    power_of_two = float(math.log2(h)).is_integer()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4096, generator=g).to(BF16)
    for c, c32 in zip((k.mhq, k.inv_hsq), (c.value for c in cuda._packed_scalars(h))):
        as_word = x * torch.tensor(c, dtype=BF16)
        assert _same(as_word, (x.float() * torch.tensor(c, dtype=torch.float32)).to(BF16))
        assert (float(torch.tensor(c32, dtype=BF16)) == c32) == power_of_two
        as_word = x * torch.tensor(c32, dtype=BF16)
        in_f32 = (x.float() * torch.tensor(c32, dtype=torch.float32)).to(BF16)
        assert _same(as_word, in_f32) == power_of_two
