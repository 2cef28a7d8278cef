"""The arithmetic of the bf16 forms of the 3D legs (K5/K6, K11/K12) on the
word tile, pinned with plain torch, no kernel.

The word tile (mgpoisson_torch/csrc/stencil3d_zw.cuh) runs the z-marching
march with a thread's pair of x cells in one bf16x2 register, every add,
subtract and multiply one bf16x2 instruction rounded once; the xy halo is
the leg's halo rounded up to even and each stage updates the words that
hold a cell of its band.  Here:

(a) a model of one word-tile block after another (the loaded 32 x 32
    window at the even halo, words of a row's 16 lanes, the A/B neighbour
    words across the pair with a row's end lane seeing its own word, the
    stage bands, the per-half x-edge face mask, the per-constant product
    rule, red-black GS keeping one half per colour step, the f32 trilinear
    and restriction rounded once) equals ops' bf16 3D legs bit for bit:
    the down-leg, from zero, the up-leg in both kinds and its sum(r^2);
    each word op is modelled by torch's bf16 op of two bf16 values (one
    rounding of the exact result: tests/test_torch_bf16x2.py (a)), the
    fma of the face subtraction by the add of c * (-1 or 0);
(b) in 3D f32(1/adiag) = f32(-h^2/6) is a bf16 value at no h = 1/2^k,
    while 1/h^2 and adiag are: so the word tile multiplies by 1/adiag in
    f32 always (a word product by its bf16 rounding is another result);
(c) kernels.cuda's mirrors of the word tile (its geometry, chunk table,
    blocks, rnorm partials, shared memory) agree with the header's
    constants, and the f32 tile's stay as they were.
"""

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from mgpoisson_torch.kernels import cuda, ops

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

BF = torch.bfloat16
_ZW = (Path(cuda.__file__).parents[1] / "csrc" / "stencil3d_zw.cuh").read_text()
_ZM = (Path(cuda.__file__).parents[1] / "csrc" / "stencil3d_zm.cuh").read_text()


def _define(src, name):
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


def _bits(t):
    return t.contiguous().view(torch.int16)


def _bf16_value(x):
    return float(torch.tensor(x, dtype=BF)) == x


# ------------------------------------------------------------ (a) the model
class _K:
    """The level's constants as the word tile multiplies by them (Mg3wK)."""

    def __init__(self, h):
        self.inv_hsq, self.inv_adiag, self.adiag = (c.value for c in cuda._scalars(h, 3, BF))
        self.exact = _bf16_value(self.inv_hsq) and _bf16_value(self.adiag)
        self.omega = torch.tensor(ops._omega(3, BF), dtype=BF)

    def _times(self, x, c, word):
        if word:                                   # one mul.rn.bf16x2 by the word
            return x * torch.tensor(c, dtype=BF)
        return (x.float() * torch.tensor(c, dtype=torch.float32)).to(BF)   # f32, rounded once

    def by_inv_hsq(self, x):
        return self._times(x, self.inv_hsq, self.exact)

    def by_adiag(self, x):
        return self._times(x, self.adiag, self.exact)

    def by_inv_adiag(self, x):
        return self._times(x, self.inv_adiag, False)


def _halo(steps, residual):
    return steps + residual, (steps + residual) + ((steps + residual) & 1)


def _blocks(n, hw):
    t = 32 - 2 * hw                                # rows = cols: MG3W_ROWS = 32
    return [(y0, x0) for y0 in range(0, n, t) for x0 in range(0, n, t)], t


def _windows(x, blocks, hw):
    """(B, n, 32, 16, 2): each block's loaded window of the (n, n, n) x as
    words, zero outside the grid."""
    p = 32
    xp = F.pad(x.float(), (p, p, p, p)).to(x.dtype)
    w = [xp[:, y0 - hw + p:y0 - hw + p + 32, x0 - hw + p:x0 - hw + p + 32] for y0, x0 in blocks]
    return torch.stack(w).reshape(len(blocks), x.shape[0], 32, 16, 2)


def _geometry(n, blocks, hw):
    """Per block and word: in the grid (both halves), the global row, the
    even cell's global column."""
    gy = torch.tensor([[y0 - hw + j for j in range(32)] for y0, _ in blocks])
    gx = torch.tensor([[x0 - hw + 2 * lane for lane in range(16)] for _, x0 in blocks])
    inside = ((gy >= 0) & (gy < n))[:, :, None] & ((gx >= 0) & (gx < n))[:, None, :]
    return inside[:, None, :, :, None], gy, gx


def _face_masks(n, gy, gx):
    """mz (per plane), my (per row), mx (per half): -1 on the grid's edge
    of that axis, else 0, as bf16."""
    m = lambda e: torch.where(e, -1.0, 0.0).to(BF)
    z = torch.arange(n)
    mz = m((z == 0) | (z == n - 1))[None, :, None, None, None]
    my = m((gy == 0) | (gy == n - 1))[:, None, :, None, None]
    mx = m(torch.stack([gx == 0, gx + 1 == n - 1], dim=-1))[:, None, None, :, :]
    return mz, my, mx


def _shift(w, dim, d):
    """out[i] = w[i + d] along dim, zero beyond the window."""
    out = torch.zeros_like(w)
    n = w.shape[dim]
    src = w.narrow(dim, max(d, 0), n - abs(d))
    out.narrow(dim, max(-d, 0), n - abs(d)).copy_(src)
    return out


def _lr(w):
    """lf + rt of both cells from the words of the lanes beside (a row's
    end lane gets its own word, as __shfl with width 16)."""
    left = torch.cat([w[..., :1, :], w[..., :-1, :]], dim=-2)
    right = torch.cat([w[..., 1:, :], w[..., -1:, :]], dim=-2)
    A = torch.stack([left[..., 1], w[..., 0]], dim=-1)
    B = torch.stack([w[..., 1], right[..., 0]], dim=-1)
    return A + B


def _nbr(w, face, masks):
    mz, my, mx = masks
    acc = _shift(w, 1, -1) + _shift(w, 1, 1)
    if face:
        acc = acc + w * mz                         # fma.rn.bf16x2(c, m, acc)
    acc = acc + (_shift(w, 2, -1) + _shift(w, 2, 1))
    if face:
        acc = acc + w * my
    acc = acc + _lr(w)
    if face:
        acc = acc + w * mx
    return acc


def _band(s):
    """The words of stage s's band: a cell of lanes and rows [s, 31 - s]."""
    j = torch.arange(32)[:, None]
    lane = torch.arange(16)[None, :]
    return ((2 * lane + 1 >= s) & (2 * lane <= 31 - s) & (j >= s) & (j <= 31 - s))[
        None, None, :, :, None]


def _sweeps(w, fw, inside, gy, steps, smoother, face, masks, k):
    n = w.shape[1]
    # the colour of each half at z = 0: (gy + gx) % 2, gx even in the low half
    colour = ((torch.arange(n)[None, :, None] + gy[:, None, :]) % 2)[:, :, :, None, None]
    colour = torch.cat([colour, 1 - colour], dim=-1).expand(-1, -1, -1, 16, -1)
    for s in range(1, steps + 1):
        jac = k.by_inv_adiag(fw - k.by_inv_hsq(_nbr(w, face, masks)))
        if smoother == "wjacobi":
            v = w + k.omega * (jac - w)
        elif smoother == "rbgs":                   # the word computed, the colour's half kept
            v = torch.where(colour == (s - 1) % 2, jac, w)
        else:
            v = jac
        w = torch.where(_band(s) & inside, v, w)
    return w


def _owned(w, blocks, hw, t, n):
    """The blocks' owned cells of window words w assembled into (n, n, n)."""
    out = torch.empty((n, n, n), dtype=w.dtype)
    cells = w.reshape(len(blocks), n, 32, 32)
    for b, (y0, x0) in enumerate(blocks):
        ty, tx = min(t, n - y0), min(t, n - x0)
        out[:, y0:y0 + ty, x0:x0 + tx] = cells[b, :, hw:hw + ty, hw:hw + tx]
    return out


def _restrict(r):
    """mg3_sum8's f32 order, rounded once, then x 0.125 rounded."""
    n = r.shape[0]
    q = r.float().reshape(n // 2, 2, n // 2, 2, n // 2, 2)
    c = lambda dz, dy, dx: q[:, dz, :, dy, :, dx]
    s = ((c(0, 0, 0) + c(1, 0, 0)) + (c(0, 1, 0) + c(1, 1, 0))) + (
        (c(0, 0, 1) + c(1, 0, 1)) + (c(0, 1, 1) + c(1, 1, 1)))
    return (s.to(BF).float() * 0.125).to(BF)


def _prolong_f32(V, n, kind):
    """P(V) of every fine cell in f32, in mg3w_tri's tap order."""
    R = V.float()
    for ax in range(3):
        R = torch.repeat_interleave(R, 2, dim=ax)
    if kind == "inject":
        return R
    idx = torch.arange(n)
    edge = (idx == 0) | (idx == n - 1)
    a = torch.where(edge, 0.5, 0.75)
    b = torch.where(edge, 0.0, 0.25)
    view = lambda x, ax: x.reshape([-1 if i == ax else 1 for i in range(3)])

    def tap(x, ax):                                # the coarse neighbour on the parity's side
        lo, hi = _shift(x, ax, -2), _shift(x, ax, 2)
        return torch.where(view(idx % 2 == 0, ax), lo, hi)

    a0, b0, a1, b1, a2, b2 = (view(a, 0), view(b, 0), view(a, 1), view(b, 1), view(a, 2),
                              view(b, 2))
    zaa, zab, zba, zbb = a0 * a1, a0 * b1, b0 * a1, b0 * b1
    Ry, Rz = tap(R, 1), tap(R, 0)
    Rzy = tap(Ry, 0)
    p = (zaa * a2) * R
    p = p + (zaa * b2) * tap(R, 2)
    p = p + (zab * a2) * Ry
    p = p + (zab * b2) * tap(Ry, 2)
    p = p + (zba * a2) * Rz
    p = p + (zba * b2) * tap(Rz, 2)
    p = p + (zbb * a2) * Rzy
    p = p + (zbb * b2) * tap(Rzy, 2)
    return p


def _model(u, f, h, nu, smoother, bc, leg, V=None, kind=None):
    """The word tile's leg on the whole grid, block after block: K5 ("rr";
    u None: from zero) -> (u, R); K6 ("pc") -> u; K6 with rnorm
    ("pc.rnorm") -> (u, sum(r^2))."""
    n = f.shape[0]
    steps = 2 * nu if smoother == "rbgs" else nu
    _, hw = _halo(steps, leg != "pc")
    blocks, t = _blocks(n, hw)
    k, face = _K(h), bc == "face"
    inside, gy, gx = _geometry(n, blocks, hw)
    masks = _face_masks(n, gy, gx)
    fw = _windows(f, blocks, hw)
    w = torch.zeros_like(fw) if u is None else _windows(u, blocks, hw)
    if leg != "rr":                                # stage 0: u + P(V), rounded once per half
        P = _windows(_prolong_f32(V, n, kind).to(BF), blocks, hw)
        w = torch.where(inside, w + P, torch.zeros_like(w))
    w = _sweeps(w, fw, inside, gy, steps, smoother, face, masks, k)
    out = _owned(w, blocks, hw, t, n)
    if leg == "pc":
        return out
    r = fw - (k.by_inv_hsq(_nbr(w, face and leg == "rr", masks)) + k.by_adiag(w))
    r = _owned(r, blocks, hw, t, n)
    if leg == "rr":
        return out, _restrict(r)
    return out, torch.sum(r.float() * r.float(), dtype=torch.float64)


SETTINGS = [("jacobi", 1), ("jacobi", 3), ("wjacobi", 1), ("wjacobi", 3), ("rbgs", 1)]


def _as_on_the_card(monkeypatch):
    """Runs the plain ops as they run on the card, where the kernels are
    held to them.  There torch divides a bf16 tensor by a Python scalar c
    as a product by f32(1 / f32(c)), rounded once to bf16 (chip_smoke.py
    probe_scalar_division), and sums a bf16 2x2x2 restriction in f32 in
    mg3_sum8's order (probe_restrict_order_3d).  On the CPU it divides in
    f32, which may round otherwise where 1/c is inexact (1/adiag in 3D,
    1/h^2 at h = 0.01), and sums in another order, which differs where
    residuals of spread magnitudes cancel (one coarse cell at h = 0.01
    below)."""
    div, restrict = torch.Tensor.__truediv__, ops.restrict

    def divide(x, c):
        if x.dtype == BF and isinstance(c, float):
            return (x.float() * float(torch.tensor(1.0) / c)).to(BF)
        return div(x, c)
    monkeypatch.setattr(torch.Tensor, "__truediv__", divide)
    monkeypatch.setattr(ops, "restrict",
                        lambda r: _restrict(r) if r.dtype == BF and r.ndim == 3 else restrict(r))


@pytest.mark.parametrize("n,h", [(8, None), (32, None), (32, 0.01)])
@pytest.mark.parametrize("smoother,nu", SETTINGS)
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_word_tile_equals_the_plain_bf16_3d_legs(n, h, smoother, nu, bc, monkeypatch):
    _as_on_the_card(monkeypatch)
    g = torch.Generator().manual_seed(100 * n + 10 * nu + (bc == "face"))
    u, f = (torch.randn((n,) * 3, generator=g).to(BF) for _ in range(2))
    V = torch.randn((n // 2,) * 3, generator=g).to(BF)
    h = 1.0 / n if h is None else h
    a = (h, nu, smoother, bc)
    same = lambda x, y: torch.equal(_bits(x), _bits(y))
    for zero, (pu, pR) in ((False, ops.smooth_residual_restrict(u, f, *a)),
                           (True, ops.smooth_residual_restrict_zero(f, *a))):
        mu, mR = _model(None if zero else u, f, *a, "rr")
        assert same(mu, pu) and same(mR, pR), zero
    for kind in ("inject", "bilinear"):
        pu, r2 = ops.prolong_correct_smooth_rnorm(u, f, V, *a, kind)
        assert same(_model(u, f, *a, "pc", V, kind), ops.prolong_correct_smooth(u, f, V, *a, kind))
        mu, m2 = _model(u, f, *a, "pc.rnorm", V, kind)
        assert same(mu, pu), kind
        assert abs(float(m2) / float(r2) - 1.0) <= 1e-5


def test_the_halo_of_the_word_tile_is_even():
    """An odd halo (rbgs nu = 1's K5 at 3, K6 at 1 and 3) loads the window
    one cell further out, so every word is a pair (even, odd) of global x
    and a K5 coarse cell's pair is one word."""
    for steps, residual, want in ((2, 1, 4), (1, 0, 2), (3, 0, 4), (3, 1, 4), (1, 1, 2)):
        h, hw = _halo(steps, residual)
        assert hw == want and hw % 2 == 0 and hw >= h
        assert cuda.tile3d_zw(h) == (32 - 2 * hw, 32 - 2 * hw)


# --------------------------------------------------- (b) the level constants
@pytest.mark.parametrize("k", range(1, 11))
def test_inv_adiag_is_never_a_bf16_value_in_3d(k):
    """At h = 1/2^k: 1/h^2 and adiag = -6/h^2 are bf16 values, so their
    products may be words; f32(1/adiag) = f32(-h^2/6) is not, and a word
    product by its bf16 rounding differs from torch's on some values, so
    the word tile multiplies by it in f32 and rounds once."""
    inv_hsq, inv_adiag, adiag = (c.value for c in cuda._scalars(2.0 ** -k, 3, BF))
    assert _bf16_value(inv_hsq) and _bf16_value(adiag)
    assert not _bf16_value(inv_adiag)
    x = torch.randn(4096, generator=torch.Generator().manual_seed(k)).to(BF)
    torch_way = x / (-6.0 * 4.0 ** k)
    in_f32 = (x.float() * torch.tensor(inv_adiag, dtype=torch.float32)).to(BF)
    as_word = x * torch.tensor(inv_adiag, dtype=BF)
    assert torch.equal(_bits(in_f32), _bits(torch_way))
    assert not torch.equal(_bits(as_word), _bits(torch_way))


# ------------------------------------------------------------ (c) the mirrors
def test_word_tile_constants_mirror_the_header():
    assert cuda.ZW_LANES == _define(_ZW, "MG3W_LANES")
    assert cuda.ZW_ROWS == _define(_ZW, "MG3W_ROWS")
    assert cuda.ZW_MIN_BLOCKS == _define(_ZW, "MG3W_MIN_BLOCKS")
    assert 2 * cuda.ZW_LANES == cuda.ZM_COLS == _define(_ZM, "MG3Z_COLS")
    assert (cuda.ZM_SMS, cuda.ZM_MIN_CHUNK) == (_define(_ZM, "MG3Z_SMS"),
                                                _define(_ZM, "MG3Z_MIN_CHUNK"))


def _word_chunk(n, nzl, nyl, halo):
    """mg3w_chunk, written out: the fewest rounds x plane-steps over
    2 x 132 slots, the largest chunk of the cheapest."""
    ty, tx = cuda.tile3d_zw(halo)
    cols = -(-n // tx) * -(-nyl // ty)
    cands = [nzl >> i for i in range(12)
             if (nzl >> i) >= 1 and ((nzl >> i) == nzl or (nzl >> i) >= cuda.ZM_MIN_CHUNK)]
    cost = {c: -(-(cols * (nzl // c)) // (cuda.ZM_SMS * cuda.ZW_MIN_BLOCKS)) * (c + 2 * halo)
            for c in cands}
    return max(c for c, v in cost.items() if v == min(cost.values()))


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2), (4, 1)])
def test_word_tile_launch_mirrors(mesh):
    """The bf16 legs' chunk, blocks and K6/K12 rnorm partials follow the
    word tile; the f32 legs' stay the f32 tile's."""
    for n in (16, 64, 256, 512):
        nzl, nyl = n // mesh[0], n // mesh[1]
        for halo in range(1, cuda.ZM_MAX_HALO + 1):
            c = cuda.zm_chunk(n, halo, nzl, nyl, torch.bfloat16)
            assert c == _word_chunk(n, nzl, nyl, halo)
            ty, tx = cuda.tile3d_zw(halo)
            blocks = -(-n // tx) * -(-nyl // ty) * (nzl // c)
            assert cuda.blocks3d(n, halo, nzl, nyl, torch.bfloat16) == blocks
            t = cuda.tile3d_zm(halo)
            assert cuda.blocks3d(n, halo, nzl, nyl) == (
                -(-n // t) * -(-nyl // t) * (nzl // cuda.zm_chunk(n, halo, nzl, nyl)))
        for smoother, nu in (("wjacobi", 3), ("rbgs", 1)):
            halo = (2 * nu if smoother == "rbgs" else nu) + 1
            shape = (nzl, nyl, n)
            want = cuda.blocks3d(n, halo, nzl, nyl, torch.bfloat16)
            assert cuda.strip_rnorm_partials(shape, nu, smoother, n, torch.bfloat16) == want
            if mesh == (1, 1):
                assert cuda.rnorm_partials(shape, nu, smoother, n, torch.bfloat16) == want
    # the main path: 256^3 at halo 4, whole grid and the (128, 128, 256) block
    assert (cuda.zm_chunk(256, 4, dtype=torch.bfloat16),
            cuda.blocks3d(256, 4, dtype=torch.bfloat16)) == (128, 242)
    assert (cuda.zm_chunk(256, 4, 128, 128, torch.bfloat16),
            cuda.blocks3d(256, 4, 128, 128, torch.bfloat16)) == (32, 264)
    assert (cuda.zm_chunk(256, 4), cuda.blocks3d(256, 4)) == (256, 121)
    assert (cuda.zm_chunk(256, 4, 128, 128), cuda.blocks3d(256, 4, 128, 128)) == (64, 132)


@pytest.mark.parametrize("steps", range(0, cuda.ZM_MAX_HALO + 1))
def test_word_tile_shared_memory(steps):
    """mg3w_bytes: two word planes per stage, K5's four, K6's f32 coarse
    ring of three planes; the f32 tile's mg3z_bytes as before.  K12 adds
    its f queue of steps + 2 word planes (the strip-fed up-leg keeps it in
    shared memory, not in registers), and still fits 48 KB."""
    lanes, rows = cuda.ZW_LANES, cuda.ZW_ROWS
    plane = lanes * rows
    ring = 3 * (cuda.ZM_COLS // 2 + 3) * (rows // 2 + 3)
    for rr in (True, False):
        got = cuda.shared_bytes_3d_zm(steps, rr=rr, pc=not rr, dtype=torch.bfloat16)
        assert got == 4 * (2 * (steps + 1) * plane + (4 * plane if rr else ring))
        f32 = cuda.shared_bytes_3d_zm(steps, rr=rr, pc=not rr)
        assert f32 == 4 * (2 * (steps + 1) * 1024 + (4 * 1024 if rr else 3 * 19 * 19))
        fq = 0 if rr else 4 * (steps + 2) * plane
        assert got <= f32 // 2 + 4 * ring and got + fq <= 48 * 1024
