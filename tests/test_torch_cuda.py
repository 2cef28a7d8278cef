"""The CUDA kernels of mgpoisson_torch against their plain torch versions,
on the card.

The kernels have no CPU mode, so every test here is marked `cuda` and
skips without a CUDA device.  The file imports no JAX, so it also runs
where JAX is not installed; tests/conftest.py imports JAX, hence:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Sizes include levels smaller than one tile (a warp's 64 columns in 2D,
down to 2x2; 16^3 or 8^3 in 3D; the register tile's warp for the packed
K7/K8) and levels of several tiles; the
strip kernels K9-K12 run every block position of (2, 2) and (4, 1) meshes,
blocks and strips cut from a whole grid as the ranks' exchange delivers
them.  Bars: normalized max |diff| <= 1e-5 (the ROADMAP's f32 kernel bar),
and bit-equality where a kernel rounds each operation as its plain version
does (K7/K8, K13/K14, K11/K12 and the cube tile); 1e-5 relative on
sum(r^2), whose partials are summed in another order.  The solver takes
f and psi0 of any strides and offset (test_solver_takes_any_strided_input)."""

import itertools

import numpy as np
import pytest
import torch

from mgpoisson_torch import MultigridPoisson, Spec
from mgpoisson_torch.kernels import cuda, ops
from mgpoisson_torch.shard.spmd import block_from_grid


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _data(n, seed, device, ndim=2):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((s,) * ndim, generator=g, device=device)
            for s in (n, n, n // 2)]


def _nmax(got, want):
    """max |got - want| over max |want|; the absolute max where want is all
    zero (a 1x1 coarse R of a 2x2 level can be)."""
    d = float((got.double() - want.double()).abs().max())
    m = float(want.double().abs().max())
    return d / m if m > 0 else d


# 2D: each smoother at its sweep cap (nu <= 8, <= 4 for rbgs) or the tuned
# scheme's wjacobi nu = 3, so every row of the tile table (kernels.cuda
# tile2d: at wjacobi 3 the small tile up to 512 and the shallow one at 1024
# and 2048, the deep one at jacobi 7 and rbgs 4), at sides 2 ... 2048:
# below one warp's tile, the first levels where a warp's loaded region
# lies inside the grid, and several tiles.  3D: levels smaller than one
# tile (16^3 at T = 16), one tile and several; the sweep counts at the
# composites' halo cap (radius*nu + 1 <= 8), where the tile narrows to 8,
# and wjacobi nu = 3 (T = 16).
CASES = ([(2, n, s, nu) for n in (2, 4, 8, 16, 32, 64, 256, 512, 1024, 2048)
          for s, nu in (("jacobi", 7), ("wjacobi", 3), ("rbgs", 4))]
         + [(3, n, s, nu) for n in (16, 32, 64)
            for s, nu in (("jacobi", 7), ("wjacobi", 3), ("rbgs", 3))])


@pytest.mark.cuda
@pytest.mark.parametrize("ndim,n,smoother,nu", CASES)
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_kernels_vs_plain(card, ndim, n, smoother, nu, bc):
    u, f, V = _data(n, n + nu, card, ndim)
    h = 1.0 / n
    a = (h, nu, smoother, bc)
    assert _nmax(cuda.smooth(u, f, *a), ops.smooth(u, f, *a)) <= 1e-5
    for got, want in zip(cuda.smooth_residual_restrict(u, f, *a),
                         ops.smooth_residual_restrict(u, f, *a)):
        assert _nmax(got, want) <= 1e-5
    for got, want in zip(cuda.smooth_residual_restrict_zero(f, *a),
                         ops.smooth_residual_restrict_zero(f, *a)):
        assert _nmax(got, want) <= 1e-5
    for kind in ("inject", "bilinear"):
        pa = (u, f, V, h, nu, smoother, bc, kind)
        assert _nmax(cuda.prolong_correct_smooth(*pa),
                     ops.prolong_correct_smooth(*pa)) <= 1e-5
        got_u, got_r2 = cuda.prolong_correct_smooth_rnorm(*pa)
        want_u, want_r2 = ops.prolong_correct_smooth_rnorm(*pa)
        assert _nmax(got_u, want_u) <= 1e-5
        assert abs(float(got_r2) / float(want_r2) - 1.0) <= 1e-5
    torch.cuda.synchronize()


# the whole-grid K5/K6 on the z-marching tile (csrc/stencil3d_zm.cuh,
# halos <= 4): sides below one 32 x 32 column and one 64-plane chunk (2, 4,
# 8), one column of several chunks' worth (128), and several (256); the
# tuned scheme's wjacobi nu = 3, the fast scheme's rbgs nu = 1, jacobi nu =
# 1, and rbgs nu = 2 (halo 5: the cube tile) beside them.  The z-marching
# tile rounds as the plain ops do: its u and R equal them bit for bit.
ZM_CASES = [(n, s, nu) for n in (2, 4, 8, 128, 256)
            for s, nu in (("wjacobi", 3), ("rbgs", 1), ("jacobi", 1), ("rbgs", 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,smoother,nu", ZM_CASES)
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_kernels3d_zmarch_vs_plain(card, n, smoother, nu, bc):
    u, f, V = _data(n, n + nu, card, ndim=3)
    h = 1.0 / n
    a = (h, nu, smoother, bc)
    steps = 2 * nu if smoother == "rbgs" else nu

    def same(got, want, halo):
        if cuda.zmarch3d(halo):
            assert torch.equal(got, want)
        assert _nmax(got, want) <= 1e-5

    for got, want in zip(cuda.smooth_residual_restrict(u, f, *a),
                         ops.smooth_residual_restrict(u, f, *a)):
        same(got, want, steps + 1)
    for got, want in zip(cuda.smooth_residual_restrict_zero(f, *a),
                         ops.smooth_residual_restrict_zero(f, *a)):
        same(got, want, steps + 1)
    for kind in ("inject", "bilinear"):
        pa = (u, f, V, h, nu, smoother, bc, kind)
        same(cuda.prolong_correct_smooth(*pa), ops.prolong_correct_smooth(*pa), steps)
        got_u, got_r2 = cuda.prolong_correct_smooth_rnorm(*pa)
        want_u, want_r2 = ops.prolong_correct_smooth_rnorm(*pa)
        same(got_u, want_u, steps + 1)
        assert abs(float(got_r2) / float(want_r2) - 1.0) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernels3d_halo_caps(card):
    """K4 alone takes a halo of 8 (rbgs nu = 4, jacobi nu = 8); the
    composites, which read one more ring, do not."""
    u, f, V = _data(32, 5, card, ndim=3)
    h = 1.0 / 32
    for smoother, nu in (("rbgs", 4), ("jacobi", 8)):
        a = (h, nu, smoother, "face")
        assert _nmax(cuda.smooth(u, f, *a), ops.smooth(u, f, *a)) <= 1e-5
        with pytest.raises(ValueError, match="no kernel"):
            cuda.smooth_residual_restrict(u, f, *a)
        with pytest.raises(ValueError, match="no kernel"):
            cuda.prolong_correct_smooth_rnorm(u, f, V, *a)
    # K6 without rnorm reads no residual ring
    a = (u, f, V, h, 4, "rbgs", "ghost0", "bilinear")
    assert _nmax(cuda.prolong_correct_smooth(*a), ops.prolong_correct_smooth(*a)) <= 1e-5
    with pytest.raises(ValueError, match="square 2D or cubic 3D"):
        cuda.smooth(u[:16].contiguous(), f[:16].contiguous(), h, 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(card):
    u, f, V = _data(64, 0, card)
    with pytest.raises(ValueError, match="no kernel"):
        cuda.smooth(u.double(), f.double(), 1 / 64, 1, "jacobi", "ghost0")
    with pytest.raises(ValueError, match="no kernel"):
        cuda.smooth(u, f, 1 / 64, 5, "rbgs", "ghost0")
    with pytest.raises(ValueError, match="contiguous"):
        cuda.smooth(u.t(), f, 1 / 64, 1, "jacobi", "ghost0")
    with pytest.raises(ValueError, match="does not match"):
        cuda.prolong_correct_smooth(u, f, u, 1 / 64, 1, "jacobi", "ghost0")
    # the 2D tile moves 8 bytes per lane: an operand at an odd offset is refused
    odd = torch.randn(64 * 64 + 1, device=card)[1:].view(64, 64)
    with pytest.raises(RuntimeError, match="misaligned"):
        cuda.smooth(odd, f, 1 / 64, 1, "jacobi", "ghost0")
    with pytest.raises(RuntimeError, match="misaligned"):
        cuda.smooth_residual_restrict(u, odd, 1 / 64, 1, "jacobi", "ghost0")


# the packed kernels: below one tile (a warp's 64 columns), one tile and
# several, at the sweep counts 1 and the cap 3.  K7 and K8 round each
# operation as the plain packed ops: bit-equal.
@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 64, 256, 1024])
@pytest.mark.parametrize("nu", [1, 3])
def test_packed_kernels_vs_plain(card, n, nu):
    u, f, V = _data(n, n + nu, card)
    up, fp = cuda.pack_grid(u), cuda.pack_grid(f)
    h = 1.0 / n
    for got, want in zip(cuda.packed_smooth_residual_restrict(up, fp, h, nu),
                         ops.packed_smooth_residual_restrict(up, fp, h, nu)):
        assert torch.equal(got, want)
    for kind in ("inject", "bilinear"):
        pa = (up, fp, V, h, nu, kind)
        assert torch.equal(cuda.packed_prolong_correct_smooth(*pa),
                           ops.packed_prolong_correct_smooth(*pa))
        got_u, got_r2 = cuda.packed_prolong_correct_smooth_rnorm(*pa)
        want_u, want_r2 = ops.packed_prolong_correct_smooth_rnorm(*pa)
        assert torch.equal(got_u, want_u)
        assert abs(float(got_r2) / float(want_r2) - 1.0) <= 1e-5
    assert torch.equal(cuda.unpack_grid(up), u)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_packed_wrappers_reject_what_the_kernels_do_not_take(card):
    u, f, V = _data(64, 2, card)
    h = 1 / 64
    with pytest.raises(ValueError, match="no kernel"):
        cuda.packed_smooth_residual_restrict(u, f, h, 4)
    with pytest.raises(ValueError, match="no kernel"):
        cuda.packed_prolong_correct_smooth(u.double(), f.double(), V.double(), h, 1)
    odd = torch.zeros(15, 15, device=card)
    with pytest.raises(ValueError, match="no kernel"):
        cuda.packed_smooth_residual_restrict(odd, odd, h, 1)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.packed_prolong_correct_smooth_rnorm(u.t(), f, V, h, 1)
    with pytest.raises(ValueError, match="does not match"):
        cuda.packed_prolong_correct_smooth(u, f, u, h, 1)


@pytest.mark.cuda
def test_launch_counters(card):
    u, f, V = _data(256, 1, card)
    cuda.reset_launches()
    cuda.smooth_residual_restrict_zero(f, 1 / 256, 3, "wjacobi", "face")
    cuda.prolong_correct_smooth_rnorm(u, f, V, 1 / 256, 3, "wjacobi", "ghost0",
                                      "bilinear")
    want = dict.fromkeys(cuda.launches, 0)
    want.update({"mg_smooth_rr": 1, "mg_smooth_rr.zero": 1,
                 "mg_prolong_correct_smooth": 1,
                 "mg_prolong_correct_smooth.rnorm": 1})
    assert cuda.launches == want
    u, f, V = _data(32, 1, card, ndim=3)
    cuda.reset_launches()
    cuda.smooth(u, f, 1 / 32, 3, "wjacobi", "ghost0")
    cuda.smooth_residual_restrict(u, f, 1 / 32, 3, "wjacobi", "ghost0")
    cuda.smooth_residual_restrict_zero(f, 1 / 32, 3, "wjacobi", "face")
    cuda.prolong_correct_smooth(u, f, V, 1 / 32, 3, "wjacobi", "face", "bilinear")
    cuda.prolong_correct_smooth_rnorm(u, f, V, 1 / 32, 3, "wjacobi", "ghost0",
                                      "bilinear")
    want = dict.fromkeys(cuda.launches, 0)
    want.update({"mg_smooth3d": 1, "mg_smooth_rr3d": 2, "mg_smooth_rr3d.zero": 1,
                 "mg_prolong_correct_smooth3d": 2,
                 "mg_prolong_correct_smooth3d.rnorm": 1})
    assert cuda.launches == want
    u, f, V = _data(256, 1, card)
    cuda.reset_launches()
    cuda.packed_smooth_residual_restrict(u, f, 1 / 256, 1)
    cuda.packed_prolong_correct_smooth(u, f, V, 1 / 256, 1, "bilinear")
    cuda.packed_prolong_correct_smooth_rnorm(u, f, V, 1 / 256, 1, "bilinear")
    cuda.pack_grid(u)
    want = dict.fromkeys(cuda.launches, 0)
    want.update({"mg_packed_rr": 1, "mg_packed_pc": 2, "mg_packed_pc.rnorm": 1})
    assert cuda.launches == want


# the strip kernels: blocks below one tile, of one tile and of several, on
# meshes with and without a column neighbour; in 3D every side 256 ... 8 on
# both meshes (blocks of 2 planes up to (128, 128, 256) and (64, 256,
# 256), one z-marching chunk or several)
SHARDED = ([(2, 64, (2, 2)), (2, 64, (4, 1)), (2, 256, (2, 2)), (2, 4096, (2, 2))]
           + [(3, n, mesh) for n in (256, 128, 64, 32, 16, 8) for mesh in ((2, 2), (4, 1))])


def _blocks(n, mesh, ndim):
    shape = (n // mesh[0], n // mesh[1]) + (n,) * (ndim - 2)
    for i, j in itertools.product(range(mesh[0]), range(mesh[1])):
        yield (i * shape[0], j * shape[1]), shape


@pytest.mark.cuda
@pytest.mark.parametrize("ndim,n,mesh", SHARDED)
@pytest.mark.parametrize("smoother,nu", [("wjacobi", 3), ("rbgs", 2), ("jacobi", 1),
                                         ("rbgs", 1)])
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_sharded_kernels_vs_plain(card, ndim, n, mesh, smoother, nu, bc):
    """Every block's outputs against the plain block ops; in 3D they are
    equal bit for bit (K11/K12 round as the plain ops do on either tile),
    and stitched over the blocks they equal K5/K6 on the whole grid."""
    u, f, V = _data(n, n + nu, card, ndim)
    d = ops.sweep_radius(smoother) * nu + 1
    cols = mesh[1] > 1
    h = 1.0 / n

    def same(got, want):
        if ndim == 3:
            assert torch.equal(got, want)
        assert _nmax(got, want) <= 1e-5

    whole = {"rr": cuda.smooth_residual_restrict(u, f, h, nu, smoother, bc),
             "rrz": cuda.smooth_residual_restrict_zero(f, h, nu, smoother, bc)}
    for kind in ("inject", "bilinear"):
        whole[kind] = (cuda.prolong_correct_smooth(u, f, V, h, nu, smoother, bc, kind),
                       *cuda.prolong_correct_smooth_rnorm(u, f, V, h, nu, smoother, bc, kind))
    st = {k: [torch.empty_like(x) for x in v[:2]] for k, v in whole.items()}
    r2 = dict.fromkeys(("inject", "bilinear"), 0.0)
    for origin, shape in _blocks(n, mesh, ndim):
        ub, us = block_from_grid(u, origin, shape, d, cols)
        fb, fs = block_from_grid(f, origin, shape, d, cols)
        vb, vs = block_from_grid(V, [o // 2 for o in origin], [s // 2 for s in shape],
                                 ops.coarse_depth(d), cols)
        fine = tuple(slice(o, o + s) for o, s in zip(origin, shape[:2]))
        coarse = tuple(slice(o // 2, (o + s) // 2) for o, s in zip(origin, shape[:2]))
        a = (origin, n, h, nu, smoother, bc)
        for key, args, zero in (("rr", (ub, fb, us, fs), False),
                                ("rrz", (None, fb, None, fs), True)):
            got = cuda.smooth_rr_sharded(*args, *a, zero=zero)
            for g, w in zip(got, ops.smooth_rr_sharded(*args, *a, zero=zero)):
                same(g, w)
            st[key][0][fine], st[key][1][coarse] = got
        for kind in ("inject", "bilinear"):
            pa = (ub, fb, vb, us, fs, vs, origin, n, h, nu, smoother, bc, kind)
            got = cuda.pc_smooth_sharded(*pa)
            same(got, ops.pc_smooth_sharded(*pa))
            (gu, g2), (wu, w2) = (cuda.pc_smooth_sharded(*pa, rnorm=True),
                                  ops.pc_smooth_sharded(*pa, rnorm=True))
            same(gu, wu)
            assert abs(float(g2) / float(w2) - 1.0) <= 1e-5
            st[kind][0][fine], st[kind][1][fine] = got, gu
            r2[kind] += float(g2)
    if ndim == 3:
        for key, outs in st.items():
            for got, want in zip(outs, whole[key]):
                assert torch.equal(got, want), key
        for kind, total in r2.items():
            assert abs(total / float(whole[kind][2]) - 1.0) <= 1e-5
    torch.cuda.synchronize()


def _guarded(x, pad):
    """x in the middle of a NaN-filled buffer: a kernel that reads past
    either end of x reads NaN."""
    buf = torch.full((x.numel() + 2 * pad,), float("nan"), device=x.device)
    buf[pad:pad + x.numel()] = x.reshape(-1)
    return buf[pad:pad + x.numel()].view(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)])
@pytest.mark.parametrize("smoother,nu", [("wjacobi", 3), ("rbgs", 1), ("jacobi", 2)])
def test_sharded3d_kernels_read_nothing_beyond_their_strips(card, mesh, smoother, nu):
    """K11/K12 on the z-marching tile read only their block and strips:
    with the strips exactly as deep as the legs need (D = the halo, DV =
    ops.coarse_depth(D)) and every array in the middle of NaN, the outputs
    still equal the plain ones.  At halo 4 (wjacobi nu = 3 with rnorm) the
    coarse ring's last prefetch lies one plane past V's bottom strip of
    every block, and its first planes at the top strip's first."""
    n = 64
    u, f, V = _data(n, 31 + nu, card, ndim=3)
    h, cols = 1.0 / n, mesh[1] > 1
    for rnorm in (False, True):
        d = ops.sweep_radius(smoother) * nu + rnorm
        for origin, shape in _blocks(n, mesh, 3):
            ub, us = block_from_grid(u, origin, shape, d, cols)
            fb, fs = block_from_grid(f, origin, shape, d, cols)
            vb, vs = block_from_grid(V, [o // 2 for o in origin], [s // 2 for s in shape],
                                     ops.coarse_depth(d), cols)
            pad = ub.numel()
            g = [[_guarded(x, pad) if x is not None else None for x in xs]
                 for xs in ((ub, fb, vb), us, fs, vs)]
            a = (origin, n, h, nu, smoother, "face")
            if rnorm:
                for got, want in zip(cuda.smooth_rr_sharded(g[0][0], g[0][1], g[1], g[2], *a),
                                     ops.smooth_rr_sharded(ub, fb, us, fs, *a)):
                    assert torch.equal(got, want)
            pa = (*g[0], *g[1:], *a, "bilinear")
            want = ops.pc_smooth_sharded(ub, fb, vb, us, fs, vs, *a, "bilinear", rnorm=rnorm)
            got = cuda.pc_smooth_sharded(*pa, rnorm=rnorm)
            if rnorm:
                assert torch.equal(got[0], want[0])
                assert abs(float(got[1]) / float(want[1]) - 1.0) <= 1e-5
            else:
                assert torch.equal(got, want)
    torch.cuda.synchronize()


# the cube tile (K4 at every halo, K5/K6 and K11/K12 at halos 5-8) rounds
# as the plain ops do since it takes each add and multiply on its own: its
# outputs equal them bit for bit.  n = 2, face, jacobi nu = 4 puts K5's
# 1x1x1 coarse R, a sum with cancellation, at halo 5.
CUBE_CASES = [(n, s, nu) for n in (2, 4, 8, 16, 32)
              for s, nu in (("jacobi", 4), ("rbgs", 2), ("wjacobi", 5), ("jacobi", 7))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,smoother,nu", CUBE_CASES)
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_cube_tile_rounds_like_plain(card, n, smoother, nu, bc):
    u, f, V = _data(n, 3 * n + nu, card, ndim=3)
    a = (1.0 / n, nu, smoother, bc)
    assert torch.equal(cuda.smooth(u, f, *a), ops.smooth(u, f, *a))
    for got, want in zip(cuda.smooth_residual_restrict(u, f, *a)
                         + cuda.smooth_residual_restrict_zero(f, *a),
                         ops.smooth_residual_restrict(u, f, *a)
                         + ops.smooth_residual_restrict_zero(f, *a)):
        assert torch.equal(got, want)
    for kind in ("inject", "bilinear"):
        pa = (u, f, V, *a, kind)
        assert torch.equal(cuda.prolong_correct_smooth(*pa), ops.prolong_correct_smooth(*pa))
        (gu, g2), (wu, w2) = (cuda.prolong_correct_smooth_rnorm(*pa),
                              ops.prolong_correct_smooth_rnorm(*pa))
        assert torch.equal(gu, wu)
        assert abs(float(g2) / float(w2) - 1.0) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sharded_wrappers_reject_what_the_kernels_do_not_take(card):
    u, f, V = _data(64, 3, card)
    ub, us = block_from_grid(u, (0, 32), (32, 32), 4)
    a = ((0, 32), 64, 1 / 64, 3, "wjacobi", "ghost0")
    with pytest.raises(ValueError, match="strips 2 deep"):
        cuda.smooth_rr_sharded(ub, ub, *[block_from_grid(u, (0, 32), (32, 32), 2)[1]] * 2, *a)
    with pytest.raises(ValueError, match="spans every column"):
        cuda.smooth_rr_sharded(ub, ub, us[:2] + (None, None), us, *a)
    with pytest.raises(ValueError, match="even block"):
        cuda.smooth_rr_sharded(ub, ub, us, us, (1, 32), *a[1:])
    with pytest.raises(ValueError, match="no kernel"):
        cuda.smooth_rr_sharded(ub.double(), ub.double(), [s.double() for s in us],
                               [s.double() for s in us], *a)


@pytest.mark.cuda
def test_sharded_launch_counters(card):
    cuda.reset_launches()
    for ndim, n in ((2, 64), (3, 32)):
        u, f, V = _data(n, 4, card, ndim)
        shape = (n // 2, n // 2) + (n,) * (ndim - 2)
        ub, us = block_from_grid(u, (0, 0), shape, 4)
        vb, vs = block_from_grid(V, (0, 0), [s // 2 for s in shape], 3)
        a = ((0, 0), n, 1 / n, 3, "wjacobi", "face")
        cuda.smooth_rr_sharded(None, ub, None, us, *a, zero=True)
        cuda.pc_smooth_sharded(ub, ub, vb, us, us, vs, *a, "bilinear", rnorm=True)
        cuda.pc_smooth_sharded(ub, ub, vb, us, us, vs, *a, "bilinear")
    want = dict.fromkeys(cuda.launches, 0)
    want.update({"mg_sharded_rr": 1, "mg_sharded_rr.zero": 1, "mg_sharded_pc": 2,
                 "mg_sharded_pc.rnorm": 1, "mg_sharded_rr3d": 1, "mg_sharded_rr3d.zero": 1,
                 "mg_sharded_pc3d": 2, "mg_sharded_pc3d.rnorm": 1})
    assert cuda.launches == want


# the packed strip kernels: every block of a mesh of one column, blocks of
# one tile (256 on (8, 1): 32 rows) and of many (4096 on (4, 1)), at every
# sweep count; the blocks' outputs stitched over the grid are K7/K8's
PACKED_SHARDED = [(4096, 4), (1024, 2), (256, 8)]


def _packed_blocks(n, mx, nu, up, fp, V):
    nl, d = n // mx, 2 * nu + 1
    for r0 in range(0, n, nl):
        yield (r0, *block_from_grid(up, (r0, 0), (nl, n), d, cols=False),
               *block_from_grid(fp, (r0, 0), (nl, n), d, cols=False),
               *block_from_grid(V, (r0 // 2, 0), (nl // 2, n // 2), ops.coarse_depth(d),
                                cols=False))


@pytest.mark.cuda
@pytest.mark.parametrize("n,mx", PACKED_SHARDED)
@pytest.mark.parametrize("nu", [1, 2, 3])
def test_sharded_packed_kernels_vs_plain(card, n, mx, nu):
    u, f, V = _data(n, n + nu + 13, card)
    up, fp = cuda.pack_grid(u), cuda.pack_grid(f)
    h, nl = 1.0 / n, n // mx
    whole_u, whole_R = cuda.packed_smooth_residual_restrict(up, fp, h, nu)
    st_u, st_R = torch.empty_like(up), torch.empty_like(whole_R)
    whole = {k: cuda.packed_prolong_correct_smooth_rnorm(up, fp, V, h, nu, k)
             for k in ("inject", "bilinear")}
    st = {k: torch.empty_like(up) for k in whole}
    r2 = dict.fromkeys(whole, 0.0)
    for r0, ub, us, fb, fs, vb, vs in _packed_blocks(n, mx, nu, up, fp, V):
        b = ((r0, 0), n, h, nu)
        got, want = (cuda.packed_rr_sharded(ub, fb, us, fs, *b),
                     ops.packed_rr_sharded(ub, fb, us, fs, *b))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        st_u[r0:r0 + nl], st_R[r0 // 2:(r0 + nl) // 2] = got
        for kind in whole:
            pa = (ub, fb, vb, us, fs, vs, *b, kind)
            assert torch.equal(cuda.packed_pc_sharded(*pa), ops.packed_pc_sharded(*pa))
            (gu, g2), (wu, w2) = (cuda.packed_pc_sharded(*pa, rnorm=True),
                                  ops.packed_pc_sharded(*pa, rnorm=True))
            assert torch.equal(gu, wu)
            assert abs(float(g2) / float(w2) - 1.0) <= 1e-5
            st[kind][r0:r0 + nl] = gu
            r2[kind] += float(g2)
    # the same tiles and arithmetic as on the whole grid
    assert torch.equal(st_u, whole_u) and torch.equal(st_R, whole_R)
    for kind, (wu, w2) in whole.items():
        assert torch.equal(st[kind], wu)
        assert abs(r2[kind] / float(w2) - 1.0) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n,mx", [(256, 4), (64, 2)])
@pytest.mark.parametrize("nu", [1, 2, 3])
def test_sharded_packed_pc_reads_nothing_beyond_its_strips(card, n, mx, nu):
    """K14, and K13, read only their block and strips: with the strips the
    solver exchanges (D = 2 nu + 1, Dv = ops.coarse_depth(D)) and every
    operand in the middle of NaN, their outputs still equal the plain ones.
    With a residual (K13, K14 with rnorm) the tile's even halo, 2 nu + 2,
    reaches one row beyond the strips."""
    u, f, V = _data(n, 41 + nu, card)
    up, fp = cuda.pack_grid(u), cuda.pack_grid(f)
    h = 1.0 / n
    for r0, ub, us, fb, fs, vb, vs in _packed_blocks(n, mx, nu, up, fp, V):
        pad = ub.numel()
        g = [[_guarded(x, pad) if x is not None else None for x in xs]
             for xs in ((ub, fb, vb), us, fs, vs)]
        b = ((r0, 0), n, h, nu)
        for got, want in zip(cuda.packed_rr_sharded(g[0][0], g[0][1], g[1], g[2], *b),
                             ops.packed_rr_sharded(ub, fb, us, fs, *b)):
            assert torch.equal(got, want)
        for kind in ("inject", "bilinear"):
            b = ((r0, 0), n, h, nu, kind)
            assert torch.equal(cuda.packed_pc_sharded(*g[0], *g[1:], *b),
                               ops.packed_pc_sharded(ub, fb, vb, us, fs, vs, *b))
            (gu, g2), (wu, w2) = (cuda.packed_pc_sharded(*g[0], *g[1:], *b, rnorm=True),
                                  ops.packed_pc_sharded(ub, fb, vb, us, fs, vs, *b, rnorm=True))
            assert torch.equal(gu, wu)
            assert abs(float(g2) / float(w2) - 1.0) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sharded_packed_wrappers_reject_what_the_kernels_do_not_take(card):
    u, f, V = _data(64, 6, card)
    up, fp = cuda.pack_grid(u), cuda.pack_grid(f)
    ub, us = block_from_grid(up, (32, 0), (32, 64), 3, cols=False)
    vb, vs = block_from_grid(V, (16, 0), (16, 32), 3, cols=False)
    b = ((32, 0), 64, 1 / 64, 1)
    shallow = block_from_grid(up, (32, 0), (32, 64), 2, cols=False)[1]
    with pytest.raises(ValueError, match="strips 2 deep"):
        cuda.packed_rr_sharded(ub, ub, shallow, shallow, *b)
    with pytest.raises(ValueError, match="row strips"):
        cuda.packed_rr_sharded(ub, ub, block_from_grid(up, (32, 0), (32, 64), 3)[1], us, *b)
    with pytest.raises(ValueError, match="whole rows"):
        cuda.packed_rr_sharded(ub[:, :32].contiguous(), ub[:, :32].contiguous(), us, us,
                               (32, 32), *b[1:])
    with pytest.raises(ValueError, match="even block"):
        cuda.packed_rr_sharded(ub, ub, us, us, (33, 0), *b[1:])
    with pytest.raises(ValueError, match="no kernel"):
        cuda.packed_rr_sharded(ub, ub, us, us, (32, 0), 64, 1 / 64, 4)
    with pytest.raises(ValueError, match="no kernel"):
        dbl = [s.double() for s in us[:2]] + [None, None]
        cuda.packed_rr_sharded(ub.double(), ub.double(), dbl, dbl, *b)
    with pytest.raises(ValueError, match="does not match"):
        cuda.packed_pc_sharded(ub, ub, ub, us, us, vs, *b)
    with pytest.raises(ValueError, match="unknown prolongation"):
        cuda.packed_pc_sharded(ub, ub, vb, us, us, vs, *b, "cubic")
    with pytest.raises(ValueError, match="contiguous"):
        cuda.packed_pc_sharded(ub, ub, vb, us, us, (vs[0].t().contiguous().t(), vs[1], None,
                                                    None), *b)
    assert _nmax(cuda.packed_pc_sharded(ub, ub, vb, us, us, vs, *b, "bilinear", rnorm=True)[0],
                 ops.packed_pc_sharded(ub, ub, vb, us, us, vs, *b, "bilinear",
                                       rnorm=True)[0]) <= 1e-5


@pytest.mark.cuda
def test_sharded_packed_launch_counters(card):
    u, f, V = _data(256, 8, card)
    ub, us = block_from_grid(u, (64, 0), (64, 256), 3, cols=False)
    vb, vs = block_from_grid(V, (32, 0), (32, 128), 3, cols=False)
    b = ((64, 0), 256, 1 / 256, 1)
    cuda.reset_launches()
    cuda.packed_rr_sharded(ub, ub, us, us, *b)
    cuda.packed_pc_sharded(ub, ub, vb, us, us, vs, *b, "bilinear")
    cuda.packed_pc_sharded(ub, ub, vb, us, us, vs, *b, "bilinear", rnorm=True)
    want = dict.fromkeys(cuda.launches, 0)
    want.update({"mg_sharded_packed_rr": 1, "mg_sharded_packed_pc": 2,
                 "mg_sharded_packed_pc.rnorm": 1})
    assert cuda.launches == want


def _misaligned(x):
    """x's values in a dense row-major view at an odd 4-byte offset."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 8 == 4
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["tuned", "fast"])
def test_solver_takes_any_strided_input(card, scheme):
    """solve() takes f and psi0 of any strides and offset, as the JAX
    package takes any array: a transposed f, a Fortran-order NumPy f or
    psi0 and a view at an odd 4-byte offset give the psi and the iteration
    count of their dense row-major copies, bit for bit (ROADMAP Queue 3
    F1); step() likewise.  256^2 runs the kernels, the fast scheme on its
    packed fine level."""
    spec = Spec(size=256, dtype="float32", scheme=scheme, stop="residual", tol=1e-8,
                maxiter=50)
    mg = MultigridPoisson(spec, device="cuda")
    f = mg.rhs()
    f[40, 200] = 3.0e5                      # not symmetric: f.t() is another problem
    ft = f.t().contiguous()
    fortran = lambda x: np.asfortranarray(x.cpu().numpy())
    for f_in, f_ref, psi0 in ((f.t(), ft, None), (fortran(ft), ft, None),
                              (_misaligned(ft), ft, None), (ft, ft, fortran(-ft)),
                              (ft, ft, _misaligned(-ft))):
        before = [x.clone() if torch.is_tensor(x) else x.copy() for x in (f_in, psi0)
                  if x is not None]
        want = mg.solve(f_ref, psi0=None if psi0 is None else -ft)
        got = mg.solve(f_in, psi0=psi0)
        assert got.iterations == want.iterations and torch.equal(got.psi, want.psi)
        for x, b in zip((x for x in (f_in, psi0) if x is not None), before):
            assert (torch.equal(x, b) if torch.is_tensor(x) else np.array_equal(x, b))
    psi = mg.init_state(ft)
    want = mg.step(psi, ft)
    for a, b in ((psi.t().contiguous().t(), f.t()), (_misaligned(psi), _misaligned(ft))):
        got = mg.step(a, b)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


# ------------------------------------------------- the bf16 forms of K1-K6
# Each op rounded to bf16 as plain torch rounds it: every output bit-equal
# (the restriction's four values summed in f32 in torch's order, rounded
# once; P(V) blended in f32, rounded once), sum(r^2) within 1e-5.  Sides
# below one warp's tile up to several tiles; each smoother at the tuned
# scheme's setting and at its cap.
BF16_CASES = [(n, s, nu) for n in (2, 8, 64, 256, 1024)
              for s, nu in (("wjacobi", 3), ("jacobi", 8), ("rbgs", 1), ("rbgs", 4))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,smoother,nu", BF16_CASES)
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_bf16_kernels_equal_plain(card, n, smoother, nu, bc):
    u, f, V = (t.to(torch.bfloat16) for t in _data(n, n + nu + 1, card))
    a = (1.0 / n, nu, smoother, bc)
    got, want = cuda.smooth(u, f, *a), ops.smooth(u, f, *a)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    for fk, fp, args in ((cuda.smooth_residual_restrict, ops.smooth_residual_restrict, (u, f)),
                         (cuda.smooth_residual_restrict_zero,
                          ops.smooth_residual_restrict_zero, (f,))):
        for g, w in zip(fk(*args, *a), fp(*args, *a)):
            assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    for kind in ("inject", "bilinear"):
        pa = (u, f, V, *a, kind)
        assert torch.equal(cuda.prolong_correct_smooth(*pa), ops.prolong_correct_smooth(*pa))
        (gu, g2), (wu, w2) = (cuda.prolong_correct_smooth_rnorm(*pa),
                              ops.prolong_correct_smooth_rnorm(*pa))
        assert torch.equal(gu, wu) and g2.dtype == torch.float32
        assert abs(float(g2) / float(w2) - 1.0) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_bf16_wrappers_reject_what_the_kernels_do_not_take(card):
    u, f, V = (t.to(torch.bfloat16) for t in _data(64, 0, card))
    c = torch.zeros((16,) * 3, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="does not match"):   # a bf16 cube, an f32 operand
        cuda.smooth(c, c.float(), 1 / 16, 1, "jacobi", "ghost0")
    with pytest.raises(ValueError, match="does not match"):
        cuda.prolong_correct_smooth(c, c, torch.zeros((8,) * 3, device=card), 1 / 16, 1)
    with pytest.raises(ValueError, match="no kernel"):        # beyond the 3D halo cap
        cuda.smooth_residual_restrict(c, c, 1 / 16, 8, "jacobi", "ghost0")
    with pytest.raises(ValueError, match="A3"):
        cuda.packed_smooth_residual_restrict(u, f, 1 / 64, 1)
    with pytest.raises(ValueError, match="does not match"):
        cuda.smooth(u, f.float(), 1 / 64, 1, "jacobi", "ghost0")
    # a bf16 pair is 4 bytes: an operand at an odd 2-byte offset is refused
    odd = torch.empty(64 * 64 + 1, dtype=torch.bfloat16, device=card)[1:].view(64, 64)
    with pytest.raises(RuntimeError, match="misaligned"):
        cuda.smooth(odd, f, 1 / 64, 1, "jacobi", "ghost0")
    with pytest.raises(RuntimeError, match="misaligned"):
        cuda.prolong_correct_smooth(u, odd, V, 1 / 64, 1, "jacobi", "ghost0")
    # 4-byte aligned but not 8: taken (a float2 would need 8)
    four = torch.empty(64 * 64 + 2, dtype=torch.bfloat16, device=card)[2:].view(64, 64)
    four.copy_(u)
    assert torch.equal(cuda.smooth(four, f, 1 / 64, 2, "rbgs", "face"),
                       ops.smooth(u, f, 1 / 64, 2, "rbgs", "face"))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_bf16_sharded_wrappers_name_their_roadmap_item(card):
    f = torch.zeros((32, 32), dtype=torch.bfloat16, device=card)
    strips = (torch.zeros((4, 32), dtype=torch.bfloat16, device=card),) * 2 + (None, None)
    with pytest.raises(ValueError, match="A4"):
        cuda.smooth_rr_sharded(None, f, None, strips, (0, 0), 64, 1 / 64, 3, "wjacobi",
                               "ghost0", zero=True)


@pytest.mark.cuda
def test_bf16_launch_counters(card):
    u, f, V = (t.to(torch.bfloat16) for t in _data(64, 1, card))
    cuda.reset_launches()
    a = (1 / 64, 3, "wjacobi", "face")
    cuda.smooth(u, f, *a)
    cuda.smooth_residual_restrict(u, f, *a)
    cuda.smooth_residual_restrict_zero(f, *a)
    cuda.prolong_correct_smooth(u, f, V, *a, "bilinear")
    cuda.prolong_correct_smooth_rnorm(u, f, V, *a, "bilinear")
    want = dict.fromkeys(cuda.launches, 0)
    want.update({"mg_smooth_bf16": 1, "mg_smooth_rr_bf16": 2, "mg_smooth_rr_bf16.zero": 1,
                 "mg_prolong_correct_smooth_bf16": 2,
                 "mg_prolong_correct_smooth_bf16.rnorm": 1})
    assert cuda.launches == want


# The bf16 forms of K4-K6, bit-equal to plain torch in bf16 as their f32
# forms are: sides below one z-marching column or cube tile up to the
# solves' 256^3, the main path's wjacobi 3 and rbgs 1 (the z-marching tile)
# and rbgs 2 and jacobi 4 (halo 5 with a residual: the cube tile).
BF16_CASES_3D = [(n, s, nu) for n in (2, 4, 8, 16, 32, 128, 256)
                 for s, nu in (("wjacobi", 3), ("rbgs", 1), ("rbgs", 2), ("jacobi", 4))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,smoother,nu", BF16_CASES_3D)
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_bf16_kernels3d_equal_plain(card, n, smoother, nu, bc):
    u, f, V = (t.to(torch.bfloat16) for t in _data(n, n + nu + 3, card, ndim=3))
    a = (1.0 / n, nu, smoother, bc)
    got, want = cuda.smooth(u, f, *a), ops.smooth(u, f, *a)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    for fk, fp, args in ((cuda.smooth_residual_restrict, ops.smooth_residual_restrict, (u, f)),
                         (cuda.smooth_residual_restrict_zero,
                          ops.smooth_residual_restrict_zero, (f,))):
        for g, w in zip(fk(*args, *a), fp(*args, *a)):
            assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    for kind in ("inject", "bilinear"):
        pa = (u, f, V, *a, kind)
        assert torch.equal(cuda.prolong_correct_smooth(*pa), ops.prolong_correct_smooth(*pa))
        (gu, g2), (wu, w2) = (cuda.prolong_correct_smooth_rnorm(*pa),
                              ops.prolong_correct_smooth_rnorm(*pa))
        assert torch.equal(gu, wu) and g2.dtype == torch.float32
        assert abs(float(g2) / float(w2) - 1.0) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_bf16_3d_launch_counters(card):
    u, f, V = (t.to(torch.bfloat16) for t in _data(32, 2, card, ndim=3))
    cuda.reset_launches()
    a = (1 / 32, 3, "wjacobi", "face")
    cuda.smooth(u, f, *a)
    cuda.smooth_residual_restrict(u, f, *a)
    cuda.smooth_residual_restrict_zero(f, *a)
    cuda.prolong_correct_smooth(u, f, V, *a, "bilinear")
    cuda.prolong_correct_smooth_rnorm(u, f, V, *a, "bilinear")
    want = dict.fromkeys(cuda.launches, 0)
    want.update({"mg_smooth3d_bf16": 1, "mg_smooth_rr3d_bf16": 2,
                 "mg_smooth_rr3d_bf16.zero": 1, "mg_prolong_correct_smooth3d_bf16": 2,
                 "mg_prolong_correct_smooth3d_bf16.rnorm": 1})
    assert cuda.launches == want


BF16_SPECS = {"mixed": dict(dtype="float32", sweep_dtype="bfloat16", tol=1e-10),
              "bf16": dict(dtype="bfloat16", tol=1e-30, maxiter=6)}


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(BF16_SPECS))
def test_bf16_solves_equal_their_plain_twins(card, which):
    """The mixed and the pure bf16 512^2 solves on the kernels give the psi
    of the same solves on plain ops (backend 'torch') bit for bit, in the
    same count; the mixed one its history too."""
    spec = Spec(size=512, scheme="tuned", stop="residual", **BF16_SPECS[which])
    cuda.reset_launches()
    got = MultigridPoisson(spec, device="cuda").solve()
    assert cuda.launches["mg_smooth_rr_bf16"] == 2 * got.iterations
    want = MultigridPoisson(spec.with_(backend="torch"), device="cuda").solve()
    assert got.iterations == want.iterations and torch.equal(got.psi, want.psi)
    assert got.errs.dtype == torch.float32
    if which == "mixed":
        assert got.converged and got.errs[0].item() == 1.0
        assert got.errs.tolist() == want.errs.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(BF16_SPECS))
def test_bf16_3d_solves_equal_their_plain_twins(card, which):
    """The mixed and the pure bf16 256^3 solves on K5/K6's bf16 forms give
    the psi of the same solves on plain ops bit for bit, in the same
    count; the mixed one its history too."""
    spec = Spec(size=256, ndim=3, scheme="tuned", stop="residual", **BF16_SPECS[which])
    cuda.reset_launches()
    got = MultigridPoisson(spec, device="cuda").solve()
    assert cuda.launches["mg_smooth_rr3d_bf16"] == got.iterations
    assert cuda.launches["mg_prolong_correct_smooth3d_bf16"] == got.iterations
    want = MultigridPoisson(spec.with_(backend="torch"), device="cuda").solve()
    assert got.iterations == want.iterations and torch.equal(got.psi, want.psi)
    if which == "mixed":
        assert got.converged and got.errs[0].item() == 1.0
        assert got.errs.tolist() == want.errs.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(BF16_SPECS))
def test_bf16_solver_takes_any_strided_input(card, which):
    """A transposed f and a view at an odd offset give the psi and the
    count of their dense copies, bit for bit, in the mixed and the pure bf16
    solves (the kernels take 4-byte-aligned bf16 operands; the solver hands
    them dense 8-byte-aligned ones)."""
    spec = Spec(size=256, scheme="tuned", stop="residual", **BF16_SPECS[which])
    mg = MultigridPoisson(spec, device="cuda")
    f = mg.rhs()
    f[40, 200] = 3.0e5
    ft = f.t().contiguous()
    want = mg.solve(ft)
    odd = torch.empty(ft.numel() + 1, dtype=ft.dtype, device=card)[1:].view(ft.shape)
    odd.copy_(ft)
    assert odd.data_ptr() % 8 != 0
    for f_in in (f.t(), odd):
        got = mg.solve(f_in)
        assert got.iterations == want.iterations and torch.equal(got.psi, want.psi)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(BF16_SPECS))
def test_bf16_solves_stop_on_a_nan(card, which):
    """A NaN in f: the first err is NaN, the loop stops after one cycle,
    not converged."""
    spec = Spec(size=256, scheme="tuned", stop="residual", **BF16_SPECS[which])
    mg = MultigridPoisson(spec, device="cuda")
    f = mg.rhs()
    f[7, 9] = float("nan")
    res = mg.solve(f)
    assert res.iterations == 1 and not res.converged and np.isnan(res.final_err)
