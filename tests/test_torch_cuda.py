"""The CUDA kernels of mgpoisson_torch against their plain torch versions,
on the card.

The kernels have no CPU mode, so every test here is marked `cuda` and
skips without a CUDA device.  The file imports no JAX, so it also runs
where JAX is not installed; tests/conftest.py imports JAX, hence:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Sizes include levels smaller than one tile (a warp's 64 columns in 2D,
down to 2x2; 16^3 or 8^3 in 3D; 32 rows x 32 packed lanes for the packed
K7/K8) and levels of several tiles; the strip kernels K9-K12 run every block position of (2, 2) and
(4, 1) meshes, blocks and strips cut from a whole grid as the ranks'
exchange delivers them.  Bars: normalized max |diff| <= 1e-5 (the ROADMAP's f32 kernel
bar), 1e-5 relative on sum(r^2), whose partials are summed in another
order."""

import itertools

import pytest
import torch

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


# the packed kernels: below one tile (32 rows x 32 packed lanes), one tile
# and several, at the sweep counts 1 and the cap 3
@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 64, 256, 1024])
@pytest.mark.parametrize("nu", [1, 3])
def test_packed_kernels_vs_plain(card, n, nu):
    u, f, V = _data(n, n + nu, card)
    up, fp = cuda.pack_grid(u), cuda.pack_grid(f)
    h = 1.0 / n
    for got, want in zip(cuda.packed_smooth_residual_restrict(up, fp, h, nu),
                         ops.packed_smooth_residual_restrict(up, fp, h, nu)):
        assert _nmax(got, want) <= 1e-5
    for kind in ("inject", "bilinear"):
        pa = (up, fp, V, h, nu, kind)
        assert _nmax(cuda.packed_prolong_correct_smooth(*pa),
                     ops.packed_prolong_correct_smooth(*pa)) <= 1e-5
        got_u, got_r2 = cuda.packed_prolong_correct_smooth_rnorm(*pa)
        want_u, want_r2 = ops.packed_prolong_correct_smooth_rnorm(*pa)
        assert _nmax(got_u, want_u) <= 1e-5
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
# meshes with and without a column neighbour
SHARDED = [(2, 64, (2, 2)), (2, 64, (4, 1)), (2, 256, (2, 2)), (2, 4096, (2, 2)),
           (3, 32, (2, 2)), (3, 64, (4, 1))]


def _blocks(n, mesh, ndim):
    shape = (n // mesh[0], n // mesh[1]) + (n,) * (ndim - 2)
    for i, j in itertools.product(range(mesh[0]), range(mesh[1])):
        yield (i * shape[0], j * shape[1]), shape


@pytest.mark.cuda
@pytest.mark.parametrize("ndim,n,mesh", SHARDED)
@pytest.mark.parametrize("smoother,nu", [("wjacobi", 3), ("rbgs", 2), ("jacobi", 1)])
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_sharded_kernels_vs_plain(card, ndim, n, mesh, smoother, nu, bc):
    u, f, V = _data(n, n + nu, card, ndim)
    d = ops.sweep_radius(smoother) * nu + 1
    cols = mesh[1] > 1
    for origin, shape in _blocks(n, mesh, ndim):
        ub, us = block_from_grid(u, origin, shape, d, cols)
        fb, fs = block_from_grid(f, origin, shape, d, cols)
        vb, vs = block_from_grid(V, [o // 2 for o in origin], [s // 2 for s in shape],
                                 ops.coarse_depth(d), cols)
        a = (origin, n, 1.0 / n, nu, smoother, bc)
        for got, want in zip(cuda.smooth_rr_sharded(ub, fb, us, fs, *a)
                             + cuda.smooth_rr_sharded(None, fb, None, fs, *a, zero=True),
                             ops.smooth_rr_sharded(ub, fb, us, fs, *a)
                             + ops.smooth_rr_sharded(None, fb, None, fs, *a, zero=True)):
            assert _nmax(got, want) <= 1e-5
        for kind in ("inject", "bilinear"):
            pa = (ub, fb, vb, us, fs, vs, origin, n, 1.0 / n, nu, smoother, bc, kind)
            assert _nmax(cuda.pc_smooth_sharded(*pa), ops.pc_smooth_sharded(*pa)) <= 1e-5
            (gu, g2), (wu, w2) = (cuda.pc_smooth_sharded(*pa, rnorm=True),
                                  ops.pc_smooth_sharded(*pa, rnorm=True))
            assert _nmax(gu, wu) <= 1e-5
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
            assert _nmax(g, w) <= 1e-5
        st_u[r0:r0 + nl], st_R[r0 // 2:(r0 + nl) // 2] = got
        for kind in whole:
            pa = (ub, fb, vb, us, fs, vs, *b, kind)
            assert _nmax(cuda.packed_pc_sharded(*pa), ops.packed_pc_sharded(*pa)) <= 1e-5
            (gu, g2), (wu, w2) = (cuda.packed_pc_sharded(*pa, rnorm=True),
                                  ops.packed_pc_sharded(*pa, rnorm=True))
            assert _nmax(gu, wu) <= 1e-5
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
