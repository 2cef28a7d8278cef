"""The plain sharded legs in bf16 against the whole-grid bf16 legs, on the CPU.

The plain versions of the strip kernels K9/K10 and K11/K12
(``ops.smooth_rr_sharded``, ``ops.pc_smooth_sharded``) run on every block
of a bf16 grid, 2D or 3D, its strips cut as the ranks' exchange delivers
them (``spmd.block_from_grid``); the blocks, stitched, must equal the
whole-grid bf16 legs bit for bit: the same operations on the same values,
with the damped-Jacobi weight rounded to bf16 (``ops._omega``) and P(V)
blended in f32 and rounded once (``ops._up_leg_correct``), as the Pallas
strip kernels and the bf16 forms of K9-K12 do.  f32 and f64 stay as they
were.
"""

import itertools

import pytest
import torch

from mgpoisson_torch.kernels import ops
from mgpoisson_torch.shard import spmd

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

N = 128


def _grids(n, dtype, seed=0, ndim=2):
    g = torch.Generator().manual_seed(seed)
    u, f = (torch.randn((n,) * ndim, generator=g).to(dtype) for _ in range(2))
    V = torch.randn((n // 2,) * ndim, generator=g).to(dtype)
    return u, f, V


def _stitched(n, mesh, u, f, V, nu, smoother, bc, kind):
    """Every block's down-leg from u and from zero and its up-leg with
    Σr², stitched into whole grids; Σr² summed over the blocks in f64.  The
    mesh cuts the first two axes (z and y in 3D; x stays whole)."""
    shape = (n // mesh[0], n // mesh[1]) + (n,) * (u.ndim - 2)
    d = ops.sweep_radius(smoother) * nu + 1
    dv = ops.coarse_depth(d)
    cols = mesh[1] > 1
    out = {"u": torch.empty_like(u), "R": torch.empty_like(V), "uz": torch.empty_like(u),
           "Rz": torch.empty_like(V), "up": torch.empty_like(u)}
    r2 = 0.0
    for i, j in itertools.product(range(mesh[0]), range(mesh[1])):
        org = (i * shape[0], j * shape[1])
        ub, us = spmd.block_from_grid(u, org, shape, d, cols)
        fb, fs = spmd.block_from_grid(f, org, shape, d, cols)
        vb, vs = spmd.block_from_grid(V, (org[0] // 2, org[1] // 2),
                                      tuple(x // 2 for x in shape), dv, cols)
        fine = (slice(org[0], org[0] + shape[0]), slice(org[1], org[1] + shape[1]))
        coarse = tuple(slice(s.start // 2, s.stop // 2) for s in fine)
        a = (org, n, 1.0 / n, nu, smoother, bc)
        out["u"][fine], out["R"][coarse] = ops.smooth_rr_sharded(ub, fb, us, fs, *a)
        out["uz"][fine], out["Rz"][coarse] = ops.smooth_rr_sharded(None, fb, None, fs, *a,
                                                                   zero=True)
        up, s = ops.pc_smooth_sharded(ub, fb, vb, us, fs, vs, org, n, 1.0 / n, nu,
                                      smoother, bc, kind, rnorm=True)
        out["up"][fine] = up
        r2 += float(s)
    return out, r2


def _whole(u, f, V, n, nu, smoother, bc, kind):
    a = (1.0 / n, nu, smoother, bc)
    u1, R1 = ops.smooth_residual_restrict(u, f, *a)
    uz, Rz = ops.smooth_residual_restrict_zero(f, *a)
    up, r2 = ops.prolong_correct_smooth_rnorm(u, f, V, *a, kind)
    return {"u": u1, "R": R1, "uz": uz, "Rz": Rz, "up": up}, float(r2)


@pytest.mark.parametrize("kind", ["inject", "bilinear"])
@pytest.mark.parametrize("smoother,nu", [("wjacobi", 3), ("rbgs", 1)])
@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_plain_sharded_bf16_legs_equal_the_whole_grid_legs(bc, mesh, smoother, nu, kind):
    """Bit for bit at 128², every block of the mesh, from u and from zero,
    the up-leg with Σr² (within 1e-6: summed per block, then over them)."""
    u, f, V = _grids(N, torch.bfloat16)
    got, r2 = _stitched(N, mesh, u, f, V, nu, smoother, bc, kind)
    want, w2 = _whole(u, f, V, N, nu, smoother, bc, kind)
    for k in want:
        assert got[k].dtype == torch.bfloat16, k
        diff = int((got[k] != want[k]).sum())
        assert diff == 0, f"{k}: {diff} of {want[k].numel()} cells differ"
    assert abs(r2 / w2 - 1) <= 1e-6


@pytest.mark.parametrize("kind", ["inject", "bilinear"])
@pytest.mark.parametrize("smoother,nu", [("wjacobi", 3), ("rbgs", 1), ("rbgs", 2)])
@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_plain_sharded_bf16_legs_equal_the_whole_grid_legs_3d(bc, mesh, smoother, nu, kind):
    """The same in 3D at 32^3 (the legs of K11/K12's bf16 forms): bit for
    bit on every block of the mesh, which cuts z and y and keeps x whole,
    from u and from zero, the up-leg with Σr² (within 1e-6).  wjacobi nu =
    3 and rbgs nu = 1 are the halos of the kernels' z-marching tile, rbgs
    nu = 2 the down-leg's cube tile."""
    u, f, V = _grids(32, torch.bfloat16, seed=3, ndim=3)
    got, r2 = _stitched(32, mesh, u, f, V, nu, smoother, bc, kind)
    want, w2 = _whole(u, f, V, 32, nu, smoother, bc, kind)
    for k in want:
        assert got[k].dtype == torch.bfloat16, k
        diff = int((got[k] != want[k]).sum())
        assert diff == 0, f"{k}: {diff} of {want[k].numel()} cells differ"
    assert abs(r2 / w2 - 1) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_plain_sharded_legs_unchanged_in_f32_and_f64(dtype):
    """The repair leaves f32 and f64 as they were: the blocks, stitched,
    equal the whole-grid legs bit for bit (wjacobi, bilinear, face)."""
    u, f, V = _grids(64, dtype, seed=1)
    got, _ = _stitched(64, (2, 2), u, f, V, 3, "wjacobi", "face", "bilinear")
    want, _ = _whole(u, f, V, 64, 3, "wjacobi", "face", "bilinear")
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_block_sweeps_take_the_dtype_s_omega():
    """The damped-Jacobi weight of the block sweeps is ops._omega: 0.8
    rounded to bf16 (0.80078125) on a bf16 block."""
    assert ops._omega(2, torch.bfloat16) == 0.80078125
    u, f, _ = _grids(16, torch.bfloat16, seed=2)
    ub, us = spmd.block_from_grid(u, (0, 0), (16, 16), 2, True)
    fb, fs = spmd.block_from_grid(f, (0, 0), (16, 16), 2, True)
    got, _ = ops.smooth_rr_sharded(ub, fb, us, fs, (0, 0), 16, 1 / 16, 1, "wjacobi")
    assert torch.equal(got, ops.wjacobi_sweep(u, f, 1 / 16))
