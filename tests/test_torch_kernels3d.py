"""The 3D half of the port's kernel layer, mgpoisson_torch.kernels.cuda
(K4 mg_smooth3d, K5 mg_smooth_rr3d, K6 mg_prolong_correct_smooth3d).

On the CPU its wrappers run their plain versions.  Those are held here
against the Pallas 3D kernels they replace, run as tests/test_pallas3d.py
runs them (interpreter mode, shape (32, 64, 128), explicit blocks), at the
tuned scheme's settings (wjacobi, nu = 3), and against mgpoisson.kernels.xla
on whole cubes at 16^3 and 32^3 for every smoother, bc, sweep count and
prolongation kind.  Inputs are float32 from a seeded numpy generator.  The
sweep forms differ (Pallas nbr/6 + f*(-h^2/6), the port (f - nbr/h^2) /
adiag) and round differently, so the bar is the f32 kernel bar of the
ROADMAP: normalized max |diff| <= 1e-5, and 1e-5 relative on sum(r^2).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
compares each with its plain version there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mgpoisson.kernels import pallas as pk, xla
from mgpoisson_torch.kernels import cuda

SHAPE = (32, 64, 128)       # the Pallas 3D tests' shape: x whole, (z, y) blocked
H = 1.0 / 64
BLOCKS = dict(bz=8, by=32)  # several blocks on both blocked axes


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MGPOISSON_PALLAS_INTERPRET", "1")


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=tuple(s // 2 for s in shape)).astype(np.float32))


def _nmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _rel(got, want):
    return abs(float(got) / float(want) - 1.0)


# ------------------------------------------- against the Pallas 3D kernels

def test_smooth3d_vs_pallas():
    u, f, _ = _data(SHAPE, seed=1)
    want = pk._smooth_fused_3d(jnp.asarray(u), jnp.asarray(f), h=H, nu=3,
                               smoother="wjacobi", bc="ghost0",
                               interpret=True, hz=3, **BLOCKS)
    got = cuda.smooth(torch.tensor(u), torch.tensor(f), H, 3, "wjacobi", "ghost0")
    assert _nmax(got, want) <= 1e-5


@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_smooth_residual_restrict3d_vs_pallas(bc):
    u, f, _ = _data(SHAPE, seed=2)
    want = pk._rr_fused_3d(jnp.asarray(u), jnp.asarray(f), h=H, nu=3,
                           smoother="wjacobi", bc=bc, interpret=True, hz=4,
                           **BLOCKS)
    got = cuda.smooth_residual_restrict(torch.tensor(u), torch.tensor(f), H, 3,
                                        "wjacobi", bc)
    for g, w in zip(got, want):
        assert _nmax(g, w) <= 1e-5


@pytest.mark.parametrize("bc,rnorm", [("face", False), ("ghost0", True)])
def test_prolong_correct_smooth3d_vs_pallas(bc, rnorm):
    u, f, V = _data(SHAPE, seed=3)
    args = (jnp.asarray(u), jnp.asarray(f), jnp.asarray(V))
    want = pk._pc_fused_3d(*args, h=H, nu=3, smoother="wjacobi", bc=bc,
                           kind="bilinear", interpret=True, hz=4, rnorm=rnorm,
                           **BLOCKS)
    targs = (torch.tensor(u), torch.tensor(f), torch.tensor(V), H, 3,
             "wjacobi", bc, "bilinear")
    if not rnorm:
        assert _nmax(cuda.prolong_correct_smooth(*targs), want) <= 1e-5
        return
    got_u, got_r2 = cuda.prolong_correct_smooth_rnorm(*targs)
    assert _nmax(got_u, want[0]) <= 1e-5
    assert _rel(got_r2, jnp.sum(want[1])) <= 1e-5
    # the metric is the zero-ghost residual's, as the XLA op computes it
    _, xla_r2 = xla.prolong_correct_smooth_rnorm(*args, H, 3, "wjacobi", bc,
                                                 "bilinear")
    assert _rel(got_r2, xla_r2) <= 1e-5


# ------------------------------------------- against mgpoisson.kernels.xla

CASES = [(n, smoother, bc, nu) for n in (16, 32)
         for smoother in ("jacobi", "wjacobi", "rbgs")
         for bc in ("ghost0", "face") for nu in (1, 3)]


def _cube(n, seed):
    """(jax arrays, torch tensors) of the same u, f, V on an n^3 level."""
    arrays = _data((n, n, n), seed)
    return [jnp.asarray(a) for a in arrays], [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("n,smoother,bc,nu", CASES)
def test_smooth3d_vs_xla(n, smoother, bc, nu):
    (u, f, _), (ut, ft, _) = _cube(n, seed=4)
    h = 1.0 / n
    assert _nmax(cuda.smooth(ut, ft, h, nu, smoother, bc),
                 xla.smooth(u, f, h, nu, smoother, bc)) <= 1e-5


@pytest.mark.parametrize("n,smoother,bc,nu", CASES)
def test_smooth_residual_restrict3d_vs_xla(n, smoother, bc, nu):
    (u, f, _), (ut, ft, _) = _cube(n, seed=5)
    h = 1.0 / n
    for got, want in zip(cuda.smooth_residual_restrict(ut, ft, h, nu, smoother, bc),
                         xla.smooth_residual_restrict(u, f, h, nu, smoother, bc)):
        assert _nmax(got, want) <= 1e-5
    # the down-leg from zero, as every coarse V-cycle entry runs it
    for got, want in zip(cuda.smooth_residual_restrict_zero(ft, h, nu, smoother, bc),
                         xla.smooth_residual_restrict_zero(f, h, nu, smoother, bc)):
        assert _nmax(got, want) <= 1e-5


@pytest.mark.parametrize("kind", ["inject", "bilinear"])
@pytest.mark.parametrize("n,smoother,bc,nu", CASES)
def test_prolong_correct_smooth3d_vs_xla(n, smoother, bc, nu, kind):
    (u, f, V), (ut, ft, Vt) = _cube(n, seed=6)
    h = 1.0 / n
    a = (h, nu, smoother, bc, kind)
    assert _nmax(cuda.prolong_correct_smooth(ut, ft, Vt, *a),
                 xla.prolong_correct_smooth(u, f, V, *a)) <= 1e-5
    got_u, got_r2 = cuda.prolong_correct_smooth_rnorm(ut, ft, Vt, *a)
    want_u, want_r2 = xla.prolong_correct_smooth_rnorm(u, f, V, *a)
    assert _nmax(got_u, want_u) <= 1e-5
    assert _rel(got_r2, want_r2) <= 1e-5


# ------------------------------------------------------- what K4-K6 take

@pytest.mark.parametrize("smoother", ["jacobi", "wjacobi", "rbgs"])
def test_3d_caps_cover_the_jax_planner(smoother):
    """K4-K6 take at least every sweep count the JAX package's 3D planner
    admits at 256^3 f32, and exactly a halo of radius*nu (+1 ring where a
    residual follows) <= 8."""
    radius = 2 if smoother == "rbgs" else 1
    for nu in range(0, 10):
        for composite in (False, True):
            takes = cuda.supports(256, torch.float32, nu, smoother, ndim=3,
                                  residual=composite)
            assert takes == (radius * nu + composite <= 8)
            if nu >= 1 and pk._plan3d((256,) * 3, nu, smoother, 4,
                                      composite=composite) is not None:
                assert takes, (nu, composite)
    assert not cuda.supports(256, torch.float64, 1, smoother, ndim=3)


def test_3d_tile_fits_shared_memory():
    """The tile side the wrapper passes keeps the K6 working set (three
    (T + 2H)^3 buffers, the coarse tile and the reduction) within the
    227 KB a block may opt in to, for every halo the caps allow."""
    for halo in range(0, cuda.MAX_HALO_3D + 1):
        assert cuda.tile3d(halo) % 2 == 0
        assert cuda.shared_bytes_3d(halo) < cuda.shared_bytes_3d(halo, pc=True)
        assert cuda.shared_bytes_3d(halo, pc=True) <= 232448, halo
    # the tuned scheme's K5 / K6 with rnorm: T = 16, H = 4
    assert cuda.shared_bytes_3d(4) == 4 * 3 * 24 ** 3
    assert cuda.shared_bytes_3d(4, pc=True) == 180960
