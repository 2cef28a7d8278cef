"""mgpoisson_torch.kernels.ops against mgpoisson.kernels.xla in float64.

The same inputs, drawn from a seeded numpy generator, go through the JAX
op and its torch port.  The bar is rtol 1e-12 with an absolute floor of
1e-12 of the reference's largest magnitude: the residual cancels to
near-zero values, where a relative bound alone would judge rounding."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mgpoisson.kernels import xla
from mgpoisson_torch.kernels import ops

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

SIZES = [8, 32, 64]
BCS = ["ghost0", "face"]
SMOOTHERS = ["jacobi", "wjacobi", "rbgs"]
KINDS = ["inject", "bilinear"]


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s) for s in shapes]


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float64
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


def _both(*arrays):
    """(jax arrays, torch tensors) of the same float64 data."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.tensor(a) for a in arrays])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bc", BCS)
def test_neighbor_sum(n, bc):
    (u,), (ut,) = _both(*_arrays((n, n)))
    _close(ops.neighbor_sum(ut, bc), xla.neighbor_sum(u, bc))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_one_sweep(n, bc, smoother):
    (u, f), (ut, ft) = _both(*_arrays((n, n), (n, n), seed=1))
    h = 1.0 / n
    _close(ops._SWEEPS[smoother](ut, ft, h, bc),
           xla._SWEEPS[smoother](u, f, h, bc))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_smooth(n, bc, smoother):
    (u, f), (ut, ft) = _both(*_arrays((n, n), (n, n), seed=2))
    h = 1.0 / n
    _close(ops.smooth(ut, ft, h, 3, smoother, bc),
           xla.smooth(u, f, h, 3, smoother, bc))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("op", ["residual", "residual_restrict"])
def test_residual(n, bc, op):
    (u, f), (ut, ft) = _both(*_arrays((n, n), (n, n), seed=3))
    h = 1.0 / n
    _close(getattr(ops, op)(ut, ft, h, bc), getattr(xla, op)(u, f, h, bc))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bc", BCS)
def test_apply_operator(n, bc):
    (u,), (ut,) = _both(*_arrays((n, n), seed=4))
    _close(ops.apply_operator(ut, 1.0 / n, bc), xla.apply_operator(u, 1.0 / n, bc))


@pytest.mark.parametrize("n", SIZES)
def test_restrict(n):
    (r,), (rt,) = _both(*_arrays((n, n), seed=5))
    _close(ops.restrict(rt), xla.restrict(r))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_prolong(n, kind):
    (V,), (Vt,) = _both(*_arrays((n // 2, n // 2), seed=6))
    _close(ops.prolong(Vt, kind), xla.prolong(V, kind))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_prolong_correct(n, kind):
    (u, V), (ut, Vt) = _both(*_arrays((n, n), (n // 2, n // 2), seed=7))
    _close(ops.prolong_correct(ut, Vt, kind), xla.prolong_correct(u, V, kind))


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_coarse_solve(n, bc, smoother):
    (u, f), (ut, ft) = _both(*_arrays((n, n), (n, n), seed=8))
    h = 1.0 / n
    got = ops.coarse_solve(ut, ft, h, smoother, bc)
    _close(got, xla.coarse_solve(u, f, h, smoother, bc))
    if n == 1 and bc == "face":
        # the 1x1 face solve is exact: A u = f with ghost = -u on all
        # four faces (the contract, ROADMAP Queue 3)
        assert abs(float(ops.residual(got, ft, h, "face")[0, 0])) <= \
            1e-12 * abs(float(ft[0, 0])) / (h * h)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_smooth_residual_restrict(n, bc, smoother):
    (u, f), (ut, ft) = _both(*_arrays((n, n), (n, n), seed=9))
    h = 1.0 / n
    for got, want in zip(ops.smooth_residual_restrict(ut, ft, h, 3, smoother, bc),
                         xla.smooth_residual_restrict(u, f, h, 3, smoother, bc)):
        _close(got, want)
    for got, want in zip(ops.smooth_residual_restrict_zero(ft, h, 3, smoother, bc),
                         xla.smooth_residual_restrict_zero(f, h, 3, smoother, bc)):
        _close(got, want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("kind", KINDS)
def test_prolong_correct_smooth(n, bc, kind):
    (u, f, V), (ut, ft, Vt) = _both(
        *_arrays((n, n), (n, n), (n // 2, n // 2), seed=10))
    h = 1.0 / n
    _close(ops.prolong_correct_smooth(ut, ft, Vt, h, 3, "wjacobi", bc, kind),
           xla.prolong_correct_smooth(u, f, V, h, 3, "wjacobi", bc, kind))
    # rnorm is the zero-ghost residual of the result whatever bc is
    got_u, got_r2 = ops.prolong_correct_smooth_rnorm(ut, ft, Vt, h, 3, "rbgs",
                                                     bc, kind)
    want_u, want_r2 = xla.prolong_correct_smooth_rnorm(u, f, V, h, 3, "rbgs",
                                                       bc, kind)
    _close(got_u, want_u)
    _close(got_r2, want_r2)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("metric", ["rms_update", "rel_err"])
def test_update_metrics(n, metric):
    a, b = _arrays((n, n), (n, n), seed=11)
    b[0, :] = 0.0          # rel_err masks zero and unchanged cells
    b[1, :] = a[1, :]
    (aj, bj), (at, bt) = _both(a, b)
    _close(getattr(ops, metric)(at, bt), getattr(xla, metric)(aj, bj))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("metric", ["residual_norm", "residual_sq_sum"])
def test_residual_metrics(n, metric):
    (u, f), (ut, ft) = _both(*_arrays((n, n), (n, n), seed=12))
    _close(getattr(ops, metric)(ut, ft, 1.0 / n), getattr(xla, metric)(u, f, 1.0 / n))


@pytest.mark.parametrize("bc", BCS)
def test_3d_ops(bc):
    """The ops stay rank-polymorphic: 3D 7-point stencils, 2x2x2
    restriction and trilinear prolongation."""
    n = 8
    (u, f, V), (ut, ft, Vt) = _both(
        *_arrays((n, n, n), (n, n, n), (n // 2,) * 3, seed=13))
    h = 1.0 / n
    _close(ops.smooth(ut, ft, h, 2, "rbgs", bc), xla.smooth(u, f, h, 2, "rbgs", bc))
    _close(ops.residual_restrict(ut, ft, h, bc), xla.residual_restrict(u, f, h, bc))
    _close(ops.prolong(Vt, "bilinear"), xla.prolong(V, "bilinear"))
