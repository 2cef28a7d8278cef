"""smoother='gs_lex': the port's lexicographic Gauss-Seidel (ops.gs_lex_sweep)
against the JAX package's xla.gs_lex_sweep and the float64 NumPy oracle,
at the tolerances of the JAX package's own tests (tests/test_kernels.py,
tests/test_solver.py).  Both solve each row's recurrence by a scan whose
order differs from the oracle's strictly sequential loop (the port's by
recursive doubling, XLA's by its associative_scan), so they agree with it
to rounding, not bit for bit.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import mgpoisson_torch
from mgpoisson import oracle
from mgpoisson.kernels import xla
from mgpoisson_torch.kernels import cuda, ops, use_kernels

SHAPES = [(8, 8), (16, 16), (8, 8, 8)]


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gs_lex_sweep(shape):
    u, f = _rand(shape, 31), _rand(shape, 32)
    h = 1.0 / shape[0]
    got = ops.gs_lex_sweep(torch.tensor(u), torch.tensor(f), h).numpy()
    np.testing.assert_allclose(got, oracle.gs_lex_sweep(u, f, h), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(xla.gs_lex_sweep(jnp.asarray(u), jnp.asarray(f), h)),
                               rtol=1e-11, atol=1e-12)
    # three sweeps through the smoother dispatch
    got3 = ops.smooth(torch.tensor(u), torch.tensor(f), h, 3, "gs_lex").numpy()
    want3 = u.copy()
    for _ in range(3):
        want3 = oracle.gs_lex_sweep(want3, f, h)
    np.testing.assert_allclose(got3, want3, rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("dtype, n", [(torch.float32, 256), (torch.float64, 1024)],
                         ids=["f32-256", "f64-1024"])
def test_rows_past_the_closed_form_overflow(dtype, n):
    """Rows where the closed form's (2 * ndim)^k leaves the dtype's range
    (4^256 past the f32 maximum, 4^1024 past the f64 one): the doubling
    scan's multipliers only shrink."""
    u, f = _rand((4, n), 33), _rand((4, n), 34)
    h = 1.0 / n
    got = ops.gs_lex_sweep(torch.tensor(u, dtype=dtype), torch.tensor(f, dtype=dtype), h)
    want = oracle.gs_lex_sweep(u, f, h)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    assert torch.isfinite(got).all()
    assert np.abs(got.double().numpy() - want).max() <= tol * np.abs(want).max()


def test_gs_lex_rejects_face_bc():
    u = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="gs_lex supports bc='ghost0' only"):
        ops.gs_lex_sweep(u, u, 0.125, bc="face")


def test_gs_lex_solver_matches_oracle_trajectory():
    """The reference's trajectory, iterate for iterate (the JAX package's
    test_gs_lex_solver_matches_oracle_trajectory, with its bars)."""
    size = 16
    spec = mgpoisson_torch.Spec(size=size, dtype="float64", scheme="reference",
                                smoother="gs_lex", maxiter=20)
    cuda.reset_launches()
    res = mgpoisson_torch.MultigridPoisson(spec, device="cpu").solve()
    opsi, oerrs = oracle.solve(size, maxiter=20, scheme="reference", smoother="gs_lex")
    assert res.iterations == len(oerrs)
    np.testing.assert_allclose(res.errs.numpy(), oerrs, rtol=1e-8, atol=1e-10 * oerrs[0])
    np.testing.assert_allclose(res.psi.numpy(), opsi, rtol=1e-9, atol=1e-9 * np.abs(opsi).max())
    assert all(v == 0 for v in cuda.launches.values())


def test_gs_lex_runs_no_kernel():
    """No kernel takes gs_lex, so every level runs the plain ops, whatever
    the size and backend (the JAX package's get_ops rule)."""
    spec = mgpoisson_torch.Spec(size=4096, scheme="reference", smoother="gs_lex",
                                backend="cuda", kernel_min_size=2)
    assert not use_kernels(spec, 4096, "cuda")
    assert use_kernels(spec.with_(smoother="jacobi"), 4096, "cuda")
