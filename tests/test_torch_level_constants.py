"""The level constants of the plain ops in bf16 against the JAX package's
xla ops, on the CPU (ROADMAP Queue 3 F4).

The JAX package rounds h^2 and adiag = -2*ndim/h^2 to the array's dtype
before its bf16 arithmetic (weak-typed Python scalars), where torch would
keep a Python scalar in f32; ops._level rounds them as JAX does.  So at
every spacing, h = 1/n and the off-grid 0.01 and 0.3 alike, the bf16
sweeps, residual, operator and coarsest solve equal xla's bit for bit, in
2D and 3D; in f32 and f64 the constants keep the values torch took
before."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mgpoisson.kernels import xla
from mgpoisson_torch.kernels import ops

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

SIDES = {2: 64, 3: 16}
OPS = ("jacobi", "wjacobi", "rbgs", "residual", "apply_operator", "coarse_solve")


def _run(mod, op, u, f, h, bc):
    """One op of `mod` (xla or ops): nu = 3 sweeps of a smoother, the
    residual, the operator, or the coarsest solve."""
    if op in ("jacobi", "wjacobi", "rbgs"):
        return mod.smooth(u, f, h, 3, op, bc)
    if op == "residual":
        return mod.residual(u, f, h, bc)
    if op == "apply_operator":
        return mod.apply_operator(u, h, bc)
    return mod.coarse_solve(u, f, h, "jacobi", bc)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("h", ["1/n", 0.01, 0.3])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_bf16_ops_equal_xla_at_every_spacing(ndim, h, op, bc):
    """At 64^2 or 16^3 (the coarsest solve at 1 cell, where face is the
    exact u = f h^2 / (-4 ndim)), seed 0."""
    n = 1 if op == "coarse_solve" else SIDES[ndim]
    h = 1.0 / n if h == "1/n" else h
    rng = np.random.default_rng(0)
    u, f = (rng.standard_normal((n,) * ndim).astype(np.float32) for _ in range(2))
    want = np.asarray(_run(xla, op, jnp.asarray(u, jnp.bfloat16), jnp.asarray(f, jnp.bfloat16),
                           h, bc).astype(jnp.float32))
    got = _run(ops, op, torch.from_numpy(u).bfloat16(), torch.from_numpy(f).bfloat16(), h, bc)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("ndim", [2, 3])
def test_level_constants_keep_their_f32_and_f64_values(ndim):
    """In f64 the constants are the double values the ops used before; in
    f32 they round to the f32 values torch took from those; in bf16 each is
    a bf16 value, adiag from the unrounded h^2."""
    for h in (1.0 / 64, 0.01, 0.3):
        hsq = h * h
        old = (hsq, -2.0 * ndim / hsq, -hsq * 0.25, 1.0 / hsq)
        assert ops._level(h, ndim, torch.float64) == old
        assert ops._level(h, ndim, torch.float32) == tuple(float(np.float32(c)) for c in old)
        bf = ops._level(h, ndim, torch.bfloat16)
        assert bf == tuple(float(torch.tensor(c).bfloat16()) for c in old)
