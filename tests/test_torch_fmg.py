"""Full multigrid (cycle='fmg') in the port against the JAX package, on the CPU.

- ``cycle.vcycle.fmg``, the FMG pass, against the JAX package's
  ``mgpoisson.cycle.vcycle.fmg`` (backend 'xla'), f64, 2D and 3D, for the
  three schemes.
- The FMG solve: the JAX package's cycles and error history, the relative
  residual taken against the -f guess and not the FMG iterate; a given psi0
  runs no FMG pass.
- L3 (ROADMAP Queue 3): the fast scheme's FMG solve keeps its fine level
  packed (``kernels.use_packed``), on the CPU under MGPOISSON_PACKED=1.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mgpoisson
import mgpoisson_torch
from mgpoisson.cycle.vcycle import fmg as jax_fmg
from mgpoisson_torch.convert import spec_from_jax
from mgpoisson_torch.cycle.vcycle import fmg, v_cycle
from mgpoisson_torch.kernels import ops, use_packed
from mgpoisson_torch.solver import multigrid

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)


def _nmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _pair(**kw):
    """(JAX solver, port solver on the CPU) for one configuration."""
    spec = mgpoisson.Spec(backend="xla", **kw)
    return (mgpoisson.MultigridPoisson(spec),
            mgpoisson_torch.MultigridPoisson(spec_from_jax(dataclasses.asdict(spec)),
                                             device="cpu"))


@pytest.mark.parametrize("scheme", ["tuned", "reference", "fast"])
@pytest.mark.parametrize("n,ndim", [(64, 2), (16, 3)])
def test_fmg_pass_matches_jax(scheme, n, ndim):
    jspec = mgpoisson.Spec(size=n, ndim=ndim, dtype="float64", scheme=scheme, cycle="fmg",
                           backend="xla")
    spec = spec_from_jax(dataclasses.asdict(jspec))
    f = np.random.default_rng(n + ndim).standard_normal((n,) * ndim)
    want = np.asarray(jax_fmg(jnp.asarray(f), jspec.fine_h, jspec))
    got = fmg(torch.tensor(f), spec.fine_h, spec)
    assert got.shape == f.shape and got.dtype == torch.float64
    assert _nmax(got, want) <= 1e-12


FMG128 = dict(size=128, dtype="float64", scheme="tuned", cycle="fmg", stop="residual",
              tol=1e-10)


def test_fmg_solve_matches_jax_with_r0_from_the_minus_f_guess():
    mj, mt = _pair(**FMG128)
    rj, rt = mj.solve(), mt.solve()
    assert rj.converged and rt.converged
    assert rt.iterations == rj.iterations and rt.n_metric_evals == rt.iterations
    np.testing.assert_allclose(rt.errs.numpy(), np.asarray(rj.errs), rtol=1e-10)
    assert _nmax(rt.psi, rj.psi) <= 1e-12
    # the first err is ||r|| of the FMG iterate's first V-cycle over ||r||
    # of -f, not over the FMG iterate's own residual
    f = mt.rhs()
    h = mt.spec.fine_h
    psi1 = v_cycle(mt.init_state(f), f, h, mt.spec)
    want1 = float(ops.residual_norm(psi1, f, h) / ops.residual_norm(-f, f, h))
    assert abs(rt.errs[0].item() / want1 - 1) <= 1e-12
    # and the FMG start beats the -f start (the JAX package's own test)
    assert rt.iterations < mgpoisson_torch.MultigridPoisson(
        mt.spec.with_(cycle="v"), device="cpu").solve().iterations


def test_psi0_runs_no_fmg_pass(monkeypatch):
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return fmg(*a, **kw)

    monkeypatch.setattr(multigrid, "fmg", counted)
    spec = mgpoisson_torch.Spec(**FMG128)
    mg = mgpoisson_torch.MultigridPoisson(spec, device="cpu")
    f = mg.rhs()
    res = mg.solve(psi0=-f)
    assert calls == []
    # ... and it is then the V-cycle solve from psi0
    want = mgpoisson_torch.MultigridPoisson(spec.with_(cycle="v"), device="cpu").solve(psi0=-f)
    assert res.iterations == want.iterations
    assert torch.equal(res.errs, want.errs) and torch.equal(res.psi, want.psi)
    mg.solve()
    assert calls == [1]


def test_fast_fmg_solve_packs_its_fine_level(monkeypatch):
    """L3: use_packed admits cycle='fmg' (as the JAX package's
    packed.supported does); the FMG pass runs unpacked, the loop packed,
    within one cycle of the unpacked solve (the bar of the JAX package's
    tests/test_packed_persistent.py)."""
    spec = mgpoisson_torch.Spec(size=256, scheme="fast", cycle="fmg", stop="residual",
                                tol=1e-6, maxiter=12)
    monkeypatch.setenv("MGPOISSON_PACKED", "0")
    mg0 = mgpoisson_torch.MultigridPoisson(spec, device="cpu")
    assert not mg0._packed
    r0 = mg0.solve()
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    assert use_packed(spec, "cpu")
    mg1 = mgpoisson_torch.MultigridPoisson(spec, device="cpu")
    assert mg1._packed
    r1 = mg1.solve()
    assert r1.converged and r0.converged
    assert abs(r1.iterations - r0.iterations) <= 1
    np.testing.assert_allclose(r1.psi.numpy(), r0.psi.numpy(), atol=1e-4, rtol=1e-3)
    k = min(r1.iterations, r0.iterations)
    np.testing.assert_allclose(r1.errs[:k].numpy(), r0.errs[:k].numpy(), rtol=5e-2)
