"""The adaptive stop (stop_check='adaptive') in the port against the JAX package,
on the CPU.

Without a callback the solve measures ||r||/||r0|| only on the cycles a
learned contraction model picks (near tol, at least every
ADAPTIVE_MAX_SKIP cycles, always the first), and records its prediction on
the others.  Held here: the JAX package's decisions, cycle for cycle (the
same iterations, n_metric_evals and error history, skipped entries too), in
f64 and in f32; NaN caught within ADAPTIVE_MAX_SKIP + 1 cycles; a stop at
maxiter on a skipped cycle remeasured, on packed state too; a callback
making every cycle measure; one device->host read per measured cycle; and
FMG with the adaptive stop.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mgpoisson
import mgpoisson_torch
from mgpoisson_torch.convert import spec_from_jax
from mgpoisson_torch.solver import multigrid

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

MG = mgpoisson_torch.MultigridPoisson
TUNED = dict(scheme="tuned", stop="residual", stop_check="adaptive")
CASES = {
    "f64": dict(TUNED, size=64, dtype="float64", tol=1e-10),
    # 9 cycles, 6 of them measured
    "f32": dict(TUNED, size=64, dtype="float32", tol=1e-9),
    # tol out of reach: cycles 1 and 5 measure, maxiter lands in a skip
    "stale": dict(TUNED, size=64, dtype="float64", tol=1e-300, maxiter=6),
}


def _nmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's JAX solve, built and run once per module."""
    cache = {}

    def run(name):
        if name not in cache:
            cache[name] = mgpoisson.MultigridPoisson(
                mgpoisson.Spec(backend="xla", **CASES[name])).solve()
        return cache[name]
    return run


def _port(name, **kw):
    spec = spec_from_jax(dataclasses.asdict(mgpoisson.Spec(backend="xla", **CASES[name])))
    return MG(spec.with_(**kw), device="cpu")


def _measured(errs, tol, rdt):
    """The cycles (1-based) the JAX package's adaptive rule measures on a
    history whose measured entries are the measured values: its decision
    for a cycle reads only earlier measurements."""
    out, meas_err, meas_it, rho = [], rdt(1.0), 0, rdt(0.05)
    with np.errstate(all="ignore"):
        for it, e in enumerate(np.asarray(errs, rdt)):
            gap = it + 1 - meas_it
            pred = meas_err * rho ** rdt(gap)
            if pred < rdt(MG.ADAPTIVE_SAFETY * tol) or gap >= MG.ADAPTIVE_MAX_SKIP or it == 0:
                rho = np.clip(np.power(np.maximum(e / np.maximum(meas_err, rdt(1e-300)),
                                                  rdt(1e-30)), rdt(1) / rdt(gap)),
                              rdt(0.02), rdt(0.95))
                meas_err, meas_it = e, it + 1
                out.append(it + 1)
    return out


@pytest.fixture
def reads(monkeypatch):
    """Counts the solve loop's device->host reads."""
    calls = []

    def counted(t):
        calls.append(1)
        return t.item()

    monkeypatch.setattr(multigrid, "read_scalar", counted)
    return calls


def test_f64_adaptive_solve_matches_jax(jax_runs, reads):
    want = jax_runs("f64")
    got = _port("f64").solve()
    assert got.converged and want.converged
    assert got.iterations == want.iterations
    assert got.n_metric_evals == want.n_metric_evals < got.iterations
    assert len(reads) == got.n_metric_evals
    # every entry, the skipped ones' predictions too
    np.testing.assert_allclose(got.errs.numpy(), np.asarray(want.errs), rtol=1e-10)
    assert got.final_err == pytest.approx(want.final_err, rel=1e-10)
    assert _nmax(got.psi, want.psi) <= 1e-12


def test_f32_adaptive_solve_measures_the_cycles_jax_measures(jax_runs, reads):
    want = jax_runs("f32")
    got = _port("f32").solve()
    assert got.errs.dtype == torch.float32
    assert got.converged and want.converged
    assert got.iterations == want.iterations
    assert got.n_metric_evals == want.n_metric_evals == len(reads) < got.iterations
    tol = CASES["f32"]["tol"]
    cycles = _measured(got.errs.numpy(), tol, np.float32)
    assert cycles == _measured(np.asarray(want.errs), tol, np.float32)
    assert len(cycles) == got.n_metric_evals
    # the last cycles sit near the f32 relres floor at 64^2 (~1e-10), where
    # the order of roundings moves a relres by up to 0.2 %
    np.testing.assert_allclose(got.errs.numpy(), np.asarray(want.errs), rtol=1e-2)


def test_stale_exit_at_maxiter_is_remeasured(jax_runs, reads):
    want = jax_runs("stale")
    mg = _port("stale")
    got = mg.solve()
    assert not got.converged and got.iterations == want.iterations == 6
    # cycles 1 and 5 measured, then the returned iterate
    assert got.n_metric_evals == want.n_metric_evals == 3 == len(reads)
    f = mg.rhs()
    true_rel = float(mg.residual_norm(got.psi, f) / mg.residual_norm(-f, f))
    assert got.final_err == pytest.approx(true_rel, rel=1e-10)
    assert got.errs[-1].item() == pytest.approx(true_rel, rel=1e-10)
    np.testing.assert_allclose(got.errs.numpy(), np.asarray(want.errs), rtol=1e-10)


def test_packed_stale_exit_is_remeasured_on_packed_state(monkeypatch, reads):
    """The fast scheme with its fine level packed (MGPOISSON_PACKED=1 on the
    CPU): the same decisions as the unpacked solve, the packed skipped
    cycles, and the remeasure of the packed iterate."""
    spec = mgpoisson_torch.Spec(size=256, scheme="fast", stop="residual",
                                stop_check="adaptive", tol=1e-30, maxiter=6)
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    mg = MG(spec, device="cpu")
    assert mg._packed
    got = mg.solve()
    assert got.iterations == 6 and got.n_metric_evals == 3 == len(reads)
    f = mg.rhs()
    true_rel = float(mg.residual_norm(got.psi, f) / mg.residual_norm(-f, f))
    assert got.final_err == pytest.approx(true_rel, rel=1e-5)
    monkeypatch.setenv("MGPOISSON_PACKED", "0")
    want = MG(spec, device="cpu").solve()
    assert want.iterations == 6 and want.n_metric_evals == 3
    np.testing.assert_allclose(got.errs.numpy(), want.errs.numpy(), rtol=5e-2)


def test_nan_is_caught_within_max_skip_cycles(reads):
    mg = MG(mgpoisson_torch.Spec(size=32, dtype="float64", scheme="tuned", stop="residual",
                                 stop_check="adaptive", tol=1e-10, maxiter=50), device="cpu")
    f = mg.rhs()
    f[0, 0] = float("nan")
    res = mg.solve(f)
    assert not res.converged
    assert res.iterations <= MG.ADAPTIVE_MAX_SKIP + 1
    assert not np.isfinite(res.final_err) and len(reads) == res.n_metric_evals


def test_a_callback_makes_every_cycle_measure(reads):
    mg = _port("f64")
    seen = []
    res = mg.solve(error_callback=lambda it, err: seen.append(err) and False)
    assert res.converged and res.n_metric_evals == res.iterations == len(seen) == len(reads)
    every = _port("f64", stop_check="every").solve()
    assert res.iterations == every.iterations
    assert torch.equal(res.errs, every.errs) and torch.equal(res.psi, every.psi)


def test_fmg_with_adaptive_stop_takes_the_every_cycle_count(reads):
    """The forced first measurement keeps an FMG-initialised solve at the
    count of the every-cycle stop (the JAX package's own test)."""
    kw = dict(size=128, dtype="float64", scheme="tuned", cycle="fmg", stop="residual",
              tol=1e-10)
    every = MG(mgpoisson_torch.Spec(**kw), device="cpu").solve()
    del reads[:]
    res = MG(mgpoisson_torch.Spec(stop_check="adaptive", **kw), device="cpu").solve()
    assert res.converged and res.iterations == every.iterations
    assert len(reads) == res.n_metric_evals <= res.iterations
    assert res.errs[-1].item() == pytest.approx(every.errs[-1].item(), rel=1e-10)

