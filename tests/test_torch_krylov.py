"""The port's Krylov solvers (``mgpoisson_torch.compare.krylov``) against the
JAX package's (``mgpoisson.compare.krylov``, backend 'xla'), on the CPU.

The same inputs, a point charge and a seeded numpy RHS, go through both in
f64 (tol 1e-10): CG, CR and GMRES (restart 40 and 25) at 32^2 (point) and
16^2 (seeded), and MGCG (pcg with mg_preconditioner) for the tuned,
reference and fast schemes at 16^2 (tuned and reference at the seeded RHS,
fast at the point charge).  Held: the iteration count and
`converged` equal, every ||r||/||b|| entry within RES_RTOL and every
||x||_inf entry within XNORM_RTOL relative, x within X_TOL normalized.
MGCG with the fast scheme (one wjacobi sweep each way) stalls on both
sides and stops at maxiter.  Then the JAX package's own checks
(tests/test_krylov.py), held by the port.

Two things the bars above do not hold, with the figures of a CPU run
(JAX package, then port; f64, tol 1e-10 unless stated):

- BiCGStab's history follows the rounding of its operations: the two
  relres histories agree to 1e-6 through iteration 25-29 and then part
  (by iteration 39 of 32^2 point they differ 28-fold), so its count is the
  same only by chance: 98 / 99 at 32^2 point, 50 / 50 at 16^2 seeded,
  48 / 50 at 16^2 point, and at tol 1e-12 (the convergence study) 106 /
  107 at 32^2, 200 / 212 at 64^2, 419 / 399 at 128^2.  XLA on the CPU sums
  a dot product as one sequential chain of fused multiply-adds; torch sums
  in another order.  test_bicgstab_tracks_jax holds the history where it
  is reproducible (BICG_TRACK iterations), `converged`, the final relres
  below tol and x within BICG_X_TOL; ROADMAP Queue 3 K1 records the miss.
- GMRES's late residual entries carry the rounding of the restart's
  first residual, ~1e-16 * ||r0|| / ||b||, which at an entry near 1e-10
  is a relative error near 1e-5: at 8^2 seeded, restart 25, the last
  entry is 7.54373e-11 / 7.54389e-11 (2.0e-5), at 64^2 point 1.6e-6;
  counts and x agree (x to 3e-15).  The inputs above stay below RES_RTOL
  (6.2e-8 to 3.8e-7); ROADMAP Queue 3 K2 records the miss.

In f32 (test_f32_mgcg_matches_jax) MGCG at 64^2 takes the JAX package's
count (12 / 12 point, 13 / 13 seeded; relres within 2.7e-4, x within
1.5e-4 at the point charge); plain CG in f32 to tol 1e-10 does not (295 /
278 at 64^2 point), which is why the card holds f32 on MGCG only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mgpoisson
from mgpoisson import oracle
from mgpoisson.compare import krylov as jk
import mgpoisson_torch
from mgpoisson_torch.compare import krylov
from mgpoisson_torch.convert import spec_from_jax
from mgpoisson_torch.cycle.vcycle import make_cycle
from mgpoisson_torch.kernels import cuda
from mgpoisson_torch.solver import multigrid

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

TOL = 1e-10
RES_RTOL = 1e-6       # ||r||/||b|| per entry, relative
XNORM_RTOL = 1e-6     # ||x||_inf per entry, relative
X_TOL = 1e-10         # x, normalized by max |x| of the JAX run
M_TOL = 1e-12         # one preconditioner application, normalized
BICG_TRACK = 20       # BiCGStab iterations whose relres is held to RES_RTOL
BICG_X_TOL = 1e-8     # BiCGStab's x, normalized: two solves stopped below tol
PCG_MAXITER = 200
# f32 MGCG: relres per entry, and x normalized.  An f32 iterate from
# x0 = -b carries the rounding of x0: eps(f32) * max|b| = 1.2e-7 * 1e6 =
# 0.12 against max|x| = 201 at 64^2, 5.9e-4 normalized
F32_RES_RTOL = 1e-3
F32_X_TOL = 1e-3

INPUTS = {"point32": ("point", 32), "seeded16": ("seeded", 16)}
PCG_INPUTS = {"point16": ("point", 16), "seeded16": ("seeded", 16)}
# (scheme, input), each scheme at one input (each JAX run compiles a
# V-cycle into its loop); tuned MGCG at the 16^2 point charge is held to
# the JAX package in tests/test_torch_converge.py, in f32 at 64^2 below
PCG_CASES = [("tuned", "seeded16"), ("reference", "seeded16"), ("fast", "point16")]
SOLVERS = {"cg": ("cg", {}), "cr": ("conjugate_residual", {}),
           "gmres40": ("gmres", {"restart": 40}), "gmres25": ("gmres", {"restart": 25})}
SCHEMES = ("tuned", "reference", "fast")


def _rhs(kind, n, dtype=np.float64):
    f = (oracle.point_charge_rhs(n) if kind == "point"
         else np.random.default_rng(n).standard_normal((n, n)))
    return f.astype(dtype)


def _jax_spec(n, scheme, dtype="float64"):
    return mgpoisson.Spec(size=n, dtype=dtype, scheme=scheme, backend="xla")


def _port_spec(n, scheme, dtype="float64"):
    return spec_from_jax(dataclasses.asdict(_jax_spec(n, scheme, dtype)))


def _numpy(res):
    return {"iterations": int(res.iterations), "converged": bool(res.converged),
            "residuals": np.asarray(res.residuals, np.float64),
            "xnorms": np.asarray(res.xnorms, np.float64), "x": np.asarray(res.x, np.float64)}


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's JAX solve, run once per module (each compiles its loop):
    case -> iterations, converged, residuals, xnorms, x as numpy."""
    cache = {}

    def run(solver, kind, n, dtype=np.float64, scheme=None, **kw):
        key = (solver, kind, n, np.dtype(dtype).name, scheme, tuple(sorted(kw.items())))
        if key not in cache:
            if scheme is not None:
                kw["M"] = jk.mg_preconditioner(_jax_spec(n, scheme, np.dtype(dtype).name))
            res = getattr(jk, solver)(jk.poisson_operator(1.0 / n),
                                      jnp.asarray(_rhs(kind, n, dtype)), tol=TOL, **kw)
            cache[key] = _numpy(res)
        return cache[key]
    return run


def _port(solver, kind, n, dtype=torch.float64, scheme=None, **kw):
    """The port's run on the CPU, and its device->host reads."""
    if scheme is not None:
        kw["M"] = krylov.mg_preconditioner(_port_spec(n, scheme, str(dtype).split(".")[-1]))
    reads, read = [], multigrid.read_scalar
    multigrid.read_scalar = lambda t: reads.append(1) or read(t)
    try:
        res = getattr(krylov, solver)(krylov.poisson_operator(1.0 / n),
                                      torch.tensor(_rhs(kind, n)).to(dtype), tol=TOL, **kw)
    finally:
        multigrid.read_scalar = read
    return res, len(reads)


def _rel(got, want):
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _nmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _hold(res, want):
    """The bars of the module docstring, res against the JAX run `want`."""
    it = res.iterations
    assert (it, res.converged) == (want["iterations"], want["converged"])
    assert res.residuals.shape == res.xnorms.shape == (it,)
    assert _rel(res.residuals.numpy(), want["residuals"]) <= RES_RTOL
    assert _rel(res.xnorms.numpy(), want["xnorms"]) <= XNORM_RTOL
    assert _nmax(res.x, want["x"]) <= X_TOL


@pytest.mark.parametrize("inp", INPUTS)
@pytest.mark.parametrize("name", SOLVERS)
def test_krylov_matches_jax(name, inp, jax_runs):
    solver, kw = SOLVERS[name]
    want = jax_runs(solver, *INPUTS[inp], maxiter=2000, **kw)
    res, reads = _port(solver, *INPUTS[inp], maxiter=2000, **kw)
    _hold(res, want)
    assert res.x.dtype == torch.float64 and res.x.shape == (INPUTS[inp][1],) * 2
    if solver == "gmres":
        # ||b||, then per restart cycle ||x||_inf (its residual norms come
        # back in one list beside it)
        cycles = -(-res.iterations // kw["restart"])
        assert reads == 1 + cycles
    else:
        assert reads == res.iterations + 1      # the stop test, before and after each


@pytest.mark.parametrize("scheme,inp", PCG_CASES)
def test_mgcg_matches_jax(scheme, inp, jax_runs):
    want = jax_runs("pcg", *PCG_INPUTS[inp], scheme=scheme, maxiter=PCG_MAXITER)
    cuda.reset_launches()
    res, reads = _port("pcg", *PCG_INPUTS[inp], scheme=scheme, maxiter=PCG_MAXITER)
    _hold(res, want)
    assert reads == res.iterations + 1
    assert res.converged == (scheme != "fast")     # fast: stalls to maxiter on both sides
    assert all(v == 0 for v in cuda.launches.values())      # CPU: the plain ops


@pytest.mark.parametrize("inp", INPUTS)
def test_bicgstab_tracks_jax(inp, jax_runs):
    """BiCGStab: see the module docstring for the counts."""
    want = jax_runs("bicgstab", *INPUTS[inp], maxiter=2000)
    res, reads = _port("bicgstab", *INPUTS[inp], maxiter=2000)
    assert want["converged"] and res.converged and reads == res.iterations + 1
    k = BICG_TRACK
    assert _rel(res.residuals[:k].numpy(), want["residuals"][:k]) <= RES_RTOL
    assert _rel(res.xnorms[:k].numpy(), want["xnorms"][:k]) <= XNORM_RTOL
    assert res.residuals[-1].item() <= TOL and want["residuals"][-1] <= TOL
    assert _nmax(res.x, want["x"]) <= BICG_X_TOL


@pytest.mark.parametrize("scheme", SCHEMES)
def test_mg_preconditioner_matches_jax(scheme):
    """M(r) against the JAX M(r), and the port's from-zero fine level
    (u=None) bit-equal to its cycle from a zeros iterate."""
    n = 16
    r = np.random.default_rng(7).standard_normal((n, n))
    want = np.asarray(jax.jit(jk.mg_preconditioner(_jax_spec(n, scheme)))(jnp.asarray(r)))
    spec = _port_spec(n, scheme)
    got = krylov.mg_preconditioner(spec)(torch.tensor(r))
    assert _nmax(got, want) <= M_TOL
    nu = max(spec.nu_pre, spec.nu_post, 1)
    pspec = spec.with_(smoother="wjacobi", pre_smooth=nu, post_smooth=nu)
    rt = torch.tensor(r)
    assert torch.equal(got, make_cycle(pspec)(torch.zeros_like(rt), rt, pspec.fine_h))


def test_f32_mgcg_matches_jax(jax_runs):
    """MGCG in f32 at 64^2, point charge: the JAX package's count (see
    the module docstring)."""
    want = jax_runs("pcg", "point", 64, np.float32, scheme="tuned", maxiter=500)
    res, _ = _port("pcg", "point", 64, torch.float32, scheme="tuned", maxiter=500)
    assert res.x.dtype == res.residuals.dtype == torch.float32
    assert (res.iterations, res.converged) == (want["iterations"], want["converged"])
    assert want["converged"]
    assert _rel(res.residuals.double().numpy(), want["residuals"]) <= F32_RES_RTOL
    assert _nmax(res.x, want["x"]) <= F32_X_TOL


def test_clamps_follow_the_dtype():
    """The JAX package's 1e-300 clamps are a weak-typed Python float: 0 in
    f32 and bf16, 1e-300 in f64."""
    assert krylov._tiny(torch.float64) == 1e-300
    assert krylov._tiny(torch.float32) == krylov._tiny(torch.bfloat16) == 0.0


# -- the JAX package's own checks (tests/test_krylov.py), held by the port

def _dense_solve(size):
    """Direct dense solve of the zero-ghost 5-point system."""
    h = 1.0 / size
    N = size * size
    A = np.zeros((N, N))
    for i in range(size):
        for j in range(size):
            k = i * size + j
            A[k, k] = -4.0 / h**2
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < size and 0 <= jj < size:
                    A[k, ii * size + jj] = 1.0 / h**2
    return np.linalg.solve(A, oracle.point_charge_rhs(size).ravel()).reshape(size, size)


@pytest.mark.parametrize("solver,kw", [
    ("cg", {}), ("conjugate_residual", {}), ("bicgstab", {}),
    ("gmres", {"restart": 40, "maxiter": 500}), ("pcg", {"scheme": "tuned", "maxiter": 200})])
def test_krylov_matches_dense_solve(solver, kw):
    exact = _dense_solve(8)
    res, _ = _port(solver, "point", 8, **kw)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), exact, rtol=1e-6, atol=1e-6 * np.abs(exact).max())


@pytest.mark.parametrize("size", [16, 32])
def test_multigrid_vs_cg_agreement_gate(size):
    spec = mgpoisson_torch.Spec(size=size, dtype="float64", scheme="tuned", tol=1e-12)
    mg_res = mgpoisson_torch.MultigridPoisson(spec, device="cpu").solve()
    f = torch.tensor(oracle.point_charge_rhs(size))
    cg_res = krylov.cg(krylov.poisson_operator(1.0 / size), f, tol=1e-12)
    d = (cg_res.x - mg_res.psi).abs().max() / mg_res.psi.abs().max()
    assert d < 1e-8, f"size {size}: mg vs cg diff {d:.2e}"


def test_multigrid_and_mgcg_beat_cg_at_64():
    size = 64
    spec = mgpoisson_torch.Spec(size=size, dtype="float64", scheme="tuned", stop="residual",
                                tol=1e-10)
    mg_res = mgpoisson_torch.MultigridPoisson(spec, device="cpu").solve()
    f = torch.tensor(oracle.point_charge_rhs(size))
    A = krylov.poisson_operator(1.0 / size)
    plain = krylov.cg(A, f, tol=1e-10, maxiter=5000)
    mgcg = krylov.pcg(A, f, M=krylov.mg_preconditioner(spec), tol=1e-10, maxiter=500)
    assert plain.converged and mgcg.converged and mg_res.converged
    assert mg_res.iterations < plain.iterations / 5
    assert mgcg.iterations < plain.iterations / 5, f"mgcg {mgcg.iterations} vs cg {plain.iterations}"


@pytest.mark.parametrize("solver,kw", [
    ("cg", {}), ("conjugate_residual", {}), ("bicgstab", {}), ("gmres", {"restart": 25}),
    ("pcg", {"scheme": "tuned"})])
def test_xnorms_last_is_max_abs_x(solver, kw):
    res, _ = _port(solver, "point", 16, maxiter=400, **kw)
    assert res.converged and res.xnorms.shape == (res.iterations,)
    assert bool(torch.isfinite(res.xnorms).all())
    assert res.xnorms[-1].item() == pytest.approx(res.x.abs().max().item(), rel=1e-12)


def test_callback_replays_the_history_and_true_ends_the_replay_only():
    f = torch.tensor(oracle.point_charge_rhs(16))
    A = krylov.poisson_operator(1.0 / 16)
    seen = []
    full = krylov.cg(A, f, tol=1e-10, error_callback=lambda it, e: seen.append((it, e)) or False)
    assert [it for it, _ in seen] == list(range(1, full.iterations + 1))
    assert [e for _, e in seen] == full.residuals.tolist() and seen[-1][1] < 1e-10
    seen.clear()
    stopped = krylov.cg(A, f, tol=1e-10, error_callback=lambda it, e: seen.append(it) or it == 3)
    assert seen == [1, 2, 3]
    assert stopped.iterations == full.iterations and stopped.converged
    assert torch.equal(stopped.x, full.x)


def test_gmres_callback_runs_in_the_loop_and_true_ends_the_solve():
    f = torch.tensor(oracle.point_charge_rhs(16))
    A = krylov.poisson_operator(1.0 / 16)
    seen = []
    res = krylov.gmres(A, f, tol=1e-10, maxiter=400, restart=25,
                       error_callback=lambda it, e: seen.append(it) or False)
    assert res.converged and seen == list(range(1, res.iterations + 1))
    stopped = krylov.gmres(A, f, tol=1e-10, maxiter=400, restart=25,
                           error_callback=lambda it, e: it == 30)
    assert stopped.converged and stopped.iterations == 30
    assert stopped.residuals[-1].item() > 1e-10
    assert stopped.xnorms.shape == (30,)
