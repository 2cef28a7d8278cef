"""The port's slice as a whole against the JAX package.

The same Spec and the same right-hand side go through mgpoisson (backend
'xla') and mgpoisson_torch (on the CPU, so the plain ops) by way of
mgpoisson_torch.convert."""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mgpoisson
import mgpoisson_torch
from mgpoisson.cycle.vcycle import v_cycle as jax_v_cycle
from mgpoisson_torch.convert import spec_from_jax, state_from_numpy
from mgpoisson_torch.cycle.vcycle import v_cycle
from mgpoisson_torch.kernels import cuda

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(**kw):
    """(JAX solver, port solver) for one configuration."""
    spec = mgpoisson.Spec(backend="xla", **kw)
    return (mgpoisson.MultigridPoisson(spec),
            mgpoisson_torch.MultigridPoisson(
                spec_from_jax(dataclasses.asdict(spec)), device="cpu"))


def _nmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("cycle", ["v", "w"])
def test_reference_scheme_iterate_for_iterate(cycle):
    mj, mt = _pair(size=16, dtype="float64", scheme="reference",
                   stop="update", cycle=cycle, maxiter=500)
    rj, rt = mj.solve(), mt.solve()
    assert rt.iterations == rj.iterations and rt.converged == rj.converged
    np.testing.assert_allclose(rt.errs.numpy(), np.asarray(rj.errs), rtol=1e-10)


# f32 solves stop at tol=1e-7: at 64^2 the f32 relres floor sits near
# 1e-10, where the order of roundings, not the algorithm, sets the count
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("dtype,tol,err_rtol,psi_tol", [
    ("float32", 1e-7, 1e-4, 1e-5), ("float64", 1e-10, 1e-10, 1e-10)])
def test_tuned_residual_solve_matches(n, dtype, tol, err_rtol, psi_tol):
    mj, mt = _pair(size=n, dtype=dtype, scheme="tuned", stop="residual",
                   tol=tol)
    rj, rt = mj.solve(), mt.solve()
    assert rj.converged and rt.converged
    assert rt.iterations == rj.iterations
    assert rt.n_metric_evals == rt.iterations
    assert math.isclose(rt.final_err, rj.final_err, rel_tol=err_rtol)
    np.testing.assert_allclose(rt.errs.numpy(), np.asarray(rj.errs),
                               rtol=err_rtol)
    assert rt.psi.dtype == getattr(torch, dtype)
    assert _nmax(rt.psi, rj.psi) <= psi_tol


@pytest.mark.parametrize("n,dtype,tol,err_rtol,psi_tol", [
    (32, "float32", 1e-7, 1e-4, 1e-5), (64, "float32", 1e-7, 1e-4, 1e-5),
    (32, "float64", 1e-10, 1e-10, 1e-10)])
def test_tuned_residual_solve_matches_3d(n, dtype, tol, err_rtol, psi_tol):
    """The 3D slice: the 7-point tuned solve, cycle for cycle."""
    mj, mt = _pair(size=n, ndim=3, dtype=dtype, scheme="tuned",
                   stop="residual", tol=tol)
    rj, rt = mj.solve(), mt.solve()
    assert rj.converged and rt.converged
    assert rt.iterations == rj.iterations
    np.testing.assert_allclose(rt.errs.numpy(), np.asarray(rj.errs),
                               rtol=err_rtol)
    assert rt.psi.shape == (n, n, n)
    assert _nmax(rt.psi, rj.psi) <= psi_tol


def test_default_device_is_the_card(monkeypatch):
    """Without a CUDA device the solver's default device raises and names
    the way to the CPU; it never carries on there by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mgpoisson_torch.MultigridPoisson(mgpoisson_torch.Spec(size=16))


def test_cpu_device_solves():
    res = mgpoisson_torch.MultigridPoisson(mgpoisson_torch.Spec(size=16),
                                           device="cpu").solve()
    assert res.converged and res.psi.device.type == "cpu"


def test_step_trace_and_metrics_match():
    """One step from the same (psi, f), the traced V-cycle stage by stage,
    and the secondary metrics."""
    mj, mt = _pair(size=8, dtype="float64", scheme="tuned", stop="residual")
    rng = np.random.default_rng(0)
    psi, f = rng.normal(size=(8, 8)), rng.normal(size=(8, 8))
    pt, ft = state_from_numpy(psi, f, "cpu", "float64")
    pj_new, ej = mj.step(jnp.asarray(psi), jnp.asarray(f))
    pt_new, et = mt.step(pt, ft)
    assert _nmax(pt_new, pj_new) <= 1e-12
    assert math.isclose(float(et), float(ej), rel_tol=1e-12)
    assert math.isclose(float(mt.rel_err(pt_new, pt)),
                        float(mj.rel_err(pj_new, jnp.asarray(psi))), rel_tol=1e-12)
    trace_j, trace_t = [], []
    jax_v_cycle(jnp.asarray(psi), jnp.asarray(f), 1 / 8, mj.spec, trace=trace_j)
    v_cycle(pt, ft, 1 / 8, mt.spec, trace=trace_t)
    assert [(a, b) for a, b, _ in trace_t] == [(a, b) for a, b, _ in trace_j]
    for (_, _, xt), (_, _, xj) in zip(trace_t, trace_j):
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12,
                                   atol=1e-12 * float(np.max(np.abs(xj))))


def test_callback_arity_and_early_exit():
    _, mt = _pair(size=16, dtype="float64", scheme="reference")
    calls = []

    def cb2(it, err, verbose=False):    # defaulted third parameter: 2-arity
        calls.append((it, err))
        return it >= 3

    res = mt.solve(error_callback=cb2)
    assert [c[0] for c in calls] == [1, 2, 3]
    assert res.iterations == 3 and not res.converged
    np.testing.assert_array_equal(res.errs.numpy(), [c[1] for c in calls])

    seen = []
    res = mt.solve(error_callback=lambda it, err, psi: seen.append(psi) and False)
    assert res.converged and len(seen) == res.iterations
    assert seen[-1] is res.psi


def test_callback_path_matches_loop_path():
    mj, mt = _pair(size=16, dtype="float64", scheme="reference", maxiter=20)
    rj_cb = mj.solve(error_callback=lambda it, err: False)
    rt = mt.solve()
    rt_cb = mt.solve(error_callback=lambda it, err: False)
    assert rt.iterations == rt_cb.iterations == rj_cb.iterations == 20
    assert not rt.converged and not rt_cb.converged and not rj_cb.converged
    np.testing.assert_array_equal(rt.psi.numpy(), rt_cb.psi.numpy())


def test_maxiter_respected():
    _, mt = _pair(size=16, dtype="float64", maxiter=5)
    res = mt.solve()
    assert res.iterations == 5 and not res.converged and len(res.errs) == 5


@pytest.mark.parametrize("stop", ["update", "residual"])
def test_nonfinite_rhs_stops_after_one_cycle(stop):
    mj, mt = _pair(size=16, dtype="float64", maxiter=100, stop=stop)
    f = np.zeros((16, 16))
    f[0, 0] = np.nan
    rj, rt = mj.solve(jnp.asarray(f)), mt.solve(torch.tensor(f))
    assert rt.iterations == rj.iterations == 1
    assert not rt.converged and not rj.converged
    assert math.isnan(rt.final_err)


def test_psi0_is_copied_not_aliased():
    _, mt = _pair(size=32, dtype="float64", scheme="tuned", tol=1e-12)
    f = mt.rhs()
    psi0 = mt.init_state(f)
    before = psi0.clone()
    res1 = mt.solve(f, psi0=psi0)
    res2 = mt.solve(f, psi0=psi0)
    assert res1.psi is not psi0
    torch.testing.assert_close(psi0, before, rtol=0, atol=0)
    assert res1.iterations == res2.iterations
    torch.testing.assert_close(res1.psi, res2.psi, rtol=0, atol=0)



def _guard_cycles(mt, seen):
    """Wraps the solver's cycles in a stub that asserts that every operand
    it is handed is a dense row-major tensor at an 8-byte boundary, as the
    kernels take them (their 2D tile moves 8 bytes per lane)."""
    def guard(cycle):
        def stub(u, f, h):
            for x in (u, f):
                assert x.is_contiguous() and x.data_ptr() % 8 == 0, (x.stride(), x.data_ptr())
            seen.append(tuple(u.shape))
            return cycle(u, f, h)
        return stub
    mt._cycle = guard(mt._cycle)
    if mt._packed:
        mt._packed_cycle = guard(mt._packed_cycle)


def _odd_offset(a):
    """a's values as a dense row-major f32 tensor at an odd 4-byte offset."""
    buf = torch.empty(a.size + 1, dtype=torch.float32)
    x = buf[1:].view(a.shape)
    x.copy_(torch.from_numpy(a))
    assert x.is_contiguous() and x.data_ptr() % 8 == 4
    return x


# (f, psi0) given to solve() as another layout than a dense row-major array
# at an 8-byte boundary; None: the default psi0 = -f
STRIDED = {
    "transposed f": (lambda a: torch.from_numpy(a.T.copy()).t(), None),
    "fortran f": (np.asfortranarray, None),
    "fortran psi0": (torch.from_numpy, np.asfortranarray),
    "odd-offset f": (_odd_offset, None),
    "odd-offset psi0": (torch.from_numpy, _odd_offset),
}


@pytest.mark.parametrize("case", sorted(STRIDED))
@pytest.mark.parametrize("scheme,n", [("tuned", 32), ("fast", 256)])
def test_solver_hands_the_cycle_dense_operands(monkeypatch, case, scheme, n):
    """F1 (ROADMAP Queue 3): solve() and step() take f and psi0 of any
    strides and offset and hand the cycle (the kernels, on the card) dense
    row-major operands at an 8-byte boundary, with the psi and the
    iteration count of the dense copies and the callers' arrays unwritten;
    the fast scheme at 256 on its packed fine level (MGPOISSON_PACKED=1)."""
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    mt = mgpoisson_torch.MultigridPoisson(
        mgpoisson_torch.Spec(size=n, dtype="float32", scheme=scheme, stop="residual",
                             tol=1e-6, maxiter=3), device="cpu")
    assert mt._packed == (scheme == "fast")
    rng = np.random.default_rng(n)
    a = mt.rhs().numpy()
    a[n // 4, n // 2 + 3] = 3.0e5                 # not symmetric: a.T is another problem
    p = (-a + rng.normal(size=a.shape)).astype(np.float32)
    make_f, make_psi0 = STRIDED[case]
    f_in = make_f(a)
    psi0_in = None if make_psi0 is None else make_psi0(p)
    want = mt.solve(torch.from_numpy(a), psi0=None if psi0_in is None else torch.from_numpy(p))
    want_step = mt.step(torch.from_numpy(p), torch.from_numpy(a))
    seen = []
    _guard_cycles(mt, seen)
    got = mt.solve(f_in, psi0=psi0_in)
    assert len(seen) == got.iterations == want.iterations
    assert torch.equal(got.psi, want.psi)
    for x, v in ((f_in, a), (psi0_in, p)):
        if x is not None:
            assert np.array_equal(np.asarray(x), v)     # the caller's array, unwritten
    # step() likewise, on tensors of the same layouts
    psi_in = torch.as_tensor(make_f(p) if make_psi0 is None else make_psi0(p))
    seen.clear()
    got = mt.step(psi_in, torch.as_tensor(f_in))
    assert len(seen) == 1 and all(torch.equal(g, w) for g, w in zip(got, want_step))


def test_state_from_numpy_gives_dense_tensors():
    """A Fortran-order or strided NumPy array comes across as a dense
    row-major tensor (F1)."""
    a = np.asfortranarray(np.random.default_rng(1).normal(size=(8, 12)))
    psi, f = state_from_numpy(a, a[:, ::2], "cpu")
    for t, v in ((psi, a), (f, a[:, ::2])):
        assert t.is_contiguous() and np.array_equal(t.numpy(), v.astype(np.float32))

VALID = [dict(), dict(scheme="reference"), dict(scheme="fast"),
         dict(smoother="rbgs"), dict(cycle="w"), dict(stop="residual"),
         dict(coarse_size=4), dict(h=0.01), dict(dtype="float64"),
         dict(backend="xla", ndim=3), dict(backend="pallas"),
         dict(pallas_min_size=64), dict(sweep_dtype="float32"), dict(ndim=3),
         dict(ndim=3, backend="pallas"), dict(mesh_shape=(2, 2)),
         dict(partition="spmd"), dict(sweep_dtype="bfloat16", mesh_shape=(2, 2)),
         # the pure bf16 solve under a mesh (A4b)
         dict(dtype="bfloat16", mesh_shape=(2, 2)),
         # FMG and the adaptive stop, on one device and under a mesh
         dict(stop="residual", stop_check="adaptive"), dict(cycle="fmg"),
         dict(sweep_dtype="bfloat16", ndim=3, mesh_shape=(2, 2), cycle="fmg"),
         # the reference's lexicographic Gauss-Seidel, on the plain ops
         dict(smoother="gs_lex", scheme="reference")]
INVALID = [dict(size=100), dict(ndim=4), dict(scheme="x"),
           dict(smoother="sor"), dict(cycle="z"), dict(stop="x"),
           dict(stop_check="x"), dict(stop_check="adaptive"),
           dict(backend="gpu"), dict(partition="x"), dict(coarse_size=3),
           dict(coarse_size=128), dict(dtype="int8"), dict(sweep_dtype="x"),
           dict(smoother="gs_lex"),
           dict(smoother="gs_lex", scheme="reference", mesh_shape=(2, 2))]
# valid in the JAX package but not ported yet: NotImplementedError, never
# silently ignored.  bf16 runs on one device and under a mesh, 2D and 3D,
# since the pure bf16 solve under a mesh (A4b); the bf16 case keeps its
# name and holds what of bf16 is still not ported: bf16 under the gspmd
# partition, which has no torch counterpart
LATER = [dict(partition="gspmd"),
         pytest.param(dict(dtype="bfloat16", mesh_shape=(2, 2), partition="gspmd"),
                      id=repr(dict(dtype="bfloat16")))]


@pytest.mark.parametrize("kw", VALID, ids=repr)
def test_spec_accepts_like_jax(kw):
    jax_spec = mgpoisson.Spec(**{"size": 64, **kw})
    spec = spec_from_jax(dataclasses.asdict(jax_spec))
    for prop in ("coarse_bc", "prolong_kind", "smoother_resolved", "nu_pre",
                 "nu_post", "fine_h", "shape"):
        assert getattr(spec, prop) == getattr(jax_spec, prop)
    assert spec.kernel_min_size == jax_spec.pallas_min_size
    assert spec.backend == {"auto": "auto", "xla": "torch",
                            "pallas": "cuda"}[jax_spec.backend]


@pytest.mark.parametrize("kw", INVALID, ids=repr)
def test_spec_rejects_like_jax(kw):
    kw = {"size": 64, **kw}
    with pytest.raises(ValueError) as jax_err:
        mgpoisson.Spec(**kw)
    with pytest.raises(ValueError) as port_err:
        spec_from_jax(kw)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("kw", LATER, ids=repr)
def test_spec_names_the_slice_of_what_is_not_ported(kw):
    kw = {"size": 64, **kw}
    mgpoisson.Spec(**kw)
    with pytest.raises(NotImplementedError, match="ROADMAP slice"):
        spec_from_jax(kw)


def test_backend_cuda_on_cpu_is_an_error():
    with pytest.raises(ValueError, match="CUDA tensors"):
        mgpoisson_torch.MultigridPoisson(mgpoisson_torch.Spec(size=64, backend="cuda"),
                                         device="cpu")


def test_cpu_solve_launches_no_kernel():
    """On CPU tensors every level runs the plain ops, whatever the
    backend: all launch counters stay 0."""
    cuda.reset_launches()
    res = mgpoisson_torch.MultigridPoisson(
        mgpoisson_torch.Spec(size=512, stop="residual", tol=1e-6),
        device="cpu").solve()
    assert res.converged
    assert all(v == 0 for v in cuda.launches.values()), cuda.launches


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import mgpoisson_torch, mgpoisson_torch.convert\n"
            "import mgpoisson_torch.kernels.cuda, mgpoisson_torch.kernels.build\n"
            "import mgpoisson_torch.cycle, mgpoisson_torch.solver\n"
            "import mgpoisson_torch.shard.mesh, mgpoisson_torch.shard.multihost\n"
            "import mgpoisson_torch.shard.spmd\n"
            "import mgpoisson_torch.bench.profile, mgpoisson_torch.bench.sass_diff\n"
            "import mgpoisson_torch.bench.ab, mgpoisson_torch.bench.packed_order\n"
            "import mgpoisson_torch.utils\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mgpoisson', 'ml_dtypes')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)


@pytest.mark.parametrize("size,coarse", [(1, 1), (64, 1), (256, 4)])
def test_hierarchy_matches_jax(size, coarse):
    from mgpoisson.core import hierarchy as jh
    from mgpoisson_torch.core import hierarchy as th
    assert th.level_sizes(size, coarse) == jh.level_sizes(size, coarse)
    assert th.num_levels(size, coarse) == jh.num_levels(size, coarse)
    assert th.level_spacings(size, 1 / size, coarse) == \
        jh.level_spacings(size, 1 / size, coarse)
