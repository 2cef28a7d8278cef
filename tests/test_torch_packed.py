"""The fast scheme's packed-persistent fine level of the port against the
JAX package.

The plain packed ops (mgpoisson_torch.kernels.ops, what K7/K8 are held to
on the card and what the wrappers run on the CPU) against the Pallas packed
kernels run as tests/test_packed_persistent.py runs them (interpreter
mode), against the XLA where-select ops on the unpacked grid, and the
packed cycle and solve against the JAX package's.  The packed and
where-select forms add in other orders, so their bars are those of
test_packed_persistent.py; the port's and the Pallas packed forms share
their order apart from XLA's own fusions, so theirs are tighter: u <= 1e-6
normalized, Rc <= 1e-5 normalized, sum(r^2) <= 1e-5 relative."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mgpoisson
import mgpoisson.kernels.pallas as P
import mgpoisson.kernels.xla as X
from mgpoisson.cycle import packed as PK
from mgpoisson_torch import MultigridPoisson, Spec
from mgpoisson_torch.convert import spec_from_jax, state_from_numpy
from mgpoisson_torch.cycle import packed as packed_cycle
from mgpoisson_torch.kernels import cuda, ops, use_packed

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MGPOISSON_PALLAS_INTERPRET", "1")


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal((n // 2, n // 2)).astype(np.float32))


def _nmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _packed_pair(u, f):
    """(JAX packed u, f), (port packed u, f)."""
    return ((P.pack_grid(jnp.asarray(u)), P.pack_grid(jnp.asarray(f))),
            (ops.pack_grid(torch.tensor(u)), ops.pack_grid(torch.tensor(f))))


@pytest.mark.parametrize("n", [256, 512])
def test_pack_and_unpack_carry_jax_state_exactly(n):
    """The port's packing is the JAX package's, bit for bit, and a JAX
    packed array carried across as numpy unpacks to the same grid."""
    u, f, _ = _data(n, seed=n)
    (uj, fj), (ut, ft) = _packed_pair(u, f)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    psi, rhs = state_from_numpy(np.asarray(uj), np.asarray(fj), "cpu")
    np.testing.assert_array_equal(ops.unpack_grid(psi).numpy(), u)
    np.testing.assert_array_equal(ops.unpack_grid(rhs).numpy(), f)


# six interpret-mode Pallas calls in all: each op once at nu = 1 and once
# at nu = 3, the two prolongation kinds split between them
@pytest.mark.parametrize("op,nu,kind", [
    ("rr", 1, None), ("rr", 3, None),
    ("pc", 1, "inject"), ("pc", 3, "bilinear"),
    ("rnorm", 1, "bilinear"), ("rnorm", 3, "inject")])
def test_plain_packed_ops_vs_pallas(op, nu, kind):
    n = 256
    u, f, V = _data(n, seed=nu)
    h = 1.0 / n
    (uj, fj), (ut, ft) = _packed_pair(u, f)
    if op == "rr":
        wu, wR = P.packed_smooth_residual_restrict(uj, fj, h, nu)
        gu, gR = ops.packed_smooth_residual_restrict(ut, ft, h, nu)
        assert _nmax(gu, wu) <= 1e-6
        assert _nmax(gR, wR) <= 1e-5
    elif op == "pc":
        want = P.packed_prolong_correct_smooth(uj, fj, jnp.asarray(V), h, nu, kind=kind)
        got = ops.packed_prolong_correct_smooth(ut, ft, torch.tensor(V), h, nu, kind)
        assert _nmax(got, want) <= 1e-6
    else:
        wu, w2 = P.packed_prolong_correct_smooth_rnorm(uj, fj, jnp.asarray(V), h, nu,
                                                       kind=kind)
        gu, g2 = ops.packed_prolong_correct_smooth_rnorm(ut, ft, torch.tensor(V), h, nu,
                                                         kind)
        assert _nmax(gu, wu) <= 1e-6
        assert abs(float(g2) / float(w2) - 1.0) <= 1e-5


@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("nu", [1, 2, 3])
def test_plain_packed_ops_vs_unpacked_xla(n, nu):
    """The packed forms against the where-select ops on the unpacked grid,
    with test_packed_persistent.py's tolerances; R's absolute one, 1e-2 at
    n = 256, scales with the 1/h^2 that R carries (one f32 ulp of its
    ~1e5 values at 256 is 2^-7)."""
    u, f, V = _data(n, seed=10 * n + nu)
    h = 1.0 / n
    uj, fj, Vj = jnp.asarray(u), jnp.asarray(f), jnp.asarray(V)
    ut, ft, Vt = (ops.pack_grid(torch.tensor(u)), ops.pack_grid(torch.tensor(f)),
                  torch.tensor(V))
    us = X.smooth(uj, fj, h, nu, "rbgs", "ghost0")
    gu, gR = ops.packed_smooth_residual_restrict(ut, ft, h, nu)
    np.testing.assert_allclose(ops.unpack_grid(gu).numpy(), np.asarray(us), atol=5e-6)
    np.testing.assert_allclose(gR.numpy(), np.asarray(X.residual_restrict(us, fj, h, "ghost0")),
                               rtol=1e-3, atol=1e-2 * (n / 256) ** 2)
    for kind in ("inject", "bilinear"):
        ue = X.smooth(X.prolong_correct(uj, Vj, kind), fj, h, nu, "rbgs", "ghost0")
        got = ops.packed_prolong_correct_smooth(ut, ft, Vt, h, nu, kind)
        np.testing.assert_allclose(ops.unpack_grid(got).numpy(), np.asarray(ue), atol=5e-6)
        g2u, g2 = ops.packed_prolong_correct_smooth_rnorm(ut, ft, Vt, h, nu, kind)
        expect = X.residual_sq_sum(jnp.asarray(ops.unpack_grid(g2u).numpy()), fj, h)
        np.testing.assert_allclose(float(g2), float(expect), rtol=1e-4)


@pytest.mark.parametrize("cycle,rnorm", [("v", False), ("w", True)])
def test_packed_cycle_matches_jax(monkeypatch, cycle, rnorm):
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    n = 256
    spec = mgpoisson.Spec(size=n, scheme="fast", backend="xla", cycle=cycle)
    u, f, _ = _data(n, seed=5)
    h = spec.fine_h
    want = PK.make_packed_cycle(spec, rnorm=rnorm)(PK.pack(jnp.asarray(u)),
                                                   PK.pack(jnp.asarray(f)), h)
    got = packed_cycle.make_packed_cycle(spec_from_jax(dataclasses.asdict(spec)),
                                         rnorm=rnorm)(
        ops.pack_grid(torch.tensor(u)), ops.pack_grid(torch.tensor(f)), h)
    if rnorm:
        (want, w2), (got, g2) = want, got
        assert abs(float(g2) / float(w2) - 1.0) <= 1e-5
    np.testing.assert_allclose(ops.unpack_grid(got).numpy(),
                               np.asarray(PK.unpack(want)), atol=2e-5)


@pytest.mark.parametrize("stop", ["update", "residual"])
def test_packed_solve_matches_jax(monkeypatch, stop):
    """The port's packed CPU solve against the JAX package's packed solve
    (test_packed_persistent.py's bars: the stopping cycle may move by one
    near the threshold)."""
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    tol = 2e-5 if stop == "update" else 1e-6
    spec = mgpoisson.Spec(size=256, scheme="fast", stop=stop, tol=tol, maxiter=12)
    mj = mgpoisson.MultigridPoisson(spec)
    mt = MultigridPoisson(spec_from_jax(dataclasses.asdict(spec)), device="cpu")
    assert mj._packed and mt._packed
    rj, rt = mj.solve(), mt.solve()
    assert rt.converged == rj.converged
    assert abs(rt.iterations - rj.iterations) <= 1
    np.testing.assert_allclose(rt.psi.numpy(), np.asarray(rj.psi), atol=1e-4, rtol=1e-3)
    k = min(rt.iterations, rj.iterations, 5)
    np.testing.assert_allclose(rt.errs.numpy()[:k], np.asarray(rj.errs)[:k], rtol=5e-2)


def test_callbacks_and_the_packed_loop(monkeypatch):
    """No callback and a 2-parameter one run the packed loop and agree
    exactly; a 3-parameter one gets the unpacked psi from the unpacked
    step, which differs from the packed loop by add order only."""
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    mt = MultigridPoisson(Spec(size=256, scheme="fast", stop="residual", tol=1e-8),
                          device="cpu")
    assert mt._packed
    plain = mt.solve()
    two = mt.solve(error_callback=lambda it, err: False)
    seen = []
    three = mt.solve(error_callback=lambda it, err, psi: seen.append(psi) and False)
    assert two.iterations == plain.iterations == three.iterations
    np.testing.assert_array_equal(two.psi.numpy(), plain.psi.numpy())
    np.testing.assert_array_equal(two.errs.numpy(), plain.errs.numpy())
    assert seen[-1] is three.psi and three.psi.shape == (256, 256)
    assert _nmax(three.psi, plain.psi) <= 1e-5


# specs as the JAX package writes them; use_packed must take exactly those
# its packed.supported takes
SUPPORT_CASES = [
    dict(scheme="fast"), dict(scheme="fast", size=4096), dict(scheme="fast", size=128),
    dict(scheme="fast", pallas_min_size=512), dict(scheme="tuned"),
    dict(scheme="tuned", smoother="rbgs"), dict(scheme="reference", smoother="rbgs"),
    dict(scheme="fast", backend="xla"), dict(scheme="fast", backend="pallas"),
    dict(scheme="fast", cycle="w"), dict(scheme="fast", pre_smooth=3),
    dict(scheme="fast", pre_smooth=4), dict(scheme="fast", post_smooth=0),
    dict(scheme="fast", dtype="float64"), dict(scheme="fast", ndim=3),
    dict(scheme="fast", coarse_size=256)]


@pytest.mark.parametrize("kw", SUPPORT_CASES, ids=repr)
@pytest.mark.parametrize("flag", ["1", "0"])
def test_use_packed_takes_what_jax_takes(monkeypatch, kw, flag):
    monkeypatch.setenv("MGPOISSON_PACKED", flag)
    spec = mgpoisson.Spec(**{"size": 256, **kw})
    want = PK.supported(spec)
    spec_t = spec_from_jax(dataclasses.asdict(spec))
    assert use_packed(spec_t, "cpu") is want
    assert use_packed(spec_t, "cuda") is want


def test_packed_module_helpers(monkeypatch):
    """cycle.packed's JAX-named helpers: the rule, the exact roundtrip and
    the residual norm of packed state (exact: it unpacks first)."""
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    assert packed_cycle.supported(Spec(size=256, scheme="fast"), "cpu")
    assert not packed_cycle.supported(Spec(size=256, scheme="tuned"), "cpu")
    u, f, _ = (torch.tensor(a) for a in _data(256, seed=4))
    up, fp = packed_cycle.pack(u), packed_cycle.pack(f)
    assert torch.equal(packed_cycle.unpack(up), u)
    assert torch.equal(packed_cycle.residual_norm_packed(up, fp, 1 / 256),
                       ops.residual_norm(u, f, 1 / 256))


def test_use_packed_on_the_card_by_default(monkeypatch):
    """Without the flag the packed level engages for CUDA tensors only;
    on the CPU the solver keeps the unpacked plain ops."""
    monkeypatch.delenv("MGPOISSON_PACKED", raising=False)
    spec = spec_from_jax(dict(size=256, scheme="fast"))
    assert use_packed(spec, "cuda") and not use_packed(spec, "cpu")
    assert not MultigridPoisson(spec, device="cpu")._packed


def test_wrappers_on_cpu_run_the_plain_packed_ops():
    u, f, V = (torch.tensor(a) for a in _data(64, seed=3))
    up, fp = ops.pack_grid(u), ops.pack_grid(f)
    h = 1 / 64
    cuda.reset_launches()
    for got, want in zip(cuda.packed_smooth_residual_restrict(up, fp, h, 2),
                         ops.packed_smooth_residual_restrict(up, fp, h, 2)):
        assert torch.equal(got, want)
    assert torch.equal(cuda.packed_prolong_correct_smooth(up, fp, V, h, 1, "bilinear"),
                       ops.packed_prolong_correct_smooth(up, fp, V, h, 1, "bilinear"))
    for got, want in zip(cuda.packed_prolong_correct_smooth_rnorm(up, fp, V, h, 3),
                         ops.packed_prolong_correct_smooth_rnorm(up, fp, V, h, 3)):
        assert torch.equal(got, want)
    assert cuda.pack_grid is ops.pack_grid and cuda.unpack_grid is ops.unpack_grid
    assert all(v == 0 for v in cuda.launches.values()), cuda.launches


def test_packed_supports():
    assert cuda.packed_supports(4096, torch.float32, 1)
    assert cuda.packed_supports(16, torch.float32, 3)
    assert not cuda.packed_supports(4096, torch.float32, 4)
    assert not cuda.packed_supports(4096, torch.float32, 0)
    assert not cuda.packed_supports(4096, torch.float64, 1)
    assert not cuda.packed_supports(15, torch.float32, 1)


def test_state_from_numpy_defaults_to_the_card():
    assert inspect.signature(state_from_numpy).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            state_from_numpy(np.zeros((4, 4)), np.zeros((4, 4)))
