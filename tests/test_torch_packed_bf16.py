"""The bf16 packed fine level of the port's fast scheme against the JAX
package, on the CPU.

The plain packed ops in bf16 (what the bf16 forms of K7/K8 are held to on
the card, and what their wrappers run on the CPU) against the Pallas packed
kernels in bf16, run in interpret mode as tests/test_packed_persistent.py
runs them: both round every op to bf16 in the same order and blend the
bilinear P(V) in f32, rounding it once, so the outputs are bit-equal (the
JAX package's 5e-2 bar is kept beside for sum(r^2), summed in another
order), also off the default spacing (h = 0.3), both rounding the level
constants to bf16 (ops._level).  Also:
the repair of the plain packed up-leg's blend (it blended in
bf16), the packed bf16 cycle and solve against the JAX package's, which bf16
solves pack (the rule of ``mgpoisson.cycle.packed.supported``), and the JAX
package's packed bf16 state carried across bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mgpoisson
import mgpoisson.kernels.pallas as P
from mgpoisson.cycle import packed as PK
from mgpoisson_torch import MultigridPoisson
from mgpoisson_torch.convert import spec_from_jax, state_from_numpy
from mgpoisson_torch.cycle import packed as packed_cycle
from mgpoisson_torch.kernels import cuda, ops, use_packed

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

N = 256
TOL = 5e-2       # the JAX package's bf16 bar (tests/test_pallas_bf16.py)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MGPOISSON_PALLAS_INTERPRET", "1")


def _arrays(n, seed):
    """u, f (n, n) and V (n/2, n/2) as JAX bf16 arrays and as the same
    values in torch bf16."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal((s, s)), jnp.bfloat16) for s in (n, n, n // 2)]
    return js, [_torch(j) for j in js]


def _torch(a):
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _nmax(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


# ----------------------------------------------- the repaired up-leg blend

@pytest.mark.parametrize("kind", ["inject", "bilinear"])
def test_packed_bf16_up_leg_blends_in_f32_and_rounds_once(kind):
    """The packed bf16 up-leg adds P(V) blended in f32 and rounded to bf16
    once, as the Pallas packed up-leg does (pallas.py
    _packed_prolong_stripe), not P(V) blended in bf16."""
    _, (u, _, V) = _arrays(N, seed=0)
    up = ops.pack_grid(u)
    pr, pb = ops._packed_prolong(V.float(), kind)      # the f32 blend, rounded once below
    want = torch.cat([up[:, :N // 2] + pr.to(torch.bfloat16),
                      up[:, N // 2:] + pb.to(torch.bfloat16)], dim=1)
    got = ops.packed_prolong_correct_smooth(up, up, V, 1.0 / N, 0, kind)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["inject", "bilinear"])
def test_packed_up_leg_blends_in_its_own_dtype_from_f32_up(dtype, kind):
    """In f32 and f64 the packed up-leg adds P(V) blended in the dtype, as
    before the bf16 repair."""
    g = torch.Generator().manual_seed(1)
    u, V = (torch.randn((s, s), generator=g, dtype=dtype) for s in (64, 32))
    up = ops.pack_grid(u)
    pr, pb = ops._packed_prolong(V, kind)
    want = torch.cat([up[:, :32] + pr, up[:, 32:] + pb], dim=1)
    assert torch.equal(ops.packed_prolong_correct_smooth(up, up, V, 1 / 64, 0, kind), want)


def test_a_bf16_blend_of_the_packed_correction_rounds_otherwise():
    """The size of the repaired fault (ROADMAP Queue 3 F2): at 256^2, seed
    0, the packed correction blended in bf16 (what the packed up-leg added
    before the repair) differs from the f32 blend rounded once in 15907 and
    16046 of the 32768 cells of the red and black planes, by up to 0.83 %
    and 0.54 % of the largest magnitude."""
    V = torch.randn((N // 2, N // 2), generator=torch.Generator().manual_seed(0))
    V = V.to(torch.bfloat16)
    pairs = list(zip(ops._packed_prolong(V, "bilinear"), ops._packed_correction(V, "bilinear")))
    assert [int((a != b).sum()) for a, b in pairs] == [15907, 16046]
    assert [round(_nmax(a, b), 4) for a, b in pairs] == [0.0083, 0.0054]


def test_packed_correction_equals_the_pallas_stripe():
    """The packed bf16 correction planes are the Pallas stripe's on the whole
    grid (one stripe, no coarse halo), bit for bit."""
    (_, _, Vj), (_, _, V) = _arrays(N, seed=2)
    want = P._packed_prolong_stripe(Vj, "bilinear", True, True, 0, N)
    for got, w in zip(ops._packed_correction(V, "bilinear"), want):
        assert torch.equal(got, _torch(w))


# ------------------------------------------- the plain legs against Pallas

# six interpret-mode Pallas calls: each leg at nu = 1 and 3, the two
# prolongation kinds split between them
@pytest.mark.parametrize("op,nu,kind", [
    ("rr", 1, None), ("rr", 3, None),
    ("pc", 1, "inject"), ("pc", 3, "bilinear"),
    ("rnorm", 1, "bilinear"), ("rnorm", 3, "inject")])
def test_plain_packed_bf16_legs_equal_pallas(op, nu, kind):
    (u, f, V), (ut, ft, Vt) = _arrays(N, seed=10 + nu)
    uj, fj = P.pack_grid(u), P.pack_grid(f)
    up, fp = ops.pack_grid(ut), ops.pack_grid(ft)
    assert torch.equal(up, _torch(uj)) and torch.equal(fp, _torch(fj))
    h = 1.0 / N
    if op == "rr":
        got = cuda.packed_smooth_residual_restrict(up, fp, h, nu)    # CPU: the plain op
        want = P.packed_smooth_residual_restrict(uj, fj, h, nu)
    elif op == "pc":
        got = (cuda.packed_prolong_correct_smooth(up, fp, Vt, h, nu, kind),)
        want = (P.packed_prolong_correct_smooth(uj, fj, V, h, nu, kind=kind),)
    else:
        gu, g2 = cuda.packed_prolong_correct_smooth_rnorm(up, fp, Vt, h, nu, kind)
        wu, w2 = P.packed_prolong_correct_smooth_rnorm(uj, fj, V, h, nu, kind=kind)
        assert g2.dtype == torch.float32
        assert abs(float(g2) / float(w2) - 1.0) <= 1e-5
        got, want = (gu,), (wu,)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert _nmax(g, _torch(w)) <= TOL
        assert torch.equal(g, _torch(w))


def test_plain_packed_bf16_legs_off_the_default_spacing():
    """At h = 0.3, where -h^2/4 and 1/h^2 rounded to f32 are no bf16
    values: the plain packed bf16 legs (the down-leg, the up-leg with
    rnorm) against the Pallas ones (interpret).  The reference rounds both
    constants to bf16 before its products (pallas.py
    ``jnp.asarray(-hsq * 0.25, dtype)`` and _packed_residual's
    ``jnp.asarray(inv_hsq, dtype)``), and so do the plain ops
    (ops._level): the outputs are bit-equal, sum(r^2) within 1e-5."""
    h, nu, kind = 0.3, 1, "bilinear"
    (u, f, V), (ut, ft, Vt) = _arrays(N, seed=31)
    uj, fj = P.pack_grid(u), P.pack_grid(f)
    up, fp = ops.pack_grid(ut), ops.pack_grid(ft)
    got = cuda.packed_smooth_residual_restrict(up, fp, h, nu)    # the plain op
    want = P.packed_smooth_residual_restrict(uj, fj, h, nu)
    assert all(torch.equal(g, _torch(w)) for g, w in zip(got, want))
    gu, g2 = cuda.packed_prolong_correct_smooth_rnorm(up, fp, Vt, h, nu, kind)
    wu, w2 = P.packed_prolong_correct_smooth_rnorm(uj, fj, V, h, nu, kind=kind)
    assert torch.equal(gu, _torch(wu))
    assert abs(float(g2) / float(w2) - 1.0) <= 1e-5


# ------------------------------------------------ the cycle and the solve

def test_packed_bf16_cycle_matches_jax(monkeypatch):
    """One packed bf16 V-cycle with Sigma r^2 against the JAX package's
    (its fine level the Pallas packed kernels in interpret mode, its coarse
    levels xla): the fine legs agree bit for bit, the coarse levels differ
    in the restriction's and the blend's rounding (tests/test_torch_bf16.py),
    so the bar is the bf16 one."""
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    spec = mgpoisson.Spec(size=N, scheme="fast", backend="xla", dtype="bfloat16")
    (u, f, _), (ut, ft, _) = _arrays(N, seed=5)
    h = spec.fine_h
    wu, w2 = PK.make_packed_cycle(spec, rnorm=True)(PK.pack(u), PK.pack(f), h)
    spec_t = spec_from_jax(dataclasses.asdict(spec))
    gu, g2 = packed_cycle.make_packed_cycle(spec_t, rnorm=True)(
        ops.pack_grid(ut), ops.pack_grid(ft), h)
    assert gu.dtype == torch.bfloat16
    assert _nmax(ops.unpack_grid(gu), _torch(PK.unpack(wu))) <= TOL
    assert abs(float(g2) / float(w2) - 1.0) <= TOL


def test_packed_bf16_solve_matches_jax(monkeypatch):
    """The port's packed bf16 solve against the JAX package's packed bf16
    solve, with tests/test_packed_persistent.py's spec and bars
    (test_packed_bf16_solve_engages_and_matches): the counts within one,
    psi within 5e-2 of the largest magnitude.  The port's backend is 'auto'
    (the JAX 'pallas' maps to 'cuda', which needs the card): on the CPU
    with MGPOISSON_PACKED=1 its fine level runs the plain packed ops."""
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    spec = mgpoisson.Spec(size=N, scheme="fast", backend="pallas", dtype="bfloat16",
                          stop="residual", tol=1e-2, maxiter=8)
    mj = mgpoisson.MultigridPoisson(spec)
    mt = MultigridPoisson(spec_from_jax(dataclasses.asdict(spec)).with_(backend="auto"),
                          device="cpu")
    assert mj._packed and mt._packed
    rj, rt = mj.solve(), mt.solve()
    assert rt.psi.dtype == torch.bfloat16 and rt.errs.dtype == torch.float32
    assert abs(rt.iterations - rj.iterations) <= 1
    assert _nmax(rt.psi, _torch(rj.psi)) <= TOL


# ------------------------------------------------------- which solves pack

SIDES = [128, 256, 512, 1024, 2048, 4096]
SWEEPS = [(nu, nu) for nu in range(5)] + [(1, 4), (3, 1)]
BACKENDS = ["auto", "xla", "pallas"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cycle", ["v", "w"])
@pytest.mark.parametrize("flag", ["0", "1", "auto"])
def test_use_packed_takes_what_jax_takes(monkeypatch, dtype, cycle, flag):
    """kernels.use_packed against mgpoisson.cycle.packed.supported for every
    side, sweep count and backend of the fast scheme: on the card it packs
    exactly what the JAX package packs on its accelerator (where the flag
    'auto' means on: the JAX rule's 'auto' asks for a TPU); on the CPU only
    under MGPOISSON_PACKED=1, as the JAX rule without one."""
    for n in SIDES:
        for (pre, post) in SWEEPS:
            for backend in BACKENDS:
                kw = dict(size=n, scheme="fast", dtype=dtype, cycle=cycle, pre_smooth=pre,
                          post_smooth=post, backend=backend)
                spec = mgpoisson.Spec(**kw)
                monkeypatch.setenv("MGPOISSON_PACKED", "1" if flag == "auto" else flag)
                want = PK.supported(spec)
                monkeypatch.setenv("MGPOISSON_PACKED", flag)
                spec_t = spec_from_jax(dataclasses.asdict(spec))
                assert use_packed(spec_t, "cuda") is want, kw
                assert use_packed(spec_t, "cpu") is (want and flag == "1"), kw


def test_a_mixed_solve_stays_unpacked():
    """sweep_dtype other than dtype: the refinement's bf16 cycle is never
    packed (the JAX solver's refinement branch comes first);
    sweep_dtype == dtype is the plain bf16 solve, packed."""
    spec = spec_from_jax(dict(size=N, scheme="fast", sweep_dtype="bfloat16"))
    assert not use_packed(spec, "cuda")
    assert not MultigridPoisson(spec, device="cpu")._packed
    same = spec_from_jax(dict(size=N, scheme="fast", dtype="bfloat16", sweep_dtype="bfloat16"))
    assert use_packed(same, "cuda")


# -------------------------------------------------------------- the state

def test_state_from_numpy_carries_jax_packed_bf16_bit_for_bit():
    (u, f, _), (ut, ft, _) = _arrays(N, seed=7)
    uj, fj = np.asarray(P.pack_grid(u)), np.asarray(P.pack_grid(f))
    assert uj.dtype.name == "bfloat16"
    psi, rhs = state_from_numpy(uj, fj, "cpu", torch.bfloat16)
    for t, a in ((psi, uj), (rhs, fj)):
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
        assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    assert torch.equal(psi, ops.pack_grid(ut)) and torch.equal(rhs, ops.pack_grid(ft))
    assert torch.equal(ops.unpack_grid(psi), ut)
