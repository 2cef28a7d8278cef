"""The bf16 forms of the port's 3D legs against the JAX package, on the CPU.

The same inputs, drawn in float64 from a seeded numpy generator and rounded
to bf16, go through mgpoisson.kernels.xla in bf16 and the port's plain ops
(the CPU side of the bf16 forms of K4-K6) in bf16.  The 3D sweeps and the
residual agree bit for bit (each op rounded to bf16; the damped-Jacobi
weight 6/7 rounded to bf16 on both sides); the legs agree within the JAX
package's bf16 bar, 5e-2 of the reference's largest magnitude
(tests/test_pallas_bf16.py): XLA on the CPU sums the restriction's eight
values in bf16 and blends P(V) in bf16, where torch sums in f32 and the
port's up-leg blends in f32 and rounds once, as the Pallas kernel does.

Also: the Pallas 3D down- and up-leg in interpret mode against the port's
bf16 legs, the header's bf16 weight, which bf16 cubes the kernels take,
the mixed-precision and the pure bf16 3D solves against MultigridPoisson
at 16^3, and the JAX package's bf16 3D state carried across bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mgpoisson
import mgpoisson_torch
from mgpoisson.kernels import pallas as pk, xla
from mgpoisson_torch.convert import state_from_numpy
from mgpoisson_torch.kernels import cuda, ops

N = 16
BCS = ["ghost0", "face"]
SMOOTHERS = ["jacobi", "wjacobi", "rbgs"]
# the tuned scheme's wjacobi 3 and the fast scheme's rbgs 1
SETTINGS = [("wjacobi", 3), ("rbgs", 1)]
LEGS = ["rr", "rr_zero", "pc_inject", "pc_bilinear", "pc_rnorm_bilinear"]
TOL = 5e-2
HEADER = Path(__file__).resolve().parents[1] / "mgpoisson_torch" / "csrc" / "stencil3d.cuh"


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s) for s in (shape, shape, tuple(d // 2 for d in shape))]


def _both(arrays):
    """(jax bf16 arrays, torch bf16 tensors) of the same values."""
    js = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    return js, [torch.tensor(np.asarray(j, np.float32)).to(torch.bfloat16) for j in js]


def _bits(t):
    return t.view(torch.int16).numpy()


def _jbits(a):
    return np.asarray(a).view(np.int16)


def _close(got, want, tol=TOL):
    """Normalized max |diff| within tol; the port's output is bf16."""
    assert got.dtype == torch.bfloat16
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    scale = max(float(np.max(np.abs(w))), 1e-30)
    assert float(np.max(np.abs(g - w))) / scale <= tol


def _leg(mod, leg, u, f, V, h, nu, smoother, bc):
    if leg == "rr":
        return mod.smooth_residual_restrict(u, f, h, nu, smoother, bc)
    if leg == "rr_zero":
        return mod.smooth_residual_restrict_zero(f, h, nu, smoother, bc)
    kind = leg.rsplit("_", 1)[1]
    if leg.startswith("pc_rnorm"):
        return mod.prolong_correct_smooth_rnorm(u, f, V, h, nu, smoother, bc, kind)
    return (mod.prolong_correct_smooth(u, f, V, h, nu, smoother, bc, kind),)


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_plain_bf16_3d_sweeps_and_residual_equal_xla(smoother, bc):
    """nu = 2 sweeps and the residual of the result, bit for bit."""
    (u, f, _), (ut, ft, _) = _both(_arrays((N,) * 3, seed=N))
    h = 1.0 / N
    got, want = ops.smooth(ut, ft, h, 2, smoother, bc), xla.smooth(u, f, h, 2, smoother, bc)
    assert got.dtype == torch.bfloat16 and np.array_equal(_bits(got), _jbits(want))
    gr, wr = ops.residual(got, ft, h, bc), xla.residual(want, f, h, bc)
    assert np.array_equal(_bits(gr), _jbits(wr))


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("smoother,nu", SETTINGS)
@pytest.mark.parametrize("leg", LEGS)
def test_plain_bf16_3d_leg_matches_xla_bf16(leg, smoother, nu, bc):
    (u, f, V), (ut, ft, Vt) = _both(_arrays((N,) * 3, seed=N + nu))
    h = 1.0 / N
    got = _leg(cuda, leg, ut, ft, Vt, h, nu, smoother, bc)   # CPU: the plain ops
    want = _leg(xla, leg, u, f, V, h, nu, smoother, bc)
    if leg.startswith("pc_rnorm"):
        (gu, g2), (wu, w2) = got, want
        _close(gu, wu)
        assert g2.dtype == torch.float32                      # accumulated in f32
        assert abs(float(g2) / float(w2) - 1.0) <= TOL
        return
    for g, w in zip(got, want):
        _close(g, w)


# The Pallas 3D kernels in interpret mode, on the shape and blocks of
# tests/test_pallas3d.py, at the tuned scheme's wjacobi nu = 3
SHAPE_3D, H_3D, NU_3D = (32, 64, 128), 1.0 / 64, 3


def test_down_leg_matches_the_pallas_kernel():
    (u, f, _), (ut, ft, _) = _both(_arrays(SHAPE_3D, seed=4))
    wu, wR = pk._rr_fused_3d(u, f, h=H_3D, nu=NU_3D, smoother="wjacobi", bc="face",
                             interpret=True, hz=NU_3D + 1, bz=8, by=32)
    assert wu.dtype == jnp.bfloat16
    gu, gR = ops.smooth_residual_restrict(ut, ft, H_3D, NU_3D, "wjacobi", "face")
    _close(gu, wu)
    _close(gR, wR)


def test_up_leg_with_rnorm_matches_the_pallas_kernel():
    """Both blend P(V) in f32 and round it once; both sum r^2 in f32."""
    (u, f, V), (ut, ft, Vt) = _both(_arrays(SHAPE_3D, seed=5))
    wu, slab = pk._pc_fused_3d(u, f, V, h=H_3D, nu=NU_3D, smoother="wjacobi", bc="ghost0",
                               kind="bilinear", interpret=True, hz=NU_3D + 1, bz=8, by=32,
                               rnorm=True)
    gu, g2 = ops.prolong_correct_smooth_rnorm(ut, ft, Vt, H_3D, NU_3D, "wjacobi", "ghost0",
                                              "bilinear")
    _close(gu, wu)
    assert slab.dtype == jnp.float32
    assert abs(float(g2) / float(jnp.sum(slab)) - 1.0) <= TOL


def test_up_leg_3d_blends_in_f32_and_rounds_once():
    """In bf16 the fused 3D up-leg adds P(V) blended in f32 and rounded to
    bf16 once; the transfer op ops.prolong blends in bf16, as xla.prolong."""
    g = torch.Generator().manual_seed(3)
    u, V = (torch.randn((s,) * 3, generator=g).to(torch.bfloat16) for s in (8, 4))
    want = u + ops.prolong(V.float(), "bilinear").to(torch.bfloat16)
    got = ops.prolong_correct_smooth(u, u, V, 1 / 8, 0, "wjacobi", "face", "bilinear")
    assert torch.equal(got, want)
    assert not torch.equal(got, u + ops.prolong(V, "bilinear"))   # the bf16 blend differs
    assert ops.prolong(V, "bilinear").dtype == torch.bfloat16


def test_omega_3d_bf16_mirrors_the_header():
    """6/7 rounded to bf16, as the JAX package's weak-typed scalar is
    (a bf16 wjacobi sweep equals XLA's, above), and the bf16 forms of K4-K6
    take that value from csrc/stencil3d.cuh."""
    assert ops._omega(3, torch.bfloat16) == 0.85546875
    assert float(jnp.asarray(6.0 / 7.0, jnp.bfloat16)) == 0.85546875
    src = HEADER.read_text()
    m = re.search(r"struct Mg3Elem<__nv_bfloat16>[^{]*\{[^}]*omega = ([0-9.]+)f;", src)
    assert m and float(m.group(1)) == ops._omega(3, torch.bfloat16)
    m = re.search(r"struct Mg3Elem<float>[^{]*\{[^}]*omega = (\w+);", src)
    assert m and m.group(1) == "MG3_OMEGA"
    assert ops._omega(3, torch.float32) == float(np.float32(6.0 / 7.0))


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_supports_admits_bf16_cubes_at_the_f32_halos(smoother):
    for n in (1, 2, 16, 256, 512):
        for nu in range(0, 10):
            for residual in (False, True):
                want = cuda.supports(n, torch.float32, nu, smoother, 3, residual)
                assert cuda.supports(n, torch.bfloat16, nu, smoother, 3, residual) is want
                assert cuda.supports(n, torch.float16, nu, smoother, 3, residual) is False
    u = torch.zeros((4,) * 3, dtype=torch.bfloat16)
    assert cuda._name("mg_prolong_correct_smooth", u) == "mg_prolong_correct_smooth3d_bf16"
    assert cuda._name("mg_smooth", u.float()) == "mg_smooth3d"


# ------------------------------------------------------------ the solves

def _solves(**kw):
    kw = dict(size=N, ndim=3, scheme="tuned", stop="residual", **kw)
    want = mgpoisson.MultigridPoisson(mgpoisson.Spec(backend="xla", **kw)).solve()
    got = mgpoisson_torch.MultigridPoisson(mgpoisson_torch.Spec(**kw), device="cpu").solve()
    return got, want


def test_mixed_3d_solve_matches_multigrid_poisson():
    """f32 with bf16 sweeps: the refinement steps within one of the JAX
    package's, each step's relres within 50 % (the bf16 V-cycles round the
    restriction and the blend differently), the first one the incoming
    iterate's (1.0)."""
    got, want = _solves(sweep_dtype="bfloat16", tol=1e-8)
    assert got.converged and want.converged
    assert abs(got.iterations - want.iterations) <= 1
    g, w = got.errs.tolist(), np.asarray(want.errs).tolist()
    assert g[0] == 1.0 and got.psi.dtype == torch.float32
    for a, b in zip(g, w):
        assert abs(a - b) <= 0.5 * b


def test_pure_bf16_3d_first_cycle_matches_multigrid_poisson():
    got, want = _solves(dtype="bfloat16", tol=1e-30, maxiter=2)
    assert got.psi.dtype == torch.bfloat16 and got.errs.dtype == torch.float32
    assert got.iterations == want.iterations == 2
    e, ej = float(got.errs[0]), float(np.asarray(want.errs)[0])
    assert abs(e - ej) <= TOL * ej


def test_state_from_numpy_carries_jax_bf16_3d_bit_for_bit():
    rng = np.random.default_rng(8)
    a = np.asarray(jnp.asarray(rng.normal(size=(8, 8, 8)), jnp.bfloat16))
    b = np.asarray(jnp.asarray(rng.normal(size=(8, 8, 8)), jnp.bfloat16)).transpose(2, 0, 1)
    psi, f = state_from_numpy(a, b, "cpu", torch.bfloat16)
    for t, v in ((psi, a), (f, b)):
        assert t.dtype == torch.bfloat16 and t.shape == (8, 8, 8) and t.is_contiguous()
        assert np.array_equal(_bits(t), np.ascontiguousarray(v).view(np.int16))
