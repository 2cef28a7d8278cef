"""The bf16 forms of the port's 2D legs against the JAX package, on the CPU.

The same inputs, drawn in float64 from a seeded numpy generator and rounded
to bf16, go through mgpoisson.kernels.xla in bf16 and the port's plain ops
(the CPU side of the bf16 forms of K1-K3) in bf16.  The sweeps and the
residual agree bit for bit (each op rounded to bf16; the damped-Jacobi
weight rounded to bf16 on both sides), the legs do not: XLA on the CPU
sums the restriction's four values in bf16, rounding after each add,
where torch sums them in f32 and rounds once, and xla.prolong blends P(V)
in bf16, where the port's up-leg blends in f32 and rounds once, as the
Pallas kernel does (the forms on the card follow the plain torch ops bit
for bit).  So the bar is the JAX package's own bf16 bar, 5e-2 of the
reference's largest magnitude (tests/test_pallas_bf16.py).

Also: the up-leg against the Pallas kernel in interpret mode (both blend
P(V) in f32 and round once), the Spec's admit/raise table for bf16, which
bf16 levels the kernels take, and the bf16 state of the JAX package carried
across bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mgpoisson
import mgpoisson_torch
from mgpoisson.kernels import pallas as pk, xla
from mgpoisson_torch.convert import spec_from_jax, state_from_numpy
from mgpoisson_torch.kernels import cuda, ops
from mgpoisson_torch.kernels.build import SIGNATURES

SIDES = [64, 128]
BCS = ["ghost0", "face"]
# every smoother at the sweep count of a scheme that runs it (tuned: wjacobi
# 3; reference: jacobi, here 2; fast: rbgs 1) and one more
SETTINGS = [("jacobi", 2), ("wjacobi", 3), ("rbgs", 1), ("rbgs", 2)]
LEGS = ["smooth", "rr", "rr_zero", "pc_inject", "pc_bilinear", "pc_rnorm_inject",
        "pc_rnorm_bilinear"]
TOL = 5e-2


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(s, s)) for s in (n, n, n // 2)]


def _both(arrays):
    """(jax bf16 arrays, torch bf16 tensors) of the same values."""
    js = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    return js, [torch.tensor(np.asarray(j, np.float32)).to(torch.bfloat16) for j in js]


def _close(got, want, tol=TOL):
    """Normalized max |diff| within tol; the port's output is bf16."""
    assert got.dtype == torch.bfloat16
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    scale = max(float(np.max(np.abs(w))), 1e-30)
    assert float(np.max(np.abs(g - w))) / scale <= tol


def _leg(mod, leg, u, f, V, h, nu, smoother, bc):
    if leg == "smooth":
        return (mod.smooth(u, f, h, nu, smoother, bc),)
    if leg == "rr":
        return mod.smooth_residual_restrict(u, f, h, nu, smoother, bc)
    if leg == "rr_zero":
        return mod.smooth_residual_restrict_zero(f, h, nu, smoother, bc)
    kind = leg.rsplit("_", 1)[1]
    if leg.startswith("pc_rnorm"):
        return mod.prolong_correct_smooth_rnorm(u, f, V, h, nu, smoother, bc, kind)
    return (mod.prolong_correct_smooth(u, f, V, h, nu, smoother, bc, kind),)


@pytest.mark.parametrize("n", SIDES)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("smoother,nu", SETTINGS)
@pytest.mark.parametrize("leg", LEGS)
def test_plain_bf16_leg_matches_xla_bf16(n, bc, smoother, nu, leg):
    (u, f, V), (ut, ft, Vt) = _both(_arrays(n, seed=n + nu))
    h = 1.0 / n
    got = _leg(cuda, leg, ut, ft, Vt, h, nu, smoother, bc)   # CPU: the plain ops
    want = _leg(xla, leg, u, f, V, h, nu, smoother, bc)
    if leg.startswith("pc_rnorm"):
        (gu, g2), (wu, w2) = got, want
        _close(gu, wu)
        assert g2.dtype == torch.float32            # accumulated in f32
        assert abs(float(g2) / float(w2) - 1.0) <= TOL
        return
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("bc,kind,rnorm", [("face", "bilinear", False),
                                           ("ghost0", "bilinear", True),
                                           ("face", "inject", False)])
def test_up_leg_matches_the_pallas_kernel(bc, kind, rnorm, monkeypatch):
    """The bf16 up-leg against the Pallas kernel in interpret mode at its
    smallest side: both blend P(V) in f32 and round it once."""
    monkeypatch.setenv("MGPOISSON_PALLAS_INTERPRET", "1")
    n, nu = pk.MIN_SIZE, 3
    (u, f, V), (ut, ft, Vt) = _both(_arrays(n, seed=7))
    a = (1.0 / n, nu, "wjacobi", bc, kind)
    if rnorm:
        (gu, g2), (wu, w2) = (ops.prolong_correct_smooth_rnorm(ut, ft, Vt, *a),
                              pk.prolong_correct_smooth_rnorm(u, f, V, *a))
        assert abs(float(g2) / float(w2) - 1.0) <= TOL
    else:
        gu, wu = (ops.prolong_correct_smooth(ut, ft, Vt, *a),
                  pk.prolong_correct_smooth(u, f, V, *a))
    assert wu.dtype == jnp.bfloat16
    _close(gu, wu)


def test_up_leg_blends_in_f32_and_rounds_once():
    """In bf16 the fused up-leg adds P(V) blended in f32 and rounded to bf16
    once; the transfer op ops.prolong blends in bf16, as xla.prolong."""
    g = torch.Generator().manual_seed(3)
    u, V = (torch.randn((s, s), generator=g).to(torch.bfloat16) for s in (16, 8))
    want = u + ops.prolong(V.float(), "bilinear").to(torch.bfloat16)
    got = ops.prolong_correct_smooth(u, u, V, 1 / 16, 0, "wjacobi", "face", "bilinear")
    assert torch.equal(got, want)
    assert ops.prolong(V, "bilinear").dtype == torch.bfloat16
    u32, V32 = torch.randn((16, 16), generator=g), torch.randn((8, 8), generator=g)
    assert torch.equal(ops.prolong_correct_smooth(u32, u32, V32, 1 / 16, 0, kind="bilinear"),
                       ops.prolong_correct(u32, V32, "bilinear"))


# ------------------------------------------------------------------ the Spec

ADMITTED = [dict(sweep_dtype="bfloat16"), dict(dtype="bfloat16"),
            dict(dtype="float64", sweep_dtype="bfloat16"),
            dict(dtype="bfloat16", sweep_dtype="bfloat16"),
            dict(sweep_dtype="bfloat16", scheme="fast", size=256),
            dict(dtype="bfloat16", scheme="fast"),                   # below the packed plan
            dict(dtype="bfloat16", scheme="fast", size=256, backend="xla"),
            dict(dtype="bfloat16", scheme="fast", size=512, post_smooth=4),
            dict(dtype="bfloat16", ndim=3),            # the bf16 forms of K4-K6
            dict(sweep_dtype="bfloat16", ndim=3)]
NOT_PORTED = [(dict(dtype="bfloat16", mesh_shape=(2, 2)), "A4"),
              (dict(sweep_dtype="bfloat16", mesh_shape=(2, 2)), "step_mixed_local"),
              (dict(sweep_dtype="float32", dtype="float64", mesh_shape=(4, 1)),
               "step_mixed_local"),
              (dict(dtype="bfloat16", scheme="fast", size=256), "A3"),
              (dict(dtype="bfloat16", smoother="rbgs", cycle="w", size=1024), "A3")]


@pytest.mark.parametrize("kw", ADMITTED, ids=repr)
def test_spec_admits_bf16_on_one_2d_device(kw):
    kw = {"size": 64, **kw}
    jax_spec = mgpoisson.Spec(**kw)
    spec = spec_from_jax(dataclasses.asdict(jax_spec))
    assert (spec.dtype, spec.sweep_dtype) == (jax_spec.dtype, jax_spec.sweep_dtype)


@pytest.mark.parametrize("kw,item", NOT_PORTED, ids=repr)
def test_spec_names_the_roadmap_item_of_bf16_not_ported(kw, item):
    kw = {"size": 64, **kw}
    mgpoisson.Spec(**kw)                                 # valid in the JAX package
    with pytest.raises(NotImplementedError, match="ROADMAP slice") as err:
        spec_from_jax(kw)
    assert item in str(err.value)


def test_spec_rejects_adaptive_mixed_with_the_jax_message():
    kw = dict(size=64, sweep_dtype="bfloat16", stop="residual", stop_check="adaptive")
    with pytest.raises(ValueError) as jax_err:
        mgpoisson.MultigridPoisson(mgpoisson.Spec(backend="xla", **kw))
    with pytest.raises(ValueError) as port_err:
        spec_from_jax(kw)
    assert str(port_err.value) == str(jax_err.value)


def test_solver_refuses_a_packed_bf16_solve_spelled_with_sweep_dtype():
    """sweep_dtype == dtype is the plain solve: the JAX package would pack
    this one, so the solver refuses it as the Spec refuses it without a
    sweep_dtype."""
    spec = mgpoisson_torch.Spec(size=256, dtype="bfloat16", sweep_dtype="bfloat16",
                                scheme="fast")
    with pytest.raises(NotImplementedError, match="A3"):
        mgpoisson_torch.MultigridPoisson(spec, device="cpu")


# ----------------------------------------------------------- which kernels

@pytest.mark.parametrize("smoother", sorted(cuda.MAX_NU))
def test_supports_bf16_in_2d_only(smoother):
    """bf16 levels run the kernels' bf16 forms in 2D and, since the bf16
    forms of K4-K6, in 3D at the f32 halo cap; the packed kernels stay f32
    only."""
    for n in (1, 2, 64, 4096):
        for nu in range(0, 10):
            want = n >= 2 and nu <= cuda.MAX_NU[smoother]
            assert cuda.supports(n, torch.bfloat16, nu, smoother) is want
            assert (cuda.supports(n, torch.bfloat16, nu, smoother, ndim=3)
                    is cuda.supports(n, torch.float32, nu, smoother, ndim=3))
            assert cuda.supports(n, torch.float16, nu, smoother) is False
    assert not cuda.packed_supports(256, torch.bfloat16, 1)
    assert cuda.packed_supports(256, torch.float32, 1)


def test_bf16_names_of_the_2d_legs():
    u2, u3 = torch.zeros((4, 4), dtype=torch.bfloat16), torch.zeros((4, 4, 4))
    assert cuda._name("mg_smooth_rr", u2) == "mg_smooth_rr_bf16"
    assert cuda._name("mg_smooth_rr", u2.float()) == "mg_smooth_rr"
    assert cuda._name("mg_smooth_rr", u3) == "mg_smooth_rr3d"
    assert cuda._name("mg_smooth_rr", u3.bfloat16()) == "mg_smooth_rr3d_bf16"
    for name in ("mg_smooth", "mg_smooth_rr", "mg_prolong_correct_smooth", "mg_smooth3d",
                 "mg_smooth_rr3d", "mg_prolong_correct_smooth3d"):
        assert name + "_bf16" in cuda.launches
        assert SIGNATURES[name + "_bf16"] == SIGNATURES[name]


def test_kernel_dispatch_takes_bf16_levels_on_the_card_only():
    from mgpoisson_torch.kernels import use_kernels
    spec = mgpoisson_torch.Spec(size=512, dtype="bfloat16")
    assert use_kernels(spec, 512, "cpu") is False
    assert use_kernels(spec, 512, "cuda") is True
    assert use_kernels(spec, 128, "cuda") is False          # below kernel_min_size
    assert use_kernels(spec.with_(backend="torch"), 512, "cuda") is False


# --------------------------------------------------------------- the state

def test_state_from_numpy_carries_jax_bf16_bit_for_bit():
    rng = np.random.default_rng(5)
    a = np.asarray(jnp.asarray(rng.normal(size=(16, 24)), jnp.bfloat16))
    b = np.asarray(jnp.asarray(rng.normal(size=(24, 16)), jnp.bfloat16)).T  # Fortran order
    assert a.dtype.name == "bfloat16"
    with pytest.raises(TypeError):
        torch.tensor(a)            # what the conversion has to work around
    psi, f = state_from_numpy(a, b, "cpu", torch.bfloat16)
    for t, v in ((psi, a), (f, b)):
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
        assert np.array_equal(t.view(torch.int16).numpy(), np.ascontiguousarray(v).view(np.int16))
    psi32, _ = state_from_numpy(a, b, "cpu")               # the default f32: exact upcast
    assert np.array_equal(psi32.numpy(), a.astype(np.float32))
