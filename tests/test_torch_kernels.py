"""The kernel layer of the port, mgpoisson_torch.kernels.cuda.

On the CPU its wrappers run their plain versions; those are held here
against the Pallas kernels they replace, run as the JAX package's own
tests run them (interpreter mode), on the whole-array path and on the
striped path, in float32 at n = 256.  The sweep forms differ (Pallas
nbr*1/4 - f*h^2/4, the port (f - nbr/h^2)/adiag) and round differently,
so the bar is the f32 kernel bar of the ROADMAP: normalized max |diff|
<= 1e-5, and 1e-5 relative on sum(r^2), whose terms are added in
another order.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
compares each with its plain version there (chip_smoke.py makes the same
comparison at the main path's sizes)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mgpoisson.kernels import pallas as pk
from mgpoisson_torch import Spec
from mgpoisson_torch.kernels import cuda, get_ops, ops, use_kernels

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

N = 256


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MGPOISSON_PALLAS_INTERPRET", "1")


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, n)).astype(np.float32),
            rng.normal(size=(n, n)).astype(np.float32),
            rng.normal(size=(n // 2, n // 2)).astype(np.float32))


def _nmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _striped_geometry(nu, smoother, composite):
    """Halo and stripe height that make n = 256 run several stripes."""
    plan = pk._fused_plan if composite else pk._smooth_plan
    halo, _ = plan(N, nu, smoother, 4)
    return halo, 64


# (smoother, bc, nu): the tuned scheme's coarse levels, the fast
# scheme's smoother, and the reference scheme's 7 Jacobi sweeps
SMOOTH_CASES = [("wjacobi", "face", 3), ("rbgs", "ghost0", 2),
                ("jacobi", "ghost0", 7)]


@pytest.mark.parametrize("path", ["whole", "striped"])
@pytest.mark.parametrize("smoother,bc,nu", SMOOTH_CASES)
def test_smooth_vs_pallas(smoother, bc, nu, path):
    u, f, _ = _data(N, seed=1)
    h = 1.0 / N
    if path == "whole":
        want = pk.smooth(jnp.asarray(u), jnp.asarray(f), h, nu, smoother, bc)
    else:
        halo, bm = _striped_geometry(nu, smoother, composite=False)
        want = pk._smooth_fused(jnp.asarray(u), jnp.asarray(f), h=h, nu=nu,
                                smoother=smoother, bc=bc, interpret=True,
                                halo=halo, bm=bm)
    got = cuda.smooth(torch.tensor(u), torch.tensor(f), h, nu, smoother, bc)
    assert _nmax(got, want) <= 1e-5


@pytest.mark.parametrize("path", ["whole", "striped"])
@pytest.mark.parametrize("smoother,bc,nu,zero", [
    ("wjacobi", "face", 3, False), ("rbgs", "face", 1, False),
    ("wjacobi", "face", 3, True)])
def test_smooth_residual_restrict_vs_pallas(smoother, bc, nu, zero, path):
    u, f, _ = _data(N, seed=2)
    h = 1.0 / N
    uj = jnp.zeros_like(jnp.asarray(f)) if zero else jnp.asarray(u)
    if path == "whole":
        want = pk.smooth_residual_restrict(uj, jnp.asarray(f), h, nu,
                                           smoother, bc)
    else:
        halo, bm = _striped_geometry(nu, smoother, composite=True)
        kw = dict(h=h, nu=nu, smoother=smoother, bc=bc, interpret=True,
                  halo=halo, bm=bm)
        want = (pk._rr_fused_zero(jnp.asarray(f), **kw) if zero
                else pk._smooth_rr_fused(uj, jnp.asarray(f), **kw))
    if zero:
        got = cuda.smooth_residual_restrict_zero(torch.tensor(f), h, nu,
                                                 smoother, bc)
    else:
        got = cuda.smooth_residual_restrict(torch.tensor(u), torch.tensor(f),
                                            h, nu, smoother, bc)
    for g, w in zip(got, want):
        assert _nmax(g, w) <= 1e-5


@pytest.mark.parametrize("path", ["whole", "striped"])
@pytest.mark.parametrize("smoother,bc,nu,kind,rnorm", [
    ("wjacobi", "face", 3, "bilinear", False),
    ("rbgs", "ghost0", 1, "inject", False),
    ("wjacobi", "ghost0", 3, "bilinear", True)])
def test_prolong_correct_smooth_vs_pallas(smoother, bc, nu, kind, rnorm, path):
    u, f, V = _data(N, seed=3)
    h = 1.0 / N
    args = (jnp.asarray(u), jnp.asarray(f), jnp.asarray(V))
    if path == "whole":
        fn = (pk.prolong_correct_smooth_rnorm if rnorm
              else pk.prolong_correct_smooth)
        want = fn(*args, h, nu, smoother, bc, kind)
    else:
        halo, bm = _striped_geometry(nu, smoother, composite=True)
        want = pk._pc_smooth_fused(*args, h=h, nu=nu, smoother=smoother,
                                   bc=bc, kind=kind, interpret=True,
                                   halo=halo, bm=bm, rnorm=rnorm)
        if rnorm:
            want = (want[0], jnp.sum(want[1]))
    targs = (torch.tensor(u), torch.tensor(f), torch.tensor(V), h, nu,
             smoother, bc, kind)
    if rnorm:
        got_u, got_r2 = cuda.prolong_correct_smooth_rnorm(*targs)
        assert _nmax(got_u, want[0]) <= 1e-5
        assert abs(float(got_r2) / float(want[1]) - 1.0) <= 1e-5
    else:
        assert _nmax(cuda.prolong_correct_smooth(*targs), want) <= 1e-5


def test_tile_matches_cuda_source():
    """The wrapper sizes the rnorm partials by the tile table of
    kernels.cuda.tile2d, whose constants must be the kernels' own."""
    src = (Path(cuda.__file__).parents[1] / "csrc" / "stencil.cuh").read_text()
    for name, value in (("MG2_COLS", cuda.TILE_COLS), ("MG2_WARPS", cuda.TILE_WARPS),
                        ("MG2_ROWS_SMALL", cuda.TILE_ROWS[0]),
                        ("MG2_ROWS_SHALLOW", cuda.TILE_ROWS[1]),
                        ("MG2_ROWS_DEEP", cuda.TILE_ROWS[2]),
                        ("MG2_SHALLOW_HALO", cuda.TILE_SHALLOW_HALO),
                        ("MG2_FILL_WARPS", cuda.TILE_FILL_WARPS)):
        assert f"#define {name} {value} " in src


@pytest.mark.parametrize("spec_kw,n,device,want", [
    (dict(), 4096, "cuda", True),
    (dict(), 256, "cuda", True),
    (dict(), 128, "cuda", False),                  # below kernel_min_size
    (dict(kernel_min_size=64), 128, "cuda", True),
    (dict(dtype="float64"), 4096, "cuda", False),  # kernels are f32
    (dict(pre_smooth=9), 4096, "cuda", False),     # nu cap 8
    (dict(scheme="fast", pre_smooth=4), 4096, "cuda", True),
    (dict(scheme="fast", pre_smooth=5), 4096, "cuda", False),  # rbgs cap 4
    (dict(backend="torch"), 4096, "cuda", False),
    (dict(), 4096, "cpu", False),
    (dict(backend="cuda"), 4096, "cuda", True),
    (dict(ndim=3, backend="torch"), 256, "cuda", False),
    # 3D: the same rule; 256^3 f32 is the JAX package's 32 MiB byte gate
    (dict(ndim=3), 256, "cuda", True),
    (dict(ndim=3), 128, "cuda", False),
    (dict(ndim=3, kernel_min_size=64), 128, "cuda", True),
    (dict(ndim=3, scheme="fast", pre_smooth=3), 256, "cuda", True),
    (dict(ndim=3, scheme="fast", pre_smooth=4), 256, "cuda", False),  # halo 9 > 8
])
def test_dispatch_rule(spec_kw, n, device, want):
    spec = Spec(size=4096, **spec_kw)
    assert use_kernels(spec, n, device) is want
    assert get_ops(spec, n, device) is (cuda if want else ops)


def test_backend_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        use_kernels(Spec(size=256, backend="cuda"), 256, "cpu")
