"""The CUDA kernels of mgpoisson_torch against their plain torch versions,
on the card.

The kernels have no CPU mode, so every test here is marked `cuda` and
skips without a CUDA device.  The file imports no JAX, so it also runs
where JAX is not installed; tests/conftest.py imports JAX, hence:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Sizes include levels smaller than one 32x32 tile and levels of several
tiles.  Bars: normalized max |diff| <= 1e-5 (the ROADMAP's f32 kernel
bar), 1e-5 relative on sum(r^2), whose partials are summed in another
order."""

import pytest
import torch

from mgpoisson_torch.kernels import cuda, ops


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _data(n, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device)
            for s in ((n, n), (n, n), (n // 2, n // 2))]


def _nmax(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 64, 256])
@pytest.mark.parametrize("smoother,nu", [("jacobi", 7), ("wjacobi", 3),
                                         ("rbgs", 4)])
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_kernels_vs_plain(card, n, smoother, nu, bc):
    u, f, V = _data(n, n + nu, card)
    h = 1.0 / n
    a = (h, nu, smoother, bc)
    assert _nmax(cuda.smooth(u, f, *a), ops.smooth(u, f, *a)) <= 1e-5
    for got, want in zip(cuda.smooth_residual_restrict(u, f, *a),
                         ops.smooth_residual_restrict(u, f, *a)):
        assert _nmax(got, want) <= 1e-5
    for got, want in zip(cuda.smooth_residual_restrict_zero(f, *a),
                         ops.smooth_residual_restrict_zero(f, *a)):
        assert _nmax(got, want) <= 1e-5
    for kind in ("inject", "bilinear"):
        pa = (u, f, V, h, nu, smoother, bc, kind)
        assert _nmax(cuda.prolong_correct_smooth(*pa),
                     ops.prolong_correct_smooth(*pa)) <= 1e-5
        got_u, got_r2 = cuda.prolong_correct_smooth_rnorm(*pa)
        want_u, want_r2 = ops.prolong_correct_smooth_rnorm(*pa)
        assert _nmax(got_u, want_u) <= 1e-5
        assert abs(float(got_r2) / float(want_r2) - 1.0) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(card):
    u, f, V = _data(64, 0, card)
    with pytest.raises(ValueError, match="no kernel"):
        cuda.smooth(u.double(), f.double(), 1 / 64, 1, "jacobi", "ghost0")
    with pytest.raises(ValueError, match="no kernel"):
        cuda.smooth(u, f, 1 / 64, 5, "rbgs", "ghost0")
    with pytest.raises(ValueError, match="contiguous"):
        cuda.smooth(u.t(), f, 1 / 64, 1, "jacobi", "ghost0")
    with pytest.raises(ValueError, match="does not match"):
        cuda.prolong_correct_smooth(u, f, u, 1 / 64, 1, "jacobi", "ghost0")


@pytest.mark.cuda
def test_launch_counters(card):
    u, f, V = _data(256, 1, card)
    cuda.reset_launches()
    cuda.smooth_residual_restrict_zero(f, 1 / 256, 3, "wjacobi", "face")
    cuda.prolong_correct_smooth_rnorm(u, f, V, 1 / 256, 3, "wjacobi", "ghost0",
                                      "bilinear")
    assert cuda.launches == {"mg_smooth": 0, "mg_smooth_rr": 1,
                             "mg_smooth_rr.zero": 1,
                             "mg_prolong_correct_smooth": 1,
                             "mg_prolong_correct_smooth.rnorm": 1}
