"""The arithmetic of the bf16 forms of the 2D legs (K1-K3, K9/K10) on
bf16x2 words, pinned with plain torch and numpy, no kernel.

The kernels keep a lane's two cells of a row in one bf16x2 register and
do every add, subtract and multiply as one bf16x2 instruction, rounded
once to nearest even (mgpoisson_torch/csrc/stencil.cuh, Mg2Word and Mg2X2).
They are held bit for bit to the plain ops in bf16, which compute each op
in f32 and round to bf16.  Here:

(a) torch's bf16 add, sub and mul of two bf16 values equal one rounding of
    the exact result, over every class of bit pattern;
(b) a product by n^2 fused into the next add (one fma) equals torch's two
    steps wherever the product is finite, and not where it overflows: so
    the kernels fuse nothing;
(c) nor through 1/adiag, where the product underflows: one known pair;
    and a product by 1/h^2, 1/adiag or adiag may be a bf16x2 word only
    where these are bf16 values (h = 1/2^k), else it is made in f32;
(d) a model of the kernels' order of operations (pairs, the A/B
    neighbour words, each op one rounding, the restriction's sum and the
    bilinear blend in f32) equals ops.smooth_residual_restrict (and _zero)
    and ops.prolong_correct_smooth (and _rnorm) in bf16 bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mgpoisson_torch.kernels import cuda, ops

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

BF16_MAX = float(torch.finfo(torch.bfloat16).max)


def rb(x):
    """The bf16 value nearest to each f64 value x (ties to even): one
    rounding, subnormals (spacing 2^-133) and overflow to inf included.
    f64 holds a bf16 sum to 53 bits, and 53 >= 2*8 + 2, so rounding the f64
    result again to bf16 is the exact result rounded once."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(x)
    q = np.ldexp(1.0, np.maximum(e, -125) - 8)   # bf16's spacing at |x|
    with np.errstate(invalid="ignore", over="ignore"):
        r = np.round(x / q) * q
    r = np.where(np.abs(r) > BF16_MAX, np.copysign(np.inf, x), r)
    return np.where((x == 0) | ~np.isfinite(x), x, r)


def to_bf16(x):
    """f64 values that are bf16 values as a bf16 tensor (exact)."""
    return torch.from_numpy(np.asarray(x, np.float64)).to(torch.bfloat16)


def bits(t):
    return t.contiguous().view(torch.int16).numpy()


def same(got, want):
    """Bit-equal bf16 tensors (any NaN equal to any NaN)."""
    nan = torch.isnan(got).numpy() & torch.isnan(want).numpy()
    return (bits(got) == bits(want)) | nan


def sample(seed, count=600):
    """A seeded sample of bf16 values from every class of bit pattern:
    normals of every exponent, subnormals, +-0, the largest finite and its
    neighbours, both signs."""
    rng = np.random.default_rng(seed)
    normal = rng.integers(0x0080, 0x7F80, count)
    subnormal = rng.integers(0x0001, 0x0080, count // 8)
    edges = np.array([0x0000, 0x0001, 0x007F, 0x0080, 0x7F7F, 0x7F7E, 0x7F00, 0x3F80])
    b = np.concatenate([normal, subnormal, edges])
    b = np.concatenate([b, b | 0x8000]).astype(np.uint16).view(np.int16)
    return torch.from_numpy(b).view(torch.bfloat16)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("seed", [0, 1])
def test_torch_bf16_op_is_one_rounding(op, seed):
    a, b = sample(seed), sample(seed + 10)
    a, b = a[:, None].expand(-1, len(b)), b[None, :].expand(len(a), -1)
    got = {"add": a + b, "sub": a - b, "mul": a * b}[op]
    x, y = a.double().numpy(), b.double().numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        want = to_bf16(rb({"add": x + y, "sub": x - y, "mul": x * y}[op]))
    assert same(got, want).all()
    subnormal = (got != 0) & (got.double().abs() < 2.0 ** -126)
    assert subnormal.any() and torch.isinf(got).any()          # both ends reached


def _fused_and_two_step(n, f, nbr, c):
    """For f - nbr*n^2 (ops.jacobi_sweep) and nbr*n^2 + adiag*c
    (ops.residual): (the fma rounded once, torch's two steps)."""
    hsq = (1.0 / n) ** 2
    fx, nx, cx = f.double().numpy(), nbr.double().numpy(), c.double().numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        return [(to_bf16(rb(fx - nx * n * n)), f - nbr / hsq),
                (to_bf16(rb(nx * n * n + rb((-4.0 * n * n) * cx))),
                 nbr / hsq + (-4.0 / hsq) * c)]


@pytest.mark.parametrize("n", [2 ** k for k in range(1, 15)])
def test_fusing_a_product_by_n2_is_exact_only_while_it_is_finite(n):
    f, nbr = sample(n), sample(n + 20)
    f, nbr = f[:, None].expand(-1, len(nbr)), nbr[None, :].expand(len(f), -1)
    with np.errstate(over="ignore"):
        finite = (np.isfinite(rb(nbr.double().numpy() * n * n))
                  & np.isfinite(rb(-4.0 * n * n * f.double().numpy())))
    for fused, two_step in _fused_and_two_step(n, f, nbr, f):
        assert same(fused, two_step)[finite].all()
    # nbr*n^2 = 2^128 overflows in torch's first step; fused beside the
    # largest finite value (f, or adiag*c = -max) it does not
    big = to_bf16([2.0 ** 128 / (n * n)])
    cases = _fused_and_two_step(n, to_bf16([BF16_MAX]), big, to_bf16([BF16_MAX / (4 * n * n)]))
    for fused, two_step in cases:
        assert torch.isinf(two_step).all() and torch.isfinite(fused).all()


def test_fusing_through_inv_adiag_is_not_exact():
    """y + t/adiag at n = 16384 (1/adiag = -2^-30): the product underflows
    into bf16's subnormals, so rounding it first (torch) and rounding the
    fma once differ."""
    n = 16384
    adiag = -4.0 * n * n
    t = torch.tensor([0x0C1A], dtype=torch.int16).view(torch.bfloat16)
    y = torch.tensor([0x0158], dtype=torch.int16).view(torch.bfloat16)
    two_step = y + t / adiag
    fused = to_bf16(rb(y.double().numpy() + t.double().numpy() / adiag))
    assert not same(fused, two_step).all()
    assert float(two_step) == float(y) and float(fused) < float(y)


@pytest.mark.parametrize("h", [1.0 / 2 ** k for k in range(1, 15)] + [0.01, 0.3])
def test_a_word_product_by_a_level_constant_needs_a_bf16_value(h):
    """The bf16 kernels multiply by 1/h^2, 1/adiag and adiag as
    kernels.cuda passes them (f32: the reciprocals taken in f32 from the
    plain ops' bf16 h^2 and adiag, ops._level) as one bf16x2 word only
    where all three are bf16 values, and else each half in f32, rounded
    once (stencil.cuh Mg2K).  adiag is a bf16 value at every h; 1/h^2 and
    1/adiag are at h = 1/2^k, where the two products agree, and not at 0.01
    and 0.3, where a word rounded from them (1/bf16(h^2) = 9986.4375 as
    9984) gives other products than the f32 constant.  The damped-Jacobi
    weight in the header is ops._omega's, a bf16 value."""
    src = (Path(cuda.__file__).parents[1] / "csrc" / "stencil.cuh").read_text()
    m = re.search(r"struct Mg2Elem<__nv_bfloat16>[^{]*\{[^}]*omega = ([0-9.]+)f;", src)
    assert m and float(m.group(1)) == ops._omega(2, torch.bfloat16)
    assert float(torch.tensor(float(m.group(1)), dtype=torch.bfloat16)) == float(m.group(1))
    consts = [x.value for x in cuda._scalars(h, 2, torch.bfloat16)]
    words = [float(torch.tensor(c, dtype=torch.bfloat16)) for c in consts]
    power_of_two = float(np.log2(h)).is_integer()
    exact = [w == c for w, c in zip(words, consts)]
    assert exact == [power_of_two, power_of_two, True]
    x = sample(7)
    x = x[torch.isfinite(x) & (x.double().abs() < 2.0 ** 100)]
    for c, w, e in zip(consts, words, exact):
        in_f32 = (x.float() * np.float32(c)).to(torch.bfloat16)        # Mg2K<false>
        as_word = x * torch.tensor(w, dtype=torch.bfloat16)             # Mg2K<true>
        assert same(as_word, in_f32).all() == e


# ------------------------------------------------- (d) the kernels' order
# Whole-grid model of the register tile's bf16 body: the array as words of
# a lane's two columns, every bf16x2 op one rounding (rb) of the exact f64
# result.  The tile's halo only bounds where the model's values are exact,
# so the grid's own edges (zero ghosts, face) stand for the checked body's.

def _x2(u):
    """(n, n) -> (n, n/2, 2): word j holds columns 2j (half 0) and 2j + 1."""
    return u.reshape(u.shape[0], -1, 2)


def _rows(w, d):
    """Row i of the result holds row i + d of w, zero beyond the grid."""
    out = np.zeros_like(w)
    if d > 0:
        out[:-d] = w[d:]
    else:
        out[-d:] = w[:d]
    return out


def _lr(w):
    """lf + rt of both cells: A = (x1 of word j - 1, x0), B = (x1, x0 of
    word j + 1), zero beyond the grid (the shuffles of the lanes beside)."""
    left, right = np.zeros_like(w), np.zeros_like(w)
    left[:, 1:], right[:, :-1] = w[:, :-1], w[:, 1:]
    A = np.stack([left[..., 1], w[..., 0]], axis=-1)
    B = np.stack([w[..., 1], right[..., 0]], axis=-1)
    return rb(A + B)


def _nbr(w, face):
    acc = rb(_rows(w, -1) + _rows(w, 1))
    if face:
        acc[0] = rb(acc[0] - w[0])
        acc[-1] = rb(acc[-1] - w[-1])
    acc = rb(acc + _lr(w))
    if face:                            # the halves on the grid's first and last column
        acc[:, 0, 0] = rb(acc[:, 0, 0] - w[:, 0, 0])
        acc[:, -1, 1] = rb(acc[:, -1, 1] - w[:, -1, 1])
    return acc


def _relax(w, f, nbr, smoother, k):
    jac = rb(rb(f - rb(nbr * k["inv_hsq"])) * k["inv_adiag"])
    if smoother == "wjacobi":
        return rb(w + rb(k["omega"] * rb(jac - w)))
    return jac


def _colour(n):
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return _x2((i + j) % 2)


def _sweeps(w, f, nu, smoother, face, k, zero):
    colour = _colour(w.shape[0])
    s = 0
    if zero and nu > 0:                 # from u = 0: f/adiag (0 + omega f/adiag)
        v = rb(f * k["inv_adiag"])
        if smoother == "wjacobi":
            v = rb(0.0 + rb(k["omega"] * v))
        if smoother == "rbgs":
            v = np.where(colour == 0, v, 0.0)
            v = np.where(colour == 1, _relax(v, f, _nbr(v, face), smoother, k), v)
        w, s = v, 1
    for _ in range(s, nu):
        if smoother == "rbgs":          # both halves updated, the colour's kept
            for p in (0, 1):
                w = np.where(colour == p, _relax(w, f, _nbr(w, face), smoother, k), w)
        else:
            w = _relax(w, f, _nbr(w, face), smoother, k)
    return w


def _resid(w, f, face, k):
    return rb(f - rb(rb(_nbr(w, face) * k["inv_hsq"]) + rb(k["adiag"] * w)))


def _restrict(r):
    """((r00 + r10) + (r01 + r11)) in f32, rounded once, then the quarter."""
    r = r.astype(np.float32)
    s = (r[0::2, :, 0] + r[1::2, :, 0]) + (r[0::2, :, 1] + r[1::2, :, 1])
    return rb(rb(s.astype(np.float64)) * 0.25)


def _blend(V, n, kind):
    """P(V) of every fine cell in f32, in mg2_blend's order."""
    Vi = np.repeat(np.repeat(V.astype(np.float32), 2, 0), 2, 1)
    if kind == "inject":
        return Vi

    def shift(x, ax):                   # the coarse neighbour on the parity's side
        m, p = np.zeros_like(x), np.zeros_like(x)
        sl = lambda s: tuple(s if a == ax else slice(None) for a in range(2))
        m[sl(slice(2, None))], p[sl(slice(None, -2))] = x[sl(slice(None, -2))], x[sl(slice(2, None))]
        even = (np.arange(n) % 2 == 0).reshape((-1, 1) if ax == 0 else (1, -1))
        return np.where(even, m, p)

    edge = (np.arange(n) == 0) | (np.arange(n) == n - 1)
    a = np.where(edge, 0.5, 0.75).astype(np.float32)
    b = np.where(edge, 0.0, 0.25).astype(np.float32)
    a0, b0, a1, b1 = a[:, None], b[:, None], a[None, :], b[None, :]
    S0, S1 = shift(Vi, 0), shift(Vi, 1)
    S01 = shift(S1, 0)
    return ((a0 * a1) * Vi + (a0 * b1) * S1 + (b0 * a1) * S0) + (b0 * b1) * S01


def _consts(n):
    h = 1.0 / n
    return {"inv_hsq": 1.0 / (h * h), "inv_adiag": -(h * h) / 4.0, "adiag": -4.0 / (h * h),
            "omega": ops._omega(2, torch.bfloat16)}


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("smoother,nu", [("jacobi", 1), ("jacobi", 2), ("jacobi", 3),
                                         ("wjacobi", 1), ("wjacobi", 2), ("wjacobi", 3),
                                         ("rbgs", 1), ("rbgs", 2)])
@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_word_order_equals_the_plain_bf16_legs(n, smoother, nu, bc):
    rng = np.random.default_rng(1000 * n + 10 * nu + (bc == "face"))
    u, f, V = (to_bf16(rb(rng.standard_normal((s, s)))) for s in (n, n, n // 2))
    h, face, k = 1.0 / n, bc == "face", _consts(n)
    uw, fw = _x2(u.double().numpy()), _x2(f.double().numpy())
    a = (h, nu, smoother, bc)
    # the down-leg, with u and from zero
    for zero, (pu, pR) in ((False, ops.smooth_residual_restrict(u, f, *a)),
                           (True, ops.smooth_residual_restrict_zero(f, *a))):
        w = _sweeps(np.zeros_like(uw) if zero else uw, fw, nu, smoother, face, k, zero)
        assert same(to_bf16(w.reshape(n, n)), pu).all(), zero
        assert same(to_bf16(_restrict(_resid(w, fw, face, k))), pR).all(), zero
    # the up-leg in both kinds, with rnorm (the zero-ghost residual)
    for kind in ("inject", "bilinear"):
        P = rb(_blend(V.double().numpy(), n, kind).astype(np.float64))
        w = _sweeps(rb(uw + _x2(P)), fw, nu, smoother, face, k, zero=False)
        pu, r2 = ops.prolong_correct_smooth_rnorm(u, f, V, *a, kind)
        assert same(to_bf16(w.reshape(n, n)), pu).all(), kind
        assert torch.equal(ops.prolong_correct_smooth(u, f, V, *a, kind), pu)
        r = _resid(w, fw, False, k).astype(np.float32)
        assert abs(float(np.sum(r * r, dtype=np.float64)) / float(r2) - 1.0) <= 1e-5
