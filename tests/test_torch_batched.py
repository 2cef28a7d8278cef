"""MultigridPoisson.solve_batched against the JAX package's.

The same batch goes through mgpoisson (backend 'xla', its vmap path on the
CPU) and mgpoisson_torch on the CPU, where the plain ops run: through
torch.func.vmap of the step (the path a small grid takes on the card too)
and through the per-element loop that the card's kernel levels take,
driven here by the batched loop's private ``use_vmap``.  Each JAX batch is
compiled once per module (``jax_runs``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import mgpoisson
import mgpoisson_torch
from mgpoisson_torch.shard.mesh import ProcessMesh
from mgpoisson_torch.solver import multigrid

F64_TOL = 1e-10            # psi, normalized by max |psi|
ERRS_RTOL = 1e-8           # errs against the JAX package's, f64
BF16_TOL = 5e-2            # the JAX package's bf16 bar (tests/test_torch_bf16.py)
STEP_RTOL = 0.5            # a mixed step's err against JAX's (tests/test_torch_mixed.py)


def _noise(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


_HARD = _noise(7, (32, 32))
# (spec, fs, cycles).  freeze32 is the JAX package's own freeze case
# (tests/test_transforms.py): the update metric is absolute, so the copy at
# 1e-6 of the amplitude converges in fewer cycles than the other element
CASES = {
    "tuned32": (dict(size=32, dtype="float64", scheme="tuned", stop="residual", tol=1e-9),
                _noise(0, (3, 32, 32)), None),
    "cycles16": (dict(size=16, dtype="float64", scheme="tuned"),
                 np.stack([_noise(1, (16, 16))] * 2), 4),
    "freeze32": (dict(size=32, dtype="float64", stop="update", tol=1e-9, maxiter=60),
                 np.stack([1e-6 * _HARD, _HARD]), None),
    # at 16^2: the JAX package compiles a bf16 batched loop for ~11 s at 32^2,
    # ~7 s at 16^2
    "mixed16": (dict(size=16, dtype="float32", sweep_dtype="bfloat16", stop="residual",
                     tol=1e-6), _noise(0, (3, 16, 16)).astype(np.float32), None),
}
# each element's cycle count in the JAX package on the CPU for mixed16: its
# solve() of that element takes these, and its solve_batched errs are those
# solves' final errs bit for bit (a batch freezes each element where its
# own solve stops)
JAX_MIXED_COUNTS = [8, 9, 8]


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's JAX solve_batched, compiled and run once per module:
    (psis, errs) as numpy arrays."""
    cache = {}

    def run(name):
        if name not in cache:
            kw, fs, cycles = CASES[name]
            mg = mgpoisson.MultigridPoisson(mgpoisson.Spec(backend="xla", **kw))
            psis, errs = mg.solve_batched(jnp.asarray(fs), cycles=cycles)
            cache[name] = (np.asarray(psis, np.float64), np.asarray(errs, np.float64))
        return cache[name]
    return run


def _port(name, **kw):
    spec = mgpoisson_torch.Spec(**{**CASES[name][0], **kw})
    return mgpoisson_torch.MultigridPoisson(spec, device="cpu")


def _fs(name):
    return torch.as_tensor(CASES[name][1])


def _nmax(got, want):
    got = np.asarray(got, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _counting(mg, fs):
    """Wrap mg._step to count the calls per element (identified by the
    address of its f, a view of fs) and return the counts."""
    counts = [0] * fs.shape[0]
    step, base, stride = mg._step, fs.data_ptr(), fs[0].numel() * fs.element_size()

    def counted(psi, f, r0):
        counts[(f.data_ptr() - base) // stride] += 1
        return step(psi, f, r0)
    mg._step = counted
    return counts


def _reads(monkeypatch):
    reads = []
    read = multigrid.read_scalar
    monkeypatch.setattr(multigrid, "read_scalar", lambda t: reads.append(1) or read(t))
    return reads


@pytest.mark.parametrize("name", ["tuned32", "cycles16", "freeze32"])
def test_batched_matches_jax(name, jax_runs):
    jpsis, jerrs = jax_runs(name)
    psis, errs = _port(name).solve_batched(_fs(name), cycles=CASES[name][2])
    assert psis.shape == jpsis.shape and errs.shape == (psis.shape[0],)
    assert errs.dtype == psis.dtype == torch.float64
    for k in range(psis.shape[0]):
        assert _nmax(psis[k], jpsis[k]) <= F64_TOL
    np.testing.assert_allclose(errs.numpy(), jerrs, rtol=ERRS_RTOL)


def test_fixed_cycles_run_identical_elements_identically():
    psis, _ = _port("cycles16").solve_batched(_fs("cycles16"), cycles=4)
    assert torch.equal(psis[0], psis[1])


def test_a_frozen_element_is_bit_stable():
    """The easy element freezes at its first converged iterate: the bits of
    its own solve(), which stops at that cycle, while the hard one goes on."""
    mg = _port("freeze32")
    fs = _fs("freeze32")
    psis, errs = mg.solve_batched(fs)
    easy, hard = mg.solve(fs[0]), mg.solve(fs[1])
    assert easy.iterations < hard.iterations
    assert torch.equal(psis[0], easy.psi)
    assert float(errs.max()) < 1e-9


@pytest.mark.parametrize("name", ["tuned32", "freeze32"])
def test_the_loop_path_is_the_vmap_path(name):
    """The per-element loop (the card's kernel levels) gives the vmap path's
    psis bit for bit, and steps each element exactly as many times as its
    own solve(): a frozen element's cycles are skipped, not run and
    dropped."""
    mg, fs = _port(name), _fs(name)
    vpsis, verrs = mg._batched_loop(fs, None, use_vmap=True)
    counts = _counting(mg, fs)
    lpsis, lerrs = mg._batched_loop(fs, None, use_vmap=False)
    assert torch.equal(lpsis, vpsis)
    np.testing.assert_allclose(lerrs.numpy(), verrs.numpy(), rtol=ERRS_RTOL)
    del mg._step
    assert counts == [mg.solve(f).iterations for f in fs]
    if name == "freeze32":
        assert counts[0] < counts[1]


def test_mixed_batch_to_the_jax_bar(jax_runs):
    """f32 with bf16 sweeps: each element's count is the JAX package's, its
    psi within the bf16 bar, its final err within a step's noise."""
    jpsis, jerrs = jax_runs("mixed16")
    mg, fs = _port("mixed16"), _fs("mixed16")
    psis, errs = mg.solve_batched(fs)
    assert psis.dtype == errs.dtype == torch.float32
    counts = _counting(mg, fs)
    lpsis, _ = mg._batched_loop(fs, None, use_vmap=False)
    assert counts == JAX_MIXED_COUNTS
    assert torch.equal(lpsis, psis)
    for k in range(fs.shape[0]):
        assert _nmax(psis[k], jpsis[k]) <= BF16_TOL
        assert abs(errs[k].item() - jerrs[k]) <= STEP_RTOL * jerrs[k]


@pytest.mark.parametrize("use_vmap", [True, False], ids=["vmap", "loop"])
def test_a_nan_element_stops_the_batch_after_one_cycle(use_vmap, monkeypatch):
    mg = _port("tuned32")
    fs = _fs("tuned32").clone()
    fs[1, 3, 5] = float("nan")
    reads, errs_reads = _reads(monkeypatch), []
    read_errs = multigrid.read_errs
    monkeypatch.setattr(multigrid, "read_errs", lambda t: errs_reads.append(1) or read_errs(t))
    psis, errs = mg._batched_loop(fs, None, use_vmap=use_vmap)
    assert len(reads) + len(errs_reads) == 1
    assert torch.isnan(errs[1]) and torch.isfinite(errs[[0, 2]]).all()
    one, _ = mg._batched_loop(fs, 1, use_vmap=use_vmap)
    assert torch.equal(psis[[0, 2]], one[[0, 2]])


def test_the_batch_stops_at_maxiter(monkeypatch):
    mg = _port("tuned32", tol=1e-30, maxiter=3)
    fs = _fs("tuned32")
    reads = _reads(monkeypatch)
    psis, errs = mg.solve_batched(fs)
    assert len(reads) == 3 and (errs >= 0).all()
    assert torch.equal(psis, mg.solve_batched(fs, cycles=3)[0])
    assert len(reads) == 3           # a fixed count reads nothing back


def test_batched_under_a_mesh_raises():
    spec = mgpoisson_torch.Spec(size=32, mesh_shape=(2, 2))
    mesh = ProcessMesh(shape=(2, 2), rank=0, ranks=(0, 1, 2, 3), backend="gloo")
    mg = mgpoisson_torch.MultigridPoisson(spec, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        mg.solve_batched(torch.zeros((2, 16, 16)))
