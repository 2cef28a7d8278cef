"""The port's debug tools and checkpoints against the JAX package's
``mgpoisson.utils``, on the CPU.

- Debug: the traced V-cycle of ``validate_cycle`` stage for stage against
  the JAX package's (its stage names and level sizes, values within
  1e-12 relative in f64), the poisoned cycle's NonFiniteError with the
  JAX message text, ``compare_traces``' report dicts and ``dump_trace``'s
  text against the JAX functions' on the same arrays.
- Checkpoints: the npz layout both ways, single file, bf16 included
  (numpy writes the JAX package's bf16 arrays as raw two-byte voids,
  ``|V2``; the port writes and reads the same bytes), and a resumed solve
  against the JAX package's ``resume_solve``.  The per-process files of a
  sharded solve are in tests/test_torch_spmd_bf16_solve.py.
"""

import io

import numpy as np
import pytest
import torch

import mgpoisson
import mgpoisson_torch
from mgpoisson_torch.utils import (check_finite, compare_traces, dump_trace, load_state,
                                   resume_solve, save_state, validate_cycle)
from mgpoisson_torch.utils.debug import NonFiniteError

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

UTILS_ALL = ["check_finite", "compare_traces", "dump_trace", "validate_cycle",
             "save_state", "load_state"]


def _specs(**kw):
    kw = {"size": 64, "dtype": "float64", "scheme": "tuned", **kw}
    return mgpoisson.Spec(backend="xla", **kw), mgpoisson_torch.Spec(**kw)


def _rhs(n, dtype=np.float64):
    from mgpoisson import oracle
    return oracle.point_charge_rhs(n).astype(dtype)


def test_utils_exports_the_jax_names_and_resume_solve():
    import mgpoisson.utils
    import mgpoisson_torch.utils
    assert mgpoisson.utils.__all__ == UTILS_ALL
    assert mgpoisson_torch.utils.__all__ == UTILS_ALL + ["resume_solve"]


# ------------------------------------------------------------------- debug

@pytest.fixture(scope="module")
def traces():
    """The JAX package's and the port's validate_cycle at 64^2 f64 from
    psi0 = -f (the JAX trace path runs eagerly, op by op)."""
    from mgpoisson.utils import validate_cycle as jax_validate
    import jax.numpy as jnp
    spec_j, spec_t = _specs()
    f = _rhs(64)
    uj, tj = jax_validate(spec_j, -jnp.asarray(f), jnp.asarray(f))
    ft = torch.tensor(f)
    ut, tt = validate_cycle(spec_t, -ft, ft)
    return (np.asarray(uj), tj), (ut, tt)


def test_validate_cycle_trace_matches_jax(traces):
    """Same structure (stage names, level sizes 64 ... 1), every stage
    within 1e-12 relative of the JAX package's, through the port's
    compare_traces."""
    (uj, tj), (ut, tt) = traces
    assert [(n, s) for n, s, _ in tt] == [(n, s) for n, s, _ in tj]
    assert [s for n, s, _ in tt if n == "u_pre"] == [64, 32, 16, 8, 4, 2]
    assert all(isinstance(a, torch.Tensor) and a.dtype == torch.float64 for _, _, a in tt)
    report = compare_traces(tt, tj, rtol=1e-12, atol=0.0)
    assert len(report) == len(tj)
    bad = [r for r in report if not (r["ok"] and r["max_rel_diff"] <= 1e-12)]
    assert not bad, bad
    np.testing.assert_allclose(ut.numpy(), uj, rtol=0, atol=1e-12 * np.abs(uj).max())


@pytest.mark.parametrize("poison", ["inf-in-f", "nan-in-psi"])
def test_poisoned_cycle_raises_the_jax_message(poison):
    """An inf in f (the JAX test's poison) or one NaN in psi0 fails the
    first stage it reaches, named with its level, in the JAX package's
    words."""
    from mgpoisson.utils import validate_cycle as jax_validate
    from mgpoisson.utils.debug import NonFiniteError as JaxNonFinite
    import jax.numpy as jnp
    spec_j, spec_t = _specs(size=32)
    f = _rhs(32)
    u = -f
    if poison == "inf-in-f":
        f[0, 0] = np.inf
    else:
        u[5, 9] = np.nan
    with pytest.raises(JaxNonFinite) as jax_err:
        jax_validate(spec_j, jnp.asarray(u), jnp.asarray(f))
    with pytest.raises(NonFiniteError) as port_err:
        validate_cycle(spec_t, torch.tensor(u), torch.tensor(f))
    assert str(port_err.value) == str(jax_err.value)
    assert "stage 'u_pre' at level size 32" in str(port_err.value)


def test_check_finite_counts_as_jax_on_tensors_and_arrays():
    from mgpoisson.utils import check_finite as jax_check
    a = np.ones((8, 8))
    a[1, 2], a[3, 3], a[7, 0] = np.nan, np.inf, -np.inf
    with pytest.raises(RuntimeError) as jax_err:
        jax_check("r", a, 8)
    for arr in (a, torch.tensor(a), torch.tensor(a).to(torch.bfloat16)):
        with pytest.raises(NonFiniteError) as port_err:
            check_finite("r", arr, 8)
        assert str(port_err.value) == str(jax_err.value)
    check_finite("u", torch.ones(4, 4, dtype=torch.bfloat16))


def _numpy_traces():
    """Two traces of the same structure on numpy arrays, apart by rounding
    at some stages and by more at two."""
    rng = np.random.default_rng(11)
    ta, tb = [], []
    for k, (name, n) in enumerate([("u_pre", 16), ("r", 16), ("R", 8), ("f", 1), ("u", 1),
                                   ("V", 8), ("u_post", 16)]):
        a = rng.normal(size=(n, n))
        b = a * (1 + (1e-9 if k == 2 else 1e-13) * rng.normal(size=a.shape))
        if name == "V":
            b = b + 1e-3
        ta.append((name, n, a))
        tb.append((name, n, b))
    return ta, tb


@pytest.mark.parametrize("as_tensors", [False, True], ids=["numpy", "tensors"])
def test_compare_traces_reports_as_jax(as_tensors):
    """The report dicts of the JAX function on the same numpy traces, key
    for key and value for value, at its default bars and at tight ones."""
    from mgpoisson.utils import compare_traces as jax_compare
    ta, tb = _numpy_traces()
    port_a = [(n, s, torch.tensor(a)) for n, s, a in ta] if as_tensors else ta
    for kw in ({}, dict(rtol=1e-12, atol=0.0)):
        want = jax_compare(ta, tb, **kw)
        got = compare_traces(port_a, tb, **kw)
        assert got == want
    assert [r["ok"] for r in got] == [True, True, False, True, True, False, True]


def test_compare_traces_structure_mismatch_raises_as_jax():
    from mgpoisson.utils import compare_traces as jax_compare
    t1 = [("u", 4, np.zeros((4, 4)))]
    t2 = [("r", 4, np.zeros((4, 4)))]
    with pytest.raises(ValueError, match="structures differ") as jax_err:
        jax_compare(t1, t2)
    with pytest.raises(ValueError, match="structures differ") as port_err:
        compare_traces(t1, [("r", 4, torch.zeros(4, 4))])
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="structures differ"):
        compare_traces(t1, [("u", 8, np.zeros((4, 4)))])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dump_trace_prints_the_jax_text(dtype):
    """Byte for byte the JAX function's text: a level of side <= 16 row by
    row, a larger one (and a 3D one) as its summary line; the port's
    stages as tensors."""
    from mgpoisson.utils import dump_trace as jax_dump
    rng = np.random.default_rng(5)
    trace = [("u", 4, rng.normal(size=(4, 4)).astype(dtype)),
             ("R", 16, rng.normal(size=(16, 16)).astype(dtype)),
             ("u_post", 32, rng.normal(size=(32, 32)).astype(dtype)),
             ("f", 8, rng.normal(size=(8, 8, 8)).astype(dtype))]
    want, got = io.StringIO(), io.StringIO()
    jax_dump(trace, file=want)
    dump_trace([(n, s, torch.tensor(a)) for n, s, a in trace], file=got)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().count("shape=") == 2


# -------------------------------------------------------------- checkpoints

def _bf16_bits(t):
    return t.view(torch.int16).numpy()


def _state(dtype, n=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    psi, f = (torch.randn((n, n), generator=g, dtype=torch.float64).to(getattr(torch, dtype))
              for _ in range(2))
    return psi, f


def _equal(got, want):
    if isinstance(want, torch.Tensor) and want.dtype == torch.bfloat16:
        return (isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
                and np.array_equal(_bf16_bits(got), _bf16_bits(want)))
    return np.array_equal(np.asarray(got), np.asarray(want)) and \
        np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_single_file_round_trip(tmp_path, dtype):
    path = str(tmp_path / "state.npz")
    psi, f = _state(dtype)
    save_state(path, psi, f=f, iteration=7, errs=torch.tensor([1.0, 0.5]),
               meta={"size": 16, "dtype": dtype})
    state = load_state(path)
    assert _equal(state["psi"], psi) and _equal(state["f"], f)
    assert state["iteration"] == 7 and state["meta_size"] == 16
    assert str(state["meta_dtype"]) == dtype
    np.testing.assert_array_equal(state["errs"], np.array([1.0, 0.5], np.float32))


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_port_files_load_in_jax(tmp_path, dtype):
    """The JAX load_state reads the port's file: the same keys and values,
    a bf16 array as the |V2 voids it reads from its own files."""
    from mgpoisson.utils import load_state as jax_load
    path = str(tmp_path / "port.npz")
    psi, f = _state(dtype, seed=1)
    save_state(path, psi, f=f, iteration=3, errs=[2.0], meta={"size": 16})
    state = jax_load(path)
    assert sorted(state) == ["errs", "f", "iteration", "meta_size", "psi"]
    assert state["iteration"] == 3
    for k, t in (("psi", psi), ("f", f)):
        if dtype == "bfloat16":
            assert state[k].dtype == np.dtype("V2")
            np.testing.assert_array_equal(state[k].view(np.int16), _bf16_bits(t))
        else:
            np.testing.assert_array_equal(state[k], t.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_jax_files_load_in_the_port(tmp_path, dtype):
    """The port reads the JAX package's file bit for bit: its bf16 arrays
    (ml_dtypes' bfloat16, saved as |V2) as torch.bfloat16 tensors."""
    import jax.numpy as jnp
    from mgpoisson.utils import save_state as jax_save
    path = str(tmp_path / "jax.npz")
    rng = np.random.default_rng(2)
    psi, f = (jnp.asarray(rng.normal(size=(16, 16)), dtype=dtype) for _ in range(2))
    jax_save(path, psi, f=f, iteration=5, errs=[1.0, 0.25], meta={"size": 16})
    state = load_state(path)
    assert state["iteration"] == 5 and state["meta_size"] == 16
    for k, a in (("psi", psi), ("f", f)):
        a = np.asarray(a)
        if dtype == "bfloat16":
            assert state[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(_bf16_bits(state[k]), a.view(np.int16))
        else:
            np.testing.assert_array_equal(state[k], a)


def test_sharded_save_needs_a_mesh(tmp_path):
    with pytest.raises(TypeError, match="needs a mesh"):
        save_state(str(tmp_path / "x"), torch.zeros(4, 4), sharded=True)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_state(str(tmp_path / "missing"))


def test_resume_matches_jax_resume_solve(tmp_path):
    """32^2 f64, tuned, to 1e-10: two steps, a checkpoint, resume_solve, in
    each package on its own files: the JAX package's iteration count,
    every errs entry within 1e-10 relative over an absolute floor of 1e-16
    (the late entries, ~1e-10 of the resumed r0, carry the residual's f64
    rounding: 3.9e-18 apart, 4e-8 relative, at 5.9e-11), psi within
    1e-12."""
    from mgpoisson.utils import save_state as jax_save
    from mgpoisson.utils.checkpoint import resume_solve as jax_resume
    spec_j, spec_t = _specs(size=32, stop="residual", tol=1e-10)
    mg_j = mgpoisson.MultigridPoisson(spec_j)
    f = mg_j.rhs()
    psi = mg_j.init_state(f)
    for _ in range(2):
        psi, _ = mg_j.step(psi, f)
    jax_save(str(tmp_path / "jax.npz"), np.asarray(psi), f=np.asarray(f), iteration=2)
    want = jax_resume(mg_j, str(tmp_path / "jax.npz"))

    mg_t = mgpoisson_torch.MultigridPoisson(spec_t, device="cpu")
    ft = mg_t.rhs()
    pt = mg_t.init_state(ft)
    for _ in range(2):
        pt, _ = mg_t.step(pt, ft)
    save_state(str(tmp_path / "port.npz"), pt, f=ft, iteration=2)
    got = resume_solve(mg_t, str(tmp_path / "port.npz"))
    assert got.converged and want.converged and got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.errs.numpy(), np.asarray(want.errs), rtol=1e-10, atol=1e-16)
    b = np.asarray(want.psi)
    assert np.abs(got.psi.numpy() - b).max() / np.abs(b).max() <= 1e-12
