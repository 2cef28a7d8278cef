"""The port's explicit partition against the JAX package's, on the CPU.

- The plain sharded ops (the plain versions of the strip kernels K9-K12):
  a global grid is cut into blocks and strips exactly as the ranks'
  exchange delivers them (spmd.block_from_grid), every block runs the op on its own, and the
  stitched result is held against the JAX package's XLA composite on the
  whole grid (the comparison tests/test_pallas_sharded.py makes for the
  JAX strip kernels).
- The sharded step and solve: one spawn of 4 gloo ranks on the CPU runs
  every case; the gathered results are held against the JAX package's
  partition="spmd" step and solve on its 8 virtual devices
  (tests/conftest.py) and against its single-device step.
- Spec, mesh and device rules.

The ranks re-import this module, so its top level imports torch, numpy,
pytest and the port only; JAX and mgpoisson are imported inside the
parent-side functions.
"""

import datetime
import itertools

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import mgpoisson_torch
from mgpoisson_torch.convert import state_from_numpy
from mgpoisson_torch.core.rhs import point_charge_rhs
from mgpoisson_torch.kernels import ops
from mgpoisson_torch.shard import multihost, spmd
from mgpoisson_torch.shard.mesh import ProcessMesh, build_mesh, mesh_shape_for

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

WORLD = 4


def _fake_mesh(shape, rank):
    """A mesh object for the code that needs no collective (block
    geometry, rhs)."""
    return ProcessMesh(shape=shape, rank=rank, ranks=tuple(range(shape[0] * shape[1])),
                       backend="gloo")


# ------------------------------------------------------ the plain sharded ops

def _stitched(n, ndim, mesh, u, f, V, nu, smoother, bc, kind):
    """Every block's down-leg (from u and from zero) and up-leg (with
    rnorm), stitched back into whole grids; Σr² summed over the blocks."""
    shape = (n // mesh[0], n // mesh[1]) + (n,) * (ndim - 2)
    d = ops.sweep_radius(smoother) * nu + 1
    dv = ops.coarse_depth(d)
    out = {k: np.zeros_like(a) for k, a in (("u", u), ("R", V), ("uz", u), ("Rz", V),
                                          ("up", u))}
    r2 = 0.0
    for i, j in itertools.product(range(mesh[0]), range(mesh[1])):
        org = (i * shape[0], j * shape[1])
        cols = mesh[1] > 1
        ub, us = spmd.block_from_grid(torch.tensor(u), org, shape, d, cols)
        fb, fs = spmd.block_from_grid(torch.tensor(f), org, shape, d, cols)
        vb, vs = spmd.block_from_grid(torch.tensor(V), (org[0] // 2, org[1] // 2),
                                      [s // 2 for s in shape], dv, cols)
        fine = (slice(org[0], org[0] + shape[0]), slice(org[1], org[1] + shape[1]))
        coarse = tuple(slice(s.start // 2, s.stop // 2) for s in fine)
        a = (org, n, 1.0 / n, nu, smoother, bc)
        for k, x in zip(("u", "R", "uz", "Rz"),
                        ops.smooth_rr_sharded(ub, fb, us, fs, *a)
                        + ops.smooth_rr_sharded(None, fb, None, fs, *a, zero=True)):
            out[k][coarse if k.startswith("R") else fine] = x.numpy()
        up, s = ops.pc_smooth_sharded(ub, fb, vb, us, fs, vs, org, n, 1.0 / n, nu,
                                      smoother, bc, kind, rnorm=True)
        out["up"][fine] = up.numpy()
        r2 += float(s)
    return out, r2


def _xla_reference(u, f, V, n, nu, smoother, bc, kind):
    import jax.numpy as jnp
    from mgpoisson.kernels import xla
    J = jnp.asarray
    h = 1.0 / n
    u1, R1 = xla.smooth_residual_restrict(J(u), J(f), h, nu, smoother, bc)
    uz, Rz = xla.smooth_residual_restrict(jnp.zeros_like(J(f)), J(f), h, nu, smoother, bc)
    up, r2 = xla.prolong_correct_smooth_rnorm(J(u), J(f), J(V), h, nu, smoother, bc, kind)
    return {"u": u1, "R": R1, "uz": uz, "Rz": Rz, "up": up}, float(r2)


def _nmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("kind", ["inject", "bilinear"])
@pytest.mark.parametrize("smoother,nu", [("wjacobi", 3), ("rbgs", 2), ("jacobi", 1)])
@pytest.mark.parametrize("bc", ["ghost0", "face"])
@pytest.mark.parametrize("ndim,n,mesh", [(2, 64, (2, 2)), (2, 64, (4, 1)), (3, 32, (2, 2))],
                         ids=["2d-2x2", "2d-4x1", "3d-2x2"])
def test_plain_sharded_ops_match_xla(ndim, n, mesh, bc, smoother, nu, kind):
    """Every block position, from u and from zero, the up-leg with Σr²,
    f64: the stitched blocks equal the XLA composites on the whole grid."""
    rng = np.random.default_rng(n + nu)
    u, f = rng.normal(size=(2,) + (n,) * ndim)
    V = rng.normal(size=(n // 2,) * ndim)
    got, r2 = _stitched(n, ndim, mesh, u, f, V, nu, smoother, bc, kind)
    want, w2 = _xla_reference(u, f, V, n, nu, smoother, bc, kind)
    for k in got:
        assert _nmax(got[k], want[k]) <= 1e-12, k
    assert abs(r2 / w2 - 1) <= 1e-12


def test_plain_sharded_ops_match_xla_f32():
    """The same in f32, at the JAX strip kernels' own bar (2e-5)."""
    n, ndim, mesh, nu, smoother, bc, kind = 64, 2, (2, 2), 3, "wjacobi", "face", "bilinear"
    rng = np.random.default_rng(7)
    u, f = rng.normal(size=(2, n, n)).astype(np.float32)
    V = rng.normal(size=(n // 2, n // 2)).astype(np.float32)
    got, r2 = _stitched(n, ndim, mesh, u, f, V, nu, smoother, bc, kind)
    want, w2 = _xla_reference(u, f, V, n, nu, smoother, bc, kind)
    for k in got:
        assert _nmax(got[k], want[k]) <= 2e-5, k
    assert abs(r2 / w2 - 1) <= 2e-5


def test_plain_sharded_ops_reject_shallow_strips():
    u = torch.zeros(16, 16, dtype=torch.float64)
    strips = (torch.zeros(2, 16, dtype=torch.float64),) * 2 + (None, None)
    with pytest.raises(ValueError, match="depth 2"):
        ops.smooth_rr_sharded(u, u, strips, strips, (0, 0), 16, 1 / 16, 3, "wjacobi")


# ----------------------------------------------------- the 4-rank spawn

MIXED = dict(size=64, dtype="float32", sweep_dtype="bfloat16", scheme="tuned", maxiter=60,
             replicate_below=8)
# id -> (port Spec fields, mesh, what the ranks run)
RANK_CASES = {
    "step-tuned-2x2": (dict(size=64, dtype="float64", scheme="tuned", replicate_below=8),
                       (2, 2), "step"),
    "step-tuned-4x1": (dict(size=64, dtype="float64", scheme="tuned", replicate_below=8),
                       (4, 1), "step"),
    "step-reference-2x2": (dict(size=64, dtype="float64", scheme="reference",
                                replicate_below=8), (2, 2), "step"),
    "step-reference-4x1": (dict(size=64, dtype="float64", scheme="reference",
                                replicate_below=8), (4, 1), "step"),
    "step-3d-tuned-2x2": (dict(size=32, ndim=3, dtype="float64", scheme="tuned",
                               replicate_below=8), (2, 2), "step"),
    "solve-tuned-2x2": (dict(size=64, dtype="float64", scheme="tuned", stop="residual",
                             tol=1e-10, replicate_below=8), (2, 2), "solve"),
    "w-step-tuned-2x2": (dict(size=64, dtype="float64", scheme="tuned", cycle="w",
                              stop="residual", replicate_below=8), (2, 2), "step"),
    # mixed-precision refinement under the partition (SpmdCycle.step_mixed):
    # the JAX package's tests/test_mixed_precision.py specs
    "mixed-solve-2x2": (dict(MIXED, stop="residual", tol=1e-8), (2, 2), "solve"),
    "mixed-solve-4x1": (dict(MIXED, stop="residual", tol=1e-8), (4, 1), "solve"),
    "mixed-update-2x2": (dict(MIXED, stop="update", tol=2e-5), (2, 2), "solve"),
    # ... in 3D: the bf16 V-cycle on the plain legs of K11/K12's bf16 forms
    "mixed-3d-solve-2x2": (dict(MIXED, size=32, ndim=3, stop="residual", tol=1e-8), (2, 2),
                           "solve"),
    "mixed-3d-solve-4x1": (dict(MIXED, size=32, ndim=3, stop="residual", tol=1e-8), (4, 1),
                           "solve"),
    "f64-f32-sweeps-4x1": (dict(size=64, dtype="float64", sweep_dtype="float32",
                                scheme="tuned", stop="residual", tol=1e-10,
                                replicate_below=8), (4, 1), "solve"),
}
# held against the port's own single-device step only: the JAX package's
# spmd W-cycle takes about a minute to compile on the CPU
PORT_ONLY = ("w-step-tuned-2x2",)


def _rank_main(rank, store, out_path):
    """One rank: every case of RANK_CASES, the results gathered; rank 0
    saves them.  One thread per rank: the 4 ranks share the test worker's
    cores."""
    torch.set_num_threads(1)
    multihost.initialize("gloo", f"file://{store}", WORLD, rank,
                         timeout=datetime.timedelta(seconds=120))
    try:
        results = {}
        for cid, (kw, mesh_shape, what) in RANK_CASES.items():
            mg = mgpoisson_torch.MultigridPoisson(
                mgpoisson_torch.Spec(**kw, mesh_shape=mesh_shape), device="cpu")
            f = mg.rhs()
            full = lambda x: multihost.gather_global(x, mg.mesh).numpy()
            if what == "step":
                psi = mg.init_state(f)
                psi_new, err = mg.step(psi, f)
                results[cid] = {"psi": full(psi_new), "err": float(err),
                                "rel_err": float(mg.rel_err(psi_new, psi)),
                                "rnorm": float(mg.residual_norm(psi_new, f)),
                                "f": full(f)}
            else:
                res = mg.solve()
                results[cid] = {"psi": full(res.psi), "iterations": res.iterations,
                                "errs": res.errs.numpy(), "converged": res.converged,
                                "psi_shape": tuple(res.psi.shape)}
        try:
            build_mesh((2, 3))
            results["bad_mesh"] = None
        except ValueError as e:
            results["bad_mesh"] = str(e)
        if rank == 0:
            torch.save(results, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spmd_results(tmp_path_factory):
    """One spawn of 4 gloo ranks on the CPU for every case (a file:// store
    under the test's own directory: no port to collide on)."""
    d = tmp_path_factory.mktemp("spmd")
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d / "results.pt")),
                       nprocs=WORLD, join=True, start_method="spawn")
    return torch.load(d / "results.pt", weights_only=False)


def _jax_pair(kw, mesh_shape):
    import mgpoisson
    spec = mgpoisson.Spec(backend="xla", **kw)
    return (mgpoisson.MultigridPoisson(spec.with_(mesh_shape=mesh_shape, partition="spmd")),
            mgpoisson.MultigridPoisson(spec))


@pytest.mark.parametrize("cid", [c for c, v in RANK_CASES.items()
                                 if v[2] == "step" and c not in PORT_ONLY])
def test_sharded_step_matches_jax(spmd_results, cid):
    """One step from psi0 = -f on 4 ranks equals the JAX package's spmd
    step and its single-device step (tests/test_shard.py's tolerances)."""
    kw, mesh_shape, _ = RANK_CASES[cid]
    got = spmd_results[cid]
    mgN, mg1 = _jax_pair(kw, mesh_shape)
    f = mg1.rhs()
    psi = mg1.init_state(f)
    np.testing.assert_array_equal(got["f"], np.asarray(f))
    for mg in (mgN, mg1):
        psi_new, err = mg.step(psi, f)
        np.testing.assert_allclose(got["psi"], np.asarray(psi_new), rtol=1e-12, atol=1e-10)
        np.testing.assert_allclose(got["err"], float(err), rtol=1e-12)
    np.testing.assert_allclose(got["rel_err"], float(mg1.rel_err(psi_new, psi)), rtol=1e-12)
    np.testing.assert_allclose(got["rnorm"], float(mg1.residual_norm(psi_new, f)),
                               rtol=1e-12)


@pytest.mark.parametrize("cid", PORT_ONLY)
def test_sharded_step_matches_the_single_device_step(spmd_results, cid):
    kw, _, _ = RANK_CASES[cid]
    got = spmd_results[cid]
    mg = mgpoisson_torch.MultigridPoisson(mgpoisson_torch.Spec(**kw), device="cpu")
    f = mg.rhs()
    psi_new, err = mg.step(mg.init_state(f), f)
    np.testing.assert_allclose(got["psi"], psi_new.numpy(), rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(got["err"], float(err), rtol=1e-12)


def test_sharded_solve_matches_jax(spmd_results):
    """The tuned residual-stop solve on 4 ranks: the JAX package's spmd
    cycle count, error history and iterate."""
    kw, mesh_shape, _ = RANK_CASES["solve-tuned-2x2"]
    got = spmd_results["solve-tuned-2x2"]
    rN = _jax_pair(kw, mesh_shape)[0].solve()
    assert got["converged"] and got["iterations"] == rN.iterations
    assert got["psi_shape"] == (32, 32)
    np.testing.assert_allclose(got["errs"], np.asarray(rN.errs), rtol=1e-10)
    np.testing.assert_allclose(got["psi"], np.asarray(rN.psi), rtol=1e-10, atol=1e-8)


def _single_device_solve(kw):
    """The port's single-device solve of the same spec, on the CPU."""
    return mgpoisson_torch.MultigridPoisson(mgpoisson_torch.Spec(**kw), device="cpu").solve()


@pytest.mark.parametrize("cid", ["mixed-solve-2x2", "mixed-solve-4x1", "mixed-3d-solve-2x2"])
def test_sharded_mixed_solve_matches_jax(spmd_results, cid):
    """The mixed residual-stop solve (f32, bf16 sweeps) on 4 ranks, 64^2 or
    32^3: the JAX package's spmd mixed solve's step count within one and
    its psi within 1e-5 normalized (tests/test_mixed_precision.py's bar),
    the first err 1.0 (the incoming iterate's), and the port's
    single-device mixed solve's psi within 1e-6."""
    import mgpoisson
    kw, mesh_shape, _ = RANK_CASES[cid]
    got = spmd_results[cid]
    assert got["converged"] and got["errs"][0] == 1.0 and got["errs"].dtype == np.float32
    rN = mgpoisson.MultigridPoisson(mgpoisson.Spec(backend="xla", mesh_shape=mesh_shape,
                                                   partition="spmd", **kw)).solve()
    assert rN.converged and abs(got["iterations"] - rN.iterations) <= 1
    assert _nmax(got["psi"], np.asarray(rN.psi)) < 1e-5
    r1 = _single_device_solve(kw)
    assert _nmax(got["psi"], r1.psi.numpy()) < 1e-6


def test_sharded_mixed_3d_solve_on_a_mesh_of_one_column(spmd_results):
    """The mixed 32^3 solve on (4, 1) (blocks of whole y planes), held to
    the port's single-device mixed solve only, to spare a second JAX
    compile: its step count and its psi within 1e-6 normalized, the first
    err 1.0 and the history in f32."""
    kw, _, _ = RANK_CASES["mixed-3d-solve-4x1"]
    got = spmd_results["mixed-3d-solve-4x1"]
    assert got["converged"] and got["errs"][0] == 1.0 and got["errs"].dtype == np.float32
    assert got["psi_shape"] == (8, 32, 32)
    r1 = _single_device_solve(kw)
    assert got["iterations"] == r1.iterations
    assert _nmax(got["psi"], r1.psi.numpy()) < 1e-6


def test_sharded_mixed_update_stop(spmd_results):
    """The update-RMS metric of the mixed step on (2, 2): it converges,
    the relative residual of the result is < 1e-3 (the JAX package's bar,
    tests/test_mixed_precision.py), and it takes the port's single-device
    mixed update-stop solve's steps to its psi within 1e-6."""
    kw, _, _ = RANK_CASES["mixed-update-2x2"]
    got = spmd_results["mixed-update-2x2"]
    assert got["converged"]
    spec = mgpoisson_torch.Spec(**kw)
    f = point_charge_rhs(spec.size, spec.ndim, torch.float64, "cpu")
    psi = torch.tensor(got["psi"], dtype=torch.float64)
    assert float(ops.residual_norm(psi, f, spec.fine_h)
                 / ops.residual_norm(torch.zeros_like(f), f, spec.fine_h)) < 1e-3
    r1 = _single_device_solve(kw)
    assert got["iterations"] == r1.iterations
    assert _nmax(got["psi"], r1.psi.numpy()) < 1e-6


def test_sharded_f64_solve_with_f32_sweeps(spmd_results):
    """An f64 solve with f32 sweeps on (4, 1) (the f32 strip legs under
    the refinement step): the port's single-device solve of the same spec,
    psi within 1e-10 normalized."""
    kw, _, _ = RANK_CASES["f64-f32-sweeps-4x1"]
    got = spmd_results["f64-f32-sweeps-4x1"]
    r1 = _single_device_solve(kw)
    assert got["converged"] and got["iterations"] == r1.iterations
    assert got["psi"].dtype == np.float64
    assert _nmax(got["psi"], r1.psi.numpy()) < 1e-10


def test_mesh_must_cover_the_group(spmd_results):
    assert "needs 6 processes" in spmd_results["bad_mesh"]


# ------------------------------------------------- spec, mesh and device

@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shape_for_matches_jax(n):
    from mgpoisson.shard.mesh import mesh_shape_for as jax_mesh_shape_for
    assert mesh_shape_for(n) == jax_mesh_shape_for(n)


@pytest.mark.parametrize("shape,ndim", [((2, 2), 2), ((4, 1), 2), ((2, 2), 3), ((1, 4), 3)])
def test_rhs_block_is_the_slice_of_the_global_rhs(shape, ndim):
    spec = mgpoisson_torch.Spec(size=32, ndim=ndim, mesh_shape=shape)
    whole = point_charge_rhs(32, ndim, device="cpu")
    blocks = []
    for rank in range(shape[0] * shape[1]):
        mesh = _fake_mesh(shape, rank)
        block = mgpoisson_torch.MultigridPoisson(spec, device="cpu", mesh=mesh).rhs()
        torch.testing.assert_close(block, whole[spmd.block_slices(32, mesh)], rtol=0, atol=0)
        blocks.append(block)
    assert sum(int((b != 0).sum()) for b in blocks) == 1


def test_state_from_numpy_gives_the_block():
    rng = np.random.default_rng(3)
    psi, f = rng.normal(size=(2, 16, 16))
    mesh = _fake_mesh((2, 2), 3)
    pb, fb = state_from_numpy(psi, f, "cpu", "float64", mesh=mesh)
    np.testing.assert_array_equal(pb.numpy(), psi[8:, 8:])
    np.testing.assert_array_equal(fb.numpy(), f[8:, 8:])


def test_sharded_solver_without_a_card_raises(monkeypatch):
    """Under a mesh too the default device is this rank's card; without one
    the solver raises, unless told device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = mgpoisson_torch.Spec(size=16, mesh_shape=(2, 2))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mgpoisson_torch.MultigridPoisson(spec, mesh=_fake_mesh((2, 2), 0))
    mg = mgpoisson_torch.MultigridPoisson(spec, device="cpu", mesh=_fake_mesh((2, 2), 0))
    assert mg.device.type == "cpu" and mg.partition == "spmd"


def test_mesh_without_process_group_raises():
    spec = mgpoisson_torch.Spec(size=16, mesh_shape=(2, 2))
    with pytest.raises(RuntimeError, match="not initialized"):
        mgpoisson_torch.MultigridPoisson(spec, device="cpu")


def test_gspmd_has_no_torch_counterpart():
    with pytest.raises(NotImplementedError, match="XLA's SPMD partitioner"):
        mgpoisson_torch.Spec(size=16, mesh_shape=(2, 2), partition="gspmd")
