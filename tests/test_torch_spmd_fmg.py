"""FMG and the adaptive stop under the explicit partition, on the CPU.

One spawn of 4 gloo ranks runs every case of RANK_CASES through
MultigridPoisson with a mesh.  Each is held to the JAX package's solver of
the same Spec (backend 'xla', one device: the JAX package's own
tests/test_shard.py holds its sharded FMG and adaptive solves to that), and
to the port's single-device solver:

- FMG (``SpmdCycle.fmg``): the initial iterate and the solve, f64, at 64^2
  on (2, 2) with replicate_below=8 for the tuned and reference schemes,
  with a finest level at or below replicate_below (32^2, replicated, sliced
  back), and 16^3 (the 3D block prolongation), within the JAX package's
  bar for the same comparison (tests/test_shard.py: rtol 1e-11, atol 1e-9);
- the adaptive stop on (2, 2): the JAX package's iterations, metric
  evaluations, error history (skipped entries too) and iterate, and the
  every-cycle stop's count with fewer metric evaluations;
- the fast scheme's packed fine level on (4, 1) (MGPOISSON_PACKED=1 in the
  ranks) under the adaptive stop, to a stop at maxiter on a skipped cycle:
  the packed bare cycles and the remeasure of the packed blocks, with the
  JAX package's decisions (its packed fine level needs a TPU, so its
  unpacked f32 solve is the reference).

The ranks re-import this module, so its top level imports torch, numpy,
pytest and the port only; JAX and mgpoisson are imported inside the
tests.
"""

import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import mgpoisson_torch
from mgpoisson_torch.shard import multihost

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

WORLD = 4
FMG = dict(size=64, dtype="float64", scheme="tuned", cycle="fmg", maxiter=6,
           replicate_below=8)
ADAPTIVE = dict(size=64, dtype="float64", scheme="tuned", stop="residual", tol=1e-10,
                replicate_below=8)
# id -> (port Spec fields, mesh)
RANK_CASES = {
    "fmg-tuned": (FMG, (2, 2)),
    "fmg-reference": (dict(FMG, scheme="reference"), (2, 2)),
    "fmg-replicated": (dict(FMG, size=32, replicate_below=64), (2, 2)),
    "fmg-3d": (dict(FMG, size=16, ndim=3, replicate_below=4), (2, 2)),
    "adaptive": (dict(ADAPTIVE, stop_check="adaptive"), (2, 2)),
    "every": (ADAPTIVE, (2, 2)),
    "packed-adaptive": (dict(size=256, scheme="fast", stop="residual", stop_check="adaptive",
                             tol=1e-30, maxiter=6), (4, 1)),
}


def _rank_main(rank, store, out_path):
    """One rank: every case's solve (and, for FMG, init_state) on its block,
    gathered; rank 0 saves the results."""
    torch.set_num_threads(1)
    os.environ["MGPOISSON_PACKED"] = "1"
    multihost.initialize("gloo", f"file://{store}", WORLD, rank,
                         timeout=datetime.timedelta(seconds=120))
    try:
        results = {}
        for cid, (kw, mesh_shape) in RANK_CASES.items():
            mg = mgpoisson_torch.MultigridPoisson(
                mgpoisson_torch.Spec(**kw, mesh_shape=mesh_shape), device="cpu")
            out = {"packed": mg._packed}
            out["f"] = multihost.gather_global(mg.rhs(), mg.mesh).numpy()
            if mg.spec.cycle == "fmg":
                u0 = mg.init_state()
                out["u0_block"] = tuple(u0.shape)
                out["u0"] = multihost.gather_global(u0, mg.mesh).numpy()
            res = mg.solve()
            out.update(iterations=res.iterations, errs=res.errs.numpy(),
                       converged=res.converged, n_metric_evals=res.n_metric_evals,
                       final_err=res.final_err,
                       psi=multihost.gather_global(res.psi, mg.mesh).numpy())
            results[cid] = out
        if rank == 0:
            torch.save(results, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spmd_results(tmp_path_factory):
    """One spawn of 4 gloo ranks on the CPU for every case."""
    d = tmp_path_factory.mktemp("spmd_fmg")
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d / "results.pt")),
                       nprocs=WORLD, join=True, start_method="spawn")
    return torch.load(d / "results.pt", weights_only=False)


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's JAX solver (backend 'xla', one device) on the same Spec,
    built and run once per module: its rhs, and its FMG iterate (FMG cases;
    the FMG solve is held to the JAX package's in tests/test_torch_fmg.py)
    or its solve."""
    cache = {}

    def run(cid):
        if cid not in cache:
            import mgpoisson
            kw, _ = RANK_CASES[cid]
            mg = mgpoisson.MultigridPoisson(mgpoisson.Spec(backend="xla", **kw))
            out = {"f": np.asarray(mg.rhs())}
            if kw.get("cycle") == "fmg":
                out["u0"] = np.asarray(mg.init_state())
            else:
                res = mg.solve()
                out.update(iterations=res.iterations, n_metric_evals=res.n_metric_evals,
                           converged=bool(res.converged), errs=np.asarray(res.errs),
                           psi=np.asarray(res.psi))
            cache[cid] = out
        return cache[cid]
    return run


def _single(cid, monkeypatch=None):
    """The single-device solver of a case's Spec (no mesh)."""
    if monkeypatch is not None:
        monkeypatch.setenv("MGPOISSON_PACKED", "1")
    kw, _ = RANK_CASES[cid]
    return mgpoisson_torch.MultigridPoisson(mgpoisson_torch.Spec(**kw), device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-11, atol=1e-9)


@pytest.mark.parametrize("cid", ["fmg-tuned", "fmg-reference", "fmg-3d"])
def test_fmg_matches_the_single_device_fmg(spmd_results, jax_runs, cid):
    got, jx = spmd_results[cid], jax_runs(cid)
    np.testing.assert_array_equal(got["f"], jx["f"])
    _close(got["u0"], jx["u0"])
    mg = _single(cid)
    want0 = mg.init_state()
    _close(got["u0"], want0)
    want = mg.solve()
    assert got["iterations"] == want.iterations == mg.spec.maxiter
    np.testing.assert_allclose(got["errs"], want.errs.numpy(), rtol=1e-10)
    _close(got["psi"], want.psi)


def test_fmg_with_a_replicated_finest_level_keeps_the_rank_block(spmd_results, jax_runs):
    """size <= replicate_below: the whole FMG pass runs replicated and each
    rank keeps its block of the result."""
    got, jx = spmd_results["fmg-replicated"], jax_runs("fmg-replicated")
    assert got["u0_block"] == (16, 16)
    np.testing.assert_array_equal(got["f"], jx["f"])
    _close(got["u0"], jx["u0"])
    mg = _single("fmg-replicated")
    _close(got["u0"], mg.init_state())
    _close(got["psi"], mg.solve().psi)


def test_adaptive_stop_under_a_mesh(spmd_results, jax_runs):
    """The JAX package's adaptive solve of the same Spec, decision for
    decision; the every-cycle stop's count and iterate with fewer metric
    evaluations (the JAX package's tests/test_shard.py); and the decisions
    of the port's single-device adaptive solve."""
    got, jx = spmd_results["adaptive"], jax_runs("adaptive")
    assert got["converged"] and jx["converged"]
    assert (got["iterations"], got["n_metric_evals"]) == (jx["iterations"],
                                                          jx["n_metric_evals"])
    # every entry, the skipped ones' predictions too
    np.testing.assert_allclose(got["errs"], jx["errs"], rtol=1e-10)
    _close(got["psi"], jx["psi"])
    every = spmd_results["every"]
    assert got["converged"] and got["iterations"] == every["iterations"]
    assert got["n_metric_evals"] < got["iterations"]
    np.testing.assert_allclose(got["psi"], every["psi"], rtol=1e-12)
    np.testing.assert_allclose(got["errs"][-1], every["errs"][-1], rtol=1e-10)
    want = _single("adaptive").solve()
    assert (got["iterations"], got["n_metric_evals"]) == (want.iterations, want.n_metric_evals)
    np.testing.assert_allclose(got["errs"], want.errs.numpy(), rtol=1e-10)
    np.testing.assert_allclose(got["psi"], want.psi.numpy(), rtol=1e-11, atol=1e-9)


def test_packed_adaptive_stop_on_a_mesh_of_one_column(spmd_results, jax_runs, monkeypatch):
    """Cycles 1 and 5 measured, the rest skipped on the packed blocks, the
    returned iterate remeasured from them: the JAX package's decisions (its
    unpacked solve; the packed sweep order moves a relres by up to 5 %, the
    bar of tests/test_torch_adaptive.py), and the single-device packed
    solve's decisions and iterate."""
    got, jx = spmd_results["packed-adaptive"], jax_runs("packed-adaptive")
    assert (jx["iterations"], jx["n_metric_evals"], jx["converged"]) == (6, 3, False)
    np.testing.assert_allclose(got["errs"], jx["errs"], rtol=5e-2)
    mg = _single("packed-adaptive", monkeypatch)
    assert got["packed"] and mg._packed
    want = mg.solve()
    assert got["iterations"] == want.iterations == 6 and not got["converged"]
    assert got["n_metric_evals"] == want.n_metric_evals == 3
    np.testing.assert_allclose(got["errs"], want.errs.numpy(), rtol=1e-4)
    psi = want.psi.numpy()
    assert np.max(np.abs(got["psi"] - psi)) / np.max(np.abs(psi)) <= 1e-5
