"""The pure bf16 solve under the partition, and the per-process checkpoint
files of a sharded solve, on 4 gloo ranks on the CPU.

- Pure bf16 (``Spec(dtype="bfloat16", mesh_shape=...)``, ``SpmdCycle.step``
  on bf16 blocks): every sharded leg equals its whole-grid leg bit for bit
  (tests/test_torch_spmd_bf16.py) and the replicated coarse levels run the
  single-device cycle, so the gathered psi equals the port's single-device
  pure bf16 solve's bit for bit, cycle for cycle; only the relres differs,
  by the order of the sum(r^2) over the blocks.  The history is held to the
  JAX package's spmd solve (partition="spmd") at its bf16 bar.
- L2, the r0 of a sharded bf16 solve (``SpmdCycle.residual_norm``) against
  the JAX solver's ``residual_norm``.
- Checkpoints (``mgpoisson_torch.utils.checkpoint``): each rank writes its
  block to ``<path>.proc<rank>.npz`` in the JAX package's layout; the JAX
  loader reads rank 0's, the port reads the JAX package's forced-sharded
  file of a (4, 2) mesh, and a resume on 4 ranks lands on the
  uninterrupted sharded solve.

One spawn of 4 ranks runs every case.  The ranks re-import this module, so
its top level imports torch, numpy, pytest and the port only.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import mgpoisson_torch
from mgpoisson_torch.shard import multihost, spmd
from mgpoisson_torch.utils import checkpoint

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

WORLD = 4
PURE = dict(dtype="bfloat16", scheme="tuned", stop="residual", tol=1e-30, maxiter=4,
            replicate_below=8)
PURE_CASES = {"64-2x2": (dict(PURE, size=64), (2, 2)),
              "64-4x1": (dict(PURE, size=64), (4, 1)),
              "32^3-2x2": (dict(PURE, size=32, ndim=3), (2, 2))}
# the resumed sharded solve: two steps, a checkpoint, resume_solve
RESUME = (dict(size=64, dtype="float64", scheme="tuned", stop="residual", tol=1e-10,
               replicate_below=8), (2, 2))
BF16_BAR = 5e-2            # the JAX package's bf16 bar (tests/test_torch_bf16.py)
# the pure bf16 solves whose result the ranks also checkpoint, 2D and 3D
CKPT_NAMES = {"64-2x2": "bf16", "32^3-2x2": "bf16_3d"}


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


def _rank_main(rank, store, out_dir):
    """One rank: the pure bf16 solves (r0, history, gathered psi), their
    checkpoint, and the resumed f64 solve; rank 0 saves the results (one
    thread per rank: the module's torch.set_num_threads runs in each)."""
    multihost.initialize("gloo", f"file://{store}", WORLD, rank,
                         timeout=datetime.timedelta(seconds=120))
    try:
        results = {}
        for cid, (kw, mesh_shape) in PURE_CASES.items():
            mg = mgpoisson_torch.MultigridPoisson(
                mgpoisson_torch.Spec(**kw, mesh_shape=mesh_shape), device="cpu")
            f = mg.rhs()
            psi0 = mg.init_state(f)
            # the parent's r0: sum(r^2) accumulated in f32, the root in f32
            r2 = spmd.all_reduce_sum(spmd.residual_sq_sum(psi0, f, mg.spec.fine_h, mg.mesh),
                                     mg.mesh)
            steps = []
            res = mg.solve(error_callback=lambda it, err, psi: steps.append(
                _bits(multihost.gather_global(psi, mg.mesh))) and False)
            results[cid] = {"r0": float(mg.residual_norm(psi0, f)),
                            "r0_parent": float(torch.sqrt(r2).to(torch.bfloat16)),
                            "errs": res.errs.numpy(), "iterations": res.iterations,
                            "psi_steps": steps, "psi_dtype": str(res.psi.dtype),
                            "block": tuple(res.psi.shape)}
            if cid in CKPT_NAMES:
                path = f"{out_dir}/{CKPT_NAMES[cid]}"
                checkpoint.save_state(path, res.psi, f=f, iteration=res.iterations,
                                      errs=res.errs, mesh=mg.mesh)
                state = checkpoint.load_state(path, mesh=mg.mesh, device="cpu")
                results[f"{cid}_reload"] = (
                    state["psi"].dtype == torch.bfloat16
                    and np.array_equal(_bits(state["psi"]), _bits(res.psi))
                    and np.array_equal(_bits(state["f"]), _bits(f)))

        kw, mesh_shape = RESUME
        mg = mgpoisson_torch.MultigridPoisson(
            mgpoisson_torch.Spec(**kw, mesh_shape=mesh_shape), device="cpu")
        f = mg.rhs()
        psi = mg.init_state(f)
        for _ in range(2):
            psi, _ = mg.step(psi, f)
        path = f"{out_dir}/resume"
        checkpoint.save_state(path, psi, f=f, iteration=2, errs=[1.0, 0.5], mesh=mg.mesh)
        state = checkpoint.load_state(path, mesh=mg.mesh, device="cpu")
        reload_ok = torch.equal(state["psi"], psi) and torch.equal(state["f"], f)
        resumed = checkpoint.resume_solve(mg, path)
        # sharded=False under a mesh: the whole grid gathered, rank 0 writes
        # one file, from which each rank resumes on its block
        checkpoint.save_state(f"{out_dir}/whole.npz", psi, f=f, iteration=2, mesh=mg.mesh,
                              sharded=False)
        dist.barrier()
        resumed_whole = checkpoint.resume_solve(mg, f"{out_dir}/whole.npz")
        full = mg.solve()
        whole_ok = (torch.equal(resumed_whole.psi, resumed.psi)
                    and resumed_whole.iterations == resumed.iterations)
        results["resume"] = {
            "reload": reload_ok, "iteration": state["iteration"],
            "resumed": multihost.gather_global(resumed.psi, mg.mesh).numpy(),
            "resumed_converged": resumed.converged,
            "full": multihost.gather_global(full.psi, mg.mesh).numpy(),
            "full_converged": full.converged,
            "psi2": multihost.gather_global(psi, mg.mesh).numpy()}
        oks = [None] * WORLD
        dist.all_gather_object(oks, tuple(results[f"{c}_reload"] for c in CKPT_NAMES)
                               + (reload_ok, whole_ok))
        results["reload_all_ranks"] = oks
        if rank == 0:
            torch.save(results, f"{out_dir}/results.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of 4 gloo ranks for every case (a file:// store under the
    module's own directory)."""
    d = tmp_path_factory.mktemp("spmd_bf16_solve")
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d)),
                       nprocs=WORLD, join=True, start_method="spawn")
    return d, torch.load(d / "results.pt", weights_only=False)


@pytest.fixture(scope="module")
def single():
    """The port's single-device pure bf16 solves, psi after every cycle."""
    out = {}
    for cid, (kw, _) in PURE_CASES.items():
        mg = mgpoisson_torch.MultigridPoisson(mgpoisson_torch.Spec(**kw), device="cpu")
        steps = []
        res = mg.solve(error_callback=lambda it, err, psi: steps.append(_bits(psi)) and False)
        out[cid] = (res, steps)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's spmd pure bf16 solves (8 virtual CPU devices,
    tests/conftest.py), built and run once per module: (solver, errs)."""
    import mgpoisson
    out = {}
    for cid, (kw, mesh_shape) in PURE_CASES.items():
        mg = mgpoisson.MultigridPoisson(mgpoisson.Spec(backend="xla", **kw,
                                                       mesh_shape=mesh_shape,
                                                       partition="spmd"))
        out[cid] = (mg, np.asarray(mg.solve().errs, np.float64))
    return out


@pytest.mark.parametrize("cid", PURE_CASES)
def test_pure_bf16_psi_equals_the_single_device_solve(ranks, single, cid):
    """Every cycle's gathered psi bit for bit the single-device pure bf16
    solve's; the relres within one bf16 ulp of its (the Sigma r^2 of the
    blocks summed in another order); bf16 blocks, an f32 history."""
    got = ranks[1][cid]
    res, steps = single[cid]
    assert got["iterations"] == res.iterations == PURE["maxiter"]
    assert len(got["psi_steps"]) == len(steps) == res.iterations
    for k, (a, b) in enumerate(zip(got["psi_steps"], steps)):
        assert np.array_equal(a, b), f"cycle {k + 1}"
    assert got["psi_dtype"] == "torch.bfloat16" and got["errs"].dtype == np.float32
    kw, mesh_shape = PURE_CASES[cid]
    n = kw["size"]
    assert got["block"] == (n // mesh_shape[0], n // mesh_shape[1]) + (n,) * (kw.get("ndim", 2) - 2)
    np.testing.assert_allclose(got["errs"], res.errs.numpy(), rtol=2 ** -7)


@pytest.mark.parametrize("cid", PURE_CASES)
def test_pure_bf16_history_matches_jax_spmd(ranks, jax_runs, cid):
    """The relres history within the JAX package's bf16 bar (5e-2,
    normalized by the history's largest) of its spmd solve, cycle 1 within
    5 %; pure bf16 stalls (BENCH_extras.json bf16_solve_cycles), so the
    solve runs its 4 cycles at tol 1e-30 on both sides."""
    got = ranks[1][cid]["errs"].astype(np.float64)
    want = jax_runs[cid][1]
    assert len(got) == len(want) == PURE["maxiter"]
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= BF16_BAR
    assert abs(got[0] - want[0]) <= BF16_BAR * want[0]


@pytest.mark.parametrize("cid", ["64-2x2", "64-4x1"])
def test_l2_sharded_bf16_r0_sums_as_jax(ranks, jax_runs, cid):
    """L2: the partition's bf16 r0 (SpmdCycle.residual_norm of psi0 = -f)
    sums as the JAX solver's residual_norm does: the squares in bf16, the
    sum in f32 rounded once to bf16 (XLA on the CPU reduces a bf16 array
    so: f32 accumulation, one rounding), the root in bf16.  Here both give
    18387828736.0, and the bar is one bf16 ulp (2^-7 relative).  The
    parent's formula (the squares, the sum and the root in f32, rounded to
    bf16 at the end) gives 18253611008.0, one ulp (134217728) below: L2
    shows on the CPU at 64^2 from the point charge's -f guess as a one-ulp
    difference, inside the bar, which the repair removes."""
    import jax.numpy as jnp
    mg_j = jax_runs[cid][0]
    f = mg_j.rhs()
    want = float(mg_j.residual_norm(mg_j.init_state(f), f))
    got = ranks[1][cid]
    assert mg_j.init_state(f).dtype == jnp.bfloat16
    assert abs(got["r0"] - want) <= 2 ** -7 * want
    assert got["r0"] == want == 18387828736.0
    assert got["r0_parent"] == 18253611008.0 == want - 2 ** 27


def test_spec_admits_bf16_under_a_mesh():
    """A4b opened: dtype='bfloat16' under a mesh no longer raises; the JAX
    package's refusals under a mesh still raise, with its exception type."""
    import mgpoisson
    for kw in (dict(dtype="bfloat16", mesh_shape=(2, 2)),
               dict(dtype="bfloat16", ndim=3, mesh_shape=(4, 1)),
               dict(dtype="bfloat16", scheme="fast", cycle="fmg", mesh_shape=(4, 1)),
               dict(dtype="bfloat16", stop="residual", stop_check="adaptive",
                    mesh_shape=(2, 2))):
        mgpoisson.Spec(size=64, **kw)
        mgpoisson_torch.Spec(size=64, **kw)
    for kw in (dict(dtype="bfloat16", smoother="gs_lex", scheme="reference",
                    mesh_shape=(2, 2)),
               dict(dtype="bfloat16", stop_check="adaptive", mesh_shape=(2, 2))):
        with pytest.raises(ValueError) as jax_err:
            mgpoisson.Spec(size=64, **kw)
        with pytest.raises(ValueError) as port_err:
            mgpoisson_torch.Spec(size=64, **kw)
        assert str(port_err.value) == str(jax_err.value)


# -------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("cid", CKPT_NAMES)
def test_rank_files_carry_the_jax_layout(ranks, cid):
    """Four files, one block each: <name>_global_shape, <name>_shard0 and
    its start (the block origin, 0 on the uncut axis in 3D), the scalars;
    every rank reloads its own block bit for bit (bf16 as |V2 voids)."""
    d, res = ranks
    assert res["reload_all_ranks"] == [(True,) * (len(CKPT_NAMES) + 2)] * WORLD
    kw, mesh_shape = PURE_CASES[cid]
    n, ndim = kw["size"], kw.get("ndim", 2)
    block = (n // mesh_shape[0], n // mesh_shape[1]) + (n,) * (ndim - 2)
    for rank in range(WORLD):
        with np.load(d / f"{CKPT_NAMES[cid]}.proc{rank}.npz") as z:
            assert sorted(z.files) == sorted(
                ["iteration", "errs"] + [f"{k}_{s}" for k in ("psi", "f")
                                         for s in ("global_shape", "shard0", "shard0_start")])
            np.testing.assert_array_equal(z["psi_global_shape"], [n] * ndim)
            cx, cy = divmod(rank, mesh_shape[1])
            np.testing.assert_array_equal(z["psi_shard0_start"],
                                          [block[0] * cx, block[1] * cy] + [0] * (ndim - 2))
            assert z["psi_shard0"].dtype == np.dtype("V2") and z["psi_shard0"].shape == block
            assert int(z["iteration"]) == PURE["maxiter"]
    assert not (d / CKPT_NAMES[cid]).exists()


def test_jax_loader_reads_rank_0s_file(ranks):
    """The JAX load_state(path), process 0 and no mesh, gives rank 0's
    block, with psi_global_shape, bit for bit: the bf16 64^2 and 32^3
    files, and the f64 one of the resumed solve."""
    from mgpoisson.utils import load_state as jax_load
    d, res = ranks
    for cid, name in CKPT_NAMES.items():
        state = jax_load(str(d / name))
        n, ndim = PURE_CASES[cid][0]["size"], PURE_CASES[cid][0].get("ndim", 2)
        assert state["psi_global_shape"] == (n,) * ndim
        assert state["iteration"] == PURE["maxiter"]
        whole = res[cid]["psi_steps"][-1]
        np.testing.assert_array_equal(state["psi"].view(np.int16), whole[:n // 2, :n // 2])
    state = jax_load(str(d / "resume"))
    np.testing.assert_array_equal(state["psi"], res["resume"]["psi2"][:32, :32])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_loads_the_jax_sharded_file(tmp_path, dtype):
    """The JAX package's forced-sharded file of a (4, 2) mesh (8 shards in
    proc0, tests/test_utils.py) loads in the port without a mesh as the
    whole grid, bit for bit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mgpoisson.shard.mesh import build_mesh
    from mgpoisson.utils import save_state as jax_save
    mesh = build_mesh((4, 2))
    rng = np.random.default_rng(4)
    a = jnp.asarray(rng.normal(size=(32, 32)), dtype=dtype)
    g = jax.device_put(a, NamedSharding(mesh, P("x", "y")))
    jax_save(str(tmp_path / "ck"), g, f=g, iteration=1, errs=[2.0], sharded=True)
    with np.load(tmp_path / "ck.proc0.npz") as z:
        assert sum(k.startswith("psi_shard") and not k.endswith("_start") for k in z.files) == 8
    state = checkpoint.load_state(str(tmp_path / "ck"))
    assert state["psi_global_shape"] == (32, 32) and state["iteration"] == 1
    want = np.asarray(a)
    if dtype == "bfloat16":
        assert state["psi"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(state["psi"]), want.view(np.int16))
    else:
        np.testing.assert_array_equal(state["psi"], want)


def test_sharded_resume_lands_on_the_uninterrupted_solve(ranks):
    """Two steps on (2, 2), the rank files, resume_solve on the 4 ranks: it
    converges, within 1e-6 (max-normalized) of the uninterrupted sharded
    solve's psi (tests/test_utils.py's bar).  The same state saved with
    sharded=False (the whole grid in one file, which the JAX loader reads)
    resumes on the ranks' blocks to the same psi bit for bit."""
    from mgpoisson.utils import load_state as jax_load
    d, res = ranks
    r = res["resume"]
    assert r["reload"] and r["iteration"] == 2
    assert all(ok[-1] for ok in res["reload_all_ranks"])      # the whole-file resume
    whole = jax_load(str(d / "whole.npz"))
    np.testing.assert_array_equal(whole["psi"], r["psi2"])
    assert not list(d.glob("whole.npz.proc*"))
    assert r["resumed_converged"] and r["full_converged"]
    a, b = r["resumed"], r["full"]
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-6
