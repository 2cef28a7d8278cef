"""MultigridPoisson.solve_batched under the partition, on 4 gloo ranks on
the CPU.

Under a mesh a rank hands solve_batched its block of every element and
the batch loops over the elements with the partition's step
(``SpmdCycle.step`` or ``step_mixed``), its decisions read from the
all-reduced errs.  Held here:

- f64, against the JAX package's mesh batch (``partition="spmd"`` on the
  tests' virtual CPU devices, which vmaps its spmd step over global
  arrays): the gathered psis, the errs, and each element's cycle count
  equal to its own sharded ``solve()``'s, whose psi it gives bit for bit;
  tuned 128^2 on (2, 2) and (4, 1) (the fine level on the sharded legs),
  16^3 on (2, 2), 32^2 on (4, 1) (the replicated cycle takes the fine
  level) and the fast scheme there;
- f32 with bf16 sweeps (``step_mixed``) against the port's single-device
  mixed batch, and pure bf16 against the port's single-device bf16 batch
  bit for bit (a bf16 psi is held to the port, not to JAX's);
- the decisions: errs bit-equal on every rank, a frozen element's psi,
  a NaN in one rank's block of one element, a fixed cycle count (no
  read), maxiter, and the ValueError of a global-shaped batch.

One spawn of 4 ranks runs every case while the parent builds the
references; the ranks re-import this module, so its top level imports
torch, numpy, pytest and the port only.
"""

import contextlib
import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import mgpoisson_torch
from mgpoisson_torch.core.rhs import point_charge_rhs
from mgpoisson_torch.shard import multihost, spmd
from mgpoisson_torch.solver import multigrid

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

WORLD = 4
# a rank waits at most this long in a collective, the parent at most
# SPAWN_TIMEOUT for the ranks: a rank-divergent decision fails, not hangs
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)
SPAWN_TIMEOUT = 240.0

PSI_TOL = 1e-11            # gathered psi against the JAX mesh batch's, max-normalized
ERRS_RTOL = 1e-10          # errs against the JAX mesh batch's, relative, over
ERRS_ATOL = 1e-19          # ... the f64 rounding floor of a relres near 3e-11:
# eps * ||f|| / ||r(-f)|| ~ 5e-20 at 32^2.  There a last-ulp difference in
# psi moves the final relres by ~2e-10 relative (6.3e-21 absolute: the
# port's 32^2 batch on (4, 1) against JAX's mesh batch); JAX's own fast
# 32^2 batch on (4, 1) parts from its unsharded batch at that level too
BF16_TOL = 5e-2            # the JAX package's bf16 bar (tests/test_torch_batched.py)
STEP_RTOL = 0.5            # a mixed step's err (tests/test_torch_batched.py)

F64 = dict(dtype="float64", scheme="tuned", stop="residual", tol=1e-10)
# (spec keywords, mesh, rhs kind).  replicate_below=8 keeps the fine level
# of the small grids on the sharded legs; at its default (64) the 32^2
# fine level goes to the replicated cycle
JAX_CASES = {
    "128-2x2": (dict(F64, size=128), (2, 2), "three"),
    "128-4x1": (dict(F64, size=128), (4, 1), "three"),
    "16^3-2x2": (dict(F64, size=16, ndim=3, replicate_below=8), (2, 2), "three"),
    "32-4x1": (dict(F64, size=32), (4, 1), "three"),
    "fast32-4x1": (dict(F64, size=32, scheme="fast"), (4, 1), "three"),
}
PORT_CASES = {
    # f32 with bf16 sweeps, tests/test_torch_batched.py's mixed16
    "mixed16-2x2": (dict(size=16, dtype="float32", sweep_dtype="bfloat16", stop="residual",
                         tol=1e-6, replicate_below=8), (2, 2), "noise32"),
    # pure bf16 stalls: 4 cycles at tol 1e-30
    "bf16-32-2x2": (dict(size=32, dtype="bfloat16", scheme="tuned", stop="residual",
                         tol=1e-30, maxiter=4, replicate_below=8), (2, 2), "two"),
    # tests/test_torch_batched.py's freeze32: the copy at 1e-6 of the
    # amplitude meets the absolute update tol in fewer cycles
    "freeze32-2x2": (dict(size=32, dtype="float64", stop="update", tol=1e-9, maxiter=60,
                          replicate_below=8), (2, 2), "freeze"),
}
CASES = {**JAX_CASES, **PORT_CASES}
# the decision cases: a tuned f64 32^2 batch on (2, 2), sharded fine level
DECIDE = (dict(F64, size=32, replicate_below=8), (2, 2))
NAN_RANK, NAN_ELEMENT = 2, 1


def _noise(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


def _global_fs(kind, n, ndim):
    """The batch's whole-grid RHS, f64: 'three' is a point charge, the same
    perturbed by seeded noise, and seeded noise; 'two' the first and the
    last; 'noise32' seed 0's noise in f32; 'freeze' 1e-6 of seed 7's noise
    and that noise."""
    shape = (n,) * ndim
    if kind == "noise32":
        return _noise(0, (3,) + shape).astype(np.float32)
    if kind == "freeze":
        hard = _noise(7, shape)
        return np.stack([1e-6 * hard, hard])
    pc = point_charge_rhs(n, ndim, torch.float64, "cpu").numpy()
    three = np.stack([pc, pc + _noise(1, shape), _noise(2, shape)])
    return three[[0, 2]] if kind == "two" else three


def _case_fs(cid):
    kw, _, kind = CASES[cid]
    return _global_fs(kind, kw["size"], kw.get("ndim", 2))


def _blocks(fs, mesh, dtype):
    """This rank's block of every element of the whole-grid batch fs."""
    sl = spmd.block_slices(fs.shape[1], mesh)
    return torch.as_tensor(np.ascontiguousarray(fs[(slice(None),) + sl])).to(dtype)


def _counting(mg, fs):
    """Wrap mg._step to count its calls per element of fs (by the address
    of the element's f, a view of fs); returns the counts."""
    counts = [0] * fs.shape[0]
    step, base, stride = mg._step, fs.data_ptr(), fs[0].numel() * fs.element_size()

    def counted(psi, f, r0):
        counts[(f.data_ptr() - base) // stride] += 1
        return step(psi, f, r0)
    mg._step = counted
    return counts


@contextlib.contextmanager
def _counting_reads():
    """Wrap the loop's two device->host reads for the block; yields the
    list of the kinds read."""
    reads = []
    read_scalar, read_errs = multigrid.read_scalar, multigrid.read_errs
    multigrid.read_scalar = lambda t: reads.append("scalar") or read_scalar(t)
    multigrid.read_errs = lambda t: reads.append("errs") or read_errs(t)
    try:
        yield reads
    finally:
        multigrid.read_scalar, multigrid.read_errs = read_scalar, read_errs


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _solver(kw, mesh_shape):
    return mgpoisson_torch.MultigridPoisson(mgpoisson_torch.Spec(**kw, mesh_shape=mesh_shape),
                                            device="cpu")


def _run_case(cid):
    """One case's batch on this rank, and each element's own sharded
    solve(): what every rank returns, with the gathered psis."""
    kw, mesh_shape, _ = CASES[cid]
    mg = _solver(kw, mesh_shape)
    fs = _blocks(_case_fs(cid), mg.mesh, mg._dtype)
    counts = _counting(mg, fs)
    with _counting_reads() as reads:
        psis, errs = mg.solve_batched(fs)
    del mg._step
    singles = [mg.solve(f) for f in fs]
    return {"errs": _bits(errs), "errs_dtype": str(errs.dtype), "counts": counts,
            "reads": reads, "block": tuple(psis.shape[1:]),
            "iterations": [r.iterations for r in singles],
            "psi_equal": [torch.equal(psis[k], r.psi) for k, r in enumerate(singles)],
            "err_equal": [errs[k].item() == r.final_err for k, r in enumerate(singles)],
            "psis": np.stack([_bits(multihost.gather_global(p, mg.mesh)) for p in psis])}


def _run_decisions(rank):
    """NaN in one rank's block of one element, a fixed cycle count, maxiter
    and the ValueError of a global-shaped batch, on DECIDE."""
    kw, mesh_shape = DECIDE
    mg = _solver(kw, mesh_shape)
    whole = _global_fs("three", kw["size"], 2)
    fs = _blocks(whole, mg.mesh, torch.float64)
    out = {}
    poisoned = fs.clone()
    if rank == NAN_RANK:
        poisoned[NAN_ELEMENT, 3, 5] = float("nan")
    with _counting_reads() as reads:
        psis, errs = mg.solve_batched(poisoned)
    one, _ = mg.solve_batched(poisoned, cycles=1)
    out["nan"] = {"reads": reads, "errs": errs.numpy(),
                  "others_equal_one_cycle": torch.equal(psis[[0, 2]], one[[0, 2]])}

    with _counting_reads() as fixed_reads:
        psis3, errs3 = mg.solve_batched(fs, cycles=3)
    stepped = []
    for f in fs:
        psi = mg.init_state(f)
        for _ in range(3):
            psi, _ = mg.step(psi, f)
        stepped.append(psi)
    mg3 = _solver(dict(kw, tol=1e-30, maxiter=3), mesh_shape)
    with _counting_reads() as reads:
        psis_m, errs_m = mg3.solve_batched(fs)
    out["fixed"] = {"reads": fixed_reads,
                    "equal_steps": torch.equal(psis3, torch.stack(stepped)),
                    "errs_equal": torch.equal(errs3, errs_m)}
    out["maxiter"] = {"reads": list(reads), "errs": errs_m.numpy(),
                      "equal_fixed": torch.equal(psis_m, psis3),
                      "final_errs": [mg3.solve(f).final_err for f in fs]}

    try:
        mg.solve_batched(torch.as_tensor(whole))
        out["global_shape"] = None
    except ValueError as e:
        out["global_shape"] = str(e)
    # the ranks go on together: the refused batch entered no collective
    out["after"] = float(spmd.all_reduce_sum(torch.ones((), dtype=torch.float64), mg.mesh))
    return out


def _rank_main(rank, store, out_dir):
    multihost.initialize("gloo", f"file://{store}", WORLD, rank, timeout=COLLECTIVE_TIMEOUT)
    try:
        results = {cid: _run_case(cid) for cid in CASES}
        results["decisions"] = _run_decisions(rank)
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _join(ctx, timeout):
    """Wait for every rank at most `timeout` seconds: a rank's failure
    raises (the others are ended), a hang kills them all and fails."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {WORLD} ranks did not finish in {timeout:.0f} s")


def _jax_batches():
    """The JAX package's mesh batches of JAX_CASES (8 virtual CPU devices,
    tests/conftest.py): (psis, errs) as f64 numpy arrays."""
    import jax.numpy as jnp
    import mgpoisson
    out = {}
    for cid, (kw, mesh_shape, _) in JAX_CASES.items():
        mg = mgpoisson.MultigridPoisson(mgpoisson.Spec(backend="xla", **kw, mesh_shape=mesh_shape,
                                                       partition="spmd"))
        psis, errs = mg.solve_batched(jnp.asarray(_case_fs(cid)))
        out[cid] = (np.asarray(psis, np.float64), np.asarray(errs, np.float64))
    return out


def _single_device_batches():
    """The port's single-device batches of the bf16 cases: (psis, errs,
    each element's cycles on the loop path)."""
    out = {}
    for cid in ("mixed16-2x2", "bf16-32-2x2"):
        kw = CASES[cid][0]
        mg = mgpoisson_torch.MultigridPoisson(mgpoisson_torch.Spec(**kw), device="cpu")
        fs = torch.as_tensor(_case_fs(cid)).to(mg._dtype)
        psis, errs = mg.solve_batched(fs)
        counts = _counting(mg, fs)
        mg._batched_loop(fs, None, use_vmap=False)
        out[cid] = (psis, errs, counts)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 4 gloo ranks for every case; the JAX mesh batches and
    the port's single-device batches are built meanwhile.  Returns (every
    rank's results, JAX's, the single-device port's)."""
    d = tmp_path_factory.mktemp("spmd_batched")
    ctx = mp.start_processes(_rank_main, args=(str(d / "store"), str(d)), nprocs=WORLD,
                             join=False, start_method="spawn")
    try:
        jax_out, single = _jax_batches(), _single_device_batches()
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    _join(ctx, SPAWN_TIMEOUT)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, jax_out, single


def _nmax(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("cid", JAX_CASES)
def test_mesh_batch_matches_jax(runs, cid):
    """The gathered psis within PSI_TOL of the JAX mesh batch's and the
    errs within ERRS_RTOL; each element's cycles its own sharded solve()'s,
    whose psi and final err the batch gives bit for bit; one read of the
    (batch,) errs per batched cycle."""
    ranks, jax_out, _ = runs
    jpsis, jerrs = jax_out[cid]
    r = ranks[0][cid]
    kw, mesh_shape, _ = CASES[cid]
    n, ndim = kw["size"], kw.get("ndim", 2)
    assert r["block"] == (n // mesh_shape[0], n // mesh_shape[1]) + (n,) * (ndim - 2)
    assert r["psis"].shape == jpsis.shape and r["errs_dtype"] == "torch.float64"
    for k in range(jpsis.shape[0]):
        assert _nmax(r["psis"][k], jpsis[k]) <= PSI_TOL, f"element {k}"
    np.testing.assert_allclose(r["errs"], jerrs, rtol=ERRS_RTOL, atol=ERRS_ATOL)
    for rr in ranks:
        assert rr[cid]["counts"] == rr[cid]["iterations"]
        assert all(rr[cid]["psi_equal"]) and all(rr[cid]["err_equal"])
        assert rr[cid]["reads"] == ["errs"] * max(rr[cid]["counts"])


@pytest.mark.parametrize("cid", CASES)
def test_errs_are_the_same_bits_on_every_rank(runs, cid):
    ranks = runs[0]
    for rr in ranks[1:]:
        assert np.array_equal(rr[cid]["errs"], ranks[0][cid]["errs"])
        assert rr[cid]["counts"] == ranks[0][cid]["counts"]
        assert np.array_equal(rr[cid]["psis"], ranks[0][cid]["psis"])


def test_mixed_batch_to_the_single_device_batch(runs):
    """f32 with bf16 sweeps: each element bit-equal to its own sharded
    solve(); the batch within the bf16 bar of the port's single-device
    mixed batch, each element's step count that batch's."""
    ranks, _, single = runs
    cid = "mixed16-2x2"
    spsis, serrs, scounts = single[cid]
    r = ranks[0][cid]
    assert r["errs_dtype"] == "torch.float32"
    for rr in ranks:
        assert all(rr[cid]["psi_equal"]) and all(rr[cid]["err_equal"])
        assert rr[cid]["counts"] == rr[cid]["iterations"] == scounts
    for k in range(spsis.shape[0]):
        want = spsis[k].double().numpy()
        assert _nmax(r["psis"][k], want) <= BF16_TOL
        assert abs(float(r["errs"][k]) - serrs[k].item()) <= STEP_RTOL * serrs[k].item()


def test_pure_bf16_batch_equals_the_single_device_batch(runs):
    """Pure bf16, 4 cycles: the gathered psis bit for bit the port's
    single-device bf16 batch's, bf16 errs; each element bit-equal to its
    own sharded solve()."""
    ranks, _, single = runs
    cid = "bf16-32-2x2"
    spsis, serrs, scounts = single[cid]
    r = ranks[0][cid]
    assert r["errs_dtype"] == "torch.bfloat16" and serrs.dtype == torch.bfloat16
    assert np.array_equal(r["psis"], _bits(spsis))
    assert r["counts"] == scounts == [CASES[cid][0]["maxiter"]] * 2
    for rr in ranks:
        assert all(rr[cid]["psi_equal"]) and all(rr[cid]["err_equal"])


def test_a_frozen_element_is_bit_stable(runs):
    """The easy element freezes at its first converged iterate, the bits of
    its own sharded solve(), which stops at that cycle; the hard one goes
    on, and the skipped cycles were never run."""
    ranks = runs[0]
    for rr in ranks:
        r = rr["freeze32-2x2"]
        assert r["counts"] == r["iterations"] and r["counts"][0] < r["counts"][1]
        assert all(r["psi_equal"]) and all(r["err_equal"])
    assert float(ranks[0]["freeze32-2x2"]["errs"].max()) < 1e-9


def test_a_nan_in_one_ranks_block_stops_every_rank(runs):
    """NaN in rank NAN_RANK's block of element NAN_ELEMENT: the all-reduce
    carries it to every rank, which all stop after cycle 1 (one read), the
    element's err NaN everywhere, the others' psis those of one cycle."""
    for rr in runs[0]:
        r = rr["decisions"]["nan"]
        assert r["reads"] == ["errs"]
        assert np.isnan(r["errs"][NAN_ELEMENT])
        assert np.isfinite(np.delete(r["errs"], NAN_ELEMENT)).all()
        assert r["others_equal_one_cycle"]


def test_fixed_cycles_read_nothing_and_maxiter_stops(runs):
    """cycles=3 reads nothing back and equals 3 step()s per element; at tol
    1e-30 and maxiter 3 the loop reads once per cycle, gives the same psis
    and errs, each the final err of the element's own 3-cycle solve()."""
    for rr in runs[0]:
        fixed, mx = rr["decisions"]["fixed"], rr["decisions"]["maxiter"]
        assert fixed["reads"] == [] and fixed["equal_steps"] and fixed["errs_equal"]
        assert mx["reads"] == ["errs"] * 3 and mx["equal_fixed"]
        assert (mx["errs"] >= 0).all() and list(mx["errs"]) == mx["final_errs"]


def test_a_global_shaped_batch_raises_before_any_collective(runs):
    """Every rank refuses the whole-grid batch with a ValueError naming
    its block shape, and the ranks' next all-reduce still meets."""
    n = DECIDE[0]["size"]
    for rr in runs[0]:
        msg = rr["decisions"]["global_shape"]
        assert msg is not None and f"(batch, *{(n // 2, n // 2)})" in msg
        assert "this rank's block" in msg and f"({3}, {n}, {n})" in msg
        assert rr["decisions"]["after"] == WORLD
