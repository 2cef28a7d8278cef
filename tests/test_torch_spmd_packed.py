"""The packed fine level under a row-sharded mesh: the port against the JAX
package, on the CPU.

- The plain packed block ops (the plain versions of the packed strip
  kernels K13/K14): the packed grid is cut into blocks of whole rows and
  row strips exactly as the ranks' exchange delivers them
  (spmd.block_from_grid), every block runs the op on its own, and the
  stitched result is held against the JAX package's XLA composites on the
  unpacked whole grid in f64 (the comparison tests/test_packed_spmd.py
  makes for the JAX kernels), and against the JAX Pallas kernels
  packed_rr_sharded / packed_pc_sharded in interpret mode in f32.
- The pack of a rank's block: the rows of the packed grid.
- The rule ``kernels.use_packed_sharded`` against the JAX package's
  ``cycle.packed.supported_spmd``.
- The sharded packed solve: one spawn of 4 gloo ranks on the CPU (fast
  256^2 f32 on (4, 1), MGPOISSON_PACKED=1 in the ranks), held against the
  JAX package's packed spmd solve and the port's single-device packed solve.

The ranks re-import this module, so its top level imports torch, numpy,
pytest and the port only; JAX and mgpoisson are imported inside the
parent-side functions.
"""

import datetime
import itertools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import mgpoisson_torch
from mgpoisson_torch.kernels import ops, use_packed, use_packed_sharded
from mgpoisson_torch.shard import multihost, spmd
from mgpoisson_torch.shard.mesh import ProcessMesh

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

WORLD = 4


def _fake_mesh(shape, rank=0):
    """A mesh object for the code that needs no collective."""
    return ProcessMesh(shape=shape, rank=rank, ranks=tuple(range(shape[0] * shape[1])),
                       backend="gloo")


def _nmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _data(n, seed, dtype):
    rng = np.random.default_rng(seed)
    u, f = rng.standard_normal((2, n, n)).astype(dtype)
    return u, f, rng.standard_normal((n // 2, n // 2)).astype(dtype)


def _blocks(n, mx, nu, u, f, V):
    """Per block of an (mx, 1) mesh: (r0, packed u block and its strips, f
    block and strips, V block and coarse strips), at the strip depths of a
    solve with nu sweeps (2 nu + 1, and the coarse depth for V)."""
    up, fp = ops.pack_grid(torch.tensor(u)), ops.pack_grid(torch.tensor(f))
    nl, d = n // mx, 2 * nu + 1
    for i in range(mx):
        r0 = i * nl
        yield (r0, *spmd.block_from_grid(up, (r0, 0), (nl, n), d, cols=False),
               *spmd.block_from_grid(fp, (r0, 0), (nl, n), d, cols=False),
               *spmd.block_from_grid(torch.tensor(V), (r0 // 2, 0), (nl // 2, n // 2),
                                     ops.coarse_depth(d), cols=False))


def _stitched(n, mx, nu, kind, u, f, V):
    """Every block's packed down-leg and up-leg (with rnorm), stitched into
    whole grids and unpacked; Σr² summed over the blocks."""
    h = 1.0 / n
    out_u, out_p = np.zeros_like(u), np.zeros_like(u)
    out_R = np.zeros_like(V)
    r2 = 0.0
    for r0, ub, us, fb, fs, vb, vs in _blocks(n, mx, nu, u, f, V):
        nl = ub.shape[0]
        gu, gR = ops.packed_rr_sharded(ub, fb, us, fs, (r0, 0), n, h, nu)
        gp, s = ops.packed_pc_sharded(ub, fb, vb, us, fs, vs, (r0, 0), n, h, nu, kind,
                                      rnorm=True)
        assert torch.equal(gp, ops.packed_pc_sharded(ub, fb, vb, us, fs, vs, (r0, 0), n, h,
                                                     nu, kind))
        out_u[r0:r0 + nl] = ops.unpack_grid(gu).numpy()
        out_p[r0:r0 + nl] = ops.unpack_grid(gp).numpy()
        out_R[r0 // 2:(r0 + nl) // 2] = gR.numpy()
        r2 += float(s)
    return out_u, out_R, out_p, r2


@pytest.mark.parametrize("kind", ["inject", "bilinear"])
@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("n,mx", [(256, 2), (256, 4), (512, 2), (512, 4)])
def test_plain_packed_sharded_ops_match_xla(n, mx, nu, kind):
    """Every block of (mx, 1), f64: the stitched packed legs equal the XLA
    composites (rbgs, ghost0) on the unpacked whole grid."""
    import jax.numpy as jnp
    from mgpoisson.kernels import xla as X
    u, f, V = _data(n, n + nu, np.float64)
    got_u, got_R, got_p, r2 = _stitched(n, mx, nu, kind, u, f, V)
    h = 1.0 / n
    J = jnp.asarray
    want_u = X.smooth(J(u), J(f), h, nu, "rbgs", "ghost0")
    want_R = X.residual_restrict(want_u, J(f), h, "ghost0")
    want_p = X.smooth(X.prolong_correct(J(u), J(V), kind), J(f), h, nu, "rbgs", "ghost0")
    w2 = float(X.residual_sq_sum(want_p, J(f), h))
    assert _nmax(got_u, want_u) <= 1e-12
    assert _nmax(got_R, want_R) <= 1e-12
    assert _nmax(got_p, want_p) <= 1e-12
    assert abs(r2 / w2 - 1) <= 1e-12


def _row_strips(G, i0, nl, depth):
    """(top, bot, None, None) row strips of row block i0 of the JAX array G,
    zero-filled outside the grid (tests/test_packed_spmd.py's helper)."""
    import jax.numpy as jnp
    Gp = jnp.pad(G, ((depth, depth), (0, 0)))
    r0 = depth + i0 * nl
    return Gp[r0 - depth:r0, :], Gp[r0 + nl:r0 + nl + depth, :], None, None


@pytest.mark.parametrize("leg", ["rr", "pc-bilinear"])
def test_plain_packed_sharded_ops_match_the_pallas_kernels(monkeypatch, leg):
    """f32, 256^2 on 4 row blocks, nu = 1: each block's plain op against the
    JAX package's packed strip kernel in interpret mode (8-deep strips there,
    2 nu + 1 here), at tests/test_packed_spmd.py's bars."""
    monkeypatch.setenv("MGPOISSON_PALLAS_INTERPRET", "1")
    import jax.numpy as jnp
    import mgpoisson.kernels.pallas as pk
    n, mx, nu = 256, 4, 1
    nl, h = n // mx, 1.0 / n
    u, f, V = _data(n, 23, np.float32)
    UP, FP, VJ = pk.pack_grid(jnp.asarray(u)), pk.pack_grid(jnp.asarray(f)), jnp.asarray(V)
    plan = pk.packed_sharded_plan((nl, n), nu, 4)
    r2_got = r2_want = 0.0
    for i, (r0, ub, us, fb, fs, vb, vs) in enumerate(_blocks(n, mx, nu, u, f, V)):
        rows = slice(r0, r0 + nl)
        flags = jnp.asarray([i == 0, i == mx - 1, 1, 1], jnp.int32)
        jstrips = [_row_strips(G, i, nl, plan[0]) for G in (UP, FP)]
        if leg == "rr":
            want_u, want_R = pk.packed_rr_sharded(UP[rows], FP[rows], *jstrips, flags, h, nu,
                                                  plan=plan)
            got_u, got_R = ops.packed_rr_sharded(ub, fb, us, fs, (r0, 0), n, h, nu)
            np.testing.assert_allclose(got_R.numpy(), np.asarray(want_R), rtol=1e-3,
                                       atol=3e-7 / h ** 2)
        else:
            want_u, racc = pk.packed_pc_sharded(
                UP[rows], FP[rows], VJ[r0 // 2:(r0 + nl) // 2], *jstrips,
                _row_strips(VJ, i, nl // 2, 8), flags, h, nu, "bilinear", plan=plan,
                rnorm=True)
            got_u, s = ops.packed_pc_sharded(ub, fb, vb, us, fs, vs, (r0, 0), n, h, nu,
                                             "bilinear", rnorm=True)
            r2_got += float(s)
            r2_want += float(jnp.sum(racc))
        np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), atol=5e-6)
    if leg != "rr":
        np.testing.assert_allclose(r2_got, r2_want, rtol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_pack_is_the_rows_of_the_packed_grid(dtype):
    """pack_grid of each row block equals those rows of the JAX package's
    pack_grid of the whole grid, bit for bit; unpack_grid inverts it on any
    (nl, m)."""
    import jax.numpy as jnp
    import mgpoisson.kernels.pallas as pk
    n = 256    # the JAX pack_grid takes multiples of its 256-lane chunk
    u = np.random.default_rng(5).standard_normal((n, n)).astype(dtype)
    want = np.asarray(pk.pack_grid(jnp.asarray(u)))
    for mx in (2, 4, 8):
        nl = n // mx
        for r0 in range(0, n, nl):
            block = torch.tensor(u[r0:r0 + nl])
            packed = ops.pack_grid(block)
            np.testing.assert_array_equal(packed.numpy(), want[r0:r0 + nl])
            assert torch.equal(ops.unpack_grid(packed), block)
    wide = torch.tensor(u[:6, :32])
    assert torch.equal(ops.unpack_grid(ops.pack_grid(wide)), wide)


def test_plain_packed_sharded_ops_reject_what_they_do_not_take():
    up = torch.zeros(32, 64, dtype=torch.float64)
    shallow = (torch.zeros(2, 64, dtype=torch.float64),) * 2 + (None, None)
    with pytest.raises(ValueError, match="depth 2"):
        ops.packed_rr_sharded(up, up, shallow, shallow, (0, 0), 64, 1 / 64, 1)
    deep = (torch.zeros(3, 64, dtype=torch.float64),) * 2 + (None, None)
    with pytest.raises(ValueError, match="spans every column"):
        ops.packed_rr_sharded(up, up, deep, deep, (0, 32), 64, 1 / 64, 1)


# ---------------------------------------------------------------- the rule

@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("mesh_shape", [(2, 1), (4, 1), (8, 1), (2, 2), (1, 4)])
def test_rule_matches_jax_supported_spmd(monkeypatch, mesh_shape, flag):
    """use_packed_sharded against the JAX package's supported_spmd on sizes
    128/256/512, fast/tuned, f32/f64 (the JAX side forced to its Pallas
    backend, the port's on the CPU with the flag, as each runs it there)."""
    import mgpoisson
    from mgpoisson.cycle import packed as PK
    from mgpoisson.shard.mesh import build_mesh
    monkeypatch.setenv("MGPOISSON_PACKED", flag)
    jmesh, mesh = build_mesh(mesh_shape), _fake_mesh(mesh_shape)
    taken = 0
    for size, scheme, dtype in itertools.product((128, 256, 512), ("fast", "tuned"),
                                                 ("float32", "float64")):
        kw = dict(size=size, scheme=scheme, dtype=dtype, mesh_shape=mesh_shape)
        want = PK.supported_spmd(mgpoisson.Spec(**kw, backend="pallas", partition="spmd"),
                                 jmesh)
        got = use_packed_sharded(mgpoisson_torch.Spec(**kw), mesh, "cpu")
        assert got == want, kw
        taken += got
    assert taken == (2 if flag == "1" and mesh_shape[1] == 1 else 0)


def test_rule_takes_the_card_and_keeps_use_packed_off_a_mesh(monkeypatch):
    monkeypatch.delenv("MGPOISSON_PACKED", raising=False)
    spec = mgpoisson_torch.Spec(size=256, scheme="fast", mesh_shape=(4, 1))
    mesh = _fake_mesh((4, 1))
    assert use_packed_sharded(spec, mesh, "cuda") and not use_packed_sharded(spec, mesh, "cpu")
    assert not use_packed_sharded(spec.with_(backend="torch"), mesh, "cuda")
    assert not use_packed_sharded(spec.with_(kernel_min_size=512), mesh, "cuda")
    assert not use_packed(spec, "cuda")


# ----------------------------------------------------- the 4-rank spawn

FAST = dict(size=256, dtype="float32", scheme="fast", maxiter=12)
# id -> (port Spec fields, mesh); each runs solve() on the ranks
RANK_CASES = {
    "residual": (dict(FAST, stop="residual", tol=1e-6), (4, 1)),
    "update": (dict(FAST, stop="update", tol=2e-5), (4, 1)),
    "w-step": (dict(FAST, cycle="w", stop="residual", maxiter=1), (4, 1)),
    "cols": (dict(FAST, stop="residual", tol=1e-6, maxiter=1), (2, 2)),
}


def _rank_main(rank, store, out_path):
    """One rank: every case of RANK_CASES with the packed sharded path on
    for CPU tensors; rank 0 saves the gathered results."""
    torch.set_num_threads(1)
    os.environ["MGPOISSON_PACKED"] = "1"
    multihost.initialize("gloo", f"file://{store}", WORLD, rank,
                         timeout=datetime.timedelta(seconds=120))
    try:
        results = {}
        for cid, (kw, mesh_shape) in RANK_CASES.items():
            mg = mgpoisson_torch.MultigridPoisson(
                mgpoisson_torch.Spec(**kw, mesh_shape=mesh_shape), device="cpu")
            res = mg.solve()
            results[cid] = {"packed": mg._packed, "iterations": res.iterations,
                            "errs": res.errs.numpy(), "converged": res.converged,
                            "psi": multihost.gather_global(res.psi, mg.mesh).numpy()}
        if rank == 0:
            torch.save(results, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spmd_results(tmp_path_factory):
    """One spawn of 4 gloo ranks on the CPU for every case."""
    d = tmp_path_factory.mktemp("spmd_packed")
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d / "results.pt")),
                       nprocs=WORLD, join=True, start_method="spawn")
    return torch.load(d / "results.pt", weights_only=False)


def _single_device(monkeypatch, kw):
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    mg = mgpoisson_torch.MultigridPoisson(mgpoisson_torch.Spec(**kw), device="cpu")
    assert mg._packed
    return mg.solve()


def test_packed_only_on_a_mesh_of_one_column(spmd_results):
    assert all(spmd_results[c]["packed"] for c in ("residual", "update", "w-step"))
    assert not spmd_results["cols"]["packed"]


def test_sharded_packed_solve_matches_jax(spmd_results, monkeypatch):
    """The residual-stop solve on (4, 1) against the JAX package's packed
    spmd solve (Pallas kernels in interpret mode) on the same mesh."""
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    monkeypatch.setenv("MGPOISSON_PALLAS_INTERPRET", "1")
    import mgpoisson
    kw, mesh_shape = RANK_CASES["residual"]
    mg = mgpoisson.MultigridPoisson(mgpoisson.Spec(**kw, backend="pallas", mesh_shape=mesh_shape,
                                                   partition="spmd"))
    assert mg._packed
    want = mg.solve()
    got = spmd_results["residual"]
    assert got["converged"] and got["iterations"] == want.iterations
    np.testing.assert_allclose(got["errs"], np.asarray(want.errs), rtol=1e-4)
    assert _nmax(got["psi"], want.psi) <= 3e-5


@pytest.mark.parametrize("cid", ["residual", "update", "w-step"])
def test_sharded_packed_solve_matches_the_single_device_packed_solve(spmd_results, monkeypatch,
                                                                      cid):
    kw, _ = RANK_CASES[cid]
    want = _single_device(monkeypatch, kw)
    got = spmd_results[cid]
    assert got["iterations"] == want.iterations and got["converged"] == want.converged
    np.testing.assert_allclose(got["errs"], want.errs.numpy(), rtol=1e-4)
    assert _nmax(got["psi"], want.psi.numpy()) <= 1e-5
