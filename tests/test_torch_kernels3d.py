"""The 3D half of the port's kernel layer, mgpoisson_torch.kernels.cuda
(K4 mg_smooth3d, K5 mg_smooth_rr3d, K6 mg_prolong_correct_smooth3d).

On the CPU its wrappers run their plain versions.  Those are held here
against the Pallas 3D kernels they replace, run as tests/test_pallas3d.py
runs them (interpreter mode, shape (32, 64, 128), explicit blocks), at the
tuned scheme's settings (wjacobi, nu = 3), and against mgpoisson.kernels.xla
on whole cubes at 16^3 and 32^3 for every smoother, bc, sweep count and
prolongation kind.  Inputs are float32 from a seeded numpy generator.  The
sweep forms differ (Pallas nbr/6 + f*(-h^2/6), the port (f - nbr/h^2) /
adiag) and round differently, so the bar is the f32 kernel bar of the
ROADMAP: normalized max |diff| <= 1e-5, and 1e-5 relative on sum(r^2).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
compares each with its plain version there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mgpoisson.kernels import pallas as pk, xla
from mgpoisson_torch.kernels import cuda

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

SHAPE = (32, 64, 128)       # the Pallas 3D tests' shape: x whole, (z, y) blocked
H = 1.0 / 64
BLOCKS = dict(bz=8, by=32)  # several blocks on both blocked axes


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MGPOISSON_PALLAS_INTERPRET", "1")


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=tuple(s // 2 for s in shape)).astype(np.float32))


def _nmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _rel(got, want):
    return abs(float(got) / float(want) - 1.0)


# ------------------------------------------- against the Pallas 3D kernels

def test_smooth3d_vs_pallas():
    u, f, _ = _data(SHAPE, seed=1)
    want = pk._smooth_fused_3d(jnp.asarray(u), jnp.asarray(f), h=H, nu=3,
                               smoother="wjacobi", bc="ghost0",
                               interpret=True, hz=3, **BLOCKS)
    got = cuda.smooth(torch.tensor(u), torch.tensor(f), H, 3, "wjacobi", "ghost0")
    assert _nmax(got, want) <= 1e-5


@pytest.mark.parametrize("bc", ["ghost0", "face"])
def test_smooth_residual_restrict3d_vs_pallas(bc):
    u, f, _ = _data(SHAPE, seed=2)
    want = pk._rr_fused_3d(jnp.asarray(u), jnp.asarray(f), h=H, nu=3,
                           smoother="wjacobi", bc=bc, interpret=True, hz=4,
                           **BLOCKS)
    got = cuda.smooth_residual_restrict(torch.tensor(u), torch.tensor(f), H, 3,
                                        "wjacobi", bc)
    for g, w in zip(got, want):
        assert _nmax(g, w) <= 1e-5


@pytest.mark.parametrize("bc,rnorm", [("face", False), ("ghost0", True)])
def test_prolong_correct_smooth3d_vs_pallas(bc, rnorm):
    u, f, V = _data(SHAPE, seed=3)
    args = (jnp.asarray(u), jnp.asarray(f), jnp.asarray(V))
    want = pk._pc_fused_3d(*args, h=H, nu=3, smoother="wjacobi", bc=bc,
                           kind="bilinear", interpret=True, hz=4, rnorm=rnorm,
                           **BLOCKS)
    targs = (torch.tensor(u), torch.tensor(f), torch.tensor(V), H, 3,
             "wjacobi", bc, "bilinear")
    if not rnorm:
        assert _nmax(cuda.prolong_correct_smooth(*targs), want) <= 1e-5
        return
    got_u, got_r2 = cuda.prolong_correct_smooth_rnorm(*targs)
    assert _nmax(got_u, want[0]) <= 1e-5
    assert _rel(got_r2, jnp.sum(want[1])) <= 1e-5
    # the metric is the zero-ghost residual's, as the XLA op computes it
    _, xla_r2 = xla.prolong_correct_smooth_rnorm(*args, H, 3, "wjacobi", bc,
                                                 "bilinear")
    assert _rel(got_r2, xla_r2) <= 1e-5


# ------------------------------------------- against mgpoisson.kernels.xla

CASES = [(n, smoother, bc, nu) for n in (16, 32)
         for smoother in ("jacobi", "wjacobi", "rbgs")
         for bc in ("ghost0", "face") for nu in (1, 3)]


def _cube(n, seed):
    """(jax arrays, torch tensors) of the same u, f, V on an n^3 level."""
    arrays = _data((n, n, n), seed)
    return [jnp.asarray(a) for a in arrays], [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("n,smoother,bc,nu", CASES)
def test_smooth3d_vs_xla(n, smoother, bc, nu):
    (u, f, _), (ut, ft, _) = _cube(n, seed=4)
    h = 1.0 / n
    assert _nmax(cuda.smooth(ut, ft, h, nu, smoother, bc),
                 xla.smooth(u, f, h, nu, smoother, bc)) <= 1e-5


@pytest.mark.parametrize("n,smoother,bc,nu", CASES)
def test_smooth_residual_restrict3d_vs_xla(n, smoother, bc, nu):
    (u, f, _), (ut, ft, _) = _cube(n, seed=5)
    h = 1.0 / n
    for got, want in zip(cuda.smooth_residual_restrict(ut, ft, h, nu, smoother, bc),
                         xla.smooth_residual_restrict(u, f, h, nu, smoother, bc)):
        assert _nmax(got, want) <= 1e-5
    # the down-leg from zero, as every coarse V-cycle entry runs it
    for got, want in zip(cuda.smooth_residual_restrict_zero(ft, h, nu, smoother, bc),
                         xla.smooth_residual_restrict_zero(f, h, nu, smoother, bc)):
        assert _nmax(got, want) <= 1e-5


@pytest.mark.parametrize("kind", ["inject", "bilinear"])
@pytest.mark.parametrize("n,smoother,bc,nu", CASES)
def test_prolong_correct_smooth3d_vs_xla(n, smoother, bc, nu, kind):
    (u, f, V), (ut, ft, Vt) = _cube(n, seed=6)
    h = 1.0 / n
    a = (h, nu, smoother, bc, kind)
    assert _nmax(cuda.prolong_correct_smooth(ut, ft, Vt, *a),
                 xla.prolong_correct_smooth(u, f, V, *a)) <= 1e-5
    got_u, got_r2 = cuda.prolong_correct_smooth_rnorm(ut, ft, Vt, *a)
    want_u, want_r2 = xla.prolong_correct_smooth_rnorm(u, f, V, *a)
    assert _nmax(got_u, want_u) <= 1e-5
    assert _rel(got_r2, want_r2) <= 1e-5


# ------------------------------------------------------- what K4-K6 take

@pytest.mark.parametrize("smoother", ["jacobi", "wjacobi", "rbgs"])
def test_3d_caps_cover_the_jax_planner(smoother):
    """K4-K6 take at least every sweep count the JAX package's 3D planner
    admits at 256^3 f32, and exactly a halo of radius*nu (+1 ring where a
    residual follows) <= 8."""
    radius = 2 if smoother == "rbgs" else 1
    for nu in range(0, 10):
        for composite in (False, True):
            takes = cuda.supports(256, torch.float32, nu, smoother, ndim=3,
                                  residual=composite)
            assert takes == (radius * nu + composite <= 8)
            if nu >= 1 and pk._plan3d((256,) * 3, nu, smoother, 4,
                                      composite=composite) is not None:
                assert takes, (nu, composite)
    assert not cuda.supports(256, torch.float64, 1, smoother, ndim=3)


def test_3d_tile_fits_shared_memory():
    """The tile side the wrapper passes keeps the K6 working set (three
    (T + 2H)^3 buffers, the coarse tile and the reduction) within the
    227 KB a block may opt in to, for every halo the caps allow."""
    for halo in range(0, cuda.MAX_HALO_3D + 1):
        assert cuda.tile3d(halo) % 2 == 0
        assert cuda.shared_bytes_3d(halo) < cuda.shared_bytes_3d(halo, pc=True)
        assert cuda.shared_bytes_3d(halo, pc=True) <= 232448, halo
    # the tuned scheme's K5 / K6 with rnorm: T = 16, H = 4
    assert cuda.shared_bytes_3d(4) == 4 * 3 * 24 ** 3
    assert cuda.shared_bytes_3d(4, pc=True) == 180960


# ------------------------------------- the z-marching tile of K5/K6 (whole grid)
# kernels.cuda mirrors csrc/stencil3d_zm.cuh: which halos the tile takes
# (zmarch3d / mg3z_takes), its interior side (tile3d_zm / mg3z_side), its
# planes per block (zm_chunk / mg3z_chunk, the chunk table) and its shared memory
# (shared_bytes_3d_zm / mg3z_bytes).  K6's rnorm partials are one per
# block of that launch, so the counts must agree or K6 writes past them.

import re
from pathlib import Path

_ZM_HEADER = (Path(cuda.__file__).parents[1] / "csrc" / "stencil3d_zm.cuh").read_text()


def _zm_define(name):
    return int(re.search(rf"#define {name} (\d+)", _ZM_HEADER).group(1))


SIDES_3D = [2 ** k for k in range(1, 11)]   # 2 ... 1024
SMOOTHERS_3D = ("jacobi", "wjacobi", "rbgs")


def _admitted(residual):
    """Every (smoother, nu >= 1) the 3D caps admit for a leg with or
    without a residual ring."""
    return [(sm, nu) for sm in SMOOTHERS_3D for nu in range(1, 9)
            if cuda.supports(256, torch.float32, nu, sm, ndim=3, residual=residual)]


def test_zmarch_constants_mirror_the_header():
    assert cuda.ZM_COLS == _zm_define("MG3Z_COLS") == _zm_define("MG3Z_ROWS")
    assert cuda.ZM_MAX_HALO == _zm_define("MG3Z_MAX_HALO")
    assert cuda.ZM_SMS == _zm_define("MG3Z_SMS")
    assert cuda.ZM_MIN_CHUNK == _zm_define("MG3Z_MIN_CHUNK")


@pytest.mark.parametrize("halo", range(0, cuda.MAX_HALO_3D + 1))
def test_zmarch_tile_geometry(halo):
    """The halos 0 ... 4 run the z-marching tile, 5 ... 8 the cube tile;
    the z-marching interior is even (2x2x2 restriction cells and
    trilinear parities stay inside a block) and leaves at least two
    halo-deep rings of threads."""
    takes = cuda.zmarch3d(halo)
    assert takes == (halo <= 4)
    if not takes:
        return
    t = cuda.tile3d_zm(halo)
    assert t == cuda.ZM_COLS - 2 * halo and t % 2 == 0 and t >= 24


@pytest.mark.parametrize("n", SIDES_3D)
def test_zmarch_blocks_cover_the_grid(n):
    """Every z-marching launch's blocks cover the n^3 grid with no block
    beyond it, and the chunk divides n (every block owns whole planes)."""
    for halo in range(0, cuda.ZM_MAX_HALO + 1):
        c = cuda.zm_chunk(n, halo)
        assert n % c == 0 and (c == n or c >= cuda.ZM_MIN_CHUNK)
        t = cuda.tile3d_zm(halo)
        g = -(-n // t)
        assert g * t >= n and (g - 1) * t < n
        assert cuda.blocks3d(n, halo) == g * g * (n // c)


def _rounds_cost(n, halo, c):
    blocks = (-(-n // cuda.tile3d_zm(halo))) ** 2 * (n // c)
    return -(-blocks // cuda.ZM_SMS) * (c + 2 * halo)


@pytest.mark.parametrize("n", SIDES_3D)
def test_zmarch_chunk_table_picks_the_fewest_plane_steps(n):
    """The chunk table's pick costs no more rounds x plane-steps than any
    other power-of-two chunk it may take, and is the largest of the
    cheapest."""
    for halo in range(0, cuda.ZM_MAX_HALO + 1):
        cands = [n >> k for k in range(0, 12)
                 if (n >> k) >= 1 and ((n >> k) == n or (n >> k) >= cuda.ZM_MIN_CHUNK)]
        costs = {c: _rounds_cost(n, halo, c) for c in cands}
        best = min(costs.values())
        assert cuda.zm_chunk(n, halo) == max(c for c, v in costs.items() if v == best)


def test_zmarch_chunk_table_at_the_main_path():
    """The tuned scheme's levels on an H100: one chunk per column at 256^3
    (K5 at halo 4: 121 blocks, one round), 128 planes at 512^3 (K5: 1936
    blocks, 15 rounds of 136 plane-steps)."""
    assert [cuda.zm_chunk(256, h) for h in (3, 4)] == [256, 256]
    assert [cuda.zm_chunk(512, h) for h in (3, 4)] == [128, 128]
    assert cuda.blocks3d(256, 4) == 121 and cuda.blocks3d(512, 4) == 22 * 22 * 4


@pytest.mark.parametrize("smoother,nu", _admitted(residual=True))
def test_k6_rnorm_partials_match_the_launch(smoother, nu):
    """K6 with rnorm writes one partial per block of its launch: the
    z-marching grid at halos <= 4, the cube tile's T^3 blocks beyond."""
    halo = (2 * nu if smoother == "rbgs" else nu) + 1
    for n in SIDES_3D:
        if cuda.zmarch3d(halo):
            t = cuda.tile3d_zm(halo)
            want = (-(-n // t)) ** 2 * -(-n // cuda.zm_chunk(n, halo))
        else:
            want = (-(-n // cuda.tile3d(halo))) ** 3
        assert cuda.rnorm_partials((n, n, n), nu, smoother, n) == want, n


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)])
@pytest.mark.parametrize("smoother,nu", _admitted(residual=True))
def test_k12_strip_partials_keep_the_cube_tile(mesh, smoother, nu):
    """K12 (the strip entry) with rnorm writes one partial per block of its
    launch over the rank's (nzl, nyl, n) block: the z-marching grid (x,
    y, chunk from the chunk table over the block) at halos <= 4, and it
    keeps the cube tile's T^3 blocks over (n, nzl, nyl) beyond."""
    halo = (2 * nu if smoother == "rbgs" else nu) + 1
    for n in SIDES_3D[2:]:
        shape = (n // mesh[0], n // mesh[1], n)
        if cuda.zmarch3d(halo):
            t = cuda.tile3d_zm(halo)
            c = cuda.zm_chunk(n, halo, shape[0], shape[1])
            want = -(-n // t) * -(-shape[1] // t) * (shape[0] // c)
        else:
            t = cuda.tile3d(halo)
            want = -(-n // t) * -(-shape[0] // t) * -(-shape[1] // t)
        assert cuda.strip_rnorm_partials(shape, nu, smoother, n) == want


# the strip entries K11/K12 on the z-marching tile: the chunk table over a
# rank's block (nzl, nyl, n) of the (2, 2) and (4, 1) meshes
BLOCK_SIDES = [2 ** k for k in range(2, 11)]   # 4 ... 1024


def _block_cost(n, nzl, nyl, halo, c):
    t = cuda.tile3d_zm(halo)
    blocks = -(-n // t) * -(-nyl // t) * (nzl // c)
    return -(-blocks // cuda.ZM_SMS) * (c + 2 * halo)


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)])
@pytest.mark.parametrize("n", BLOCK_SIDES)
def test_zmarch_chunk_table_over_a_block(mesh, n):
    """Over a rank's block the chunk divides nzl (every block owns whole
    planes of the rank's), the launch grid covers the block with no block
    beyond it, and the pick costs no more rounds x plane-steps than any
    other chunk it may take, the largest of the cheapest."""
    nzl, nyl = n // mesh[0], n // mesh[1]
    for halo in range(0, cuda.ZM_MAX_HALO + 1):
        c = cuda.zm_chunk(n, halo, nzl, nyl)
        assert nzl % c == 0 and (c == nzl or c >= cuda.ZM_MIN_CHUNK)
        t = cuda.tile3d_zm(halo)
        gx, gy = -(-n // t), -(-nyl // t)
        assert gx * t >= n and (gx - 1) * t < n and gy * t >= nyl and (gy - 1) * t < nyl
        assert cuda.blocks3d(n, halo, nzl, nyl) == gx * gy * (nzl // c)
        cands = [nzl >> k for k in range(0, 12)
                 if (nzl >> k) >= 1 and ((nzl >> k) == nzl or (nzl >> k) >= cuda.ZM_MIN_CHUNK)]
        costs = {k: _block_cost(n, nzl, nyl, halo, k) for k in cands}
        best = min(costs.values())
        assert c == max(k for k, v in costs.items() if v == best)


def test_zmarch_chunk_table_at_the_sharded_path():
    """The 256^3 solve on (2, 2): the (128, 128, 256) block at halo 4 (K11,
    K12 with rnorm) has 11 x 6 = 66 columns and takes 64 planes per block,
    132 blocks in one round of 72 plane-steps (128 planes: 66 blocks, one
    round of 136); on (4, 1) the (64, 256, 256) block, 121 columns, takes
    64 too.  The whole grid is the same table with nzl = nyl = n."""
    assert cuda.zm_chunk(256, 4, 128, 128) == 64
    assert cuda.blocks3d(256, 4, 128, 128) == 132
    assert cuda.zm_chunk(256, 4, 64, 256) == 64
    assert cuda.blocks3d(256, 4, 64, 256) == 121
    for n in SIDES_3D:
        for halo in range(0, cuda.ZM_MAX_HALO + 1):
            assert cuda.zm_chunk(n, halo, n, n) == cuda.zm_chunk(n, halo)
            assert cuda.blocks3d(n, halo, n, n) == cuda.blocks3d(n, halo)


@pytest.mark.parametrize("leg", ["rr", "pc", "pc.rnorm"])
def test_zmarch_strip_instances_fit_shared_memory(leg):
    """The strip instances of K11 (rr), K12 and K12 with rnorm take the
    whole-grid legs' shared memory (csrc/stencil3d_zm.cuh mg3z_bytes):
    under 100 KB at every step count whose halo the z-marching tile takes."""
    residual = leg != "pc"
    for smoother, nu in [(sm, nu) for sm in SMOOTHERS_3D for nu in range(0, 5)]:
        steps = 2 * nu if smoother == "rbgs" else nu
        if not cuda.zmarch3d(steps + residual):
            continue
        got = cuda.shared_bytes_3d_zm(steps, rr=leg == "rr", pc=leg != "rr")
        assert 0 < got <= 100 * 1024, (smoother, nu)


@pytest.mark.parametrize("halo", range(0, cuda.ZM_MAX_HALO + 1))
def test_zmarch_shared_memory_fits(halo):
    """A z-marching block's dynamic shared memory (two planes per stage,
    K5's four residual planes, K6's three coarse planes) stays within the
    227 KB a block may opt in to, and under 100 KB, at every halo it
    takes."""
    plane = 4 * cuda.ZM_COLS ** 2
    coarse = 4 * 3 * (cuda.ZM_COLS // 2 + 3) ** 2
    for steps, rr in ((halo - 1, True), (halo, False), (halo - 1, False)):
        if steps < 0:
            continue
        got = cuda.shared_bytes_3d_zm(steps, rr=rr, pc=not rr)
        assert got == 2 * (steps + 1) * plane + (4 * plane if rr else coarse)
        assert got <= 100 * 1024 <= 232448


# --------------------------------------------- K4 on the z-marching tiles
# K4 runs its sweeps alone on the z-marching tile (kSmooth; in bf16 the word
# tile) at the halo steps <= 4, the cube tile beyond: the entry chooses as
# zmarch3d does, instances exist for every step count the tile takes, the
# chunk table and blocks are the other legs' at that halo, and the shared
# memory has no plane for the last stage (no residual reads it).

_CSRC = Path(cuda.__file__).parents[1] / "csrc"


@pytest.mark.parametrize("smoother,nu", _admitted(False))
def test_k4_runs_the_zmarching_tile_at_halos_up_to_4(smoother, nu):
    steps = 2 * nu if smoother == "rbgs" else nu
    assert cuda.zmarch3d(steps) == (steps <= cuda.ZM_MAX_HALO)
    entry = (_CSRC / "mg_smooth3d.cu").read_text()
    assert "const int H = mg_steps(nu, smoother);\n  if (mg3z_takes(H))" in entry
    for src, kernel in (("mg_smooth3d_zm.cu", "MgSmooth3dZm"),
                        ("mg_smooth3d_zw.cu", "MgSmooth3dZmBf16")):
        text = (_CSRC / src).read_text()
        assert f"mg3z_pick_from<{kernel}, 1, MG3Z_MAX_HALO>" in text


@pytest.mark.parametrize("steps", range(1, cuda.ZM_MAX_HALO + 1))
def test_k4_shared_memory(steps):
    """Two planes per stage but the last, f32 cells or words of a pair of
    cells (mg3z_bytes / mg3w_bytes with `smooth`): within 48 KB."""
    f32 = cuda.shared_bytes_3d_zm(steps, smooth=True)
    bf16 = cuda.shared_bytes_3d_zm(steps, dtype=torch.bfloat16, smooth=True)
    assert f32 == 4 * 2 * steps * cuda.ZM_COLS ** 2
    assert bf16 == 4 * 2 * steps * cuda.ZW_LANES * cuda.ZW_ROWS == f32 // 2
    assert f32 <= 48 * 1024
    assert "mg3z_bytes(steps, false, false, true)" in (_CSRC / "mg_smooth3d_zm.cu").read_text()
    assert "MG3W_SMOOTH" in (_CSRC / "mg_smooth3d_zw.cu").read_text()
    assert re.search(r"\(smooth \? steps : steps \+ 1\) \* 2 \* MG3Z_PLANE", _ZM_HEADER)


def test_k4_chunk_table_at_the_main_path():
    """K4 at the tuned scheme's halo 3 (wjacobi nu = 3): in f32 one chunk
    per column at 256^3 (100 blocks, one round) and 128 planes at 512^3;
    in bf16 128 planes at 256^3 (242 blocks, one round of 2 x 132 slots)
    and the whole column at 512^3."""
    bf = torch.bfloat16
    assert (cuda.zm_chunk(256, 3), cuda.blocks3d(256, 3)) == (256, 100)
    assert (cuda.zm_chunk(512, 3), cuda.blocks3d(512, 3)) == (128, 1600)
    assert (cuda.zm_chunk(256, 3, dtype=bf), cuda.blocks3d(256, 3, dtype=bf)) == (128, 242)
    assert (cuda.zm_chunk(512, 3, dtype=bf), cuda.blocks3d(512, 3, dtype=bf)) == (512, 484)
