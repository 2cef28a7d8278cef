"""Hand-written CUDA kernels for the hot 2D and 3D ops on Hopper (port of
the public entry points of ``mgpoisson/kernels/pallas.py``).

Six kernels, built from ``mgpoisson_torch/csrc`` by ``kernels.build`` at
first use, carry the V-cycle; each wrapper routes by rank, a square 2D
array to K1-K3, a cubic 3D array to K4-K6:

  2D                                3D
  K1 ``mg_smooth``                  K4 ``mg_smooth3d``            — ``smooth``
  K2 ``mg_smooth_rr``               K5 ``mg_smooth_rr3d``         — ``smooth_residual_restrict``,
                                                                    ``smooth_residual_restrict_zero``
  K3 ``mg_prolong_correct_smooth``  K6 ``mg_prolong_correct_smooth3d``
                                                                  — ``prolong_correct_smooth``,
                                                                    ``prolong_correct_smooth_rnorm``

Two more carry the fast scheme's fine level on checkerboard-packed state
(``ops.pack_grid``):

  K7 ``mg_packed_rr``  — ``packed_smooth_residual_restrict``
  K8 ``mg_packed_pc``  — ``packed_prolong_correct_smooth``,
                         ``packed_prolong_correct_smooth_rnorm``

Four more carry a sharded level (``shard.spmd``) on one rank's block, the
halo read from the neighbours' strips; each routes by rank like the first
six:

  K9  ``mg_sharded_rr``   K11 ``mg_sharded_rr3d``  — ``smooth_rr_sharded``
  K10 ``mg_sharded_pc``   K12 ``mg_sharded_pc3d``  — ``pc_smooth_sharded``

and two carry the packed fine level on a rank's block of whole rows of a
row-sharded mesh, its halo rows from the neighbours' strips:

  K13 ``mg_sharded_packed_rr`` — ``packed_rr_sharded``
  K14 ``mg_sharded_packed_pc`` — ``packed_pc_sharded``

K4-K6 and the strip entries K11/K12 run two tiles by halo depth
(``zmarch3d``): the z-marching tile of ``csrc/stencil3d_zm.cuh`` at halos
<= 4 (the main path's; K11/K12 in its strip-fed form, over a rank's block
with its own chunk table; K4 its sweeps alone; their bf16 forms the same
march on bf16x2 words, the word tile of ``csrc/stencil3d_zw.cuh``,
``tile3d_zw``), the cube tile of ``csrc/stencil3d.cuh`` beyond.  The 2D
legs K1-K3 and K9/K10 run the
register tile of ``csrc/stencil.cuh``, and so do the packed legs K7/K8
and their strip entries K13/K14 on packed state
(``csrc/stencil_packed.cuh``); the bf16 forms of K7/K8 run the packed
word tile of ``csrc/stencil_packed_w.cuh`` (two packed columns of each
plane per lane as bf16x2 words, ``tile_packed_w``).

K1-K12 have bf16 forms (``mg_smooth_bf16``, ``mg_smooth_rr_bf16``,
``mg_prolong_correct_smooth_bf16``, ``mg_smooth3d_bf16``,
``mg_smooth_rr3d_bf16``, ``mg_prolong_correct_smooth3d_bf16``,
``mg_packed_rr_bf16``, ``mg_packed_pc_bf16``, ``mg_sharded_rr_bf16``,
``mg_sharded_pc_bf16``, ``mg_sharded_rr3d_bf16``, ``mg_sharded_pc3d_bf16``:
the same sources and tiles, bf16 arrays and strips, each op rounded to
bf16 as plain torch rounds it), which the wrappers launch for a bf16
square 2D or cubic 3D array, a bf16 packed one and a bf16 2D or 3D
block.  The packed strip kernels K13/K14 are f32 only, as the JAX
package's packed strip kernels are.

Each wrapper has the signature of its counterpart in ``kernels.ops`` (the
plain version beside it).  A tensor on the CPU goes to that plain
version.  A CUDA tensor launches the kernel, or raises if the kernel does
not take it (``supports``, ``packed_supports``): f32 or bf16, square 2D
or cubic 3D, contiguous, and the sweep count within the kernel's cap.
Which levels
reach these wrappers at all is decided by the rules of
``mgpoisson_torch.kernels``: ``use_kernels``, ``use_packed``,
``use_sharded_kernels`` and ``use_packed_sharded``.  Outputs are fresh
``torch.empty`` buffers (no in-place writes: a tile reads its
neighbours' cells as halo), and launches go on the current stream.

The ops that have no kernel (residual, prolong, coarse_solve, ...) are
the plain ones on every device, as the Pallas module delegates them to
the XLA ops.
"""

from __future__ import annotations

import ctypes

import torch

from mgpoisson_torch.kernels import ops
from mgpoisson_torch.kernels.build import load

SMOOTHERS = {"jacobi": 0, "wjacobi": 1, "rbgs": 2}
BCS = {"ghost0": 0, "face": 1}
PROLONG_KINDS = {"inject": 0, "bilinear": 1}
# 2D per-call sweep cap: the tile's halo grows by the dependency radius
# per sweep (1 for the Jacobi variants, 2 for red-black GS), up to
# MG2_MAX_HALO in csrc/stencil.cuh
MAX_NU = {"jacobi": 8, "wjacobi": 8, "rbgs": 4}
# the 2D register tile (csrc/stencil.cuh): a warp loads TILE_COLS columns
# and R rows with an even halo, TILE_WARPS warps per block in row bands;
# the tile table (mg2_rows) takes R from TILE_ROWS = (small, shallow,
# deep): deep above an even halo of TILE_SHALLOW_HALO, else shallow where
# the level has at least TILE_FILL_WARPS warps of it, else small
TILE_COLS = 64
TILE_WARPS = 2
TILE_ROWS = (16, 24, 40)
TILE_SHALLOW_HALO = 4
TILE_FILL_WARPS = 528
# 3D cap on the halo depth, radius * nu plus the ring a residual reads
# (K5, K6 with rnorm): the z halo the JAX package's planner admits
# (pallas.py _plan3d), so composites take jacobi/wjacobi nu <= 7 and rbgs
# nu <= 3, K4 alone jacobi/wjacobi nu <= 8 and rbgs nu <= 4
MAX_HALO_3D = 8
# K4-K6 and the strip entries K11/K12 at a halo <= ZM_MAX_HALO (K4's is
# its step count) run the z-marching tile of csrc/stencil3d_zm.cuh:
# ZM_COLS x ZM_COLS loaded cells per plane (a warp per row), a chunk of
# planes per block from the chunk table (zm_chunk, over the grid or a
# rank's block, tuned for the ZM_SMS SMs of an H100); deeper halos run the
# cube tile of csrc/stencil3d.cuh (tile3d)
ZM_COLS = 32
ZM_MAX_HALO = 4
ZM_SMS = 132
ZM_MIN_CHUNK = 32
# ... and their bf16 forms there run the word tile of csrc/stencil3d_zw.cuh:
# the same march on bf16x2 words, ZW_LANES lanes of a pair of cells each
# per loaded row of ZM_COLS cells, ZW_ROWS rows per plane, the xy halo
# rounded up to even (tile3d_zw), ZW_MIN_BLOCKS blocks per SM (so the
# chunk table counts ZM_SMS * ZW_MIN_BLOCKS slots)
ZW_LANES = 16
ZW_ROWS = 32
ZW_MIN_BLOCKS = 2
# packed kernels: the JAX package's sweep cap (pallas.py packed_plan)
PACKED_MAX_NU = 3
# the packed word tile of the bf16 forms of K7/K8 (csrc/stencil_packed_w.cuh):
# a warp loads PACKED_W_COLS packed columns of each plane (a word of two per
# lane), its column halo the kernel halo in fine columns rounded up to a
# multiple of 4, and PACKED_W_ROWS = (shallow, deep) rows: shallow at an
# even row halo <= TILE_SHALLOW_HALO
PACKED_W_COLS = 64
PACKED_W_ROWS = (16, 32)

# Launches per kernel, counted where the wrapper launches it; ".zero" and
# ".rnorm" count the flagged launches among them.  Read and reset by
# chip_smoke.py to show that a run went through the kernels.
launches = dict.fromkeys((
    "mg_smooth", "mg_smooth_rr", "mg_smooth_rr.zero",
    "mg_prolong_correct_smooth", "mg_prolong_correct_smooth.rnorm",
    "mg_smooth_bf16", "mg_smooth_rr_bf16", "mg_smooth_rr_bf16.zero",
    "mg_prolong_correct_smooth_bf16", "mg_prolong_correct_smooth_bf16.rnorm",
    "mg_smooth3d", "mg_smooth_rr3d", "mg_smooth_rr3d.zero",
    "mg_prolong_correct_smooth3d", "mg_prolong_correct_smooth3d.rnorm",
    "mg_smooth3d_bf16", "mg_smooth_rr3d_bf16", "mg_smooth_rr3d_bf16.zero",
    "mg_prolong_correct_smooth3d_bf16", "mg_prolong_correct_smooth3d_bf16.rnorm",
    "mg_packed_rr", "mg_packed_pc", "mg_packed_pc.rnorm",
    "mg_packed_rr_bf16", "mg_packed_pc_bf16", "mg_packed_pc_bf16.rnorm",
    "mg_sharded_rr", "mg_sharded_rr.zero", "mg_sharded_pc", "mg_sharded_pc.rnorm",
    "mg_sharded_rr_bf16", "mg_sharded_rr_bf16.zero", "mg_sharded_pc_bf16",
    "mg_sharded_pc_bf16.rnorm",
    "mg_sharded_rr3d", "mg_sharded_rr3d.zero", "mg_sharded_pc3d",
    "mg_sharded_pc3d.rnorm", "mg_sharded_rr3d_bf16", "mg_sharded_rr3d_bf16.zero",
    "mg_sharded_pc3d_bf16", "mg_sharded_pc3d_bf16.rnorm", "mg_sharded_packed_rr", "mg_sharded_packed_pc",
    "mg_sharded_packed_pc.rnorm"), 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _steps(nu, smoother):
    """Shrinking-region steps of nu sweeps: red-black GS takes one per
    colour."""
    return 2 * nu if smoother == "rbgs" else nu


def tile2d(nl: int, ml: int, halo: int) -> tuple[int, int]:
    """(rows, columns) of the interior of one block of a 2D launch on an
    (nl, ml) array or block whose kernel halo is `halo` (K1 steps, K2/K3
    and K9/K10 steps + 1): the tile table of csrc/stencil.cuh, mg2_rows and
    mg2_grid."""
    hr = halo + (halo & 1)
    cols = TILE_COLS - 2 * hr
    small, shallow, deep = TILE_ROWS
    if hr > TILE_SHALLOW_HALO:
        rows = deep
    else:
        warps = -(-ml // cols) * -(-nl // (shallow - 2 * hr))
        rows = shallow if warps >= TILE_FILL_WARPS else small
    return TILE_WARPS * (rows - 2 * hr), cols


def blocks2d(nl: int, ml: int, halo: int) -> int:
    """Number of blocks of a 2D launch (one rnorm partial each)."""
    rows, cols = tile2d(nl, ml, halo)
    return -(-nl // rows) * -(-ml // cols)


def tile3d(halo: int) -> int:
    """Interior side of a 3D block with this halo depth: 16 while three
    (16 + 2 halo)^3 f32 buffers fit in shared memory, else 8 (see
    csrc/stencil3d.cuh)."""
    return 16 if halo <= 4 else 8


def shared_bytes_3d(halo: int, pc: bool = False) -> int:
    """Dynamic shared memory of one 3D block at this halo depth, as the C
    entries size it: u ping-pong and f, (T + 2 halo)^3 f32 each, and for
    K6 (`pc`) the coarse tile (T/2 + 2 (ceil(halo/2) + 1))^3 and one
    reduction slot per thread (1024)."""
    t = tile3d(halo)
    floats = 3 * (t + 2 * halo) ** 3
    if pc:
        floats += (t // 2 + 2 * ((halo + 1) // 2 + 1)) ** 3 + 1024
    return 4 * floats


def zmarch3d(halo: int) -> bool:
    """Whether the 3D legs (K4 at the halo steps, K5, K6 and their strip
    entries K11, K12 at steps + 1) run the z-marching tile at this halo
    depth (in bf16 the word tile), else the cube tile:
    csrc/stencil3d_zm.cuh mg3z_takes."""
    return halo <= ZM_MAX_HALO


def tile3d_zm(halo: int) -> int:
    """Interior cells per xy side of a z-marching block (mg3z_side)."""
    return ZM_COLS - 2 * halo


def tile3d_zw(halo: int) -> tuple[int, int]:
    """(rows, columns) of the interior of a word-tile block, the bf16
    z-marching legs' (mg3w_rows, mg3w_cols): the halo rounded up to even
    on both xy axes."""
    hw = halo + (halo & 1)
    return ZW_ROWS - 2 * hw, ZM_COLS - 2 * hw


def _zm_tile(halo, dtype):
    """(rows, columns, slots) of the z-marching tile that runs a leg of
    this dtype at this halo: the f32 tile's, or the word tile's in bf16."""
    if dtype == torch.bfloat16:
        return (*tile3d_zw(halo), ZM_SMS * ZW_MIN_BLOCKS)
    t = tile3d_zm(halo)
    return t, t, ZM_SMS


def zm_chunk(n: int, halo: int, nzl: int | None = None, nyl: int | None = None,
             dtype: torch.dtype = torch.float32) -> int:
    """Planes per z-marching block at this halo (K4's is its step count) on
    a block of nzl planes of nyl rows of n cells (by default the whole n^3
    level): the chunk table of mg3z_chunk (in bf16 the word tile's,
    mg3w_chunk), the same for every leg.  One f32 block runs
    per SM (ZW_MIN_BLOCKS word-tile blocks), so a launch over ceil(n/T)
    ceil(nyl/T) columns takes ceil(blocks / slots) rounds of c + 2 halo
    plane-steps; the chunk c (nzl, nzl/2, ... down to ZM_MIN_CHUNK) with
    the fewest in all, the larger on a tie."""
    nzl = n if nzl is None else nzl
    nyl = n if nyl is None else nyl
    ty, tx, slots = _zm_tile(halo, dtype)
    cols = -(-n // tx) * -(-nyl // ty)
    best, best_cost, c = nzl, None, nzl
    while c >= 1 and nzl % c == 0 and (c == nzl or c >= ZM_MIN_CHUNK):
        cost = -(-(cols * (nzl // c)) // slots) * (c + 2 * halo)
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
        if c & 1:
            break
        c //= 2
    return best


def blocks3d(n: int, halo: int, nzl: int | None = None, nyl: int | None = None,
             dtype: torch.dtype = torch.float32) -> int:
    """Number of blocks of a 3D leg's launch at this halo (one rnorm partial
    each) on a block of nzl planes of nyl rows of n cells (by default the
    whole n^3 level): the z-marching tile's (x, y, chunk) grid (in bf16 the
    word tile's), or the cube tile's T^3 blocks."""
    nzl = n if nzl is None else nzl
    nyl = n if nyl is None else nyl
    if zmarch3d(halo):
        ty, tx, _ = _zm_tile(halo, dtype)
        return -(-n // tx) * -(-nyl // ty) * -(-nzl // zm_chunk(n, halo, nzl, nyl, dtype))
    t = tile3d(halo)
    return -(-n // t) * -(-nyl // t) * -(-nzl // t)


def shared_bytes_3d_zm(steps: int, rr: bool = False, pc: bool = False,
                       dtype: torch.dtype = torch.float32, smooth: bool = False) -> int:
    """Dynamic shared memory of one whole-grid z-marching block, as the C
    entries size it (mg3z_bytes; in bf16 the word tile's mg3w_bytes): two
    planes per stage (steps + 1 stages, K4's sweeps alone (`smooth`) steps:
    no residual reads its last; f32 cells, or words of a pair of cells), K5's
    ring of four residual planes (`rr`), K6's ring of three f32 coarse
    planes (`pc`)."""
    bf16 = dtype == torch.bfloat16
    rows = ZW_ROWS if bf16 else ZM_COLS
    plane = rows * (ZW_LANES if bf16 else ZM_COLS)
    floats = (steps + (not smooth)) * 2 * plane + (4 * plane if rr else 0)
    if pc:
        floats += 3 * (ZM_COLS // 2 + 3) * (rows // 2 + 3)
    return 4 * floats


def supports(n: int, dtype: torch.dtype, nu: int, smoother: str, ndim: int = 2,
             residual: bool = True) -> bool:
    """Whether the kernels take an n^ndim level of this dtype with nu
    sweeps of this smoother: f32 or bf16 (each kernel's bf16 form).  2D:
    nu <= MAX_NU[smoother] for K1-K3.  3D: the halo, radius * nu plus one
    ring where a residual follows the sweeps (`residual`: K5, K6 with
    rnorm), is at most MAX_HALO_3D."""
    if (n < 2 or smoother not in SMOOTHERS or nu < 0
            or dtype not in (torch.float32, torch.bfloat16)):
        return False
    if ndim == 2:
        return nu <= MAX_NU[smoother]
    return ndim == 3 and _steps(nu, smoother) + residual <= MAX_HALO_3D


def _name(base, u):
    """The C entry of a leg for u: the 2D or the 3D one (for the packed
    legs the 2D one), its f32 or its bf16 form."""
    name = base + "3d" if u.ndim == 3 else base
    return name + "_bf16" if u.dtype == torch.bfloat16 else name


def _check(name, u, nu, smoother, bc, residual, *others):
    if u.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {u.device}")
    if u.ndim not in (2, 3) or len(set(u.shape)) != 1:
        raise ValueError(f"{name}: needs a square 2D or cubic 3D array, got "
                         f"{tuple(u.shape)}")
    if (not supports(u.shape[0], u.dtype, nu, smoother, u.ndim, residual)
            or bc not in BCS):
        raise ValueError(f"{name}: no kernel for n={u.shape[0]} ndim={u.ndim} "
                         f"{u.dtype} nu={nu} smoother={smoother!r} bc={bc!r}")
    _check_operands(name, u, *others)


def _check_operands(name, u, *others):
    """Every operand, u included, on u's device, of u's dtype, of its
    expected shape and contiguous."""
    for t, shape in ((u, u.shape), *others):
        if t.device != u.device or t.dtype != u.dtype or t.shape != shape:
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match {tuple(shape)} "
                             f"{u.dtype} on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _half(shape):
    return torch.Size(s // 2 for s in shape)


def _geometry(u, halo):
    """The launch's size arguments: n, and in 3D the cube tile's side too
    (used where zmarch3d(halo) is false, as by the strip entries' `tile`)."""
    n = u.shape[0]
    return (n,) if u.ndim == 2 else (n, tile3d(halo))


def rnorm_partials(shape, nu: int, smoother: str, n_global: int,
                   dtype: torch.dtype = torch.float32) -> int:
    """Number of f32 Sigma r^2 partials, one per thread block, that a
    whole-grid up-leg with rnorm (K3, K6) of this dtype writes on an array
    of this shape of a grid of side n_global: in 2D the tile table's blocks
    at the halo steps + 1, in 3D the blocks of blocks3d at that halo (the
    word tile's in bf16)."""
    halo = _steps(nu, smoother) + 1
    if len(shape) == 2:
        return blocks2d(shape[0], shape[1], halo)
    return blocks3d(n_global, halo, dtype=dtype)


def strip_rnorm_partials(shape, nu: int, smoother: str, n_global: int,
                         dtype: torch.dtype = torch.float32) -> int:
    """The same for a strip up-leg (K10, K12) on one rank's block of this
    shape: in 2D the tile table's blocks, in 3D the blocks of blocks3d over
    the (shape[0], shape[1], n_global) block (x whole) at the halo
    steps + 1: the z-marching grid at halos <= ZM_MAX_HALO (the word
    tile's in bf16), the cube tile's T^3 blocks beyond."""
    halo = _steps(nu, smoother) + 1
    if len(shape) == 2:
        return blocks2d(shape[0], shape[1], halo)
    return blocks3d(n_global, halo, shape[0], shape[1], dtype)


def _scalars(h, ndim, dtype=torch.float32):
    """1/h^2, 1/adiag and adiag of the 2*ndim+1-point operator (adiag =
    -2*ndim/h^2) for a kernel of this dtype.  In f32 the double values
    rounded to f32, as the f32 kernels have always taken them.  In bf16 the
    constants plain torch uses on the card with ops' rounded h^2 and adiag
    (ops._level): it divides a tensor by a Python scalar c as a product by
    1/c taken in f32 from f32(c), and multiplies by f32(c)."""
    if dtype != torch.bfloat16:
        hsq = h * h
        adiag = -2.0 * ndim / hsq
        return ctypes.c_float(1.0 / hsq), ctypes.c_float(1.0 / adiag), ctypes.c_float(adiag)
    hsq, adiag, _, _ = ops._level(h, ndim, dtype)
    one = torch.tensor(1.0)
    return (ctypes.c_float(float(one / hsq)), ctypes.c_float(float(one / adiag)),
            ctypes.c_float(adiag))


def _launch(name, u, *args):
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        lib = load()
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{lib.mg_error_string(rc).decode()}")
    launches[name] += 1


def smooth(u, f, h, nu, smoother="jacobi", bc="ghost0"):
    """nu smoother sweeps in one pass (K1, K4).  K4 runs at the halo
    steps, on the z-marching tile (in bf16 the word tile) where zmarch3d
    takes it, else on the cube tile of side tile3d(steps)."""
    if u.device.type == "cpu":
        return ops.smooth(u, f, h, nu, smoother, bc)
    name = _name("mg_smooth", u)
    _check(name, u, nu, smoother, bc, False, (f, u.shape))
    if nu == 0:
        return u
    out = torch.empty_like(u)
    inv_hsq, inv_adiag, _ = _scalars(h, u.ndim, u.dtype)
    _launch(name, u, u.data_ptr(), f.data_ptr(), out.data_ptr(),
            *_geometry(u, _steps(nu, smoother)), nu, SMOOTHERS[smoother],
            BCS[bc], inv_hsq, inv_adiag)
    return out


def _rr(u, f, h, nu, smoother, bc, zero):
    name = _name("mg_smooth_rr", f)
    out = torch.empty_like(f)
    R = torch.empty(_half(f.shape), dtype=f.dtype, device=f.device)
    inv_hsq, inv_adiag, adiag = _scalars(h, f.ndim, f.dtype)
    _launch(name, f, None if zero else u.data_ptr(), f.data_ptr(),
            out.data_ptr(), R.data_ptr(), *_geometry(f, _steps(nu, smoother) + 1),
            nu, SMOOTHERS[smoother], BCS[bc], inv_hsq, inv_adiag, adiag, int(zero))
    if zero:
        launches[name + ".zero"] += 1
    return out, R


def smooth_residual_restrict(u, f, h, nu, smoother="jacobi", bc="ghost0"):
    """nu sweeps, then R = restrict(residual). Returns (u, R) (K2, K5)."""
    if u.device.type == "cpu":
        return ops.smooth_residual_restrict(u, f, h, nu, smoother, bc)
    _check(_name("mg_smooth_rr", u), u, nu, smoother, bc, True, (f, u.shape))
    return _rr(u, f, h, nu, smoother, bc, zero=False)


def smooth_residual_restrict_zero(f, h, nu, smoother="jacobi", bc="ghost0"):
    """The down-leg from u identically zero; reads f only (K2, K5, from
    zero)."""
    if f.device.type == "cpu":
        return ops.smooth_residual_restrict_zero(f, h, nu, smoother, bc)
    _check(_name("mg_smooth_rr", f), f, nu, smoother, bc, True)
    return _rr(None, f, h, nu, smoother, bc, zero=True)


def _pc(u, f, V, h, nu, smoother, bc, kind, rnorm):
    name = _name("mg_prolong_correct_smooth", u)
    if kind not in PROLONG_KINDS:
        raise ValueError(f"{name}: unknown prolongation {kind!r}")
    _check(name, u, nu, smoother, bc, rnorm, (f, u.shape), (V, _half(u.shape)))
    out = torch.empty_like(u)
    halo = _steps(nu, smoother) + rnorm
    partials = (torch.empty(rnorm_partials(u.shape, nu, smoother, u.shape[0], u.dtype),
                            dtype=torch.float32, device=u.device)
                if rnorm else None)
    inv_hsq, inv_adiag, adiag = _scalars(h, u.ndim, u.dtype)
    _launch(name, u, u.data_ptr(), f.data_ptr(), V.data_ptr(), out.data_ptr(),
            partials.data_ptr() if rnorm else None, *_geometry(u, halo), nu,
            SMOOTHERS[smoother], BCS[bc], PROLONG_KINDS[kind], inv_hsq,
            inv_adiag, adiag, int(rnorm))
    if rnorm:
        launches[name + ".rnorm"] += 1
    return out, partials


def prolong_correct_smooth(u, f, V, h, nu, smoother="jacobi", bc="ghost0",
                           kind="inject"):
    """u += P(V), then nu sweeps (K3, K6)."""
    if u.device.type == "cpu":
        return ops.prolong_correct_smooth(u, f, V, h, nu, smoother, bc, kind)
    return _pc(u, f, V, h, nu, smoother, bc, kind, rnorm=False)[0]


def prolong_correct_smooth_rnorm(u, f, V, h, nu, smoother="jacobi",
                                 bc="ghost0", kind="inject"):
    """The up-leg and sum(r^2) of the result's zero-ghost residual:
    (u, sum(r^2)).  The kernel writes one f32 partial per block; they are
    summed here in a fixed order (K3, K6 with rnorm)."""
    if u.device.type == "cpu":
        return ops.prolong_correct_smooth_rnorm(u, f, V, h, nu, smoother, bc,
                                                kind)
    out, partials = _pc(u, f, V, h, nu, smoother, bc, kind, rnorm=True)
    return out, torch.sum(partials)


# ------------------------------------------------ packed-persistent fine level

def packed_supports(n: int, dtype: torch.dtype, nu: int) -> bool:
    """Whether K7/K8 take a packed n x n level of this dtype with nu rbgs
    sweeps: f32 or bf16 (each kernel's bf16 form), even n, 1 <= nu <=
    PACKED_MAX_NU."""
    return (dtype in (torch.float32, torch.bfloat16) and n >= 2 and n % 2 == 0
            and 1 <= nu <= PACKED_MAX_NU)


def tile_packed_w(halo: int) -> tuple[int, int]:
    """(rows, packed columns of each plane) of the interior of one block of
    the packed word tile at this kernel halo, on a packed level of any side
    (csrc/stencil_packed_w.cuh mg2w_rows, mg2w_grid): the row halo rounded
    up to even, the column halo to a multiple of 4 fine columns."""
    hr = halo + (halo & 1)
    rows = PACKED_W_ROWS[hr > TILE_SHALLOW_HALO]
    return TILE_WARPS * (rows - 2 * hr), PACKED_W_COLS - (halo + 3) // 4 * 4


def packed_rnorm_partials(nl: int, n: int, nu: int, dtype: torch.dtype = torch.float32) -> int:
    """Number of f32 Sigma r^2 partials, one per thread block, that the
    packed up-leg with rnorm (K8 on the grid, nl = n; K14 on a block of nl
    whole rows) writes at the halo 2 nu + 1: in f32 the 2D register tile on
    the fine geometry of the packed (nl, n) array (blocks2d), in bf16 (K8
    only) the packed word tile's blocks (tile_packed_w)."""
    if dtype != torch.bfloat16:
        return blocks2d(nl, n, 2 * nu + 1)
    rows, cols = tile_packed_w(2 * nu + 1)
    return -(-nl // rows) * -(-(n // 2) // cols)


def _check_packed(name, up, nu, *others):
    if up.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {up.device}")
    if up.ndim != 2 or up.shape[0] != up.shape[1]:
        raise ValueError(f"{name}: needs a square packed 2D array, got {tuple(up.shape)}")
    if not packed_supports(up.shape[0], up.dtype, nu):
        raise ValueError(f"{name}: no kernel for n={up.shape[0]} {up.dtype} nu={nu}")
    _check_operands(name, up, *others)


def _packed_scalars(h, dtype=torch.float32):
    """-h^2/4 and 1/h^2, as the plain packed ops of this dtype multiply by
    them (ops._level): bf16 values in bf16."""
    return [ctypes.c_float(c) for c in ops._level(h, 2, dtype)[2:]]


def packed_smooth_residual_restrict(up, fp, h, nu):
    """Packed down-leg: nu rbgs sweeps, residual, restriction.  Returns
    (up', Rc), Rc the unpacked (n/2, n/2) coarse rhs (K7)."""
    if up.device.type == "cpu":
        return ops.packed_smooth_residual_restrict(up, fp, h, nu)
    name = _name("mg_packed_rr", up)
    _check_packed(name, up, nu, (fp, up.shape))
    out = torch.empty_like(up)
    Rc = torch.empty(_half(up.shape), dtype=up.dtype, device=up.device)
    _launch(name, up, up.data_ptr(), fp.data_ptr(), out.data_ptr(), Rc.data_ptr(),
            up.shape[0], nu, *_packed_scalars(h, up.dtype))
    return out, Rc


def _packed_pc(up, fp, V, h, nu, kind, rnorm):
    name = _name("mg_packed_pc", up)
    if kind not in PROLONG_KINDS:
        raise ValueError(f"{name}: unknown prolongation {kind!r}")
    _check_packed(name, up, nu, (fp, up.shape), (V, _half(up.shape)))
    n = up.shape[0]
    out = torch.empty_like(up)
    partials = (torch.empty(packed_rnorm_partials(n, n, nu, up.dtype), dtype=torch.float32,
                            device=up.device) if rnorm else None)
    _launch(name, up, up.data_ptr(), fp.data_ptr(), V.data_ptr(), out.data_ptr(),
            partials.data_ptr() if rnorm else None, n, nu, PROLONG_KINDS[kind],
            *_packed_scalars(h, up.dtype), int(rnorm))
    if rnorm:
        launches[name + ".rnorm"] += 1
    return out, partials


def packed_prolong_correct_smooth(up, fp, V, h, nu, kind="inject"):
    """Packed up-leg: up += P(V), V the unpacked coarse correction, then
    nu rbgs sweeps (K8)."""
    if up.device.type == "cpu":
        return ops.packed_prolong_correct_smooth(up, fp, V, h, nu, kind)
    return _packed_pc(up, fp, V, h, nu, kind, rnorm=False)[0]


def packed_prolong_correct_smooth_rnorm(up, fp, V, h, nu, kind="inject"):
    """The packed up-leg and sum(r^2) of the result's zero-ghost residual:
    (up', sum(r^2)), from one f32 partial per block summed here in a fixed
    order (K8 with rnorm)."""
    if up.device.type == "cpu":
        return ops.packed_prolong_correct_smooth_rnorm(up, fp, V, h, nu, kind)
    out, partials = _packed_pc(up, fp, V, h, nu, kind, rnorm=True)
    return out, torch.sum(partials)


# ------------------------------------------------ one block of a sharded level

def sharded_supports(ndim: int, dtype: torch.dtype) -> bool:
    """Whether a strip kernel takes a block of this rank and dtype: f32 or
    bf16 in 2D and 3D (K9-K12 and their bf16 forms)."""
    return ndim in (2, 3) and dtype in (torch.float32, torch.bfloat16)


def _check_sharded(name, f, origin, n_global, nu, smoother, bc, residual, *others):
    """A rank's block f of a grid of side n_global at `origin`: on the
    card, 2D or 3D with whole x rows, of a dtype with a strip kernel
    (``sharded_supports``), even extents and origin inside the grid, the
    sweep count within the cap, and the other operands matching
    (``_check_operands``)."""
    if f.ndim not in (2, 3) or (f.ndim == 3 and f.shape[2] != n_global):
        raise ValueError(f"{name}: needs a 2D block or a 3D block of whole rows, got "
                         f"{tuple(f.shape)} of a grid of side {n_global}")
    if (not sharded_supports(f.ndim, f.dtype)
            or not supports(n_global, f.dtype, nu, smoother, f.ndim, residual)
            or bc not in BCS):
        raise ValueError(f"{name}: no kernel for n={n_global} ndim={f.ndim} {f.dtype} "
                         f"nu={nu} smoother={smoother!r} bc={bc!r}")
    (nl, ml), (r0, c0) = f.shape[:2], origin
    if (min(nl, ml) < 2 or (nl | ml | r0 | c0) & 1 or min(r0, c0) < 0
            or r0 + nl > n_global or c0 + ml > n_global):
        raise ValueError(f"{name}: block {tuple(f.shape)} at {tuple(origin)} is not an "
                         f"even block of a grid of side {n_global}")
    if f.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {f.device}")
    _check_operands(name, f, *others)


def _strip_args(name, strips, x, need, n_global, col0):
    """The pointers of block x's (top, bot, left, right) strips and their
    depth D >= need, checked against the layout of kernels.ops: top/bot
    (D, *x.shape[1:]), left/right (x.shape[0] + 2D, D, *x.shape[2:]), or
    both None for a block that spans every column (starts at column
    col0 = 0 and has n_global of them)."""
    top, bot, left, right = strips
    d = top.shape[0]
    if d < need:
        raise ValueError(f"{name}: strips {d} deep, the kernel's halo is {need}")
    tb = torch.Size((d, *x.shape[1:]))
    pairs = [(top, tb), (bot, tb)]
    if left is None or right is None:
        if left is not right or col0 != 0 or x.shape[1] != n_global:
            raise ValueError(f"{name}: left/right strips may be None only for a block "
                             "that spans every column")
    else:
        lr = torch.Size((x.shape[0] + 2 * d, d, *x.shape[2:]))
        pairs += [(left, lr), (right, lr)]
    _check_operands(name, x, *pairs)
    return [None if t is None else t.data_ptr() for t in strips], d


def _sharded_geometry(x, origin, n_global):
    return (n_global, x.shape[0], x.shape[1], int(origin[0]), int(origin[1]))


def smooth_rr_sharded(u, f, ustrips, fstrips, origin, n_global, h, nu,
                      smoother="jacobi", bc="ghost0", zero=False):
    """The down-leg of one rank's block, the halo from the neighbours'
    strips: returns (u, R) (K9, K11; with `zero`, u is identically 0 and
    neither u nor its strips are read)."""
    if f.device.type == "cpu":
        return ops.smooth_rr_sharded(u, f, ustrips, fstrips, origin, n_global, h, nu,
                                     smoother, bc, zero)
    name = _name("mg_sharded_rr", f)
    halo = _steps(nu, smoother) + 1
    _check_sharded(name, f, origin, n_global, nu, smoother, bc, True,
                   *(() if zero else ((u, f.shape),)))
    fptrs, d = _strip_args(name, fstrips, f, halo, n_global, origin[1])
    uptrs = [None] * 4
    if not zero:
        uptrs, du = _strip_args(name, ustrips, f, halo, n_global, origin[1])
        if du != d:
            raise ValueError(f"{name}: u strips {du} deep, f strips {d}")
    out = torch.empty_like(f)
    R = torch.empty(_half(f.shape), dtype=f.dtype, device=f.device)
    tile = (tile3d(halo),) if f.ndim == 3 else ()
    _launch(name, f, None if zero else u.data_ptr(), f.data_ptr(), out.data_ptr(),
            R.data_ptr(), *uptrs, *fptrs, *_sharded_geometry(f, origin, n_global), d, *tile,
            nu, SMOOTHERS[smoother], BCS[bc], *_scalars(h, f.ndim, f.dtype), int(zero))
    if zero:
        launches[name + ".zero"] += 1
    return out, R


def pc_smooth_sharded(u, f, V, ustrips, fstrips, vstrips, origin, n_global, h, nu,
                      smoother="jacobi", bc="ghost0", kind="inject", rnorm=False):
    """The up-leg of one rank's block: u += P(V), V the coarse block with
    its coarse strips, then nu sweeps; with rnorm also the block's sum(r^2)
    of the zero-ghost residual, from one f32 partial per thread block summed
    here in a fixed order: u, or (u, sum(r^2)) (K10, K12)."""
    if u.device.type == "cpu":
        return ops.pc_smooth_sharded(u, f, V, ustrips, fstrips, vstrips, origin,
                                     n_global, h, nu, smoother, bc, kind, rnorm)
    name = _name("mg_sharded_pc", u)
    if kind not in PROLONG_KINDS:
        raise ValueError(f"{name}: unknown prolongation {kind!r}")
    halo = _steps(nu, smoother) + bool(rnorm)
    _check_sharded(name, u, origin, n_global, nu, smoother, bc, rnorm,
                   (f, u.shape), (V, _half(u.shape)))
    uptrs, d = _strip_args(name, ustrips, u, halo, n_global, origin[1])
    fptrs, df = _strip_args(name, fstrips, u, halo, n_global, origin[1])
    vptrs, dv = _strip_args(name, vstrips, V, ops.coarse_depth(halo), n_global // 2,
                            origin[1] // 2)
    if df != d:
        raise ValueError(f"{name}: u strips {d} deep, f strips {df}")
    out = torch.empty_like(u)
    partials = None
    if rnorm:
        partials = torch.empty(strip_rnorm_partials(u.shape, nu, smoother, n_global, u.dtype),
                               dtype=torch.float32, device=u.device)
    tile = (tile3d(halo),) if u.ndim == 3 else ()
    _launch(name, u, u.data_ptr(), f.data_ptr(), V.data_ptr(), out.data_ptr(),
            None if partials is None else partials.data_ptr(), *uptrs, *fptrs, *vptrs,
            *_sharded_geometry(u, origin, n_global), d, dv, *tile, nu, SMOOTHERS[smoother],
            BCS[bc], PROLONG_KINDS[kind], *_scalars(h, u.ndim, u.dtype), int(bool(rnorm)))
    if not rnorm:
        return out
    launches[name + ".rnorm"] += 1
    return out, torch.sum(partials)


# ------------------------- the packed fine level on one block of a row-sharded mesh

def _check_packed_sharded(name, up, origin, n_global, nu, *others):
    """A rank's packed block up of a grid of side n_global at `origin`: on
    the card, f32 (the JAX package's packed strip kernels are f32 only:
    mgpoisson/cycle/packed.py supported_spmd), whole rows (nl, n_global)
    from column 0, nl and the first row even and the block inside the grid,
    1 <= nu <= PACKED_MAX_NU, and the other operands matching
    (``_check_operands``)."""
    if up.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {up.device}")
    if up.ndim != 2 or up.shape[1] != n_global or origin[1] != 0:
        raise ValueError(f"{name}: needs a packed block of whole rows (nl, {n_global}) "
                         f"at column 0, got {tuple(up.shape)} at {tuple(origin)}")
    if up.dtype != torch.float32 or not packed_supports(n_global, up.dtype, nu):
        raise ValueError(f"{name}: no kernel for n={n_global} {up.dtype} nu={nu}"
                         + (" (f32 only, as the JAX package's packed strip kernels are)"
                            if up.dtype == torch.bfloat16 else ""))
    nl, r0 = up.shape[0], origin[0]
    if nl < 2 or (nl | r0) & 1 or r0 < 0 or r0 + nl > n_global:
        raise ValueError(f"{name}: block {tuple(up.shape)} at {tuple(origin)} is not an "
                         f"even block of a grid of side {n_global}")
    _check_operands(name, up, *others)


def _row_strip_args(name, strips, x, need, n_global):
    """The (top, bot) pointers of block x's row strips and their depth D >=
    need (``_strip_args`` for a block that spans every column)."""
    if len(strips) != 4 or strips[2] is not None or strips[3] is not None:
        raise ValueError(f"{name}: a packed block takes (top, bot, None, None) row strips")
    ptrs, d = _strip_args(name, strips, x, need, n_global, 0)
    return ptrs[:2], d


def packed_rr_sharded(up, fp, ustrips, fstrips, origin, n_global, h, nu):
    """The packed down-leg of one rank's block of whole rows, its halo rows
    from the neighbours' strips: returns (up', Rc), Rc the block's UNPACKED
    coarse rhs (K13)."""
    if up.device.type == "cpu":
        return ops.packed_rr_sharded(up, fp, ustrips, fstrips, origin, n_global, h, nu)
    name = "mg_sharded_packed_rr"
    halo = 2 * nu + 1
    _check_packed_sharded(name, up, origin, n_global, nu, (fp, up.shape))
    uptrs, d = _row_strip_args(name, ustrips, up, halo, n_global)
    fptrs, df = _row_strip_args(name, fstrips, up, halo, n_global)
    if df != d:
        raise ValueError(f"{name}: u strips {d} deep, f strips {df}")
    out = torch.empty_like(up)
    Rc = torch.empty(_half(up.shape), dtype=up.dtype, device=up.device)
    _launch(name, up, up.data_ptr(), fp.data_ptr(), out.data_ptr(), Rc.data_ptr(), *uptrs,
            *fptrs, n_global, up.shape[0], int(origin[0]), d, nu, *_packed_scalars(h))
    return out, Rc


def packed_pc_sharded(up, fp, V, ustrips, fstrips, vstrips, origin, n_global, h, nu,
                      kind="inject", rnorm=False):
    """The packed up-leg of one rank's block of whole rows: up += P(V), V
    the block's unpacked coarse correction with its coarse row strips, then
    nu rbgs sweeps; with rnorm also the block's sum(r^2), from one f32
    partial per thread block summed here in a fixed order: up', or (up',
    sum(r^2)) (K14)."""
    if up.device.type == "cpu":
        return ops.packed_pc_sharded(up, fp, V, ustrips, fstrips, vstrips, origin,
                                     n_global, h, nu, kind, rnorm)
    name = "mg_sharded_packed_pc"
    if kind not in PROLONG_KINDS:
        raise ValueError(f"{name}: unknown prolongation {kind!r}")
    halo = 2 * nu + bool(rnorm)
    _check_packed_sharded(name, up, origin, n_global, nu, (fp, up.shape),
                          (V, _half(up.shape)))
    uptrs, d = _row_strip_args(name, ustrips, up, halo, n_global)
    fptrs, df = _row_strip_args(name, fstrips, up, halo, n_global)
    vptrs, dv = _row_strip_args(name, vstrips, V, ops.coarse_depth(halo), n_global // 2)
    if df != d:
        raise ValueError(f"{name}: u strips {d} deep, f strips {df}")
    nl = up.shape[0]
    out = torch.empty_like(up)
    partials = None
    if rnorm:
        partials = torch.empty(packed_rnorm_partials(nl, n_global, nu), dtype=torch.float32,
                               device=up.device)
    _launch(name, up, up.data_ptr(), fp.data_ptr(), V.data_ptr(), out.data_ptr(),
            None if partials is None else partials.data_ptr(), *uptrs, *fptrs, *vptrs,
            n_global, nl, int(origin[0]), d, dv, nu, PROLONG_KINDS[kind],
            *_packed_scalars(h), int(bool(rnorm)))
    if not rnorm:
        return out
    launches[name + ".rnorm"] += 1
    return out, torch.sum(partials)


# the ops the cycle also reaches through this module that have no kernel:
# the plain versions on every device (the packing is exact data movement,
# a view and a row-parity select)
pack_grid = ops.pack_grid
unpack_grid = ops.unpack_grid
residual = ops.residual
restrict = ops.restrict
prolong = ops.prolong
prolong_correct = ops.prolong_correct
residual_restrict = ops.residual_restrict
coarse_solve = ops.coarse_solve
