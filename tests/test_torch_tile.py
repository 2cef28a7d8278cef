"""The geometry of the 2D register tile on the CPU: kernels.cuda's mirror of
the tile table of csrc/stencil.cuh (tile2d, blocks2d), which sizes the
rnorm partials of K3 and K10, and the sweep caps of cuda.supports.

For every power-of-two side 2 ... 32768 and every (smoother, nu) that
supports admits: each warp's tile has the shape the kernels assume (rows
from the table, an even halo no shallower than the kernel's and within
MG2_MAX_HALO, even interiors), the blocks' interiors cover the array with
no block beyond it, and the partials count equals that launch's block
count, on the whole grid (K3) and on a block of a (2, 2) and a (4, 1) mesh
(K10)."""

import re
from pathlib import Path

import pytest
import torch

from mgpoisson_torch.kernels import cuda

# one intra-op thread per process: tier-1 runs six test workers at once, and
# torch's default of a thread per core oversubscribed the CPU ~10-fold
torch.set_num_threads(1)

SIDES = [2 ** k for k in range(1, 16)]
HEADER = (Path(cuda.__file__).parents[1] / "csrc" / "stencil.cuh").read_text()
MAX_HALO = int(re.search(r"#define MG2_MAX_HALO (\d+)", HEADER).group(1))
# the sweep caps cuda.supports admitted before the register tile
CAPS = {"jacobi": 8, "wjacobi": 8, "rbgs": 4}


def _steps(smoother, nu):
    return 2 * nu if smoother == "rbgs" else nu


def _launch_blocks(nl, ml, halo):
    """The launch of csrc/stencil.cuh on an (nl, ml) block, checked warp by
    warp: returns its number of blocks."""
    rows, cols = cuda.tile2d(nl, ml, halo)
    hr = halo + (halo & 1)
    warp_rows = rows // cuda.TILE_WARPS
    loaded = warp_rows + 2 * hr
    assert loaded in cuda.TILE_ROWS and rows % cuda.TILE_WARPS == 0
    assert hr >= halo and hr % 2 == 0 and hr <= MAX_HALO
    assert warp_rows >= 2 and warp_rows % 2 == 0 and cols >= 2 and cols % 2 == 0
    assert cols == cuda.TILE_COLS - 2 * hr
    # the table: the deep tile at deep halos; at shallow ones the shallow
    # tile where the level fills the card with it, else the small one
    small, shallow, deep = cuda.TILE_ROWS
    if hr > cuda.TILE_SHALLOW_HALO:
        assert loaded == deep
    else:
        fills = -(-ml // cols) * -(-nl // (shallow - 2 * hr)) >= cuda.TILE_FILL_WARPS
        assert loaded == (shallow if fills else small)
    gy, gx = -(-nl // rows), -(-ml // cols)
    # the interiors cover the block, and every block owns a cell of it
    assert gy * rows >= nl and (gy - 1) * rows < nl
    assert gx * cols >= ml and (gx - 1) * cols < ml
    assert cuda.blocks2d(nl, ml, halo) == gx * gy
    return gx * gy


@pytest.mark.parametrize("smoother", sorted(CAPS))
@pytest.mark.parametrize("launch", ["K3", "K10 (2, 2)", "K10 (4, 1)"])
def test_rnorm_partials_match_the_launch(smoother, launch):
    mesh = {"K3": (1, 1), "K10 (2, 2)": (2, 2), "K10 (4, 1)": (4, 1)}[launch]
    for n in SIDES:
        if n // mesh[0] < 2:
            continue
        shape = (n // mesh[0], n // mesh[1])
        for nu in range(1, CAPS[smoother] + 1):
            assert cuda.supports(n, torch.float32, nu, smoother)
            for halo in (_steps(smoother, nu), _steps(smoother, nu) + 1):   # K1; K2, K3
                _launch_blocks(*shape, halo)
            assert (cuda.rnorm_partials(shape, nu, smoother, n)
                    == _launch_blocks(*shape, _steps(smoother, nu) + 1))


@pytest.mark.parametrize("smoother", sorted(CAPS))
def test_supports_admits_what_it_admitted(smoother):
    for n in [1] + SIDES:
        for nu in range(0, 11):
            want = n >= 2 and nu <= CAPS[smoother]
            assert cuda.supports(n, torch.float32, nu, smoother) is want
            assert not cuda.supports(n, torch.float64, nu, smoother)
            # the bf16 forms of K1-K6: 2D, and 3D at the f32 halo cap
            assert cuda.supports(n, torch.bfloat16, nu, smoother) is want
            assert (cuda.supports(n, torch.bfloat16, nu, smoother, ndim=3)
                    is cuda.supports(n, torch.float32, nu, smoother, ndim=3))
