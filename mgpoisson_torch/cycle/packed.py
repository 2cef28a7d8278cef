"""Packed-persistent V/W-cycle: the fast scheme's fine level runs entirely
in the checkerboard-packed layout (port of ``mgpoisson/cycle/packed.py``).

Red-black Gauss-Seidel in packed form evaluates the stencil once per cell
of each colour, where the where-select form computes every cell and keeps
half; the state must LIVE packed for that to pay, so the solver packs psi
and f once per solve (``mgpoisson_torch.solver``), every fine-level
half-cycle runs K7/K8 (``kernels.cuda.packed_*``; the plain packed ops on
the CPU), and the coarse levels run the normal unpacked recursion: the
restriction's output is already unpacked (coarse column J = packed lane
J) and the prolongation takes the unpacked coarse correction.

Engaged by the solver under ``kernels.use_packed`` (with cycle='fmg' the
FMG pass runs unpacked and the solver packs its result); MGPOISSON_PACKED=0
turns it off, MGPOISSON_PACKED=1 turns it on for CPU tensors.  Under a
row-sharded mesh the same packed fine level runs per rank on its block
(``shard.spmd.SpmdCycle.cycle_packed``, K13/K14), engaged under
``kernels.use_packed_sharded``.
"""

from __future__ import annotations

from mgpoisson_torch.cycle.vcycle import _cycle
from mgpoisson_torch.kernels import cuda, ops, use_packed, use_packed_sharded


# the JAX module's names: whether a solve of `spec` on `device` (on `mesh`)
# runs the packed fine level, and the exact pack / unpack of the state (of
# the grid, or of a rank's block of whole rows)
supported = use_packed
supported_spmd = use_packed_sharded
pack, unpack = ops.pack_grid, ops.unpack_grid


def make_packed_cycle(spec, rnorm: bool = False):
    """Cycle function over PACKED fine-level state: (up, fp, h) -> up' (or
    (up', sum(r^2)) with rnorm).  The coarse levels are the unpacked
    ``_cycle`` recursion from zero, the same as in the unpacked solve; the
    fine level differs from it by add-order rounding only."""
    gamma = {"v": 1, "fmg": 1, "w": 2}[spec.cycle]

    def cycle(up, fp, h):
        up, Rc = cuda.packed_smooth_residual_restrict(up, fp, h, spec.nu_pre)
        # the first coarse visit runs the from-zero down-leg (u=None)
        V = _cycle(None, Rc, 2 * h, spec, gamma, False, None)
        for _ in range(gamma - 1):
            V = _cycle(V, Rc, 2 * h, spec, gamma, False, None)
        if rnorm:
            return cuda.packed_prolong_correct_smooth_rnorm(
                up, fp, V, h, spec.nu_post, spec.prolong_kind)
        return cuda.packed_prolong_correct_smooth(up, fp, V, h, spec.nu_post,
                                                  spec.prolong_kind)

    return cycle


def residual_norm_packed(up, fp, h):
    """||r|| from packed state (unpack, then the plain norm)."""
    return ops.residual_norm(unpack(up), unpack(fp), h)
