"""Drives mgpoisson_torch's main paths once on one NVIDIA GPU and checks them.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device   — a CUDA device must be present; prints its name and power
              limit (nvidia-smi) and turns TF32 off.
2. build    — builds every CUDA kernel from mgpoisson_torch/csrc (one nvcc
              per source, in parallel) and prints ptxas's registers, spills
              and shared memory (K7/K8 and K13/K14 among them: the register
              tile's instances), and the tiles' geometry.
3. parity   — each 2D kernel (K1-K3) against its plain torch version on the
              card, f32, at every level side the 2D path gives the kernels
              (4096 ... 256) x bc x smoother x nu, and at every side below
              (128 ... 2: sides smaller than one warp's tile, the checked
              edge path, the tile table's switch points) x bc with wjacobi
              nu = 3, rbgs nu = 1 and 4 and jacobi nu = 7; then the time of
              each at 4096^2 beside the plain version's (CUDA events, median
              of 25, alternating; and the kernel's own device time from
              torch.profiler, without the host's time to enqueue the call)
              and beside its bound.
4. slice    — the tuned-scheme 4096^2 f32 solve through
              MultigridPoisson(spec, device="cuda").solve(): the cycle count
              and per-cycle relres against the JAX package's, the returned
              psi re-checked in f64, the launch counters of that solve; then
              a traced V-cycle (the per-stage debugging path, the one caller
              of K1) with the counters zeroed again; then the same solve on
              plain ops (backend="torch") for comparison.
4b. parity_bf16 — the bf16 forms of K1-K3 against their plain torch
              versions in bf16, at every side the two bf16 solves give the
              kernels (4096 ... 256) and at 128 ... 2, x bc x (jacobi and
              wjacobi nu 1-3, rbgs nu 1-2), both prolongation kinds, from
              zero and with rnorm: every output bit-equal, sum(r^2) within
              1e-5; then (timing_bf16) each form at 4096^2 with the main
              path's settings beside its f32 form's device time from the
              same run, each with its bound and share of it.
4c. slice_mixed — the mixed-precision refinement solve (f32 with a bf16
              V-cycle, tuned 4096^2, the JAX package's bench config):
              refinement steps against the JAX package's count (equal or
              within one), each step's relres beside the JAX package's, an
              f64 re-check, the bf16 forms' launches, the same solve on
              plain ops (the same history, bit for bit), and device ms,
              launches and wall per step from torch.profiler beside the f32
              tuned 4096^2 solve's.  Then (slice_bf16) the pure bf16 solve
              (12 cycles, tol 1e-30): its history beside the JAX package's
              and beside its plain-ops twin (equal), its launches, and a
              traced bf16 V-cycle (K1's bf16 form).
5. parity3d — each 3D kernel (K4-K6) against its plain version at every side
              the 3D paths give the kernels (512, 256) x bc x smoother x nu,
              both prolongation kinds, rnorm and from zero, and at every side
              below (128 ... 2: sides smaller than one z-marching column or
              chunk) x bc with wjacobi nu = 3, rbgs nu = 1, rbgs nu = 2 and
              jacobi nu = 4 (halo 5: K5 and K6 with rnorm on the cube tile,
              K6 on the z-marching one); every K4-K6 output, of either tile,
              must equal its plain version bit for bit.  Then the time of
              each at 256^3 with the main path's settings.
6. slice3d  — the tuned 256^3 f32 solve (BASELINE config 4) as in phase 4:
              cycles and relres against the JAX package's, f64 re-check,
              launches of the solve and of a traced V-cycle (K4), the same
              solve on plain ops.
7. solve512 — the same spec at 512^3, where two levels run the kernels and
              K5's from-zero flag is on the solve's path: cycles, relres,
              launches of the solve and of a traced V-cycle.
7b. parity_bf16_3d — the bf16 forms of K4-K6 against their plain torch
              versions in bf16: first a probe of the order in which torch
              sums a bf16 2x2x2 restriction on the card (values of spread
              magnitudes at every side 512 ... 2, against mg3_sum8's f32
              order rounded once), then 256^3 and 128 ... 2 x bc x (wjacobi
              nu = 3, rbgs nu = 1 and 2, jacobi nu = 4: both tiles) and
              512^3 with wjacobi nu = 3, both prolongation kinds, from zero
              and with rnorm: every output bit-equal, sum(r^2) within 1e-5;
              then (timing_bf16) each form at 256^3 beside its f32 form.
7c. slice_mixed3d — the mixed-precision refinement solve at 256^3 (tuned,
              f32 with bf16 sweeps) as in phase 4c: steps against the JAX
              package's CPU count (within one), the first err 1.0, an f64
              re-check, the bf16 forms' launches, the plain-ops twin bit
              for bit, profiler rows beside the f32 256^3 cycle's; the same
              spec at 512^3 (its launches and the f64 re-check); then
              (slice_bf16_3d) the pure bf16 256^3 solve (12 cycles, tol
              1e-30): cycle 1 against the JAX package's, its launches, the
              plain-ops twin, a traced bf16 V-cycle (K4's bf16 form).
8. parity_packed — the packed fine level of the fast scheme: pack/unpack
              exact on the card; K7 and K8 (both prolongation kinds, rnorm)
              against their plain packed versions at 16384 ... 256 x nu in
              {1, 2, 3} and at 128 ... 2 with nu = 1 and 3 (the checked
              edge path, sides below one warp), every K7 and K8 output
              bit-equal; the unpacked result of each against K2 / K3 (rbgs,
              ghost0) on the unpacked grid, two formulas that differ by add
              order only; then the time of K7, K8 and K8 with rnorm at
              4096^2 (rbgs nu = 1, bilinear, the fast scheme's fine
              settings) beside K2 and K3 at the same settings unpacked,
              each pair with its device times and bounds, and the time of
              the solver's pack and unpack.
9. slice_fast — the fast-scheme 4096^2 f32 solve, packed, as in phase 4
              (cycles, relres, f64 re-check, launches), then the same spec
              with MGPOISSON_PACKED=0 (the unpacked K2/K3 fine level) and on
              plain ops, each with its per-cycle wall; then 1024^2 and
              16384^2 with the same checks.  Then (strided) the tuned and
              the fast 256^2 solves of an f or psi0 that is transposed,
              Fortran-order NumPy or a view at an odd 4-byte offset: each
              gives the psi and the cycle count of its dense copy, bit for
              bit.
10. parity_sharded — the strip kernels K9-K12 of the sharded solve against
              their plain versions at every block position of the (2, 2) and
              (4, 1) meshes, blocks and strips cut from a whole grid as the
              ranks' exchange delivers them: every global side at which a
              solve of phase 11 runs them (2D 16384 ... 256, 3D 256^3) and
              512^3 x bc x (wjacobi nu = 3, rbgs nu = 1, 2), from u
              and from zero, both prolongation kinds, rnorm; each kernel's
              outputs stitched over the blocks against the single-device
              K2/K3 (K5/K6) on the whole grid, where K9/K10 must be
              bit-equal to K2/K3 and K11/K12 to K5/K6 (the same bodies, the
              same arithmetic per cell), and every K11/K12 output to its
              plain version.  Then (timing_sharded) K9/K10 on one (2, 2)
              block of 16384^2 beside K2/K3 on a whole 8192^2 array, and
              K11/K12 on one (2, 2) block of 256^3 beside K5/K6 on the whole
              256^3 per cell, each with its plain version and bound.
11. parity_sharded_packed — the packed strip kernels K13/K14 of the fast
              scheme's fine level on a mesh of one column against their plain
              versions at every block of (4, 1), at every fine side of the
              packed sharded solves of phase 12 (16384, 4096) x nu in {1, 2,
              3}, both prolongation kinds, with and without rnorm; each
              kernel's outputs stitched over the blocks against K7/K8 on the
              whole packed grid (the same tiles, the same arithmetic): every
              K13 and K14 output bit-equal to its plain version and,
              stitched, to K7 / K8.  Then
              (timing_sharded_packed) K13/K14 on an interior (4096, 16384)
              block beside K7/K8 on a whole 8192^2 array, each with its
              plain version and bound.
12. spmd    — the sharded f32 solves through MultigridPoisson with a mesh: 4
              ranks spawned on the card over a gloo process group (the strips
              staged through host memory: NCCL refuses two ranks on one GPU)
              solve tuned 4096^2 on (2, 2) and (4, 1) and 256^3 on (2, 2)
              against the JAX package's per-cycle relres, tuned 16384^2 on
              (2, 2) against the single-device 16384^2 solve, and the fast
              scheme on (4, 1), its fine level packed on K13/K14: 4096^2
              against the JAX package and 16384^2 against the single-device
              packed 16384^2 solve; the single-device references run in this
              phase too.  An f64 re-check of each gathered iterate, and every
              rank's launches (K9/K10 at every sharded level >= 256, K11/K12
              at the 3D fine level, K13/K14 at a packed fine level, no
              single-device kernel).  With 4 or more cards, the tuned and the
              packed 4096^2 solves again over NCCL.

The last lines are a JSON object of the off-path kernels (K1, K4 and their
bf16 forms, with their launches in the traced cycles), a JSON object of the
main paths' kernels (K2, K3 with their launches in the 4096^2 tuned solve;
the bf16 forms of K2 and K3 with theirs in the mixed 4096^2 solve; K5, K6 with
theirs in the 256^3 solve and their bf16 forms with theirs in the mixed
256^3 solve; K7, K8 with theirs in the 4096^2 fast solve;
K9, K10 with one rank's in the sharded 16384^2 solve, K11, K12 in the
sharded 256^3 solve and K13, K14 in the sharded fast 16384^2 solve), the
card's name and power limit, and {"ok": true, "device": {...}}.  Imports
nothing of JAX.
"""

from __future__ import annotations

import datetime
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mgpoisson_torch import MultigridPoisson, Spec
from mgpoisson_torch.bench.profile import event_ms, kernel_ms, profile_solve
from mgpoisson_torch.core import level_sizes
from mgpoisson_torch.cycle.vcycle import v_cycle
from mgpoisson_torch.kernels import (build, cuda, exchange_depth, ops, use_packed_sharded,
                                     use_sharded_kernels)
from mgpoisson_torch.shard import multihost, spmd
from mgpoisson_torch.shard.mesh import ProcessMesh

# mgpoisson (the JAX package, backend='xla'), run on a CPU for
# Spec(size=4096, dtype='float32', scheme='tuned', stop='residual',
# tol=1e-10): 9 V-cycles, converged, with this relres per cycle.
JAX_ITERATIONS = 9
JAX_ERRS = [0.013347355648875237, 0.0006291550816968083, 4.472383079701103e-05,
            4.021771474072011e-06, 4.0204946571975597e-07, 4.2531766553111083e-08,
            4.677897180727086e-09, 5.301771799359756e-10, 6.155618376135763e-11]
# the same package and backend on a CPU for Spec(size=n, ndim=3,
# dtype='float32', scheme='tuned', stop='residual', tol=1e-10) at n = 256
# and 512: 11 V-cycles each, converged, with this relres per cycle.
JAX_ITERATIONS_3D = 11
JAX_ERRS_3D = {
    256: [0.019346917048096657, 0.0016700325068086386, 0.0001768919755704701,
          2.0735191355925053e-05, 2.616955043777125e-06, 3.521028588693298e-07,
          5.017472304302828e-08, 7.513534683312173e-09, 1.171715169334675e-09,
          1.8861685824322905e-10, 3.11942555120126e-11],
    512: [0.019346920773386955, 0.0016700336709618568, 0.0001768922811606899,
          2.0735233192681335e-05, 2.616956635392853e-06, 3.520983682392398e-07,
          5.0171301779755595e-08, 7.511745891974897e-09, 1.170777585990379e-09,
          1.882346084558506e-10, 3.100347756301858e-11],
}
# the same package and backend on a CPU for Spec(size=n, dtype='float32',
# scheme='fast', stop='residual', tol=1e-10): converged, with this relres
# per cycle (one per cycle run)
JAX_ERRS_FAST = {
    1024: [9.896094610439832e-09, 1.0446016274201497e-09, 1.500611718219247e-10,
           2.8420021544461882e-11],
    4096: [6.152843790019347e-10, 6.275716751824589e-11],
    16384: [3.840496323737064e-11],
}

# the same package and backend on a CPU for Spec(size=4096,
# dtype='float32', sweep_dtype='bfloat16', scheme='tuned', stop='residual',
# tol=1e-10): 13 refinement steps, converged, with this relres per step
# (the incoming iterate's: 1.0 first)
JAX_ITERATIONS_MIXED = 13
JAX_ERRS_MIXED = [1.0, 0.01529780589044094, 0.006269084755331278, 0.0010397398145869374,
                  0.00023754766152705997, 4.224124495522119e-05, 5.796138793812133e-06,
                  1.413964696439507e-06, 1.7821612630086747e-07, 7.977005722636932e-09,
                  2.0543007295259486e-09, 5.675052650033763e-10, 7.26461737987627e-11]
# ... and for Spec(size=4096, dtype='bfloat16', scheme='tuned',
# stop='residual', tol=1e-30, maxiter=12): 12 cycles, finite, not converged;
# after the second cycle the relres grows (r = f - A psi in bf16 is all
# cancellation at this h; on the TPU the same solve went non-finite)
JAX_ERRS_BF16 = [0.01336669921875, 0.001251220703125, 0.002716064453125, 0.0037994384765625,
                 0.00799560546875, 0.01153564453125, 0.01031494140625, 0.029052734375,
                 0.0167236328125, 0.026611328125, 0.042236328125, 0.0712890625]
# the same package and backend on a CPU for Spec(size=256, ndim=3,
# dtype='float32', sweep_dtype='bfloat16', scheme='tuned', stop='residual',
# tol=1e-10): 13 refinement steps, converged, with this relres per step
JAX_ITERATIONS_MIXED_3D = 13
JAX_ERRS_MIXED_3D = [1.0, 0.019899588078260422, 0.0016835599672049284, 0.0001845023944042623,
                     2.267056879645679e-05, 3.2478490084031364e-06, 5.399007818596147e-07,
                     9.590227989519917e-08, 1.8399351375819606e-08, 3.579897045469238e-09,
                     7.538972779386199e-10, 1.60050153685809e-10, 3.554027558361206e-11]
# ... and the first two cycles of Spec(size=256, ndim=3, dtype='bfloat16',
# scheme='tuned', stop='residual', tol=1e-30, maxiter=2)
JAX_ERRS_BF16_3D = [0.018860479816794395, 0.0015980113530531526]
BF16_TOL = 5e-2            # the JAX package's bf16 bar (tests/test_pallas_bf16.py)

PARITY_TOL = 1e-5          # normalized max |diff|, the ROADMAP's f32 kernel bar
# the 2D parity below the main path's kernel levels (128 ... 2): the main
# path's settings, the fast scheme's coarse rbgs nu = 1, and the deepest
# halos (rbgs nu = 4, jacobi nu = 7)
SMALL_SIDES = tuple(2 ** k for k in range(7, 0, -1))
SMALL_SETTINGS = (("wjacobi", 3), ("rbgs", 1), ("rbgs", 4), ("jacobi", 7))
# the 3D parity below the main path's sides (128 ... 2): the main path's
# settings, the fast scheme's rbgs nu = 1 (both on the z-marching tile of
# K5/K6), rbgs nu = 2 and jacobi nu = 4 (halo 5 with a residual: the cube
# tile; at n = 2, face, jacobi nu = 4 K5's 1x1x1 R is a sum with
# cancellation)
SMALL_SETTINGS_3D = (("wjacobi", 3), ("rbgs", 1), ("rbgs", 2), ("jacobi", 4))
RNORM_TOL = 1e-5           # relative, on sum(r^2): partials summed in another order
RELRES_TOL = 0.01          # per-cycle relres against the JAX package, relative
MAIN_N = 4096
MAIN_SPEC = Spec(size=MAIN_N, dtype="float32", scheme="tuned", stop="residual",
                 tol=1e-10)
SPEC_3D = Spec(size=256, ndim=3, dtype="float32", scheme="tuned", stop="residual",
               tol=1e-10)
SIDES_3D = (512, 256)      # the 3D levels the 256^3 and 512^3 solves run on the kernels
FAST_SPEC = MAIN_SPEC.with_(scheme="fast")
# the bf16 paths: mixed-precision refinement (bench.py's sec_bf16 config) and
# the pure bf16 solve; the bf16 parity's settings
MIXED_SPEC = MAIN_SPEC.with_(sweep_dtype="bfloat16")
BF16_SPEC = MAIN_SPEC.with_(dtype="bfloat16", tol=1e-30, maxiter=12)
BF16_SETTINGS = tuple([(sm, nu) for sm in ("jacobi", "wjacobi") for nu in (1, 2, 3)]
                      + [("rbgs", 1), ("rbgs", 2)])
# ... in 3D: the mixed 256^3 and 512^3 solves and the pure bf16 256^3 one
MIXED_SPEC_3D = SPEC_3D.with_(sweep_dtype="bfloat16")
BF16_SPEC_3D = SPEC_3D.with_(dtype="bfloat16", tol=1e-30, maxiter=12)
PACKED_SIDES = (16384, 4096, 1024, 256)   # the fine sides of the packed solves, and 256
CROSS_TOL = 1e-4           # packed against unpacked kernels: two formulas, add order only
# the sharded solve: its meshes and the sweep settings of its schemes; its
# parity sides are those of the solves of phase_spmd (sharded_sides)
SHARDED_MESHES = ((2, 2), (4, 1))
SHARDED_SETTINGS = (("wjacobi", 3), ("rbgs", 1), ("rbgs", 2))
# timing_sharded: K9/K10 on a (2, 2) block of 16384^2 beside K2/K3 on a
# whole array of the block's side; K11/K12 on a (2, 2) block of 256^3
TIMING_SHARDED = {2: 16384, 3: 256}
SPMD_WORLD = 4
SPEC_16K = MAIN_SPEC.with_(size=16384)
FAST_16K = FAST_SPEC.with_(size=16384)
SPMD_DIR = build.BUILD_DIR.parent / "spmd"
# the solves of phase_spmd: (label, spec, mesh, warm-up solve first); the
# fast scheme on (4, 1) runs its fine level packed on K13/K14
SPMD_CASES = (("spmd4096", MAIN_SPEC, (2, 2), True), ("spmd4096", MAIN_SPEC, (4, 1), True),
              ("spmd256^3", SPEC_3D, (2, 2), True), ("spmd16384", SPEC_16K, (2, 2), False),
              ("spmd4096fast", FAST_SPEC, (4, 1), True),
              ("spmd16384fast", FAST_16K, (4, 1), False))
# timing_sharded_packed: K13/K14 on the interior block (4096, 16384) of
# 16384^2 on (4, 1) beside K7/K8 on a whole array of the same cell count
TIMING_SHARDED_PACKED = (16384, 4, 8192)


def kernel_levels(spec):
    """The level sides at which a solve of `spec` runs the kernels."""
    return [s for s in level_sizes(spec.size) if s >= spec.kernel_min_size]


TIMING_REPS = 25
# the card's datasheet peaks (H100 SXM, at a 700 W power limit): HBM bytes
# per second and f32 operations per second outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# kernel -> (source, the Pallas kernel it replaces); K1 and K4 (and their
# bf16 forms) run only on the traced cycles, K2, K3, K5, K6, K7 and K8 (and
# the bf16 forms of K2, K3, K5 and K6) carry the solves
OFF_PATH = ("mg_smooth", "mg_smooth3d", "mg_smooth_bf16", "mg_smooth3d_bf16")
KERNELS = {
    "mg_smooth": ("mgpoisson_torch/csrc/mg_smooth.cu",
                  "mgpoisson/kernels/pallas.py:587"),
    "mg_smooth_rr": ("mgpoisson_torch/csrc/mg_smooth_rr.cu",
                     "mgpoisson/kernels/pallas.py:2223"),
    "mg_prolong_correct_smooth": ("mgpoisson_torch/csrc/mg_prolong_correct_smooth.cu",
                                  "mgpoisson/kernels/pallas.py:2482"),
    "mg_smooth_bf16": ("mgpoisson_torch/csrc/mg_smooth.cu",
                       "mgpoisson/kernels/pallas.py:587"),
    "mg_smooth_rr_bf16": ("mgpoisson_torch/csrc/mg_smooth_rr.cu",
                          "mgpoisson/kernels/pallas.py:2223"),
    "mg_prolong_correct_smooth_bf16": ("mgpoisson_torch/csrc/mg_prolong_correct_smooth.cu",
                                       "mgpoisson/kernels/pallas.py:2482"),
    "mg_smooth3d": ("mgpoisson_torch/csrc/mg_smooth3d.cu",
                    "mgpoisson/kernels/pallas.py:1558"),
    "mg_smooth_rr3d": ("mgpoisson_torch/csrc/mg_smooth_rr3d.cu",
                       "mgpoisson/kernels/pallas.py:1693"),
    "mg_prolong_correct_smooth3d": ("mgpoisson_torch/csrc/mg_prolong_correct_smooth3d.cu",
                                    "mgpoisson/kernels/pallas.py:1821"),
    "mg_smooth3d_bf16": ("mgpoisson_torch/csrc/mg_smooth3d.cu",
                         "mgpoisson/kernels/pallas.py:1558"),
    "mg_smooth_rr3d_bf16": ("mgpoisson_torch/csrc/mg_smooth_rr3d_bf16.cu",
                            "mgpoisson/kernels/pallas.py:1693"),
    "mg_prolong_correct_smooth3d_bf16": (
        "mgpoisson_torch/csrc/mg_prolong_correct_smooth3d_bf16.cu",
        "mgpoisson/kernels/pallas.py:1821"),
    "mg_packed_rr": ("mgpoisson_torch/csrc/mg_packed_rr.cu",
                     "mgpoisson/kernels/pallas.py:3079"),
    "mg_packed_pc": ("mgpoisson_torch/csrc/mg_packed_pc.cu",
                     "mgpoisson/kernels/pallas.py:3243"),
    "mg_sharded_rr": ("mgpoisson_torch/csrc/mg_smooth_rr.cu",
                      "mgpoisson/kernels/pallas.py:4080"),
    "mg_sharded_pc": ("mgpoisson_torch/csrc/mg_prolong_correct_smooth.cu",
                      "mgpoisson/kernels/pallas.py:4228"),
    "mg_sharded_rr3d": ("mgpoisson_torch/csrc/mg_smooth_rr3d.cu",
                        "mgpoisson/kernels/pallas.py:4908"),
    "mg_sharded_pc3d": ("mgpoisson_torch/csrc/mg_prolong_correct_smooth3d.cu",
                        "mgpoisson/kernels/pallas.py:5060"),
    "mg_sharded_packed_rr": ("mgpoisson_torch/csrc/mg_packed_rr.cu",
                             "mgpoisson/kernels/pallas.py:4499"),
    "mg_sharded_packed_pc": ("mgpoisson_torch/csrc/mg_packed_pc.cu",
                             "mgpoisson/kernels/pallas.py:4621"),
}
# per rank: the (smooth, rr, pc) kernels and the tags of the parity lines
# (their bf16 forms: the names with BF16)
BF16 = "_bf16"
RANK = {2: (("mg_smooth", "mg_smooth_rr", "mg_prolong_correct_smooth"), ("K1", "K2", "K3")),
        3: (("mg_smooth3d", "mg_smooth_rr3d", "mg_prolong_correct_smooth3d"),
            ("K4", "K5", "K6"))}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nmax(got, want):
    """(normalized max |diff|, max |diff|) of two tensors; normalized by
    the absolute max of `want`, or not at all where want is all zero (a 1x1
    coarse R of a 2x2 level can be)."""
    d = float((got.double() - want.double()).abs().max())
    m = float(want.double().abs().max())
    return (d / m if m > 0 else d), d


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: "
          "this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] nvidia-smi: {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    # the plain references must run in full f32; this solver has no matmul
    # or convolution, but a reference states and pins both switches
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def ptxas_report(log):
    """Per entry function of nvcc's -Xptxas -v log: registers, spill store
    and load bytes, static shared memory bytes."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {"registers": 0, "spill_stores": 0, "spill_loads": 0, "smem": 0}
        elif fn is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    out[fn][key] = int(m.group(1))
    return out


def phase_build():
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"[build] {lib_path.name} ready in {time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    report = ptxas_report(log.read_text() if log.exists() else "")
    for fn, r in report.items():
        print(f"[build] {fn}: {r['registers']} registers, {r['spill_stores']} / "
              f"{r['spill_loads']} bytes of spill stores / loads, {r['smem']} bytes of static "
              "shared memory")
    # the bf16 forms of K1-K3 (one instance per smoother and tile row
    # count) and of K4-K6 (the cube tile's three kernels, and one z-marching
    # instance per step count, smoother and bc: 16 of K5, 22 of K6)
    for what, want, rank in (("K1-K3", 27, lambda fn: "3d" not in fn),
                             ("K4-K6", 41, lambda fn: "3d" in fn)):
        bf16 = {fn: r for fn, r in report.items() if BF16 in fn and rank(fn)}
        check(len(bf16) == want,
              f"{len(bf16)} bf16 instances of {what} in the ptxas report, not {want}")
        regs = sorted(r["registers"] for r in bf16.values())
        spilled = [fn for fn, r in bf16.items() if r["spill_stores"] or r["spill_loads"]]
        print(f"[build] bf16 forms of {what}: {len(bf16)} instances, {regs[0]}-{regs[-1]} "
              f"registers, {len(spilled)} with spills")
        check(not spilled, f"bf16 instances spill: {spilled}")
    # ptxas reports static shared memory only; the 3D kernels' is dynamic.
    # K4 runs the cube tile; K5/K6 and K11/K12 the z-marching tile at halos
    # <= 4
    print(f"[build] mg_smooth3d at the tuned scheme's halo 3: cube tile "
          f"{cuda.tile3d(3)}^3, {cuda.shared_bytes_3d(3)} bytes of dynamic shared memory "
          "per block")
    for name, steps, rr in (("mg_smooth_rr3d", 3, True), ("mg_prolong_correct_smooth3d", 3, False),
                            ("mg_prolong_correct_smooth3d.rnorm", 3, False)):
        halo = steps + (name != "mg_prolong_correct_smooth3d")
        t = cuda.tile3d_zm(halo)
        print(f"[build] {name} at the tuned scheme's halo {halo}: z-marching tile, "
              f"{cuda.ZM_COLS}^2 loaded cells per plane ({t}^2 owned), "
              f"{cuda.zm_chunk(256, halo)} / {cuda.zm_chunk(512, halo)} planes per block at "
              f"256^3 / 512^3, {cuda.shared_bytes_3d_zm(steps, rr=rr, pc=not rr)} bytes of "
              "dynamic shared memory per block")
    # the strip entries on the 256^3 solve's (2, 2) block
    nzl, nyl = SPEC_3D.size // 2, SPEC_3D.size // 2
    for name, steps, rr in (("mg_sharded_rr3d", 3, True), ("mg_sharded_pc3d", 3, False),
                            ("mg_sharded_pc3d.rnorm", 3, False)):
        halo = steps + (name != "mg_sharded_pc3d")
        t, c = cuda.tile3d_zm(halo), cuda.zm_chunk(SPEC_3D.size, halo, nzl, nyl)
        print(f"[build] {name} at the tuned scheme's halo {halo} on the ({nzl}, {nyl}, "
              f"{SPEC_3D.size}) block of {SPEC_3D.size}^3 on (2, 2): z-marching tile, "
              f"{t}^2 owned cells per column, {c} planes per block, "
              f"{cuda.blocks3d(SPEC_3D.size, halo, nzl, nyl)} blocks, "
              f"{cuda.shared_bytes_3d_zm(steps, rr=rr, pc=not rr)} bytes of dynamic shared "
              "memory per block")
    # the packed legs on the 2D register tile at the fast scheme's fine
    # settings (rbgs nu = 1), on the whole 4096^2 grid and on the sharded
    # 16384^2 solve's (4096, 16384) block; their ptxas lines are above
    for leg, nl, n in (("mg_packed", 4096, 4096), ("mg_sharded_packed", 4096, 16384)):
        for name, halo in ((leg + "_rr", 3), (leg + "_pc", 2), (leg + "_pc.rnorm", 3)):
            rows, cols = cuda.tile2d(nl, n, halo)
            print(f"[build] {name} at rbgs nu = 1 on ({nl}, {n}): "
                  f"register tile, halo {halo} (even {halo + (halo & 1)}), {rows} x {cols} "
                  f"owned cells per block of {cuda.TILE_WARPS} warps, "
                  f"{cuda.blocks2d(nl, n, halo)} blocks, no dynamic shared memory")


def _data(n, ndim, seed, dev):
    """u, f of side n and V of side n/2, standard normal, on `dev`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((s,) * ndim, generator=g, device=dev)
            for s in (n, n, n // 2)]


def note(worst, kernel, tag, got, want, row, tol=PARITY_TOL, exact=False):
    """Appends tag=normalized max |diff| to `row` and checks it against
    `tol` (and, with `exact`, that the two are equal bit for bit); with a
    kernel, records its largest normalized and absolute differences in
    `worst`."""
    rel, ab = nmax(got, want)
    if kernel is not None:
        worst[kernel][0] = max(worst[kernel][0], rel)
        worst[kernel][1] = max(worst[kernel][1], ab)
    row.append(f"{tag}={rel:.1e}")
    check(rel <= tol, f"{tag} {row[0]}: normalized max |diff| {rel:.3e} > {tol}")
    check(not exact or torch.equal(got, want),
          f"{tag} {row[0]}: not bit-equal to its plain version (max |diff| {ab:.3e})")


def note_r2(tag, got, want, row, tol=RNORM_TOL):
    got, want = float(got), float(want)
    rel2 = abs(got / want - 1.0) if want != 0 else abs(got)
    row.append(f"{tag}={rel2:.1e}")
    check(rel2 <= tol, f"{row[0]}: {tag} sum(r^2) relative difference {rel2:.3e} > {tol}")


def _parity_settings(ndim, full):
    """(smoother, nu) of the parity sweep: every smoother at nu 1 and 3
    (and 7 for 2D jacobi), or below the main path's sides SMALL_SETTINGS
    (SMALL_SETTINGS_3D)."""
    if not full:
        return SMALL_SETTINGS if ndim == 2 else SMALL_SETTINGS_3D
    return [(smoother, nu) for smoother in ("jacobi", "wjacobi", "rbgs")
            for nu in ((1, 3, 7) if smoother == "jacobi" and ndim == 2 else (1, 3))]


def phase_parity(dev, ndim, sides, worst, small_sides=()):
    """Every kernel variant of rank `ndim` against its plain version at each
    side (at `small_sides` with SMALL_SETTINGS only); records per kernel the
    largest normalized and absolute differences seen in `worst`."""
    (k_smooth, k_rr, k_pc), (t_smooth, t_rr, t_pc) = RANK[ndim]
    label = "parity" if ndim == 2 else "parity3d"

    # every 3D output equals its plain version bit for bit, on the
    # z-marching tile (halo <= 4) and on the cube tile alike
    exact = ndim == 3

    for n in list(sides) + list(small_sides):
        u, f, V = _data(n, ndim, seed=n, dev=dev)
        h = 1.0 / n
        for bc in ("ghost0", "face"):
            for smoother, nu in _parity_settings(ndim, n in sides):
                row = [f"n={n} {bc} {smoother} nu={nu}"]
                a = (h, nu, smoother, bc)
                steps = ops.sweep_radius(smoother) * nu
                note(worst, k_smooth, t_smooth, cuda.smooth(u, f, *a),
                     ops.smooth(u, f, *a), row, exact=exact)
                for tag, fk, fp, args in (
                        (t_rr, cuda.smooth_residual_restrict,
                         ops.smooth_residual_restrict, (u, f)),
                        (t_rr + "z", cuda.smooth_residual_restrict_zero,
                         ops.smooth_residual_restrict_zero, (f,))):
                    (gu, gR), (wu, wR) = fk(*args, *a), fp(*args, *a)
                    note(worst, k_rr, f"{tag}.u", gu, wu, row, exact=exact)
                    note(worst, k_rr, f"{tag}.R", gR, wR, row, exact=exact)
                for kind in ("inject", "bilinear"):
                    pa = (u, f, V, h, nu, smoother, bc, kind)
                    tag = t_pc + kind[0]
                    note(worst, k_pc, tag, cuda.prolong_correct_smooth(*pa),
                         ops.prolong_correct_smooth(*pa), row, exact=exact)
                    (gu, g2), (wu, w2) = (cuda.prolong_correct_smooth_rnorm(*pa),
                                          ops.prolong_correct_smooth_rnorm(*pa))
                    note(worst, k_pc, tag + "r.u", gu, wu, row, exact=exact)
                    note_r2(tag + "r.r2", g2, w2, row)
                if ndim == 3:
                    row.append("bit-equal; K5/K6: " + ", ".join(
                        f"halo {hh} {'z-marching' if cuda.zmarch3d(hh) else 'cube'} tile"
                        for hh in sorted({steps, steps + 1})))
                torch.cuda.synchronize()
                print(f"[{label}] " + " ".join(row))
        del u, f, V
        torch.cuda.empty_cache()


def _flat(x):
    return [t for y in x for t in _flat(y)] if isinstance(x, (tuple, list)) else [x]


def _work(ndim, nu, smoother, leg, kind=None, rnorm=False):
    """f32 operations per fine cell of one op, as the plain version does
    them (each +, -, x one operation): nu sweeps (the 2*ndim-neighbour sum,
    the Jacobi form, the damping), then the residual and restriction of
    the down-leg, or the correction (trilinear: 2^ndim taps) and the
    fused sum(r^2) of the up-leg."""
    sweep = (2 * ndim - 1) + 3 + (3 if smoother == "wjacobi" else 0)
    residual = 2 * ndim + 3
    work = nu * sweep
    if leg == "rr":
        work += residual + 1
    elif leg == "pc":
        work += 1 + (2 ** (ndim + 1) if kind == "bilinear" else 0)
        work += residual + 2 if rnorm else 0
    return work


def bound_ms(inputs, outputs, operations):
    """The least time the card could take: the larger of the unique bytes
    (each input read once, each output written once) over the HBM rate
    and the f32 operations over the f32 rate; and which of the two it is."""
    nbytes = sum(t.numel() * t.element_size() for t in _flat(inputs) + _flat(outputs))
    t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * operations / PEAK_F32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(dev, n, ndim, dtype=torch.float32):
    """Each kernel of this rank and its plain version at side n with the
    main path's settings (wjacobi, nu=3; ghost0 on the fine level, face
    where the kernel runs on coarse levels), alternating plain and kernel;
    with each its bound.  With dtype bf16, the bf16 forms (2D)."""
    u, f, V = (t.to(dtype) for t in _data(n, ndim, seed=7, dev=dev))
    h, cells = 1.0 / n, n ** ndim
    suffix = BF16 if dtype == torch.bfloat16 else ""
    k_smooth, k_rr, k_pc = (k + suffix for k in RANK[ndim][0])
    cases = {
        k_smooth: (lambda m: m.smooth(u, f, h, 3, "wjacobi", "ghost0"),
                   (u, f), _work(ndim, 3, "wjacobi", "smooth")),
        k_rr: (lambda m: m.smooth_residual_restrict(u, f, h, 3, "wjacobi", "ghost0"),
               (u, f), _work(ndim, 3, "wjacobi", "rr")),
        k_rr + ".zero": (lambda m: m.smooth_residual_restrict_zero(
            f, h, 3, "wjacobi", "face"), (f,), _work(ndim, 3, "wjacobi", "rr")),
        k_pc: (lambda m: m.prolong_correct_smooth(u, f, V, h, 3, "wjacobi", "face",
                                                  "bilinear"),
               (u, f, V), _work(ndim, 3, "wjacobi", "pc", "bilinear")),
        k_pc + ".rnorm": (lambda m: m.prolong_correct_smooth_rnorm(
            u, f, V, h, 3, "wjacobi", "ghost0", "bilinear"),
            (u, f, V), _work(ndim, 3, "wjacobi", "pc", "bilinear", rnorm=True)),
    }
    out = _time_cases("timing" + suffix, cases, f"{n}^{ndim}", cells, "bf16" if suffix else "f32")
    del u, f, V
    torch.cuda.empty_cache()
    return out


def _time_cases(label, cases, shape, cells, dtype="f32"):
    """Times each case's kernel (through kernels.cuda) and plain version
    (kernels.ops), in turns plain, kernel, kernel, plain; with each its
    bound."""
    out = {}
    for name, (call, inputs, work) in cases.items():
        p1 = event_ms(lambda: call(ops), TIMING_REPS)
        k1 = event_ms(lambda: call(cuda), TIMING_REPS)
        d1 = kernel_ms(lambda: call(cuda), TIMING_REPS)
        d2 = kernel_ms(lambda: call(cuda), TIMING_REPS)
        k2 = event_ms(lambda: call(cuda), TIMING_REPS)
        p2 = event_ms(lambda: call(ops), TIMING_REPS)
        b_ms, b_by = bound_ms(inputs, call(cuda), work * cells)
        out[name] = {"ms": statistics.median([k1, k2]),
                     "plain_ms": statistics.median([p1, p2]),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "kernel_ms": statistics.median([d1, d2])}
        print(f"[{label}] {name} at {shape} {dtype}: kernel {k1:.4f} / {k2:.4f} ms "
              f"(device {d1:.4f} / {d2:.4f} ms, {100 * b_ms / max(d1, d2):.1f} % of the "
              f"bound), plain {p1:.4f} / {p2:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return out


def _beside(a, b):
    """Two timed cases side by side: device ms, share of each one's bound,
    and the ratio b / a of device and of event times."""
    return (f"device {a['kernel_ms']:.4f} / {b['kernel_ms']:.4f} ms "
            f"({b['kernel_ms'] / a['kernel_ms']:.3f}x), "
            f"{100 * a['bound_ms'] / a['kernel_ms']:.1f} / "
            f"{100 * b['bound_ms'] / b['kernel_ms']:.1f} % of the bounds "
            f"{a['bound_ms']:.4f} / {b['bound_ms']:.4f} ms; events {a['ms']:.4f} / "
            f"{b['ms']:.4f} ms ({b['ms'] / a['ms']:.3f}x)")


def phase_parity_packed(dev, worst):
    """K7 and K8 against their plain packed versions at every fine side of
    the packed solves and nu in {1, 2, 3}; each unpacked result against the
    unpacked kernels K2 / K3 (rbgs, ghost0) on the unpacked grid.  Every K7
    and K8 output must equal its plain version bit for bit, here and at the
    sides below (128 ... 2: the checked edge path, sides below one warp)
    with nu = 1 and 3."""
    for n in PACKED_SIDES + SMALL_SIDES:
        u, f, V = _data(n, 2, seed=n + 1, dev=dev)
        up, fp = cuda.pack_grid(u), cuda.pack_grid(f)
        check(torch.equal(cuda.unpack_grid(up), u) and torch.equal(cuda.unpack_grid(fp), f),
              f"unpack(pack(u)) != u at {n}^2")
        h = 1.0 / n
        full = n in PACKED_SIDES
        for nu in (1, 2, 3) if full else (1, 3):
            row = [f"n={n} nu={nu}"]
            a = (h, nu)
            (gu, gR), (wu, wR) = (cuda.packed_smooth_residual_restrict(up, fp, *a),
                                  ops.packed_smooth_residual_restrict(up, fp, *a))
            note(worst, "mg_packed_rr", "K7.u", gu, wu, row, exact=True)
            note(worst, "mg_packed_rr", "K7.R", gR, wR, row, exact=True)
            if full:
                xu, xR = cuda.smooth_residual_restrict(u, f, h, nu, "rbgs", "ghost0")
                note(worst, None, "K7~K2.u", cuda.unpack_grid(gu), xu, row, CROSS_TOL)
                note(worst, None, "K7~K2.R", gR, xR, row, CROSS_TOL)
            for kind in ("inject", "bilinear"):
                pa = (up, fp, V, *a, kind)
                tag = "K8" + kind[0]
                gu = cuda.packed_prolong_correct_smooth(*pa)
                note(worst, "mg_packed_pc", tag, gu, ops.packed_prolong_correct_smooth(*pa), row,
                     exact=True)
                (gru, g2), (wru, w2) = (cuda.packed_prolong_correct_smooth_rnorm(*pa),
                                        ops.packed_prolong_correct_smooth_rnorm(*pa))
                note(worst, "mg_packed_pc", tag + "r.u", gru, wru, row, exact=True)
                note_r2(tag + "r.r2", g2, w2, row)
                if full:
                    xa = (u, f, V, h, nu, "rbgs", "ghost0", kind)
                    note(worst, None, tag + "~K3", cuda.unpack_grid(gu),
                         cuda.prolong_correct_smooth(*xa), row, CROSS_TOL)
                    note_r2(tag + "r~K3.r2", g2, cuda.prolong_correct_smooth_rnorm(*xa)[1],
                            row, CROSS_TOL)
            torch.cuda.synchronize()
            print("[parity_packed] " + " ".join(row) + "; K7, K8 bit-equal")
        del u, f, V, up, fp
        torch.cuda.empty_cache()


def phase_timing_packed(dev, n):
    """At the fast scheme's fine settings (rbgs nu = 1, bilinear, ghost0):
    K7, K8 and K8 with rnorm on packed state, and beside them K2 and K3 on
    the unpacked grid, each with its plain version and its bound."""
    u, f, V = _data(n, 2, seed=11, dev=dev)
    up, fp = cuda.pack_grid(u), cuda.pack_grid(f)
    h, nu = 1.0 / n, 1
    unpacked = (h, nu, "rbgs", "ghost0")
    w_rr, w_pc = _work(2, nu, "rbgs", "rr"), _work(2, nu, "rbgs", "pc", "bilinear")
    w_pcr = _work(2, nu, "rbgs", "pc", "bilinear", rnorm=True)
    cases = {
        "mg_packed_rr": (lambda m: m.packed_smooth_residual_restrict(up, fp, h, nu),
                         (up, fp), w_rr),
        "mg_smooth_rr@rbgs": (lambda m: m.smooth_residual_restrict(u, f, *unpacked),
                              (u, f), w_rr),
        "mg_packed_pc": (lambda m: m.packed_prolong_correct_smooth(up, fp, V, h, nu,
                                                                   "bilinear"),
                         (up, fp, V), w_pc),
        "mg_prolong_correct_smooth@rbgs": (
            lambda m: m.prolong_correct_smooth(u, f, V, *unpacked, "bilinear"),
            (u, f, V), w_pc),
        "mg_packed_pc.rnorm": (
            lambda m: m.packed_prolong_correct_smooth_rnorm(up, fp, V, h, nu, "bilinear"),
            (up, fp, V), w_pcr),
        "mg_prolong_correct_smooth.rnorm@rbgs": (
            lambda m: m.prolong_correct_smooth_rnorm(u, f, V, *unpacked, "bilinear"),
            (u, f, V), w_pcr),
    }
    out = _time_cases("timing_packed", cases, f"{n}^2", n * n)
    for packed_name, name in (("mg_packed_rr", "mg_smooth_rr@rbgs"),
                              ("mg_packed_pc", "mg_prolong_correct_smooth@rbgs"),
                              ("mg_packed_pc.rnorm", "mg_prolong_correct_smooth.rnorm@rbgs")):
        print(f"[timing_packed] packed {packed_name} against unpacked {name}: "
              + _beside(out[packed_name], out[name]))
    # the solver's pack of psi and f and unpack of psi, once per solve
    # (plain torch: exact data movement)
    print(f"[timing_packed] pack_grid {event_ms(lambda: cuda.pack_grid(u), TIMING_REPS):.4f} ms, "
          f"unpack_grid {event_ms(lambda: cuda.unpack_grid(up), TIMING_REPS):.4f} ms at {n}^2 f32")
    del u, f, V, up, fp
    torch.cuda.empty_cache()
    return out


def _solve(spec, dev):
    """One solve, with the wall time of every cycle from the callback."""
    mg = MultigridPoisson(spec, device=dev)
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mg.solve(error_callback=lambda it, err: stamps.append(time.perf_counter()))
    cycle_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
    return mg, res, cycle_ms


def _expected(counts):
    """The launch counters with these counts and every other one 0."""
    return {**dict.fromkeys(cuda.launches, 0), **counts}


def phase_slice(label, spec, dev, jax_iterations, jax_errs, *, compare_plain=True,
                warm_up=True, traced=True):
    """The solve of `spec` on the card against the JAX package's per-cycle
    relres; returns the launch counts of the solve and (with `traced`) of
    a traced V-cycle, each read from its own run with the counters zeroed
    just before it."""
    if warm_up:
        _solve(spec, dev)
    cuda.reset_launches()
    mg, res, cycle_ms = _solve(spec, dev)
    after_solve = dict(cuda.launches)
    f = mg.rhs()
    after_trace = None
    if traced:
        # the traced V-cycle (the per-stage debugging entry point) is the
        # one caller of K1 / K4
        cuda.reset_launches()
        v_cycle(res.psi, f, spec.fine_h, spec, trace=[])
        torch.cuda.synchronize()
        after_trace = dict(cuda.launches)

    it, errs, shape = res.iterations, res.errs.tolist(), f"{spec.size}^{spec.ndim}"
    what = f"{spec.scheme}{' packed' if mg._packed else ''}"
    print(f"[{label}] {what} {shape} f32 on {dev}: {it} cycles, converged="
          f"{res.converged}, final relres {res.final_err:.6e}")
    for k, (e, ej) in enumerate(zip(errs, jax_errs), 1):
        print(f"[{label}]   cycle {k}: relres {e:.6e}  jax {ej:.6e}  "
              f"rel diff {abs(e - ej) / ej:.2e}")
    check(res.converged, f"the {shape} {what} solve did not converge")
    check(it == jax_iterations, f"{shape}: {it} cycles, the JAX package takes "
          f"{jax_iterations}")
    for k, (e, ej) in enumerate(zip(errs, jax_errs), 1):
        check(abs(e - ej) <= RELRES_TOL * ej,
              f"{shape} cycle {k}: relres {e:.6e} vs the JAX package's {ej:.6e}")
    check(res.psi.shape == spec.shape and bool(torch.isfinite(res.psi).all()),
          f"psi is not a finite {shape} array")

    # the returned psi, re-checked independently in f64 with the plain ops
    f64, psi64 = f.double(), res.psi.double()
    rel64 = float(ops.residual_norm(psi64, f64, spec.fine_h)
                  / ops.residual_norm(-f64, f64, spec.fine_h))
    del f64, psi64
    print(f"[{label}] f64 re-check: ||r||/||r0|| = {rel64:.6e} (tol {spec.tol})")
    check(rel64 < spec.tol, f"{shape}: f64 relres of the returned psi {rel64:.3e} >= tol")
    print(f"[{label}] kernel levels {kernel_levels(spec)}; launches in the solve "
          f"{after_solve}; in the traced cycle {after_trace}")
    ms_k = statistics.median(cycle_ms)
    print(f"[{label}] per-cycle wall ms, median (all): kernels {ms_k:.3f} "
          f"({' '.join(f'{c:.3f}' for c in cycle_ms)})")

    if compare_plain:
        compare_solve(label, "plain", spec.with_(backend="torch"), dev, it, {}, warm_up)
    return it, after_solve, after_trace


def compare_solve(label, what, spec, dev, it, launches, warm_up=True):
    """Another solve of the same problem, for its per-cycle wall: it must
    take `it` cycles and launch exactly `launches`.  Returns its result."""
    if warm_up:
        _solve(spec, dev)
    cuda.reset_launches()
    _, res, cycle_ms = _solve(spec, dev)
    check_launches(f"{label} {what}", dict(cuda.launches), _expected(launches),
                   f"the {what} solve")
    check(res.iterations == it, f"{label} {what}: {res.iterations} cycles, not {it}")
    ms = statistics.median(cycle_ms)
    print(f"[{label}] per-cycle wall ms, median (all): {what:<8} {ms:.3f} "
          f"({' '.join(f'{c:.3f}' for c in cycle_ms)})")
    return res


def probe_restrict_order_3d(dev):
    """Whether torch's sum of a bf16 2x2x2 restriction on the card
    (ops.restrict) equals the eight values added in f32 in mg3_sum8's
    order and rounded once, as the bf16 form of K5 adds them: values of
    spread magnitudes (2^-40 ... 2^40), where another order rounds
    otherwise, at every side 512 ... 2."""
    for n in (512,) + SIDES_3D[1:] + SMALL_SIDES:
        g = torch.Generator(device=dev).manual_seed(n + 11)
        e = torch.randint(-40, 41, (n,) * 3, generator=g, device=dev).float()
        r = (torch.randn((n,) * 3, generator=g, device=dev) * torch.exp2(e)).to(torch.bfloat16)
        x = r.float()

        def s(dz, dy, dx):
            return x[dz::2, dy::2, dx::2]

        want = ((s(0, 0, 0) + s(1, 0, 0)) + (s(0, 1, 0) + s(1, 1, 0))) + (
            (s(0, 0, 1) + s(1, 0, 1)) + (s(0, 1, 1) + s(1, 1, 1)))
        got = ops.restrict(r)
        check(torch.equal(got, want.to(torch.bfloat16) * 0.125),
              f"n={n}: torch's bf16 2x2x2 sum is not mg3_sum8's f32 order rounded once")
    print("[parity_bf16_3d] torch's bf16 2x2x2 restriction on the card: the eight values "
          "summed in f32 in mg3_sum8's order ((z pairs, then y, then x), the f32 form's), "
          "rounded once, at every side 512 ... 2 (spread magnitudes)")


def _bf16_parity_cases(ndim):
    """(side, settings) of the bf16 parity: in 2D every level side the two
    bf16 solves give the kernels and 128 ... 2, x BF16_SETTINGS; in 3D
    512^3 with the main path's wjacobi 3, and 256^3 and 128 ... 2 with
    SMALL_SETTINGS_3D (both tiles)."""
    if ndim == 2:
        return [(n, BF16_SETTINGS) for n in kernel_levels(MIXED_SPEC) + list(SMALL_SIDES)]
    return [(512, (("wjacobi", 3),))] + [(n, SMALL_SETTINGS_3D)
                                        for n in (256,) + SMALL_SIDES]


def phase_parity_bf16(dev, worst, ndim=2):
    """The bf16 forms of the legs of rank `ndim` (K1-K3, K4-K6) against
    their plain torch versions in bf16 at the sides and settings of
    _bf16_parity_cases x bc, both prolongation kinds, from zero and with
    rnorm: every output bit-equal (each op rounded to bf16 as torch rounds
    it), sum(r^2) within RNORM_TOL."""
    (k_smooth, k_rr, k_pc), (t_smooth, t_rr, t_pc) = RANK[ndim]
    k_smooth, k_rr, k_pc = k_smooth + BF16, k_rr + BF16, k_pc + BF16
    label = "parity_bf16" if ndim == 2 else "parity_bf16_3d"
    for n, settings in _bf16_parity_cases(ndim):
        u, f, V = (t.to(torch.bfloat16) for t in _data(n, ndim, seed=n + 2, dev=dev))
        h = 1.0 / n
        for bc in ("ghost0", "face"):
            for smoother, nu in settings:
                row = [f"n={n} {bc} {smoother} nu={nu}"]
                a = (h, nu, smoother, bc)
                note(worst, k_smooth, t_smooth, cuda.smooth(u, f, *a), ops.smooth(u, f, *a),
                     row, exact=True)
                for tag, fk, fp, args in (
                        (t_rr, cuda.smooth_residual_restrict,
                         ops.smooth_residual_restrict, (u, f)),
                        (t_rr + "z", cuda.smooth_residual_restrict_zero,
                         ops.smooth_residual_restrict_zero, (f,))):
                    (gu, gR), (wu, wR) = fk(*args, *a), fp(*args, *a)
                    note(worst, k_rr, f"{tag}.u", gu, wu, row, exact=True)
                    note(worst, k_rr, f"{tag}.R", gR, wR, row, exact=True)
                for kind in ("inject", "bilinear"):
                    pa = (u, f, V, h, nu, smoother, bc, kind)
                    tag = t_pc + kind[0]
                    note(worst, k_pc, tag, cuda.prolong_correct_smooth(*pa),
                         ops.prolong_correct_smooth(*pa), row, exact=True)
                    (gu, g2), (wu, w2) = (cuda.prolong_correct_smooth_rnorm(*pa),
                                          ops.prolong_correct_smooth_rnorm(*pa))
                    note(worst, k_pc, tag + "r.u", gu, wu, row, exact=True)
                    note_r2(tag + "r.r2", g2, w2, row)
                check(gu.dtype == torch.bfloat16 and g2.dtype == torch.float32,
                      f"bf16 up-leg dtypes {gu.dtype}, {g2.dtype}")
                torch.cuda.synchronize()
                print(f"[{label}] " + " ".join(row) + "; bit-equal")
        del u, f, V
        torch.cuda.empty_cache()


def _steps_beside(label, errs, jax_errs):
    for k, e in enumerate(errs, 1):
        ej = jax_errs[k - 1] if k <= len(jax_errs) else float("nan")
        print(f"[{label}]   cycle {k}: relres {e:.6e}  jax {ej:.6e}")


def _per_cycle_profile(label, spec, dev):
    """torch.profiler's device ms, launches and mg_* ms per cycle of a
    solve of `spec`, beside its wall (bench/profile.py)."""
    row = profile_solve(spec, dev)
    print(f"[{label}] {spec.dtype}{'/' + spec.sweep_dtype if spec.sweep_dtype else ''} "
          f"{spec.size}^{spec.ndim} per cycle: device {row['device_ms_per_cycle']:.4f} ms, mg_* "
          f"{row['mg_kernel_ms_per_cycle']:.4f} ms, {row['launches_per_cycle']:.1f} launches, "
          f"wall {row['wall_ms_per_cycle']:.3f} ms (busy share "
          f"{row['device_busy_share']:.3f}); {row['cycles']} cycles")
    return row


def _bf16_legs(spec):
    """The bf16 forms of the down- and up-leg of `spec`'s rank, and the
    shape of its grid as printed."""
    _, k_rr, k_pc = RANK[spec.ndim][0]
    return k_rr + BF16, k_pc + BF16, f"{spec.size}^{spec.ndim}"


def phase_slice_mixed(dev, spec=MIXED_SPEC, f32_spec=MAIN_SPEC, jax_iterations=JAX_ITERATIONS_MIXED,
                      jax_errs=JAX_ERRS_MIXED, label="slice_mixed"):
    """The mixed-precision refinement solve of `spec`: its steps, the first
    one's relres 1.0 (the incoming iterate's), an f64 re-check, the bf16
    forms' launches (per step K2/K5 from u at the fine level, from zero
    below, K3/K6 without rnorm at every kernel level: the JAX step hands
    the cycle a zeros array and stops on the residual it computes itself).
    With the JAX package's count (`jax_iterations`): the steps against it
    (equal or within one), each step's relres beside the JAX package's,
    the plain-ops twin (the same history, bit for bit) and the per-step
    device time beside the f32 solve's (`f32_spec`).  Returns the solve's
    launches."""
    k_rr, k_pc, shape = _bf16_legs(spec)
    _solve(spec, dev)
    cuda.reset_launches()
    mg, res, cycle_ms = _solve(spec, dev)
    launches = dict(cuda.launches)
    it, errs = res.iterations, res.errs.tolist()
    print(f"[{label}] f32 with bf16 sweeps, tuned {shape} on {dev}: {it} steps, "
          f"converged={res.converged}, final relres {res.final_err:.6e}"
          + (f"; the JAX package takes {jax_iterations}" if jax_iterations else ""))
    _steps_beside(label, errs, jax_errs or [])
    check(res.converged, f"the mixed {shape} solve did not converge")
    check(errs[0] == 1.0, f"the first step's relres is {errs[0]}, not 1.0 (the incoming psi0)")
    check(res.errs.dtype == torch.float32, f"the history is {res.errs.dtype}")
    if jax_iterations:
        check(abs(it - jax_iterations) <= 1,
              f"{it} steps, the JAX package takes {jax_iterations}")
        if it != jax_iterations:
            print(f"[{label}] {it} steps against {jax_iterations}: the bf16 V-cycles differ "
                  "in the restriction's sum (bf16 adds under XLA on the CPU, f32 in torch) "
                  "and the blend (bf16 in xla.prolong, f32 here as in the Pallas up-leg)")
    f = mg.rhs()
    f64, psi64 = f.double(), res.psi.double()
    rel64 = float(ops.residual_norm(psi64, f64, spec.fine_h)
                  / ops.residual_norm(-f64, f64, spec.fine_h))
    del f64, psi64
    print(f"[{label}] f64 re-check: ||r||/||r0|| = {rel64:.6e} (tol {spec.tol})")
    check(rel64 < spec.tol, f"mixed {shape}: f64 relres of the returned psi {rel64:.3e} >= tol")
    L = len(kernel_levels(spec))
    check_launches(f"{shape} mixed solve", launches, _expected({
        k_rr: it * L, k_rr + ".zero": it * (L - 1), k_pc: it * L}),
        f"per step {k_rr} from u at {spec.size} and from zero below, and {k_pc} "
        f"without rnorm, at each of the {L} kernel levels; no f32 kernel")
    print(f"[{label}] per-step wall ms, median (all): kernels {statistics.median(cycle_ms):.3f} "
          f"({' '.join(f'{c:.3f}' for c in cycle_ms)})")
    if not jax_iterations:
        return launches
    plain = compare_solve(label, "plain", spec.with_(backend="torch"), dev, it, {})
    check(torch.equal(plain.psi, res.psi) and plain.errs.tolist() == errs,
          f"the plain-ops mixed solve differs: {plain.errs.tolist()} vs {errs}")
    print(f"[{label}] plain-ops twin: the same psi and {it} relres values, bit for bit")
    mixed_row = _per_cycle_profile(label, spec, dev)
    f32_row = _per_cycle_profile(label, f32_spec, dev)
    print(f"[{label}] mixed step / f32 tuned {shape} cycle: device "
          f"{mixed_row['device_ms_per_cycle'] / f32_row['device_ms_per_cycle']:.3f}x, mg_* "
          f"{mixed_row['mg_kernel_ms_per_cycle'] / f32_row['mg_kernel_ms_per_cycle']:.3f}x, "
          f"wall {mixed_row['wall_ms_per_cycle'] / f32_row['wall_ms_per_cycle']:.3f}x")
    return launches


def phase_slice_bf16(dev, spec=BF16_SPEC, jax_errs=JAX_ERRS_BF16, label="slice_bf16"):
    """The pure bf16 solve of `spec` (12 cycles at tol 1e-30): its history
    beside the JAX package's (cycle 1 within BF16_TOL of it) and equal to
    its plain-ops twin's, its launches, and a traced bf16 V-cycle (the one
    caller of the bf16 form of K1 / K4).  Returns the traced cycle's
    launches."""
    k_rr, k_pc, shape = _bf16_legs(spec)
    k_smooth = RANK[spec.ndim][0][0] + BF16
    _solve(spec, dev)
    cuda.reset_launches()
    mg, res, cycle_ms = _solve(spec, dev)
    launches = dict(cuda.launches)
    it, errs = res.iterations, res.errs.tolist()
    print(f"[{label}] bf16 tuned {shape} on {dev}: {it} cycles (maxiter "
          f"{spec.maxiter}), final relres {res.final_err:.6e}; the JAX package's beside")
    _steps_beside(label, errs, jax_errs)
    check(res.psi.dtype == torch.bfloat16 and res.errs.dtype == torch.float32,
          f"psi {res.psi.dtype}, history {res.errs.dtype}")
    # the first cycle, from psi0 = -f, before bf16's cancellation sets in
    check(abs(errs[0] - jax_errs[0]) <= BF16_TOL * jax_errs[0],
          f"bf16 {shape} cycle 1: relres {errs[0]:.6e} vs the JAX package's "
          f"{jax_errs[0]:.6e}")
    L = len(kernel_levels(spec))
    check_launches(f"{shape} bf16 solve", launches, _expected({
        k_rr: it * L, k_rr + ".zero": it * (L - 1), k_pc: it * L, k_pc + ".rnorm": it}),
        f"one {k_rr} and {k_pc} per cycle at each of the {L} kernel levels, {k_rr} from "
        f"zero below the fine level, {k_pc} with rnorm at it")
    # the same psi bit for bit; the relres from Sigma r^2 summed in another
    # order (the kernel's partials), so within one bf16 ulp after rounding
    plain = compare_solve(label, "plain", spec.with_(backend="torch"), dev, it, {})
    check(torch.equal(plain.psi, res.psi), f"the plain-ops bf16 {shape} solve's psi differs")
    check(all(abs(a - b) <= 2 ** -7 * abs(b) for a, b in zip(errs, plain.errs.tolist())),
          f"the plain-ops bf16 solve's history differs: {plain.errs.tolist()} vs {errs}")
    print(f"[{label}] plain-ops twin: the same psi bit for bit, relres "
          f"{' '.join(f'{e:.6e}' for e in plain.errs.tolist())}")
    cuda.reset_launches()
    v_cycle(res.psi, mg.rhs(), spec.fine_h, spec, trace=[])
    torch.cuda.synchronize()
    trace = dict(cuda.launches)
    check_launches(f"{shape} traced bf16 V-cycle", trace, _expected({k_smooth: 2 * L}),
                   f"{k_smooth} twice at each of the {L} kernel levels")
    return trace


def check_launches(label, got, want, what):
    check(got == want, f"{label}: launches {got}, expected {want}: {what}")


def fast_launches(spec, it, packed=True):
    """The launch counts of an `it`-cycle fast V-cycle solve: packed, K7 and
    K8 (with rnorm) once per cycle at the fine level and K2 (from zero) and
    K3 once per cycle at each coarse kernel level; unpacked, K2 and K3 at
    every kernel level, K3 with rnorm at the fine one."""
    L = len(kernel_levels(spec))
    if packed:
        return {"mg_packed_rr": it, "mg_packed_pc": it, "mg_packed_pc.rnorm": it,
                "mg_smooth_rr": it * (L - 1), "mg_smooth_rr.zero": it * (L - 1),
                "mg_prolong_correct_smooth": it * (L - 1)}
    return {"mg_smooth_rr": it * L, "mg_smooth_rr.zero": it * (L - 1),
            "mg_prolong_correct_smooth": it * L, "mg_prolong_correct_smooth.rnorm": it}


def phase_slice_fast(dev, n, compare):
    """The fast-scheme f32 solve at n^2, packed, against the JAX package;
    with `compare`, the same spec with MGPOISSON_PACKED=0 and on plain ops
    beside it.  Returns the packed solve's launches."""
    spec = FAST_SPEC.with_(size=n)
    label = f"slice_fast{n}"
    jax_errs = JAX_ERRS_FAST[n]
    it, launches, _ = phase_slice(label, spec, dev, len(jax_errs), jax_errs,
                                  compare_plain=False, traced=False,
                                  warm_up=n <= MAIN_N)
    check_launches(f"{n}^2 fast solve", launches, _expected(fast_launches(spec, it)),
                   "K7 and K8 (rnorm) once per cycle, K2 (zero) and K3 once per cycle "
                   "at each coarse level >= kernel_min_size")
    if compare:
        old = os.environ.get("MGPOISSON_PACKED")
        os.environ["MGPOISSON_PACKED"] = "0"
        try:
            compare_solve(label, "unpacked", spec, dev, it,
                          fast_launches(spec, it, packed=False))
        finally:
            if old is None:
                del os.environ["MGPOISSON_PACKED"]
            else:
                os.environ["MGPOISSON_PACKED"] = old
        compare_solve(label, "plain", spec.with_(backend="torch"), dev, it, {})
    return launches


def _misaligned(x):
    """x's values in a dense row-major view at an odd 4-byte offset."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    check(out.is_contiguous() and out.data_ptr() % 8 == 4, "no odd-offset view")
    return out


def phase_strided(dev):
    """The solver's entry takes f and psi0 of any strides and offset (ROADMAP
    Queue 3 F1): the tuned and the fast 256^2 solves (the fast one packed)
    of a transposed f, a Fortran-order NumPy f or psi0 and views at an odd
    4-byte offset give the psi and the cycle count of the dense copies, bit
    for bit."""
    n = 256
    for scheme in ("tuned", "fast"):
        spec = MAIN_SPEC.with_(size=n, scheme=scheme, tol=1e-8, maxiter=50)
        mg = MultigridPoisson(spec, device=dev)
        f = mg.rhs()
        f[n // 4, n // 2 + 3] = 3.0e5     # not symmetric: f.t() is another problem
        ft = f.t().contiguous()
        fortran = lambda x: np.asfortranarray(x.cpu().numpy())
        want = mg.solve(ft)
        cases = {"transposed f": (f.t(), None), "Fortran-order f": (fortran(ft), None),
                 "odd-offset f": (_misaligned(ft), None),
                 "Fortran-order psi0": (ft, fortran(-ft)),
                 "odd-offset psi0": (ft, _misaligned(-ft))}
        for what, (f_in, psi0) in cases.items():
            got = mg.solve(f_in, psi0=psi0)
            check(got.iterations == want.iterations and torch.equal(got.psi, want.psi),
                  f"{scheme} {n}^2 solve of a {what}: {got.iterations} cycles against "
                  f"{want.iterations}, psi {'equal' if torch.equal(got.psi, want.psi) else 'differs'}")
        print(f"[strided] {scheme}{' packed' if mg._packed else ''} {n}^2: "
              f"{', '.join(cases)}: each {want.iterations} cycles, psi bit-equal to the dense "
              "copies'")


# ------------------------------------------------------------ the sharded solve

def _sharded_names(ndim):
    """(rr kernel, pc kernel, their tags, the single-device kernels' tags)."""
    if ndim == 2:
        return "mg_sharded_rr", "mg_sharded_pc", ("K9", "K10"), ("K2", "K3")
    return "mg_sharded_rr3d", "mg_sharded_pc3d", ("K11", "K12"), ("K5", "K6")


def _mesh_blocks(n, ndim, mesh):
    """(origin, shape) of every block of an n^ndim grid on `mesh`."""
    shape = (n // mesh[0], n // mesh[1]) + (n,) * (ndim - 2)
    for i, j in itertools.product(range(mesh[0]), range(mesh[1])):
        yield (i * shape[0], j * shape[1]), shape


def _block_slices(origin, shape, coarse=False):
    k = 2 if coarse else 1
    return tuple(slice(o // k, (o + s) // k) for o, s in zip(origin, shape[:2]))


class _Worst:
    """The largest normalized difference per tag of one configuration, and
    per kernel over the run (in `worst`); the tags of the outputs that were
    to be bit-equal and are not (in `unequal`)."""

    def __init__(self, worst):
        self.worst, self.tags, self.unequal = worst, {}, []

    def note(self, kernel, tag, got, want, exact=False):
        rel, ab = nmax(got, want)
        self.tags[tag] = max(self.tags.get(tag, 0.0), rel)
        if kernel is not None:
            self.worst[kernel][0] = max(self.worst[kernel][0], rel)
            self.worst[kernel][1] = max(self.worst[kernel][1], ab)
        if exact and not torch.equal(got, want):
            self.unequal.append(f"{tag} max |diff| {ab:.3e}")

    def check(self, row):
        for tag, rel in self.tags.items():
            row.append(f"{tag}={rel:.1e}")
            check(rel <= PARITY_TOL, f"{tag} {row[0]}: normalized max |diff| {rel:.3e} > "
                  f"{PARITY_TOL}")


def sharded_sides():
    """Per rank, the global sides at which the solves of phase_spmd run
    the strip kernels on any of their meshes (2D 16384 ... 256, 3D 256),
    and 512^3 beside them."""
    sides = {2: set(), 3: {512}}
    for _, spec, mesh_shape, _ in SPMD_CASES:
        sides[spec.ndim].update(sharded_kernel_levels(spec, mesh_shape))
    return {ndim: sorted(s, reverse=True) for ndim, s in sides.items()}


def phase_parity_sharded(dev, worst):
    """K9-K12 against their plain versions at every block position of the
    (2, 2) and (4, 1) meshes and every side of sharded_sides, and their
    outputs stitched over the blocks against the single-device kernels on
    the whole grid.  Bit-equal: the stitched outputs (K9/K10 to K2/K3,
    K11/K12 to K5/K6) and every K11/K12 output to its plain version."""
    sides_of = sharded_sides()
    print(f"[parity_sharded] global sides {sides_of} on the meshes {SHARDED_MESHES}")
    for ndim, sides in sides_of.items():
        k_rr, k_pc, (t_rr, t_pc), (s_rr, s_pc) = _sharded_names(ndim)
        for n in sides:
            u, f, V = _data(n, ndim, seed=n + 5, dev=dev)
            h = 1.0 / n
            for bc, (smoother, nu) in itertools.product(("ghost0", "face"), SHARDED_SETTINGS):
                row = [f"n={n}^{ndim} {bc} {smoother} nu={nu}"]
                w = _Worst(worst)
                exact = ndim == 3   # the blocks' outputs against the plain block ops
                a = (h, nu, smoother, bc)
                whole = {"rr": cuda.smooth_residual_restrict(u, f, *a),
                         "rrz": cuda.smooth_residual_restrict_zero(f, *a)}
                for kind in ("inject", "bilinear"):
                    whole[kind] = cuda.prolong_correct_smooth_rnorm(u, f, V, *a, kind)
                d = ops.sweep_radius(smoother) * nu + 1
                for mesh in SHARDED_MESHES:
                    cols = mesh[1] > 1
                    st = {k: [torch.empty_like(x) for x in v] for k, v in whole.items()}
                    r2 = {"inject": 0.0, "bilinear": 0.0}
                    for origin, shape in _mesh_blocks(n, ndim, mesh):
                        ub, us = spmd.block_from_grid(u, origin, shape, d, cols)
                        fb, fs = spmd.block_from_grid(f, origin, shape, d, cols)
                        vb, vs = spmd.block_from_grid(V, [o // 2 for o in origin],
                                                      [s // 2 for s in shape],
                                                      ops.coarse_depth(d), cols)
                        fine, coarse = _block_slices(origin, shape), _block_slices(origin, shape, True)
                        b = (origin, n, *a)
                        for key, tag, args, zero in (("rr", t_rr, (ub, fb, us, fs), False),
                                                     ("rrz", t_rr + "z", (None, fb, None, fs), True)):
                            (gu, gR), (wu, wR) = (cuda.smooth_rr_sharded(*args, *b, zero=zero),
                                                  ops.smooth_rr_sharded(*args, *b, zero=zero))
                            w.note(k_rr, tag + ".u", gu, wu, exact)
                            w.note(k_rr, tag + ".R", gR, wR, exact)
                            st[key][0][fine], st[key][1][coarse] = gu, gR
                        for kind in ("inject", "bilinear"):
                            pa = (ub, fb, vb, us, fs, vs, origin, n, *a, kind)
                            (gu, g2), (wu, w2) = (cuda.pc_smooth_sharded(*pa, rnorm=True),
                                                  ops.pc_smooth_sharded(*pa, rnorm=True))
                            tag = t_pc + kind[0]
                            w.note(k_pc, tag, cuda.pc_smooth_sharded(*pa), wu, exact)
                            w.note(k_pc, tag + "r.u", gu, wu, exact)
                            w.tags[tag + "r.r2"] = max(w.tags.get(tag + "r.r2", 0.0),
                                                       abs(float(g2) / float(w2) - 1.0))
                            st[kind][0][fine] = gu
                            r2[kind] += float(g2)
                    m = "x".join(map(str, mesh))
                    pairs = []
                    for key, tag in (("rr", f"{t_rr}~{s_rr}"), ("rrz", f"{t_rr}z~{s_rr}z")):
                        pairs += [(f"{tag}.u@{m}", st[key][0], whole[key][0]),
                                  (f"{tag}.R@{m}", st[key][1], whole[key][1])]
                    for kind in ("inject", "bilinear"):
                        tag = f"{t_pc}{kind[0]}~{s_pc}"
                        pairs.append((f"{tag}.u@{m}", st[kind][0], whole[kind][0]))
                        w.tags[f"{tag}.r2@{m}"] = abs(r2[kind] / float(whole[kind][1]) - 1.0)
                    for tag, got, want in pairs:
                        w.note(None, tag, got, want, exact=True)
                    del st
                w.check(row)
                what = f"{t_rr}/{t_pc}: stitched bit-equal to {s_rr}/{s_pc}" + (
                    ", blocks bit-equal to plain" if exact else "")
                row.append(what if not w.unequal else
                           f"NOT bit-equal ({what}): " + "; ".join(w.unequal))
                torch.cuda.synchronize()
                print("[parity_sharded] " + " ".join(row))
                check(not w.unequal, f"{row[0]}: {t_rr}/{t_pc} not bit-equal where they "
                      f"must be: {'; '.join(w.unequal)}")
            del u, f, V, whole
            torch.cuda.empty_cache()


def phase_timing_sharded(dev, whole3d):
    """K9/K10 on the (0, 0) block of a (2, 2) mesh at 16384^2 (8192^2) with
    the main path's settings, beside K2/K3 on a whole 8192^2 array; K11/K12
    on the (0, 0) block of 256^3 beside K5/K6 on the whole 256^3 per cell
    (`whole3d`: phase_timing's 3D times); each with its plain version and
    bound."""
    out = {}
    d = exchange_depth(MAIN_SPEC)
    dv = ops.coarse_depth(d)
    for ndim, n in TIMING_SHARDED.items():
        k_rr, k_pc, _, _ = _sharded_names(ndim)
        u, f, V = _data(n, ndim, seed=17, dev=dev)
        shape = (n // 2, n // 2) + (n,) * (ndim - 2)
        ub, us = spmd.block_from_grid(u, (0, 0), shape, d)
        fb, fs = spmd.block_from_grid(f, (0, 0), shape, d)
        vb, vs = spmd.block_from_grid(V, (0, 0), [s // 2 for s in shape], dv)
        del u, f, V
        b, s = ((0, 0), n, 1.0 / n), (3, "wjacobi")
        cases = {
            k_rr: (lambda m: m.smooth_rr_sharded(ub, fb, us, fs, *b, *s, "ghost0"),
                   [ub, fb, *us, *fs], _work(ndim, 3, "wjacobi", "rr")),
            k_rr + ".zero": (lambda m: m.smooth_rr_sharded(None, fb, None, fs, *b, *s, "face",
                                                           zero=True),
                             [fb, *fs], _work(ndim, 3, "wjacobi", "rr")),
            k_pc: (lambda m: m.pc_smooth_sharded(ub, fb, vb, us, fs, vs, *b, *s, "face",
                                                 "bilinear"),
                   [ub, fb, vb, *us, *fs, *vs], _work(ndim, 3, "wjacobi", "pc", "bilinear")),
            k_pc + ".rnorm": (lambda m: m.pc_smooth_sharded(ub, fb, vb, us, fs, vs, *b, *s,
                                                            "ghost0", "bilinear", rnorm=True),
                              [ub, fb, vb, *us, *fs, *vs],
                              _work(ndim, 3, "wjacobi", "pc", "bilinear", rnorm=True)),
        }
        cells = 1
        for x in shape:
            cells *= x
        out.update(_time_cases("timing_sharded", cases,
                               f"the (0, 0) block {shape} of {n}^{ndim}", cells))
        del ub, fb, vb, us, fs, vs
        torch.cuda.empty_cache()
        if ndim == 3:
            single = RANK[3][0]
            for sharded, whole in ((k_rr, single[1]), (k_rr + ".zero", single[1] + ".zero"),
                                   (k_pc, single[2]), (k_pc + ".rnorm", single[2] + ".rnorm")):
                per, per_whole = (out[sharded]["kernel_ms"] / cells,
                                  whole3d[whole]["kernel_ms"] / n ** 3)
                print(f"[timing_sharded] {sharded} on the block {shape}: {1e6 * per:.4f} ns of "
                      f"device time per cell against {whole} on {n}^3: {1e6 * per_whole:.4f} "
                      f"ns ({per / per_whole:.3f}x)")
    # beside K9/K10: K2/K3 on a whole array of the block's side
    n = TIMING_SHARDED[2] // 2
    u, f, V = _data(n, 2, seed=19, dev=dev)
    h = 1.0 / n
    rr, pc = f"mg_smooth_rr@{n}", f"mg_prolong_correct_smooth@{n}"
    whole = {
        rr: (lambda m: m.smooth_residual_restrict(u, f, h, 3, "wjacobi", "ghost0"),
             (u, f), _work(2, 3, "wjacobi", "rr")),
        pc: (lambda m: m.prolong_correct_smooth(u, f, V, h, 3, "wjacobi", "face", "bilinear"),
             (u, f, V), _work(2, 3, "wjacobi", "pc", "bilinear")),
    }
    t = _time_cases("timing_sharded", whole, f"{n}^2", n * n)
    for sharded, single in (("mg_sharded_rr", rr), ("mg_sharded_pc", pc)):
        print(f"[timing_sharded] {sharded} on a {n}^2 block against {single}: "
              f"{out[sharded]['ms'] / t[single]['ms']:.3f}x")
    del u, f, V
    torch.cuda.empty_cache()
    return out


def packed_sharded_sides():
    """The fine sides of the solves of phase_spmd that run the packed fine
    level on K13/K14 (16384, 4096)."""
    return sorted({spec.size for _, spec, mesh_shape, _ in SPMD_CASES
                   if packed_sharded(spec, mesh_shape)}, reverse=True)


def phase_parity_sharded_packed(dev, worst):
    """K13/K14 against their plain versions at every block of (4, 1) and
    every fine side of packed_sharded_sides, nu in {1, 2, 3}, both
    prolongation kinds, with and without rnorm; each kernel's outputs
    stitched over the blocks against K7/K8 on the whole packed grid.  Every
    K13 and K14 output must equal its plain version and, stitched, K7 / K8
    bit for bit (the same tile and arithmetic on the same values)."""
    mx = 4
    for n in packed_sharded_sides():
        u, f, V = _data(n, 2, seed=n + 9, dev=dev)
        up, fp = cuda.pack_grid(u), cuda.pack_grid(f)
        del u, f
        h, nl = 1.0 / n, n // mx
        for nu in (1, 2, 3):
            row = [f"n={n} (4, 1) nu={nu}"]
            w = _Worst(worst)
            d = 2 * nu + 1
            whole = {"rr": cuda.packed_smooth_residual_restrict(up, fp, h, nu)}
            st = {"rr": [torch.empty_like(x) for x in whole["rr"]]}
            for kind in ("inject", "bilinear"):
                whole[kind] = cuda.packed_prolong_correct_smooth(up, fp, V, h, nu, kind)
                whole[kind + "r"] = cuda.packed_prolong_correct_smooth_rnorm(up, fp, V, h, nu,
                                                                             kind)
                st[kind], st[kind + "r"] = torch.empty_like(up), torch.empty_like(up)
            r2 = {"inject": 0.0, "bilinear": 0.0}
            for r0 in range(0, n, nl):
                fine, coarse = slice(r0, r0 + nl), slice(r0 // 2, (r0 + nl) // 2)
                ub, us = spmd.block_from_grid(up, (r0, 0), (nl, n), d, cols=False)
                fb, fs = spmd.block_from_grid(fp, (r0, 0), (nl, n), d, cols=False)
                vb, vs = spmd.block_from_grid(V, (r0 // 2, 0), (nl // 2, n // 2),
                                              ops.coarse_depth(d), cols=False)
                b = ((r0, 0), n, h, nu)
                (gu, gR), (wu, wR) = (cuda.packed_rr_sharded(ub, fb, us, fs, *b),
                                      ops.packed_rr_sharded(ub, fb, us, fs, *b))
                w.note("mg_sharded_packed_rr", "K13.u", gu, wu, exact=True)
                w.note("mg_sharded_packed_rr", "K13.R", gR, wR, exact=True)
                st["rr"][0][fine], st["rr"][1][coarse] = gu, gR
                for kind in ("inject", "bilinear"):
                    pa = (ub, fb, vb, us, fs, vs, *b, kind)
                    tag = "K14" + kind[0]
                    gp = cuda.packed_pc_sharded(*pa)
                    w.note("mg_sharded_packed_pc", tag, gp, ops.packed_pc_sharded(*pa),
                           exact=True)
                    (gr, g2), (wr, w2) = (cuda.packed_pc_sharded(*pa, rnorm=True),
                                          ops.packed_pc_sharded(*pa, rnorm=True))
                    w.note("mg_sharded_packed_pc", tag + "r.u", gr, wr, exact=True)
                    w.tags[tag + "r.r2"] = max(w.tags.get(tag + "r.r2", 0.0),
                                               abs(float(g2) / float(w2) - 1.0))
                    st[kind][fine], st[kind + "r"][fine] = gp, gr
                    r2[kind] += float(g2)
            pairs = [("K13~K7.u", st["rr"][0], whole["rr"][0]),
                     ("K13~K7.R", st["rr"][1], whole["rr"][1])]
            for kind in ("inject", "bilinear"):
                k = kind[0]
                pairs += [(f"K14{k}~K8", st[kind], whole[kind]),
                          (f"K14{k}r~K8r.u", st[kind + "r"], whole[kind + "r"][0])]
                w.tags[f"K14{k}r~K8r.r2"] = abs(r2[kind] / float(whole[kind + "r"][1]) - 1.0)
            for tag, got, want in pairs:
                w.note(None, tag, got, want, exact=True)
            w.check(row)
            row.append("K13/K14 blocks bit-equal to plain; stitched: bit-equal to K7/K8"
                       if not w.unequal else "NOT bit-equal: " + "; ".join(w.unequal))
            torch.cuda.synchronize()
            print("[parity_sharded_packed] " + " ".join(row))
            check(not w.unequal, f"{row[0]}: K13/K14 not bit-equal where they must be: "
                  f"{'; '.join(w.unequal)}")
            del whole, st
            torch.cuda.empty_cache()
        del up, fp, V
        torch.cuda.empty_cache()


def phase_timing_sharded_packed(dev):
    """At the fast scheme's fine settings (rbgs nu = 1, bilinear): K13, K14
    and K14 with rnorm on an interior block (both strips from neighbours) of
    16384^2 on (4, 1), beside K7, K8 and K8 with rnorm on a whole 8192^2
    array of the same cell count; each with its plain version and bound."""
    n, mx, m = TIMING_SHARDED_PACKED
    nu, nl, h = 1, n // mx, 1.0 / n
    d = exchange_depth(FAST_SPEC)
    dv = ops.coarse_depth(d)
    g = torch.Generator(device=dev).manual_seed(23)
    rand = lambda *shape: torch.randn(shape, generator=g, device=dev)
    ub, fb, vb = rand(nl, n), rand(nl, n), rand(nl // 2, n // 2)
    us, fs = (rand(d, n), rand(d, n), None, None), (rand(d, n), rand(d, n), None, None)
    vs = (rand(dv, n // 2), rand(dv, n // 2), None, None)
    b = ((nl, 0), n, h, nu)
    w_rr, w_pc = _work(2, nu, "rbgs", "rr"), _work(2, nu, "rbgs", "pc", "bilinear")
    w_pcr = _work(2, nu, "rbgs", "pc", "bilinear", rnorm=True)
    fine_in = [ub, fb, *us[:2], *fs[:2]]
    cases = {
        "mg_sharded_packed_rr": (lambda k: k.packed_rr_sharded(ub, fb, us, fs, *b),
                                 fine_in, w_rr),
        "mg_sharded_packed_pc": (
            lambda k: k.packed_pc_sharded(ub, fb, vb, us, fs, vs, *b, "bilinear"),
            fine_in + [vb, *vs[:2]], w_pc),
        "mg_sharded_packed_pc.rnorm": (
            lambda k: k.packed_pc_sharded(ub, fb, vb, us, fs, vs, *b, "bilinear", rnorm=True),
            fine_in + [vb, *vs[:2]], w_pcr),
    }
    out = _time_cases("timing_sharded_packed", cases,
                      f"the block ({nl}, {n}) at row {nl} of {n}^2", nl * n)
    del ub, fb, vb, us, fs, vs
    torch.cuda.empty_cache()
    u, f, V = _data(m, 2, seed=29, dev=dev)
    up, fp = cuda.pack_grid(u), cuda.pack_grid(f)
    del u, f
    hm = 1.0 / m
    whole = {
        f"mg_packed_rr@{m}": (lambda k: k.packed_smooth_residual_restrict(up, fp, hm, nu),
                             (up, fp), w_rr),
        f"mg_packed_pc@{m}": (
            lambda k: k.packed_prolong_correct_smooth(up, fp, V, hm, nu, "bilinear"),
            (up, fp, V), w_pc),
        f"mg_packed_pc.rnorm@{m}": (
            lambda k: k.packed_prolong_correct_smooth_rnorm(up, fp, V, hm, nu, "bilinear"),
            (up, fp, V), w_pcr),
    }
    t = _time_cases("timing_sharded_packed", whole, f"{m}^2", m * m)
    for sharded, single in (("mg_sharded_packed_rr", "mg_packed_rr"),
                            ("mg_sharded_packed_pc", "mg_packed_pc"),
                            ("mg_sharded_packed_pc.rnorm", "mg_packed_pc.rnorm")):
        print(f"[timing_sharded_packed] {sharded} on a ({nl}, {n}) block against {single} "
              f"on {m}^2: " + _beside(out[sharded], t[f"{single}@{m}"]))
    del up, fp, V
    torch.cuda.empty_cache()
    return out


def _mesh(mesh_shape):
    """A mesh object of this shape, for the rules (no process group)."""
    return ProcessMesh(shape=mesh_shape, rank=0, ranks=(0,) * SPMD_WORLD, backend="gloo")


def packed_sharded(spec, mesh_shape):
    """Whether a sharded solve of `spec` on the card runs the packed fine
    level (K13/K14)."""
    return use_packed_sharded(spec.with_(mesh_shape=mesh_shape), _mesh(mesh_shape), "cuda")


def sharded_kernel_levels(spec, mesh_shape):
    """The global sides at which a sharded solve of `spec` runs K9-K12 or,
    at a packed fine level, K13/K14: the sharded levels (above
    replicate_below, the next level still splitting evenly) where the
    dispatch rule picks the kernels on the card."""
    mesh = _mesh(mesh_shape)
    return [g for g in level_sizes(spec.size)
            if g > spec.replicate_below and spmd.shardable(g // 2, mesh)
            and use_sharded_kernels(spec, g, spmd.block_shape(g, spec.ndim, mesh), "cuda")]


def sharded_launches(spec, mesh_shape, it):
    """One rank's launches in an `it`-cycle sharded solve: the down-leg
    (from zero below the fine level) and the up-leg at every sharded kernel
    level, the up-leg with rnorm once per cycle; with a packed fine level,
    K13 and K14 (rnorm) there, once per cycle."""
    L = len(sharded_kernel_levels(spec, mesh_shape))
    k_rr, k_pc, _, _ = _sharded_names(spec.ndim)
    if packed_sharded(spec, mesh_shape):
        return {"mg_sharded_packed_rr": it, "mg_sharded_packed_pc": it,
                "mg_sharded_packed_pc.rnorm": it, k_rr: (L - 1) * it,
                k_rr + ".zero": (L - 1) * it, k_pc: (L - 1) * it}
    return {k_rr: L * it, k_rr + ".zero": (L - 1) * it, k_pc: L * it, k_pc + ".rnorm": it}


def _spmd_rank(rank, backend, store, cases, out_dir):
    """One rank of phase_spmd: every case's solve on this rank's card, its
    launches and per-cycle wall; rank 0 re-checks each gathered iterate in
    f64.  Writes rank{rank}.json."""
    multihost.initialize(backend, f"file://{store}", SPMD_WORLD, rank,
                         timeout=datetime.timedelta(seconds=300))
    try:
        torch.cuda.set_device(multihost.device_for(rank))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        results = []
        for label, spec, mesh_shape, warm_up in cases:
            spec = spec.with_(mesh_shape=mesh_shape)
            if warm_up:
                _solve(spec, "cuda")
            cuda.reset_launches()
            mg, res, cycle_ms = _solve(spec, "cuda")
            launches = dict(cuda.launches)
            psi = multihost.gather_global(res.psi, mg.mesh)
            rel64 = None
            if rank == 0:
                f64 = torch.zeros_like(psi, dtype=torch.float64)
                f64[(spec.size // 2,) * spec.ndim] = -1e6
                rel64 = float(ops.residual_norm(psi.double(), f64, spec.fine_h)
                              / ops.residual_norm(-f64, f64, spec.fine_h))
                del f64
            results.append({"label": label, "iterations": res.iterations,
                            "errs": res.errs.tolist(), "converged": res.converged,
                            "launches": launches, "cycle_ms": cycle_ms, "rel64": rel64,
                            "packed": mg._packed,
                            "block": list(res.psi.shape), "device": str(mg.device),
                            "finite": bool(torch.isfinite(psi).all()),
                            "shape": list(psi.shape)})
            del mg, res, psi
            torch.cuda.empty_cache()
        (out_dir / f"rank{rank}.json").write_text(json.dumps(results))
    finally:
        dist.destroy_process_group()


def _spawn_ranks(backend, cases):
    """Runs _spmd_rank on SPMD_WORLD spawned processes (a rank's failure
    ends the others and raises here); returns every rank's results."""
    out_dir = SPMD_DIR / backend
    out_dir.mkdir(parents=True, exist_ok=True)
    for p in out_dir.iterdir():
        p.unlink()
    mp.start_processes(_spmd_rank, args=(backend, str(out_dir / "store"), cases, out_dir),
                       nprocs=SPMD_WORLD, join=True, start_method="spawn")
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(SPMD_WORLD)]


def _check_spmd(label, spec, mesh_shape, ranks, ref_errs, how):
    """Every rank's result of one sharded solve: identical histories, the
    reference's cycle count and per-cycle relres (within RELRES_TOL), the
    f64 re-check of the gathered iterate, exact launches."""
    r0 = ranks[0]
    it, errs = r0["iterations"], r0["errs"]
    shape = f"{spec.size}^{spec.ndim} on {mesh_shape}"
    what = f"{spec.scheme}{', fine level packed' if r0['packed'] else ''}"
    print(f"[{label}] {shape} {what}, {SPMD_WORLD} ranks ({how}): {it} cycles, converged="
          f"{r0['converged']}, blocks {r0['block']} on {r0['device']}")
    check(all(r["packed"] == packed_sharded(spec, mesh_shape) for r in ranks),
          f"{shape}: the ranks' packed fine level is not the rule's")
    for k, (e, ej) in enumerate(zip(errs, ref_errs), 1):
        print(f"[{label}]   cycle {k}: relres {e:.6e}  reference {ej:.6e}  "
              f"rel diff {abs(e - ej) / ej:.2e}")
    check(all(r["errs"] == errs and r["iterations"] == it for r in ranks),
          f"{shape}: the ranks' error histories differ")
    check(r0["converged"] and it == len(ref_errs),
          f"{shape}: {it} cycles (converged={r0['converged']}), the reference takes "
          f"{len(ref_errs)}")
    for k, (e, ej) in enumerate(zip(errs, ref_errs), 1):
        check(abs(e - ej) <= RELRES_TOL * ej, f"{shape} cycle {k}: relres {e:.6e} vs {ej:.6e}")
    check(r0["finite"] and r0["shape"] == list(spec.shape),
          f"{shape}: the gathered psi is not a finite {spec.shape} array")
    print(f"[{label}] f64 re-check of the gathered psi: ||r||/||r0|| = {r0['rel64']:.6e} "
          f"(tol {spec.tol})")
    check(r0["rel64"] < spec.tol, f"{shape}: f64 relres {r0['rel64']:.3e} >= tol")
    want = _expected(sharded_launches(spec, mesh_shape, it))
    for rank, r in enumerate(ranks):
        check_launches(f"{shape} rank {rank}", r["launches"], want,
                       "K9/K10 (K11/K12) at every sharded level >= kernel_min_size, "
                       "K13/K14 instead at a packed fine level, no single-device kernel")
    print(f"[{label}] sharded kernel levels {sharded_kernel_levels(spec, mesh_shape)}; "
          f"launches per rank {r0['launches']}")
    ms = [statistics.median(r["cycle_ms"]) for r in ranks]
    print(f"[{label}] per-cycle wall ms, median ({how}), rank 0..3: "
          + " ".join(f"{m:.3f}" for m in ms)
          + f" (rank 0: {' '.join(f'{c:.3f}' for c in r0['cycle_ms'])})")
    return r0["launches"]


def phase_spmd(dev):
    """The sharded solves on 4 ranks sharing the card over gloo; the
    single-device 16384^2 solves (tuned, and fast with its packed fine
    level) as the references of the sharded ones."""
    refs16k = {}
    for spec in (SPEC_16K, FAST_16K):
        mg, res, cycle_ms = _solve(spec, dev)
        what = f"{spec.scheme}{' packed' if mg._packed else ''}"
        check(res.converged, f"the single-device 16384^2 {what} solve did not converge")
        check(mg._packed == (spec.scheme == "fast"), f"the single-device 16384^2 {what} solve")
        refs16k[spec.scheme] = res.errs.tolist()
        print(f"[spmd] single-device 16384^2 {what} f32: {res.iterations} cycles, per-cycle "
              f"wall ms median {statistics.median(cycle_ms):.3f}")
        del mg, res
        torch.cuda.empty_cache()

    refs = {"spmd4096": JAX_ERRS, "spmd256^3": JAX_ERRS_3D[256],
            "spmd16384": refs16k["tuned"], "spmd4096fast": JAX_ERRS_FAST[MAIN_N],
            "spmd16384fast": refs16k["fast"]}
    t0 = time.perf_counter()
    ranks = _spawn_ranks("gloo", SPMD_CASES)
    print(f"[spmd] {SPMD_WORLD} ranks over gloo on {torch.cuda.device_count()} card(s): "
          f"{time.perf_counter() - t0:.1f} s for the spawn and every solve")
    launches = {}
    how = "4 ranks, one card, gloo" if torch.cuda.device_count() == 1 else "4 ranks, gloo"
    for i, (label, spec, mesh_shape, _) in enumerate(SPMD_CASES):
        launches[label] = _check_spmd(label, spec, mesh_shape, [r[i] for r in ranks],
                                      refs[label], how)
    if torch.cuda.device_count() >= SPMD_WORLD:
        cases = [c for c in SPMD_CASES if c[0] in ("spmd4096", "spmd4096fast")
                 and c[2] == ((2, 2) if c[0] == "spmd4096" else (4, 1))]
        nccl = _spawn_ranks("nccl", cases)
        for i, (label, spec, mesh_shape, _) in enumerate(cases):
            _check_spmd(label, spec, mesh_shape, [r[i] for r in nccl], refs[label],
                        "4 ranks, 4 cards, nccl")
    else:
        print(f"[spmd] NCCL: not run: {torch.cuda.device_count()} card(s), and NCCL refuses "
              f"two ranks on one GPU; the {SPMD_WORLD} ranks above ran over gloo")
    return {"2d": launches["spmd16384"], "3d": launches["spmd256^3"],
            "packed": launches["spmd16384fast"]}


def main():
    card = phase_device()
    dev = torch.device("cuda")
    phase_build()
    worst = {k: [0.0, 0.0] for k in KERNELS}

    # the 2D path: the tuned 4096^2 solve
    phase_parity(dev, 2, kernel_levels(MAIN_SPEC), worst, SMALL_SIDES)
    times = phase_timing(dev, MAIN_N, 2)
    it, solve2, trace2 = phase_slice("slice", MAIN_SPEC, dev, JAX_ITERATIONS, JAX_ERRS)
    L = len(kernel_levels(MAIN_SPEC))
    check_launches("4096^2 solve", solve2, _expected({
        "mg_smooth_rr": it * L, "mg_smooth_rr.zero": it * (L - 1),
        "mg_prolong_correct_smooth": it * L, "mg_prolong_correct_smooth.rnorm": it}),
        f"one K2 and one K3 per cycle at every level >= {MAIN_SPEC.kernel_min_size}, "
        "K3 with rnorm once per cycle, no 3D kernel")
    check_launches("4096^2 traced V-cycle", trace2, _expected({"mg_smooth": 2 * L}),
                   f"K1 twice at each of the {L} kernel levels")

    # the bf16 forms of K1-K3: the mixed-precision 4096^2 solve and the
    # pure bf16 one
    phase_parity_bf16(dev, worst)
    times_bf16 = phase_timing(dev, MAIN_N, 2, torch.bfloat16)
    for name, t in times_bf16.items():
        f32 = name.replace(BF16, "")
        print(f"[timing_bf16] {name} against its f32 form: " + _beside(times[f32], t))
    times.update(times_bf16)
    solve_mixed = phase_slice_mixed(dev)
    trace_bf16 = phase_slice_bf16(dev)

    # the 3D path: the tuned 256^3 solve, then 512^3
    phase_parity(dev, 3, SIDES_3D, worst, SMALL_SIDES)
    times.update(phase_timing(dev, SPEC_3D.size, 3))
    it3, solve3, trace3 = phase_slice("slice3d", SPEC_3D, dev, JAX_ITERATIONS_3D,
                                   JAX_ERRS_3D[256])
    check_launches("256^3 solve", solve3, _expected({
        "mg_smooth_rr3d": it3, "mg_prolong_correct_smooth3d": it3,
        "mg_prolong_correct_smooth3d.rnorm": it3}),
        "one K5 and one K6 (with rnorm) per cycle at the one kernel level, "
        "K5 never from zero, no 2D kernel")
    check_launches("256^3 traced V-cycle", trace3, _expected({"mg_smooth3d": 2}),
                   "K4 twice at the one kernel level")
    spec512 = SPEC_3D.with_(size=512)
    it5, solve5, trace5 = phase_slice("solve512", spec512, dev, JAX_ITERATIONS_3D,
                                      JAX_ERRS_3D[512], compare_plain=False,
                                      warm_up=False)
    check_launches("512^3 solve", solve5, _expected({
        "mg_smooth_rr3d": 2 * it5, "mg_smooth_rr3d.zero": it5,
        "mg_prolong_correct_smooth3d": 2 * it5, "mg_prolong_correct_smooth3d.rnorm": it5}),
        "one K5 and one K6 per cycle at 512 and 256, K5 from zero at 256, "
        "K6 with rnorm at 512")
    check_launches("512^3 traced V-cycle", trace5, _expected({"mg_smooth3d": 4}),
                   "K4 twice at each of the two kernel levels")

    # the bf16 forms of K4-K6: the mixed-precision 256^3 and 512^3 solves
    # and the pure bf16 256^3 one
    probe_restrict_order_3d(dev)
    phase_parity_bf16(dev, worst, 3)
    times_bf16 = phase_timing(dev, SPEC_3D.size, 3, torch.bfloat16)
    for name, t in times_bf16.items():
        print(f"[timing_bf16] {name} against its f32 form: "
              + _beside(times[name.replace(BF16, "")], t))
    times.update(times_bf16)
    solve_mixed3 = phase_slice_mixed(dev, MIXED_SPEC_3D, SPEC_3D, JAX_ITERATIONS_MIXED_3D,
                                     JAX_ERRS_MIXED_3D, "slice_mixed3d")
    phase_slice_mixed(dev, MIXED_SPEC_3D.with_(size=512), None, None, None, "solve512_mixed")
    trace_bf16_3 = phase_slice_bf16(dev, BF16_SPEC_3D, JAX_ERRS_BF16_3D, "slice_bf16_3d")

    # the fast scheme's packed fine level: the 4096^2 solve, then 1024^2
    # and 16384^2
    phase_parity_packed(dev, worst)
    times.update(phase_timing_packed(dev, MAIN_N))
    solve_fast = phase_slice_fast(dev, MAIN_N, compare=True)
    phase_slice_fast(dev, 1024, compare=False)
    phase_slice_fast(dev, 16384, compare=False)
    phase_strided(dev)

    # the sharded solves (explicit partition): the strip kernels, the
    # packed strip kernels of the fast scheme on a mesh of one column, then
    # 4 ranks solving 4096^2, 256^3 and 16384^2 (tuned) and 4096^2 and
    # 16384^2 (fast, packed)
    phase_parity_sharded(dev, worst)
    times.update(phase_timing_sharded(dev, times))
    phase_parity_sharded_packed(dev, worst)
    times.update(phase_timing_sharded_packed(dev))
    solve_spmd = phase_spmd(dev)

    kernels, off_path = [], []
    for name, (source, replaces) in KERNELS.items():
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "max_abs_err": worst[name][1], "max_norm_err": worst[name][0],
               **times[name], "library_ms": None}
        solve, trace = (solve3, trace3) if name.endswith("3d") else (solve2, trace2)
        if name.endswith(BF16):
            solve, trace = ((solve_mixed3, trace_bf16_3) if "3d" in name
                            else (solve_mixed, trace_bf16))
        if name.startswith("mg_packed"):
            solve = solve_fast
        if name.startswith("mg_sharded"):
            solve = solve_spmd["3d" if name.endswith("3d") else
                               "packed" if name.startswith("mg_sharded_packed") else "2d"]
        if name in OFF_PATH:
            off_path.append({**row, "trace_launches": trace[name]})
        else:
            kernels.append({**row, "launches": solve[name]})
    print(json.dumps({"off_path_kernels": off_path}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
