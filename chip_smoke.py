"""Drives mgpoisson_torch's main paths once on one NVIDIA GPU and checks them.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device   — a CUDA device must be present; prints its name and power
              limit (nvidia-smi) and turns TF32 off.
2. build    — builds every CUDA kernel from mgpoisson_torch/csrc (one nvcc
              per source, in parallel) and prints ptxas's registers, spills
              and shared memory (K7/K8 and K13/K14 among them: the register
              tile's instances), and the tiles' geometry (K4's at the tuned
              scheme's halo 3: the z-marching tile, in bf16 the word tile).
3. parity   — each 2D kernel (K1-K3) against its plain torch version on the
              card, f32, at every level side the 2D path gives the kernels
              (4096 ... 256) x bc x smoother x nu, and at every side below
              (128 ... 2: sides smaller than one warp's tile, the checked
              edge path, the tile table's switch points) x bc with wjacobi
              nu = 3, rbgs nu = 1 and 4 and jacobi nu = 7; then the time of
              each at 4096^2 beside the plain version's (CUDA events, median
              of 25, alternating; and the kernel's own device time from
              torch.profiler, without the host's time to enqueue the call)
              and beside its bound.  At the tuned and fast solves' settings
              (wjacobi nu = 3, rbgs nu = 1) every output must be bit-equal.
4. slice    — the tuned-scheme 4096^2 f32 solve through
              MultigridPoisson(spec, device="cuda").solve(): the cycle count
              and per-cycle relres against the JAX package's, the returned
              psi re-checked in f64, the launch counters of that solve; then
              a traced V-cycle (the per-stage debugging path, the one caller
              of K1) with the counters zeroed again; then the same solve on
              plain ops (backend="torch") for comparison.
4b. parity_bf16 — first a probe that torch on the card divides a bf16
              tensor by a Python scalar c as a product by f32(1 / f32(c)),
              the constants kernels.cuda._scalars hands the bf16 kernels;
              then the bf16 forms of K1-K3 against their plain torch
              versions in bf16, at every side the two bf16 solves give the
              kernels (4096 ... 256) and at 128 ... 2, x bc x (jacobi and
              wjacobi nu 1-3, rbgs nu 1-2), and at 256 and 16 with wjacobi
              nu 3 and rbgs nu 1 on inputs x 2^-120 and at h = 0.01, 0.3,
              both prolongation kinds, from zero and with rnorm: every
              output bit-equal, sum(r^2) within 1e-5; then (timing_bf16)
              each form at 4096^2 with the main path's settings beside its
              f32 form's device time from the same run, each with its
              bound and share of it.
4c. slice_mixed — the mixed-precision refinement solve (f32 with a bf16
              V-cycle, tuned 4096^2, the JAX package's bench config):
              refinement steps against the JAX package's count (equal or
              within one), each step's relres beside the JAX package's, an
              f64 re-check, the bf16 forms' launches, the same solve on
              plain ops (the same history, bit for bit), and device ms,
              launches and wall per step from torch.profiler beside the f32
              tuned 4096^2 solve's.  Then (mixed_off_grid) the mixed
              solve at 1024^2 with h = 0.01 (1/2^k at no level), tol 1e-8:
              its launches, and its plain-ops twin bit-equal.  Then
              (slice_bf16) the pure bf16 solve (12 cycles, tol 1e-30): its
              history beside the JAX package's and beside its plain-ops
              twin (equal), its launches, and a traced bf16 V-cycle (K1's
              bf16 form).
5. parity3d — each 3D kernel (K4-K6) against its plain version at every side
              the 3D paths give the kernels (512, 256) x bc x smoother x nu,
              both prolongation kinds, rnorm and from zero, and at every side
              below (128 ... 2: sides smaller than one z-marching column or
              chunk) x bc with wjacobi nu = 3, rbgs nu = 1, rbgs nu = 2 and
              jacobi nu = 4 (halo 5: K5 and K6 with rnorm on the cube tile,
              K6 on the z-marching one; K4 runs the z-marching tile at halos
              <= 4 and the cube tile at rbgs nu = 3's 6); every K4-K6
              output, of either tile,
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
              each pair with its device times and bounds (a packed leg's
              counts u's black plane only: the red one is dead on input),
              and the time of the solver's pack and unpack.
9. slice_fast — the fast-scheme 4096^2 f32 solve, packed, as in phase 4
              (cycles, relres, f64 re-check, launches), then the same spec
              with MGPOISSON_PACKED=0 (the unpacked K2/K3 fine level) and on
              plain ops, each with its per-cycle wall; then 1024^2 and
              16384^2 with the same checks.  Then (parity_packed_bf16) the
              bf16 forms of K7 and K8 against their plain packed versions in
              bf16 at 4096, 1024, 256 x nu in {1, 2, 3} and with nu = 1 and 3
              at 128 ... 2, at 10 and 6 (n % 4 == 2), on inputs x 2^-120 and
              at h = 0.01 and 0.3 (256 and 16), every output bit-equal, after
              a probe that torch sums a bf16 row pair of the packed
              restriction in f32 and rounds once;
              (timing_packed_bf16) their times at 4096^2 beside their f32
              forms' and the bf16 K2/K3 at rbgs nu = 1 unpacked; and
              (slice_fast_bf16) the pure bf16 fast solve, packed, at 4096^2
              (beside its MGPOISSON_PACKED=0 twin on the unpacked bf16
              kernels) and 1024^2: 12 cycles at tol 1e-30, each history beside
              the JAX package's, cycle 1's psi against the twin's and the f32
              solve's, the launches.  Then (strided) the tuned and
              the fast 256^2 solves of an f or psi0 that is transposed,
              Fortran-order NumPy or a view at an odd 4-byte offset: each
              gives the psi and the cycle count of its dense copy, bit for
              bit.
9b. fmg_adaptive — FMG and the adaptive stop, each solve as a user calls it,
              with no callback, timed by CUDA events: slice_fmg (tuned
              4096^2 FMG: the JAX package's cycle count and relres, the f64
              re-check, the FMG pass's launches and its wall alone),
              slice_adaptive (tuned 4096^2 adaptive: the JAX package's
              cycles and metric evaluations, each measured relres against
              JAX_ERRS, K3 with rnorm on the JAX run's measured cycles
              (JAX_MEASURED) only, one
              device->host read per evaluation), slice_fast_adaptive (fast
              4096^2 packed adaptive, then to a stop at maxiter on a skipped
              cycle, K8 without rnorm there, then with FMG, its loop
              packed), slice_fmg3d (256^3 FMG and adaptive together); every
              count against a JAX CPU run, every launch count worked out in
              code.
9c. krylov  — the multigrid-vs-Krylov gate (compare.krylov, bench.converge):
              krylov_mgcg (CG preconditioned by one tuned V-cycle from zero,
              4096^2 point charge, tol 1e-10, f32 and f64: the JAX package's
              iteration count and each relres within 1 % of its CPU run; in
              f32 K2 (from zero) and K3 at 4096 ... 256 once per
              preconditioner call, iterations + 1 device->host reads, the
              wall, the device ms and the preconditioner's share of the
              wall, each ||x||_inf within the rounding floor of x0 = -b
              (eps(f32) * 1e6: the f32 x is rounding there); in f64, on
              plain ops, xnorms[-1] within 1e-5 of the JAX run's) and converge_study (run_study at 4 ... 128, reference
              scheme, f64, all five solvers, plain ops: the JAX package's
              multigrid, CG, CR, GMRES and MGCG counts, BiCGStab's history
              tracked to its 20th iteration and its count beside the JAX
              count; each Krylov psi within 1e-8 of multigrid's where
              multigrid converged, and at 128, where multigrid stops at
              maxiter as in the JAX run, the gap to multigrid the JAX run's
              and the Krylov solutions within 1e-8 of CG's).
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
              256^3 per cell, each with its plain version and bound.  Then
              (parity_sharded_bf16) the bf16 forms of K9-K12 the same way
              at the 2D and 3D sides, every output bit-equal to the plain
              sharded op in bf16 and, stitched, to the bf16 forms of K2/K3
              (K5/K6), Σr² within 1e-5, each 3D row naming the tile each
              leg ran (z-marching, or the cube tile at rbgs nu = 2's
              deeper halo); (timing_sharded_bf16) their times on the same
              blocks beside their f32 forms, the bf16 K2/K3 on the whole
              8192^2 array and the bf16 K5/K6 on the whole 256^3 per cell.
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
              packed 16384^2 solve, and the mixed-precision solve (f32, bf16
              sweeps) at 4096^2 on (2, 2) and (4, 1), its step count against
              the JAX package's (within one) and its history against the
              single-device mixed solve's, and at 16384^2 on (2, 2) against
              the single-device mixed 16384^2 solve (its step count), and
              the mixed solve at 256^3 on (2, 2) and (4, 1), its step count
              against the JAX package's (within one) and its history
              against the single-device mixed 256^3 solve's, and at 512^3
              on (2, 2) against the single-device mixed 512^3 solve (its
              step count); the
              single-device references run in this phase too.  An f64
              re-check of each gathered iterate, and every rank's launches
              (K9/K10 at every sharded level >= 256, K11/K12 at every 3D
              one, their bf16 forms in a mixed solve, K13/K14 at a packed
              fine level, no single-device kernel).  Then FMG and the
              adaptive stop: 4096^2 FMG and 4096^2 adaptive on (2, 2), the
              fast packed 4096^2 adaptive on (4, 1) and its stop at maxiter
              on a skipped cycle (K14 without rnorm), each with the
              iterations, metric evaluations and psi (within 1e-5
              normalized) of its single-device solve of phase 9b.  With 4 or
              more cards, the tuned, the packed and the mixed 4096^2 solves
              again over NCCL.

13. batched — MultigridPoisson.solve_batched, the JAX package's batched
              serving setting (tuned f32 1024^2, stop='residual', tol
              1e-10, 4 RHS): four point charges, and a point charge with
              three seeded RHS that freeze at other cycles, at
              kernel_min_size 256 and 2, on the kernel path (one step per
              live element per cycle, frozen elements skipped): each
              element's psi bit for bit its own solve()'s, its cycles that
              solve's and the JAX package's, one read per batched cycle,
              K2/K3 exactly once per kernel level per element-cycle; the
              fast scheme's batch of 2 (unpacked: each psi bit for bit its
              MGPOISSON_PACKED=0 solve's, the JAX package's unpacked
              counts); the vmap path at 128^2 (plain ops): each psi within
              1e-5 of its solve()'s, the same counts; every wall beside
              the four single solves' (CUDA events, with the card's name
              and power limit).
14. gs_lex  — smoother='gs_lex', reference scheme, 64^2, plain ops on the
              card (no kernel, nothing moved to the CPU): in f64 the JAX
              package's cycle count and each err within 1e-8 of its CPU
              run's; in f32 to 10 cycles, psi within 1e-5 of the f64 psi;
              the phase's seconds.

13 and 14 run last, after every phase that reads the kernels' device time
from torch.profiler: run before phase 10, they were seen to leave that
phase's captures with few or none of the kernels' events.

The last lines are a JSON object of the off-path kernels (K1, K4 and their
bf16 forms, with their launches in the traced cycles), a JSON object of the
main paths' kernels (K2, K3 with their launches in the 4096^2 tuned solve;
the bf16 forms of K2 and K3 with theirs in the mixed 4096^2 solve; K5, K6 with
theirs in the 256^3 solve and their bf16 forms with theirs in the mixed
256^3 solve; K7, K8 with theirs in the 4096^2 fast solve and their bf16
forms with theirs in the bf16 4096^2 fast solve;
K9, K10 with one rank's in the sharded 16384^2 solve, their bf16 forms
in the sharded mixed 16384^2 solve, K11, K12 in the sharded 256^3 solve,
their bf16 forms in the sharded mixed 256^3 solve on (2, 2), and K13, K14
in the sharded fast 16384^2 solve), the
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
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mgpoisson_torch import MultigridPoisson, Spec, point_charge_rhs
from mgpoisson_torch.bench import converge
from mgpoisson_torch.bench.profile import device_summary, event_ms, kernel_ms, profile_solve
from mgpoisson_torch.compare import krylov
from mgpoisson_torch.core import level_sizes
from mgpoisson_torch.cycle.vcycle import v_cycle
from mgpoisson_torch.kernels import (build, cuda, exchange_depth, ops, use_packed_sharded,
                                     use_sharded_kernels)
from mgpoisson_torch.shard import multihost, spmd
from mgpoisson_torch.shard.mesh import ProcessMesh
from mgpoisson_torch.solver import multigrid

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
# ... and for Spec(size=n, dtype='bfloat16', scheme='fast', stop='residual',
# tol=1e-30, maxiter=12) at n = 4096 and 1024: 12 cycles each, finite, with
# this relres per cycle.  The xla backend does not pack (its packed path,
# the Pallas kernels in interpret mode, is too slow at 4096^2 on a CPU), and
# XLA on the CPU computes a fused bf16 expression in f32 and rounds it once
# where torch and the kernels round every op.  After cycle 1 the relres is
# the bf16 residual's rounding noise (the f32 solve's is 6.2e-10 at 4096^2):
# it depends on the residual's formula, not on the iterate (the port's
# packed and unpacked cycles give the same psi, and relres 2.70e-8 and
# 2.71e-9 in a CPU run of the plain ops), so it is printed beside, not held
# to a bar.  What is held: the relres of cycle 1's psi recomputed in f64,
# against the JAX package's cycle-1 psi's recomputed the same way on the CPU.
JAX_ERRS_FAST_BF16 = {
    4096: [2.17535198743235e-08, 9.397520983611685e-08, 5.464484047479345e-07,
           3.5919413221563445e-06, 2.0159421183052473e-05, 0.00018265996186528355,
           0.00157533073797822, 0.0025233805645257235, 0.002181227086111903,
           0.0033502508886158466, 0.0025946623645722866, 0.0040773265063762665],
    1024: [7.918281141883199e-08, 8.962449982163889e-08, 1.1833915181114207e-07,
           1.0224154323168477e-07, 9.789084032263418e-08, 1.018064708091515e-07,
           8.918943450453298e-08, 9.223492725141114e-08, 7.700746351702037e-08,
           7.309182592507568e-08, 7.04814056007308e-08, 5.7429293320865327e-08],
}
JAX_F64_FAST_BF16 = {4096: 3.210807475524961e-08, 1024: 1.9839039433498228e-07}
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
# the same package and backend on a CPU, each solve without a callback, for
# Spec(size=4096, dtype='float32', scheme='tuned', stop='residual',
# tol=1e-10, cycle='fmg'): 1 V-cycle after the FMG pass, converged, with
# this relres (against the -f guess)
JAX_ITERATIONS_FMG = 1
JAX_ERRS_FMG = [1.739887400820095e-11]
# ... and (iterations, n_metric_evals) with stop_check='adaptive' for: that
# spec with cycle='v' (measured relres JAX_ERRS's within 0.003 %), for
# scheme='fast', at tol=1e-30 and maxiter=6 (a stop on a skipped cycle, the
# returned iterate remeasured), and with cycle='fmg'; and for
# Spec(size=256, ndim=3, dtype='float32', scheme='tuned', stop='residual',
# tol=1e-10, cycle='fmg', stop_check='adaptive'), whose history is
# JAX_ERRS_FMG3D.  JAX_MEASURED: the cycles (1-based) that run measured
JAX_ADAPTIVE = {"tuned": (9, 5), "fast": (2, 2), "fast_stale": (6, 3), "fast_fmg": (1, 1),
                "fmg3d": (4, 4)}
JAX_MEASURED = {"tuned": [1, 5, 7, 8, 9], "fast": [1, 2], "fast_stale": [1, 5],
                "fast_fmg": [1], "fmg3d": [1, 2, 3, 4]}
JAX_ERRS_FMG3D = [6.677884023531533e-09, 8.609845614238054e-10, 1.1970295588081825e-10,
                  1.766055704455205e-11]
# mgpoisson.compare.krylov (backend 'xla') on a CPU for
# pcg(poisson_operator(1 / 4096), point_charge_rhs(4096, dtype=dt),
#     M=mg_preconditioner(Spec(size=4096, dtype=dt, scheme='tuned',
#     backend='xla')), tol=1e-10, maxiter=500), dt float32 and float64: 13
# iterations each, converged, with this ||r||/||b|| and ||x||_inf per
# iteration.  The f32 x is rounding from the second iteration on: x0 = -b
# is 1e6 at the centre, the solution's max 0.0884 (the f64 run's), so an
# f32 iterate carries ~eps(f32) * 1e6 = 0.12 of rounding (the JAX run's
# last ||x||_inf is 0.0675, the port's on a CPU 0.1177); its xnorms are
# held to that floor, x itself in the f64 run
MGCG_SPEC = Spec(size=4096, dtype="float32", scheme="tuned")
JAX_MGCG = {
    "float32": ([902550.1875, 34851.5703125, 1041.507568359375, 43.024959564208984,
                 1.4568437337875366, 0.05347932130098343, 0.0021153625566512346,
                 9.866555774351582e-05, 1.4153813935990911e-05, 7.735739018244203e-07,
                 2.9356383990375434e-08, 1.0987610821189264e-09, 5.621564672098067e-11],
                [14889.0791015625, 390.67926025390625, 8.887585639953613, 0.31109076738357544,
                 0.07457747310400009, 0.06738623231649399, 0.0675317719578743,
                 0.06752057373523712, 0.06752090901136398, 0.067520871758461,
                 0.067520871758461, 0.067520871758461, 0.067520871758461]),
    "float64": ([902550.2960758972, 34852.27645363262, 1041.5399833112517, 43.026037808837685,
                 1.4568733628871948, 0.05348007723762877, 0.0021153596786252678,
                 9.863296991264961e-05, 1.414800896237132e-05, 7.735561793526669e-07,
                 2.9356316454340466e-08, 1.0987373594625223e-09, 5.618531736149681e-11],
                [14889.140161680125, 390.6930308911349, 8.905092880913003, 0.32895070294163975,
                 0.09544740083805589, 0.08825529302762204, 0.0884007646383143,
                 0.08838956577726025, 0.08838989719991035, 0.08838986226093248,
                 0.08838986546359305, 0.08838986538481076, 0.08838986538884888]),
}
XNORM_TOL = 1e-5           # relative, on the f64 run's xnorms[-1]
# mgpoisson.bench.converge.run_study(n, 'reference', ['cg', 'cr',
# 'bicgstab', 'gmres', 'mgcg'], 1e-12, 'float64') on a CPU, n = 4 ... 128:
# the multigrid and Krylov iteration counts, every solver converged; at 128
# multigrid stops at maxiter (2000) and every Krylov psi is 1.0429e-3 from
# its psi (normalized), 1e-12 from each other.  BiCGStab's history follows
# the operations' rounding (its relres agrees with the port's CPU run to
# 1e-6 through iteration 25-29 only, then the two part), so its count is
# printed beside the JAX count and its relres held at iteration k (k, relres)
CONVERGE_SIZES = (4, 8, 16, 32, 64, 128)
CONVERGE_SOLVERS = ("cg", "cr", "bicgstab", "gmres", "mgcg")
JAX_CONVERGE = {4: (15, 9, 9, 9, 9, 4), 8: (44, 33, 33, 25, 33, 6),
                16: (146, 72, 72, 52, 72, 8), 32: (511, 141, 141, 106, 185, 10),
                64: (1816, 278, 276, 200, 447, 12), 128: (2000, 543, 532, 419, 1348, 13)}
JAX_CONVERGE_MG_GAP = {128: 1.042898198e-3}
JAX_BICGSTAB_AT = {4: (4, 0.41754320069530654), 8: (12, 0.03654578271249348),
                   16: (20, 0.1135800126579141), 32: (20, 0.874714229070579),
                   64: (20, 4.020653090581913), 128: (20, 16.153455535851293)}
CONVERGE_TOL = 1e-8        # psi against multigrid's, normalized (tests/test_krylov.py)
TRACK_TOL = 1e-6           # BiCGStab's relres at iteration k, relative
BF16_TOL = 5e-2            # the JAX package's bf16 bar (tests/test_pallas_bf16.py)
# solve_batched (phase_batched): the JAX package's batched serving setting
# (bench.py: tuned f32 1024^2, stop='residual', tol=1e-10, 4 RHS per
# program).  Its batches: "identical" (four point charges, as bench.py),
# "mixed" (the point charge and three seeded RHS of BATCH_NOISE: numpy's
# standard normal of the seed, times the amplitude in f64, rounded to f32)
# and, with scheme='fast', "fast" (the point charge and the first seeded
# RHS).  mgpoisson (backend 'xla') on a CPU, solve_batched: each element's
# cycles, those of its own solve() (unpacked on a CPU), whose final err its
# batched err equals bit for bit
BATCH_SPEC = Spec(size=1024, dtype="float32", scheme="tuned", stop="residual", tol=1e-10)
BATCH_NOISE = ((1, 1e-3), (2, 1.0), (3, 1e3))      # (seed, amplitude)
JAX_BATCHED = {"identical": [9, 9, 9, 9], "mixed": [9, 12, 12, 12], "fast": [4, 12]}
BATCH_KMS = (256, 2)       # the kernel_min_size of the batched kernel path's runs
VMAP_N = 128               # the vmap path's side: below kernel_min_size, plain ops
# smoother='gs_lex' (phase_gs_lex): mgpoisson (backend 'xla') on a CPU for
# GS_LEX_SPEC: 21 cycles, converged, with this update RMS per cycle; in f32
# its update stalls near 1e-5 (a 6e4 iterate), so the f32 run stops at
# GS_LEX_F32_MAXITER, where the f64 iterate is already within 1e-6 of its
# last (5.4e-7 normalized on a CPU), and the phase stays near 15 s (a cycle
# is ~28,000 small launches, 0.37-0.51 s on the card)
GS_LEX_F32_MAXITER = 10
GS_LEX_SPEC = Spec(size=64, dtype="float64", scheme="reference", smoother="gs_lex")
JAX_GS_LEX_ERRS = [15620.538703052398, 16.320333445986947, 2.396243706954304,
                   0.5997485393763937, 0.1543316655354285, 0.03988821440015518,
                   0.0103190990987668, 0.002670149453667136, 0.0006909562446875692,
                   0.0001788001460107478, 4.626829053394846e-05, 1.1972834511085799e-05,
                   3.0981962867417193e-06, 8.017146161871599e-07, 2.0745789460828127e-07,
                   5.368334921102799e-08, 1.3891492640180141e-08, 3.5946272158693405e-09,
                   9.301485824601281e-10, 2.4070043798023076e-10, 6.226618554737979e-11]
GS_LEX_RTOL = 1e-8         # errs against the JAX package's, over a floor of
GS_LEX_ATOL = 1e-10        # ... this times errs[0] (tests/test_solver.py)

PARITY_TOL = 1e-5          # normalized max |diff|, the ROADMAP's f32 kernel bar
# the 2D parity below the main path's kernel levels (128 ... 2): the main
# path's settings, the fast scheme's coarse rbgs nu = 1, and the deepest
# halos (rbgs nu = 4, jacobi nu = 7)
SMALL_SIDES = tuple(2 ** k for k in range(7, 0, -1))
SMALL_SETTINGS = (("wjacobi", 3), ("rbgs", 1), ("rbgs", 4), ("jacobi", 7))
# the sweep settings of the tuned and the fast solves: at these every 2D f32
# output of K1-K3 and of K9/K10 (blocks against the plain block ops) must be
# bit-equal to its plain version, as every 3D one and every bf16 one must:
# among them the forms that FMG's V-cycles (K2 from u with bc face, K9 too)
# and the adaptive stop's skipped cycles (K3, K10 without rnorm at the fine
# level) launch
PATH_SETTINGS = (("wjacobi", 3), ("rbgs", 1))
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
# FMG and the adaptive stop (phase_fmg_adaptive, and under a mesh)
FMG_SPEC = MAIN_SPEC.with_(cycle="fmg")
ADAPTIVE_SPEC = MAIN_SPEC.with_(stop_check="adaptive")
FAST_ADAPTIVE_SPEC = FAST_SPEC.with_(stop_check="adaptive")
FAST_STALE_SPEC = FAST_ADAPTIVE_SPEC.with_(tol=1e-30, maxiter=6)
FMG3D_SPEC = SPEC_3D.with_(cycle="fmg", stop_check="adaptive")
# the bf16 paths: mixed-precision refinement (bench.py's sec_bf16 config) and
# the pure bf16 solve; the bf16 parity's settings
MIXED_SPEC = MAIN_SPEC.with_(sweep_dtype="bfloat16")
BF16_SPEC = MAIN_SPEC.with_(dtype="bfloat16", tol=1e-30, maxiter=12)
BF16_SETTINGS = tuple([(sm, nu) for sm in ("jacobi", "wjacobi") for nu in (1, 2, 3)]
                      + [("rbgs", 1), ("rbgs", 2)])
# ... and on inputs scaled by 2^-120 (u, f, V), so that Jacobi quotients
# (and their sums) go subnormal in bf16, where bf16x2 arithmetic must keep
# them as torch does: the 2D bf16 parity and its sharded form at these
# sides with the tuned scheme's and the fast scheme's coarse settings
SUBNORMAL_SCALE = 2.0 ** -120
SUBNORMAL_SIDES = (256, 16)
SUBNORMAL_SETTINGS = (("wjacobi", 3), ("rbgs", 1))
# ... and at spacings h that are not 1/2^k, where the plain ops' bf16 h^2
# and adiag (ops._level) give a 1/h^2 and 1/adiag that are no bf16 values,
# which the 2D bf16 legs multiply by in f32, as torch multiplies by an f32
# scalar (csrc/stencil.cuh Mg2K): at the same sides and settings
OFF_GRID_H = (0.01, 0.3)
# ... and both sets for the bf16 3D legs (the word tile of K5/K6 and
# K11/K12, whose product by 1/adiag is f32 at every h, and the cube tile
# at deeper halos): at these small cubes, whole grid and blocks
SUBNORMAL_SIDES_3D = (64, 32)
# ... in 3D: the mixed 256^3 and 512^3 solves and the pure bf16 256^3 one
MIXED_SPEC_3D = SPEC_3D.with_(sweep_dtype="bfloat16")
BF16_SPEC_3D = SPEC_3D.with_(dtype="bfloat16", tol=1e-30, maxiter=12)
PACKED_SIDES = (16384, 4096, 1024, 256)   # the fine sides of the packed solves, and 256
# the pure bf16 fast solve, its fine level packed on the bf16 forms of K7/K8:
# the companion of BF16_SPEC, at 4096^2 and 1024^2; the bf16 packed parity's
# sides (every fine side of those solves, and 256)
FAST_BF16_SPEC = FAST_SPEC.with_(dtype="bfloat16", tol=1e-30, maxiter=12)
PACKED_BF16_SIDES = (4096, 1024, 256)
# ... and for the packed word tile of K7.bf16/K8.bf16: sides n % 4 == 2 (the
# black plane at odd offsets: 2-byte accesses), then the subnormal and
# OFF_GRID_H sets at SUBNORMAL_SIDES, each with nu = 1 and 3
PACKED_ODD_SIDES = (10, 6)
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
# the mixed-precision solve under a mesh (SpmdCycle.step_mixed, the bf16
# forms of K9/K10): MIXED_SPEC, and at BASELINE's scale-out size; in 3D
# (the bf16 forms of K11/K12) MIXED_SPEC_3D, and at 512^3, where two levels
# are sharded and K11.bf16's from-zero flag is on the path
MIXED_16K = MIXED_SPEC.with_(size=16384)
MIXED_512 = MIXED_SPEC_3D.with_(size=512)
SPMD_DIR = build.BUILD_DIR.parent / "spmd"
# the solves of phase_spmd: (label, spec, mesh, warm-up solve first); the
# fast scheme on (4, 1) runs its fine level packed on K13/K14, the mixed
# solves their bf16 V-cycle on the bf16 forms of K9/K10 (K11/K12 in 3D)
SPMD_CASES = (("spmd4096", MAIN_SPEC, (2, 2), True), ("spmd4096", MAIN_SPEC, (4, 1), True),
              ("spmd256^3", SPEC_3D, (2, 2), True), ("spmd16384", SPEC_16K, (2, 2), False),
              ("spmd4096fast", FAST_SPEC, (4, 1), True),
              ("spmd16384fast", FAST_16K, (4, 1), False),
              ("spmd4096mixed", MIXED_SPEC, (2, 2), True),
              ("spmd4096mixed", MIXED_SPEC, (4, 1), True),
              ("spmd16384mixed", MIXED_16K, (2, 2), False),
              ("spmd256^3mixed", MIXED_SPEC_3D, (2, 2), True),
              ("spmd256^3mixed", MIXED_SPEC_3D, (4, 1), True),
              ("spmd512^3mixed", MIXED_512, (2, 2), False),
              # FMG and the adaptive stop, each held to the single-device
              # solve of phase_fmg_adaptive; the last to a stop at maxiter
              # on a skipped cycle (K14 without rnorm, the packed remeasure)
              ("spmd4096fmg", FMG_SPEC, (2, 2), False),
              ("spmd4096adaptive", ADAPTIVE_SPEC, (2, 2), False),
              ("spmd4096fastadaptive", FAST_ADAPTIVE_SPEC, (4, 1), False),
              ("spmd4096faststale", FAST_STALE_SPEC, (4, 1), False))
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

# kernel -> (source, the Pallas kernel it replaces: for K4, K5 and K6 in
# bf16 and for K4 in f32 the source of their z-marching instances, the
# main path's tile); K1 and K4 (and their
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
    "mg_smooth3d": ("mgpoisson_torch/csrc/mg_smooth3d_zm.cu",
                    "mgpoisson/kernels/pallas.py:1558"),
    "mg_smooth_rr3d": ("mgpoisson_torch/csrc/mg_smooth_rr3d.cu",
                       "mgpoisson/kernels/pallas.py:1693"),
    "mg_prolong_correct_smooth3d": ("mgpoisson_torch/csrc/mg_prolong_correct_smooth3d.cu",
                                    "mgpoisson/kernels/pallas.py:1821"),
    "mg_smooth3d_bf16": ("mgpoisson_torch/csrc/mg_smooth3d_zw.cu",
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
    "mg_packed_rr_bf16": ("mgpoisson_torch/csrc/mg_packed_rr_bf16.cu",
                          "mgpoisson/kernels/pallas.py:3079"),
    "mg_packed_pc_bf16": ("mgpoisson_torch/csrc/mg_packed_pc_bf16.cu",
                          "mgpoisson/kernels/pallas.py:3243"),
    "mg_sharded_rr": ("mgpoisson_torch/csrc/mg_smooth_rr.cu",
                      "mgpoisson/kernels/pallas.py:4080"),
    "mg_sharded_pc": ("mgpoisson_torch/csrc/mg_prolong_correct_smooth.cu",
                      "mgpoisson/kernels/pallas.py:4228"),
    "mg_sharded_rr_bf16": ("mgpoisson_torch/csrc/mg_sharded_rr_bf16.cu",
                           "mgpoisson/kernels/pallas.py:4080"),
    "mg_sharded_pc_bf16": ("mgpoisson_torch/csrc/mg_sharded_pc_bf16.cu",
                           "mgpoisson/kernels/pallas.py:4228"),
    "mg_sharded_rr3d": ("mgpoisson_torch/csrc/mg_smooth_rr3d.cu",
                        "mgpoisson/kernels/pallas.py:4908"),
    "mg_sharded_pc3d": ("mgpoisson_torch/csrc/mg_prolong_correct_smooth3d.cu",
                        "mgpoisson/kernels/pallas.py:5060"),
    "mg_sharded_rr3d_bf16": ("mgpoisson_torch/csrc/mg_sharded_rr3d_zm_bf16.cu",
                             "mgpoisson/kernels/pallas.py:4908"),
    "mg_sharded_pc3d_bf16": ("mgpoisson_torch/csrc/mg_sharded_pc3d_zm_bf16.cu",
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
    # the bf16 forms of K1-K3 and of K9/K10 (one instance per smoother and
    # tile row count; K9's without the deep tile's 40 rows), of K4-K6 (the
    # cube tile's three kernels, and one word-tile instance per step count,
    # smoother and bc: 20 of K4, 16 of K5, 22 of K6, each at <= 64
    # registers for two blocks per SM), of K11/K12 (the same: two cube
    # kernels, 16 + 22 strip-fed word-tile instances) and of K7/K8 (on the
    # packed word tile, one per row count, 16 or 32)
    flat2d = lambda fn: "3d" not in fn and "packed" not in fn
    for what, want, rank in (("K1-K3", 27, lambda fn: flat2d(fn) and "sharded" not in fn),
                             ("K9/K10", 15, lambda fn: flat2d(fn) and "sharded" in fn),
                             ("K4-K6", 61, lambda fn: "3d" in fn and "sharded" not in fn),
                             ("K11/K12", 40, lambda fn: "3d" in fn and "sharded" in fn),
                             ("K7/K8", 4, lambda fn: "packed" in fn)):
        bf16 = {fn: r for fn, r in report.items() if BF16 in fn and rank(fn)}
        check(len(bf16) == want,
              f"{len(bf16)} bf16 instances of {what} in the ptxas report, not {want}")
        regs = sorted(r["registers"] for r in bf16.values())
        spilled = [fn for fn, r in bf16.items() if r["spill_stores"] or r["spill_loads"]]
        print(f"[build] bf16 forms of {what}: {len(bf16)} instances, {regs[0]}-{regs[-1]} "
              f"registers, {len(spilled)} with spills")
        check(not spilled, f"bf16 instances spill: {spilled}")
    # ptxas reports static shared memory only; the 3D kernels' is dynamic.
    # K4-K6 and K11/K12 run the z-marching tile at halos <= 4 (K4's halo is
    # its step count, K5's and K6.rnorm's one more), the cube tile beyond
    legs = (("mg_smooth3d", 3, "smooth"), ("mg_smooth_rr3d", 4, "rr"),
            ("mg_prolong_correct_smooth3d", 3, "pc"),
            ("mg_prolong_correct_smooth3d.rnorm", 4, "pc"))
    check(all(cuda.zmarch3d(halo) for _, halo, _ in legs),
          "a leg at the tuned scheme's halo runs the cube tile")
    for name, halo, leg in legs:
        t = cuda.tile3d_zm(halo)
        smem = cuda.shared_bytes_3d_zm(3, leg == "rr", leg == "pc", smooth=leg == "smooth")
        print(f"[build] {name} at the tuned scheme's halo {halo}: z-marching tile, "
              f"{cuda.ZM_COLS}^2 loaded cells per plane ({t}^2 owned), "
              f"{cuda.zm_chunk(256, halo)} / {cuda.zm_chunk(512, halo)} planes per block at "
              f"256^3 / 512^3, {smem} bytes of dynamic shared memory per block")
    # their bf16 forms on the word tile (csrc/stencil3d_zw.cuh)
    bf = torch.bfloat16
    for name, halo, leg in legs:
        ty, tx = cuda.tile3d_zw(halo)
        chunks = [cuda.zm_chunk(n, halo, dtype=bf) for n in (256, 512)]
        blocks = [cuda.blocks3d(n, halo, dtype=bf) for n in (256, 512)]
        print(f"[build] {name.replace('3d', '3d' + BF16, 1)} at the tuned scheme's halo "
              f"{halo}: word tile, {cuda.ZW_LANES} words x {cuda.ZW_ROWS} rows loaded per plane "
              f"({ty} x {tx} owned cells), {chunks[0]} / {chunks[1]} planes per block at 256^3 "
              f"/ 512^3 ({blocks[0]} / {blocks[1]} blocks), "
              f"{cuda.shared_bytes_3d_zm(3, leg == 'rr', leg == 'pc', bf, leg == 'smooth')} "
              "bytes of dynamic shared memory per block")
    k4 = {fn: r for fn, r in report.items() if "mg_smooth3d_zm" in fn}
    for what, sel in (("f32", lambda fn: BF16 not in fn), ("bf16", lambda fn: BF16 in fn)):
        regs = sorted(r["registers"] for fn, r in k4.items() if sel(fn))
        spills = sum(1 for fn, r in k4.items()
                     if sel(fn) and (r["spill_stores"] or r["spill_loads"]))
        check(len(regs) == 20,
              f"{len(regs)} {what} instances of K4 on the z-marching tiles, not 20")
        print(f"[build] K4 {what} on the {'word' if what == 'bf16' else 'z-marching'} tile: "
              f"{len(regs)} instances, {regs[0]}-{regs[-1]} registers, {spills} with spills")
    for fn, r in k4.items():
        if "ILi3ELi1ELb0E" in fn:   # the tuned scheme's wjacobi nu = 3, ghost0
            print(f"[build] K4 at halo 3 (wjacobi, ghost0): {fn}: {r['registers']} registers, "
                  f"{r['spill_stores']} / {r['spill_loads']} bytes of spill stores / loads")
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
              "memory per block; bf16 on the word tile: "
              f"{cuda.zm_chunk(SPEC_3D.size, halo, nzl, nyl, bf)} planes per block, "
              f"{cuda.blocks3d(SPEC_3D.size, halo, nzl, nyl, bf)} blocks")
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
    # ... and their bf16 forms on the packed word tile, on the whole grid
    for name, halo in (("mg_packed_rr_bf16", 3), ("mg_packed_pc_bf16", 2),
                       ("mg_packed_pc_bf16.rnorm", 3)):
        rows, cols = cuda.tile_packed_w(halo)
        print(f"[build] {name} at rbgs nu = 1 on (4096, 4096): packed word tile, halo "
              f"{halo}, {rows} rows x {cols} packed columns of each plane owned per block of "
              f"{cuda.TILE_WARPS} warps, {-(-4096 // rows) * -(-2048 // cols)} blocks, no "
              "dynamic shared memory")


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


def rel_r2(got, want):
    """The relative difference of two sums of r^2; the absolute one where
    want is 0 (r^2 of a residual near bf16's subnormals underflows in f32)."""
    got, want = float(got), float(want)
    return abs(got / want - 1.0) if want != 0 else abs(got)


def note_r2(tag, got, want, row, tol=RNORM_TOL):
    rel2 = rel_r2(got, want)
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

    for n in list(sides) + list(small_sides):
        u, f, V = _data(n, ndim, seed=n, dev=dev)
        h = 1.0 / n
        for bc in ("ghost0", "face"):
            for smoother, nu in _parity_settings(ndim, n in sides):
                # every 3D output equals its plain version bit for bit, on
                # the z-marching tile (halo <= 4) and on the cube tile
                # alike; in 2D every output at the settings of the solves
                exact = ndim == 3 or (smoother, nu) in PATH_SETTINGS
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
                if ndim == 2 and exact:
                    row.append("bit-equal")
                if ndim == 3:
                    tile = lambda hh: "z-marching" if cuda.zmarch3d(hh) else "cube"
                    row.append(f"bit-equal; K4: halo {steps} {tile(steps)} tile; K5/K6: "
                               + ", ".join(f"halo {hh} {tile(hh)} tile"
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


def _black(up):
    """A packed array's black plane (its right half), the part of u that a
    packed leg needs: the red plane is dead on input, the first red step
    overwriting it from the black plane alone, so the bounds count only the
    black one (the f32 tile loads both all the same)."""
    return ops._planes(up)[1]


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


def phase_timing_packed(dev, n, dtype=torch.float32):
    """At the fast scheme's fine settings (rbgs nu = 1, bilinear, ghost0):
    K7, K8 and K8 with rnorm on packed state, and beside them K2 and K3 on
    the unpacked grid, each with its plain version and its bound.  With
    dtype bf16, the bf16 forms (timing_packed_bf16)."""
    u, f, V = (t.to(dtype) for t in _data(n, 2, seed=11, dev=dev))
    up, fp = cuda.pack_grid(u), cuda.pack_grid(f)
    h, nu = 1.0 / n, 1
    unpacked = (h, nu, "rbgs", "ghost0")
    w_rr, w_pc = _work(2, nu, "rbgs", "rr"), _work(2, nu, "rbgs", "pc", "bilinear")
    w_pcr = _work(2, nu, "rbgs", "pc", "bilinear", rnorm=True)
    sfx = BF16 if dtype == torch.bfloat16 else ""
    rr, pc = "mg_smooth_rr" + sfx, "mg_prolong_correct_smooth" + sfx
    cases = {
        "mg_packed_rr" + sfx: (lambda m: m.packed_smooth_residual_restrict(up, fp, h, nu),
                               (_black(up), fp), w_rr),
        rr + "@rbgs": (lambda m: m.smooth_residual_restrict(u, f, *unpacked), (u, f), w_rr),
        "mg_packed_pc" + sfx: (lambda m: m.packed_prolong_correct_smooth(up, fp, V, h, nu,
                                                                         "bilinear"),
                               (_black(up), fp, V), w_pc),
        pc + "@rbgs": (lambda m: m.prolong_correct_smooth(u, f, V, *unpacked, "bilinear"),
                       (u, f, V), w_pc),
        f"mg_packed_pc{sfx}.rnorm": (
            lambda m: m.packed_prolong_correct_smooth_rnorm(up, fp, V, h, nu, "bilinear"),
            (_black(up), fp, V), w_pcr),
        pc + ".rnorm@rbgs": (
            lambda m: m.prolong_correct_smooth_rnorm(u, f, V, *unpacked, "bilinear"),
            (u, f, V), w_pcr),
    }
    label, what = "timing_packed" + sfx, "bf16" if sfx else "f32"
    out = _time_cases(label, cases, f"{n}^2", n * n, what)
    for packed_name, name in ((f"mg_packed_rr{sfx}", rr + "@rbgs"),
                              (f"mg_packed_pc{sfx}", pc + "@rbgs"),
                              (f"mg_packed_pc{sfx}.rnorm", pc + ".rnorm@rbgs")):
        print(f"[{label}] packed {packed_name} against unpacked {name}: "
              + _beside(out[packed_name], out[name]))
    # the solver's pack of psi and f and unpack of psi, once per solve
    # (plain torch: exact data movement)
    print(f"[{label}] pack_grid {event_ms(lambda: cuda.pack_grid(u), TIMING_REPS):.4f} ms, "
          f"unpack_grid {event_ms(lambda: cuda.unpack_grid(up), TIMING_REPS):.4f} ms at {n}^2 "
          f"{what}")
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

    f64_recheck(label, spec, f, res.psi)
    print(f"[{label}] kernel levels {kernel_levels(spec)}; launches in the solve "
          f"{after_solve}; in the traced cycle {after_trace}")
    ms_k = statistics.median(cycle_ms)
    print(f"[{label}] per-cycle wall ms, median (all): kernels {ms_k:.3f} "
          f"({' '.join(f'{c:.3f}' for c in cycle_ms)})")

    if compare_plain:
        compare_solve(label, "plain", spec.with_(backend="torch"), dev, it, {}, warm_up)
    return it, after_solve, after_trace


def f64_recheck(label, spec, f, psi):
    """The returned psi, re-checked independently in f64 with the plain
    ops: ||r|| / ||r0|| of the -f guess must be below tol."""
    f64, psi64 = f.double(), psi.double()
    rel64 = float(ops.residual_norm(psi64, f64, spec.fine_h)
                  / ops.residual_norm(-f64, f64, spec.fine_h))
    del f64, psi64
    print(f"[{label}] f64 re-check: ||r||/||r0|| = {rel64:.6e} (tol {spec.tol})")
    check(rel64 < spec.tol, f"{label}: f64 relres of the returned psi {rel64:.3e} >= tol")


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
    """(side, settings, scale of the inputs, spacing h or None for 1/side)
    of the bf16 parity: in 2D every level side the two bf16 solves give the
    kernels and 128 ... 2, x BF16_SETTINGS, then the subnormal set and the
    OFF_GRID_H set; in 3D 512^3 with the main path's wjacobi 3, and 256^3
    and 128 ... 2 with SMALL_SETTINGS_3D (both tiles), then the subnormal
    and OFF_GRID_H sets at SUBNORMAL_SIDES_3D with those settings."""
    if ndim == 2:
        return ([(n, BF16_SETTINGS, 1.0, None)
                 for n in kernel_levels(MIXED_SPEC) + list(SMALL_SIDES)]
                + [(n, SUBNORMAL_SETTINGS, SUBNORMAL_SCALE, None) for n in SUBNORMAL_SIDES]
                + [(n, SUBNORMAL_SETTINGS, 1.0, h) for h in OFF_GRID_H for n in SUBNORMAL_SIDES])
    return ([(512, (("wjacobi", 3),), 1.0, None)]
            + [(n, SMALL_SETTINGS_3D, 1.0, None) for n in (256,) + SMALL_SIDES]
            + [(n, SMALL_SETTINGS_3D, SUBNORMAL_SCALE, None) for n in SUBNORMAL_SIDES_3D]
            + [(n, SMALL_SETTINGS_3D, 1.0, h) for h in OFF_GRID_H for n in SUBNORMAL_SIDES_3D])


def _case_label(n, scale, h, ndim=None):
    """A parity row's side, with its input scale and spacing where they
    are not 1 and 1/side."""
    return (f"n={n}{'' if ndim is None else f'^{ndim}'}"
            f"{'' if scale == 1 else ' x2^-120'}{'' if h is None else f' h={h}'}")


def _subnormals(x):
    """The count of nonzero values of bf16 x below bf16's least normal."""
    return int(((x != 0) & (x.float().abs() < torch.finfo(torch.bfloat16).tiny)).sum())


def probe_scalar_division(dev):
    """That torch on the card divides a bf16 tensor by a Python scalar c as
    a product by f32(1 / f32(c)), rounded once to bf16, and multiplies by
    f32(c): the constants kernels.cuda._scalars hands the bf16 kernels, the
    reciprocals taken in f32 from the plain ops' bf16 h^2 and adiag
    (ops._level), at h = 1/256 and OFF_GRID_H in 2D and 3D.  The CPU
    divides; the cells where its quotient differs are counted."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(1 << 20, generator=g, device=dev).to(torch.bfloat16)
    xc = x.cpu()
    for ndim, h in itertools.product((2, 3), (1.0 / 256,) + OFF_GRID_H):
        hsq, adiag, _, _ = ops._level(h, ndim, torch.bfloat16)
        inv_hsq, inv_adiag, k_adiag = (c.value for c in cuda._scalars(h, ndim, torch.bfloat16))
        row = [f"ndim={ndim} h={h}"]
        for c, inv in ((hsq, inv_hsq), (adiag, inv_adiag)):
            got = x / c
            check(torch.equal(got, (x.float() * inv).to(torch.bfloat16)),
                  f"{row[0]}: torch's x / {c!r} on the card is not x * f32(1 / f32(c))")
            row.append(f"x / {c!r} = x * {inv!r} ({int((got.cpu() != xc / c).sum())} of "
                       f"{x.numel()} cells off the CPU's quotient)")
        check(k_adiag == adiag and torch.equal(x * adiag, (x.float() * k_adiag).to(torch.bfloat16)),
              f"{row[0]}: torch's x * {adiag!r} on the card is not the f32 product")
        print("[probe_division] " + "; ".join(row))


def phase_parity_bf16(dev, worst, ndim=2):
    """The bf16 forms of the legs of rank `ndim` (K1-K3, K4-K6) against
    their plain torch versions in bf16 at the sides and settings of
    _bf16_parity_cases x bc, both prolongation kinds, from zero and with
    rnorm: every output bit-equal (each op rounded to bf16 as torch rounds
    it), sum(r^2) within RNORM_TOL."""
    (k_smooth, k_rr, k_pc), (t_smooth, t_rr, t_pc) = RANK[ndim]
    k_smooth, k_rr, k_pc = k_smooth + BF16, k_rr + BF16, k_pc + BF16
    label = "parity_bf16" if ndim == 2 else "parity_bf16_3d"
    for n, settings, scale, h_case in _bf16_parity_cases(ndim):
        u, f, V = ((t * scale).to(torch.bfloat16)
                   for t in _data(n, ndim, seed=n + 2, dev=dev))
        h = 1.0 / n if h_case is None else h_case
        for bc in ("ghost0", "face"):
            for smoother, nu in settings:
                row = [f"{_case_label(n, scale, h_case)} {bc} {smoother} nu={nu}"]
                a = (h, nu, smoother, bc)
                want = ops.smooth(u, f, *a)
                note(worst, k_smooth, t_smooth, cuda.smooth(u, f, *a), want, row, exact=True)
                if scale != 1:
                    row.append(f"subnormal {t_smooth}={_subnormals(want)}/{want.numel()}")
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


def phase_mixed_off_grid(dev):
    """The mixed solve at 1024^2 with the spacing OFF_GRID_H[0], which is
    1/2^k at no level, so the bf16 forms of K2/K3 multiply by the level
    constants in f32 (csrc/stencil.cuh Mg2K): to tol 1e-8 (the f32
    residual of such an h stalls near 2e-10), one K2.bf16 from u and one
    K3.bf16 per step at each kernel level, K2.bf16 from zero below the
    fine one, and its psi and history equal its plain-ops twin's bit for
    bit."""
    label = "mixed_off_grid"
    spec = MIXED_SPEC.with_(size=1024, h=OFF_GRID_H[0], tol=1e-8, maxiter=30)
    k_rr, k_pc, shape = _bf16_legs(spec)
    cuda.reset_launches()
    _, res, _ = _solve(spec, dev)
    launches = dict(cuda.launches)
    it, errs = res.iterations, res.errs.tolist()
    print(f"[{label}] f32 with bf16 sweeps, tuned {shape}, h={spec.h}: {it} steps, "
          f"converged={res.converged}, final relres {res.final_err:.6e}")
    check(res.converged, f"the mixed {shape} solve at h={spec.h} did not converge")
    L = len(kernel_levels(spec))
    check_launches(f"{shape} mixed solve at h={spec.h}", launches, _expected({
        k_rr: it * L, k_rr + ".zero": it * (L - 1), k_pc: it * L}),
        f"per step {k_rr} from u at {spec.size} and from zero below, and {k_pc}, "
        f"at each of the {L} kernel levels")
    plain = compare_solve(label, "plain", spec.with_(backend="torch"), dev, it, {},
                          warm_up=False)
    check(torch.equal(plain.psi, res.psi) and plain.errs.tolist() == errs,
          f"the plain-ops mixed solve at h={spec.h} differs: {plain.errs.tolist()} vs {errs}")
    print(f"[{label}] plain-ops twin: the same psi and {it} relres values, bit for bit")


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


def fast_launches(spec, it, packed=True, measured=None):
    """The launch counts of an `it`-cycle fast V-cycle solve of `spec` (the
    bf16 forms' for a bf16 spec): packed, K7 and K8 (with rnorm on the
    `measured` cycles, by default all) once per cycle at the fine level and
    K2 (from zero) and K3 once per cycle at each coarse kernel level;
    unpacked, K2 and K3 at every kernel level, K3 with rnorm at the fine
    one."""
    L = len(kernel_levels(spec))
    sfx = BF16 if spec.dtype == "bfloat16" else ""
    rr, pc = "mg_smooth_rr" + sfx, "mg_prolong_correct_smooth" + sfx
    measured = it if measured is None else measured
    if packed:
        return {"mg_packed_rr" + sfx: it, "mg_packed_pc" + sfx: it,
                f"mg_packed_pc{sfx}.rnorm": measured, rr: it * (L - 1),
                rr + ".zero": it * (L - 1), pc: it * (L - 1)}
    return loop_launches(rr, pc, L, it, measured)


def loop_launches(rr, pc, L, it, measured):
    """The launches of `it` V-cycles with L kernel levels (whole grid, or
    sharded: K9/K10, K11/K12): the down-leg `rr` at each, from zero below
    the fine level, the up-leg `pc` at each, with rnorm on the `measured`
    cycles."""
    return {rr: it * L, rr + ".zero": it * (L - 1), pc: it * L, pc + ".rnorm": measured}


def fmg_launches(spec, sides, rr, pc):
    """The launches of the FMG pass of `spec` (cycle.vcycle.fmg, or
    SpmdCycle.fmg) whose V-cycles run the kernels at the level sides
    `sides`: one V-cycle from the prolonged iterate at every level but the
    coarsest, each running the down-leg (from u at its own side, from zero
    below) and the up-leg (no rnorm) at every kernel side at or below its
    own."""
    counts = {rr: 0, rr + ".zero": 0, pc: 0}
    for side in level_sizes(spec.size, spec.coarse_size)[:-1]:
        k = sum(1 for s in sides if s <= side)
        counts[rr] += k
        counts[rr + ".zero"] += max(k - 1, 0)
        counts[pc] += k
    return counts


def add_counts(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


class _packed_flag:
    """MGPOISSON_PACKED set to `value` inside the block, then restored."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.old = os.environ.get("MGPOISSON_PACKED")
        os.environ["MGPOISSON_PACKED"] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ["MGPOISSON_PACKED"]
        else:
            os.environ["MGPOISSON_PACKED"] = self.old


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
        with _packed_flag("0"):
            compare_solve(label, "unpacked", spec, dev, it,
                          fast_launches(spec, it, packed=False))
        compare_solve(label, "plain", spec.with_(backend="torch"), dev, it, {})
    return launches


def probe_restrict_order_packed(dev):
    """Whether torch's sum of a bf16 row pair of the packed restriction on
    the card (the .sum(dim=1) of ops.packed_smooth_residual_restrict) equals
    the two values added in f32 and rounded once, as the bf16 form of K7
    adds them: values of spread magnitudes (2^-40 ... 2^40) at every side
    16384 ... 2."""
    for n in (16384,) + PACKED_BF16_SIDES + SMALL_SIDES:
        w = max(n // 2, 1)
        g = torch.Generator(device=dev).manual_seed(n + 13)
        e = torch.randint(-40, 41, (n, w), generator=g, device=dev).float()
        x = (torch.randn((n, w), generator=g, device=dev) * torch.exp2(e)).to(torch.bfloat16)
        want = (x[0::2].float() + x[1::2].float()).to(torch.bfloat16)
        check(torch.equal(x.reshape(n // 2, 2, w).sum(dim=1), want),
              f"n={n}: torch's bf16 row-pair sum is not the f32 sum rounded once")
    print("[parity_packed_bf16] torch's bf16 row-pair sum of the packed restriction on the "
          "card: the two values summed in f32, rounded once (mg2p_restrict's order), at every "
          "side 16384 ... 2 (spread magnitudes)")


def _packed_bf16_parity_cases():
    """(side, scale of the inputs, spacing h or None for 1/side) of the bf16
    packed parity: every fine side of the bf16 fast solves and 256, 128 ...
    2, PACKED_ODD_SIDES, then the subnormal and OFF_GRID_H sets at
    SUBNORMAL_SIDES."""
    return ([(n, 1.0, None) for n in PACKED_BF16_SIDES + SMALL_SIDES + PACKED_ODD_SIDES]
            + [(n, SUBNORMAL_SCALE, None) for n in SUBNORMAL_SIDES]
            + [(n, 1.0, h) for h in OFF_GRID_H for n in SUBNORMAL_SIDES])


def phase_parity_packed_bf16(dev, worst):
    """The bf16 forms of K7 and K8 (both prolongation kinds, rnorm) against
    their plain packed versions in bf16 at every fine side of the bf16 fast
    solves and 256 with nu in {1, 2, 3}, and with nu = 1 and 3 at 128 ... 2,
    at sides n % 4 == 2, on inputs x 2^-120 and at h = 0.01 and 0.3
    (_packed_bf16_parity_cases): every output bit-equal, sum(r^2) within
    RNORM_TOL."""
    probe_restrict_order_packed(dev)
    for n, scale, h_case in _packed_bf16_parity_cases():
        u, f, V = ((t * scale).to(torch.bfloat16) for t in _data(n, 2, seed=n + 3, dev=dev))
        up, fp = cuda.pack_grid(u), cuda.pack_grid(f)
        check(torch.equal(cuda.unpack_grid(up), u), f"unpack(pack(u)) != u at {n}^2 bf16")
        h = 1.0 / n if h_case is None else h_case
        full = n in PACKED_BF16_SIDES and scale == 1 and h_case is None
        for nu in (1, 2, 3) if full else (1, 3):
            row = [f"{_case_label(n, scale, h_case)} nu={nu}"]
            (gu, gR), (wu, wR) = (cuda.packed_smooth_residual_restrict(up, fp, h, nu),
                                  ops.packed_smooth_residual_restrict(up, fp, h, nu))
            note(worst, "mg_packed_rr_bf16", "K7.u", gu, wu, row, exact=True)
            note(worst, "mg_packed_rr_bf16", "K7.R", gR, wR, row, exact=True)
            for kind in ("inject", "bilinear"):
                pa = (up, fp, V, h, nu, kind)
                tag = "K8" + kind[0]
                note(worst, "mg_packed_pc_bf16", tag, cuda.packed_prolong_correct_smooth(*pa),
                     ops.packed_prolong_correct_smooth(*pa), row, exact=True)
                (gru, g2), (wru, w2) = (cuda.packed_prolong_correct_smooth_rnorm(*pa),
                                        ops.packed_prolong_correct_smooth_rnorm(*pa))
                note(worst, "mg_packed_pc_bf16", tag + "r.u", gru, wru, row, exact=True)
                note_r2(tag + "r.r2", g2, w2, row)
            if scale != 1:
                row.append(f"subnormal K7.u={_subnormals(wu)}/{wu.numel()}")
            check(gu.dtype == gR.dtype == gru.dtype == torch.bfloat16
                  and g2.dtype == torch.float32,
                  f"bf16 packed dtypes {gu.dtype}, {gR.dtype}, {gru.dtype}, {g2.dtype}")
            torch.cuda.synchronize()
            print("[parity_packed_bf16] " + " ".join(row) + "; K7.bf16, K8.bf16 bit-equal")
        del u, f, V, up, fp
        torch.cuda.empty_cache()


def check_cycle1(label, spec, dev, psi1):
    """Cycle 1 of a bf16 fast solve: the relres of its psi recomputed in f64
    within BF16_TOL of the JAX package's (JAX_F64_FAST_BF16), and its psi
    within BF16_TOL of the f32 fast solve's cycle-1 psi (normalized by the
    largest magnitude, the JAX package's bf16 bar)."""
    f = MultigridPoisson(spec, device=dev).rhs().double()
    h = spec.fine_h
    rel64 = float(ops.residual_norm(psi1.double(), f, h) / ops.residual_norm(-f, f, h))
    want = JAX_F64_FAST_BF16[spec.size]
    psi32 = _first_cycle_psi(spec.with_(dtype="float32"), dev)
    rel32, _ = nmax(psi1, psi32)
    print(f"[{label}] cycle 1's psi: f64 relres {rel64:.6e}, the JAX package's {want:.6e} "
          f"(rel diff {abs(rel64 - want) / want:.2e}); against the f32 fast solve's cycle-1 "
          f"psi: normalized max |diff| {rel32:.3e}")
    check(abs(rel64 - want) <= BF16_TOL * want,
          f"{spec.size}^2 bf16 fast cycle 1: f64 relres {rel64:.6e} vs the JAX package's "
          f"{want:.6e}")
    check(rel32 <= BF16_TOL, f"{spec.size}^2 bf16 fast cycle 1: psi differs from the f32 "
          f"solve's by {rel32:.3e} > {BF16_TOL}")


def _first_cycle_psi(spec, dev):
    """psi after one cycle of a solve of `spec` (its own solve, maxiter 1:
    a callback that takes psi would run the unpacked step)."""
    return MultigridPoisson(spec.with_(maxiter=1), device=dev).solve().psi


def phase_slice_fast_bf16(dev, n, compare):
    """The pure bf16 fast solve of FAST_BF16_SPEC at n^2, its fine level
    packed on the bf16 forms of K7/K8: 12 cycles at tol 1e-30, psi bf16
    and the history f32, each cycle's relres beside the JAX package's, and
    the launches.  Cycle 1's psi against the f32 fast solve's and (with
    `compare`) against the MGPOISSON_PACKED=0 twin's on the unpacked bf16
    kernels, which must take as many cycles.  Returns the launches."""
    spec = FAST_BF16_SPEC.with_(size=n)
    label = f"slice_fast_bf16_{n}"
    jax_errs = JAX_ERRS_FAST_BF16[n]
    _solve(spec, dev)
    cuda.reset_launches()
    mg, res, cycle_ms = _solve(spec, dev)
    launches = dict(cuda.launches)
    it, errs = res.iterations, res.errs.tolist()
    check(mg._packed, f"the bf16 fast {n}^2 solve does not pack its fine level")
    print(f"[{label}] bf16 fast packed {n}^2 on {dev}: {it} cycles (maxiter {spec.maxiter}), "
          f"final relres {res.final_err:.6e}; the JAX package's (xla, unpacked) beside")
    _steps_beside(label, errs, jax_errs)
    check(res.psi.dtype == torch.bfloat16 and res.errs.dtype == torch.float32,
          f"psi {res.psi.dtype}, history {res.errs.dtype}")
    check(it == spec.maxiter and bool(torch.isfinite(res.psi).all()),
          f"bf16 fast {n}^2: {it} cycles, psi finite {bool(torch.isfinite(res.psi).all())}")
    check_launches(f"{n}^2 bf16 fast solve", launches, _expected(fast_launches(spec, it)),
                   "K7.bf16 and K8.bf16 (rnorm) once per cycle, K2.bf16 (zero) and "
                   "K3.bf16 once per cycle at each coarse level >= kernel_min_size")
    print(f"[{label}] per-cycle wall ms, median (all): kernels {statistics.median(cycle_ms):.3f} "
          f"({' '.join(f'{c:.3f}' for c in cycle_ms)})")
    psi1 = _first_cycle_psi(spec, dev)
    check_cycle1(label, spec, dev, psi1)
    if compare:
        with _packed_flag("0"):
            twin = compare_solve(label, "unpacked", spec, dev, it,
                                 fast_launches(spec, it, packed=False))
            twin1 = _first_cycle_psi(spec, dev)
        rel, _ = nmax(psi1, twin1)
        print(f"[{label}] unpacked twin: relres {' '.join(f'{e:.6e}' for e in twin.errs.tolist())}; "
              f"cycle 1's psi against the packed solve's: normalized max |diff| {rel:.3e}")
        check(rel <= BF16_TOL, f"bf16 fast {n}^2: cycle 1's psi packed and unpacked differ by "
              f"{rel:.3e} > {BF16_TOL}")
    return launches
    """x's values in a dense row-major view at an odd 4-byte offset."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    check(out.is_contiguous() and out.data_ptr() % 8 == 4, "no odd-offset view")
    return out


def _solve_timed(spec, dev):
    """One solve as a user calls it, without a callback (the FMG pass and
    the adaptive loop run only so): the solver, the result, the solve's
    wall ms (CUDA events around solve(), which ends on a read of the last
    metric) and the solve loop's device->host reads (multigrid.read_scalar,
    the loop's one way to the host)."""
    mg = MultigridPoisson(spec, device=dev)
    return (mg, *_timed_reads(mg.solve))


def _timed_reads(fn):
    """(fn(), its wall ms by CUDA events around it, the device->host reads
    it made through multigrid.read_scalar and multigrid.read_errs, the
    solvers' ways to the host)."""
    reads, read, read_errs = [], multigrid.read_scalar, multigrid.read_errs
    multigrid.read_scalar = lambda t: reads.append(1) or read(t)
    multigrid.read_errs = lambda t: reads.append(1) or read_errs(t)
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        multigrid.read_scalar, multigrid.read_errs = read, read_errs
    return out, start.elapsed_time(end), len(reads)


def _new_phase_solve(label, spec, dev, jax_count, launches_of, jax_errs=None,
                     jax_measured=None):
    """One solve of the FMG or adaptive phases, without a callback: its
    cycles and metric evaluations against the JAX package's CPU run
    (`jax_count`: iterations, n_metric_evals; `jax_measured`: an adaptive
    solve's measured cycles, a stale stop at maxiter remeasured once more),
    one device->host read per metric evaluation, each measured relres
    within RELRES_TOL of `jax_errs`, the f64 re-check of a converged psi,
    and the launches, exactly `launches_of(it, measured)`: K3 (K8) with
    rnorm on the JAX run's measured cycles only.  The timed solve follows a
    warm-up solve of the same spec.  Returns (result, wall ms, launches)."""
    _solve_timed(spec, dev)
    cuda.reset_launches()
    mg, res, ms, reads = _solve_timed(spec, dev)
    launches = dict(cuda.launches)
    it, n, errs = res.iterations, res.n_metric_evals, res.errs.tolist()
    cyc = jax_measured if spec.stop_check == "adaptive" else list(range(1, it + 1))
    stale = it not in cyc
    what = (f"{spec.scheme}{' packed' if mg._packed else ''} {spec.size}^{spec.ndim} "
            f"cycle={spec.cycle} stop_check={spec.stop_check} tol={spec.tol:g}")
    print(f"[{label}] {what}: {it} cycles, {n} metric evaluations (the JAX run's measured "
          f"cycles {cyc}"
          f"{', then the returned iterate' if stale else ''}), {reads} device->host reads, "
          f"converged={res.converged}, final relres {res.final_err:.6e}; solve wall {ms:.3f} ms "
          "(CUDA events, no callback)")
    for k, e in enumerate(errs, 1):
        ej = jax_errs[k - 1] if jax_errs is not None and k <= len(jax_errs) else None
        print(f"[{label}]   cycle {k}: relres {e:.6e} {'measured' if k in cyc else 'predicted'}"
              + ("" if ej is None else f"  jax {ej:.6e}  rel diff {abs(e - ej) / ej:.2e}"))
    check((it, n) == jax_count, f"{label}: {it} cycles, {n} metric evaluations; the JAX package "
          f"takes {jax_count}")
    check(reads == n, f"{label}: {n} metric evaluations, {reads} device->host reads")
    check(mg._packed == (spec.scheme == "fast"), f"{label}: packed={mg._packed}")
    for k in cyc if jax_errs is not None and it == len(jax_errs) else ():
        check(abs(errs[k - 1] - jax_errs[k - 1]) <= RELRES_TOL * jax_errs[k - 1],
              f"{label} cycle {k}: relres {errs[k - 1]:.6e} vs the JAX package's "
              f"{jax_errs[k - 1]:.6e}")
    check(res.psi.shape == spec.shape and bool(torch.isfinite(res.psi).all()),
          f"{label}: psi is not a finite {spec.shape} array")
    if res.converged:
        f64_recheck(label, spec, mg.rhs(), res.psi)
    check_launches(label, launches, _expected(launches_of(it, len(cyc))),
                   "the FMG pass's V-cycles and the loop's, rnorm on the measured cycles")
    print(f"[{label}] launches {({k: v for k, v in launches.items() if v})}")
    print(f"[{label}] " + profiled_solve(mg, ms))
    return res, ms, launches


def profiled_solve(mg, wall_ms, run=None):
    """One more solve of `mg` (or call of `run`) under torch.profiler, the
    card's activity only (a solve is ~10^4 launches: the host's ops would
    cost the capture seconds more): its device launches, device ms (the
    union of the device events) and mg_* kernel ms, and the device's busy
    share of `wall_ms`, the timed solve's wall.  A capture that records no
    device event is taken once more, then reported as not measured."""
    t0 = time.perf_counter()
    for _ in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            (run or mg.solve)()
            torch.cuda.synchronize()
        n_ev, dev_ms, mg_ms = device_summary(prof)
        if n_ev:
            break
    else:
        return (f"profiled solve: not measured (two captures recorded no device event; "
                f"{time.perf_counter() - t0:.1f} s)")
    return (f"profiled solve: {n_ev} device launches, device {dev_ms:.4f} ms, mg_* kernels "
            f"{mg_ms:.4f} ms; device busy {100 * dev_ms / wall_ms:.1f} % of the timed "
            f"solve's {wall_ms:.3f} ms (the capture took {time.perf_counter() - t0:.1f} s)")


def _single_ref(res, measured=None):
    """What the sharded solves of phase_spmd are held to; `measured`, an
    adaptive solve's measured cycles in the JAX run (JAX_MEASURED)."""
    return {"errs": res.errs.tolist(), "n_metric_evals": res.n_metric_evals,
            "converged": res.converged, "psi": res.psi.cpu(), "measured": measured}


def phase_fmg_adaptive(dev):
    """slice_fmg, slice_adaptive, slice_fast_adaptive and slice_fmg3d: FMG
    and the adaptive stop on one card, each solve as a user calls it, with
    no callback.  Returns the single-device results the sharded solves of
    phase_spmd are held to, and the phases' seconds."""
    t0 = time.perf_counter()
    (_, rr, pc), _ = RANK[2]
    L = len(kernel_levels(MAIN_SPEC))
    fmg2 = fmg_launches(FMG_SPEC, kernel_levels(FMG_SPEC), rr, pc)
    refs = {}

    # slice_fmg: the tuned 4096^2 solve from the FMG pass's iterate
    res, _, _ = _new_phase_solve(
        "slice_fmg", FMG_SPEC, dev, (JAX_ITERATIONS_FMG, JAX_ITERATIONS_FMG),
        lambda it, m: add_counts(fmg2, loop_launches(rr, pc, L, it, m)), JAX_ERRS_FMG)
    refs["spmd4096fmg"] = _single_ref(res)
    mg = MultigridPoisson(FMG_SPEC, device=dev)
    f = mg.rhs()
    cuda.reset_launches()
    mg.init_state(f)
    torch.cuda.synchronize()
    check_launches("slice_fmg pass", dict(cuda.launches), _expected(fmg2),
                   "the FMG pass's V-cycles")
    ms = event_ms(lambda: mg.init_state(f), reps=5)
    print(f"[slice_fmg] the FMG pass alone (init_state): {ms:.3f} ms (CUDA events, median of "
          f"5); launches per pass {fmg2}")

    # slice_adaptive: the tuned 4096^2 solve, cycle v, adaptive stop
    res, _, _ = _new_phase_solve("slice_adaptive", ADAPTIVE_SPEC, dev, JAX_ADAPTIVE["tuned"],
                                 lambda it, m: loop_launches(rr, pc, L, it, m), JAX_ERRS,
                                 jax_measured=JAX_MEASURED["tuned"])
    refs["spmd4096adaptive"] = _single_ref(res, JAX_MEASURED["tuned"])

    # slice_fast_adaptive: the fast 4096^2 solve, packed, adaptive; to a
    # stop at maxiter on a skipped cycle (K8 without rnorm); with FMG (L3)
    for key, spec, jax_errs in (("fast", FAST_ADAPTIVE_SPEC, JAX_ERRS_FAST[MAIN_N]),
                                ("fast_stale", FAST_STALE_SPEC, None),
                                ("fast_fmg", FAST_ADAPTIVE_SPEC.with_(cycle="fmg"), None)):
        pass_counts = (fmg_launches(spec, kernel_levels(spec), rr, pc)
                       if spec.cycle == "fmg" else {})
        res, _, launches = _new_phase_solve(
            f"slice_{key}_adaptive", spec, dev, JAX_ADAPTIVE[key],
            lambda it, m: add_counts(pass_counts, fast_launches(spec, it, measured=m)), jax_errs,
            jax_measured=JAX_MEASURED[key])
        check(launches["mg_packed_rr"] > 0 and launches["mg_packed_pc"] > 0,
              f"slice_{key}_adaptive: the packed loop did not run K7/K8")
        if key != "fast_fmg":
            refs[{"fast": "spmd4096fastadaptive", "fast_stale": "spmd4096faststale"}[key]] = \
                _single_ref(res, JAX_MEASURED[key])

    # slice_fmg3d: the tuned 256^3 solve, FMG and the adaptive stop together
    (_, rr3, pc3), _ = RANK[3]
    L3 = len(kernel_levels(FMG3D_SPEC))
    _new_phase_solve("slice_fmg3d", FMG3D_SPEC, dev, JAX_ADAPTIVE["fmg3d"],
                     lambda it, m: add_counts(fmg_launches(FMG3D_SPEC, kernel_levels(FMG3D_SPEC),
                                                           rr3, pc3),
                                              loop_launches(rr3, pc3, L3, it, m)),
                     JAX_ERRS_FMG3D, jax_measured=JAX_MEASURED["fmg3d"])
    torch.cuda.empty_cache()
    return refs, time.perf_counter() - t0


def batch_rhs(n, count, dev):
    """The first `count` of: the point charge, then BATCH_NOISE's seeded
    RHS, stacked into one dense (count, n, n) f32 batch on `dev`."""
    fs = [point_charge_rhs(n, 2, torch.float32, dev)]
    for seed, amp in BATCH_NOISE[:count - 1]:
        noise = amp * np.random.default_rng(seed).standard_normal((n, n))
        fs.append(torch.from_numpy(noise.astype(np.float32)).to(dev))
    return torch.stack(fs)


def _count_steps(mg, fs):
    """Wrap mg._step to count its calls per element of the batch fs (the
    element whose f it is handed, a view of fs); returns the counts."""
    counts = [0] * fs.shape[0]
    step, base, stride = mg._step, fs.data_ptr(), fs[0].numel() * fs.element_size()

    def counted(psi, f, r0):
        counts[(f.data_ptr() - base) // stride] += 1
        return step(psi, f, r0)
    mg._step = counted
    return counts


def _single_solver(spec, dev, packed_flag=None):
    """The solver of the batch's single solves (built under
    MGPOISSON_PACKED=packed_flag where given), after a warm-up solve."""
    if packed_flag is None:
        mg = MultigridPoisson(spec, device=dev)
    else:
        with _packed_flag(packed_flag):
            mg = MultigridPoisson(spec, device=dev)
    mg.solve()
    return mg


def _singles(mg, fs):
    """Each element of fs through mg's solve(): [(result, wall ms)]."""
    return [_timed_reads(lambda f=f: mg.solve(f))[:2] for f in fs]


def _batched_times(label, card, mg, single, fs):
    """The batched solve's wall beside its elements' own solves', in turns
    (singles, batched, batched, singles; CUDA events; a batched cycle is
    one device->host read), then one batched cycle (cycles=1) timed and
    profiled.  Returns the first round's single
    solves, batched (psis, errs) and its device->host reads."""
    singles = _singles(single, fs)
    out, ms1, reads = _timed_reads(lambda: mg.solve_batched(fs))
    ms2 = _timed_reads(lambda: mg.solve_batched(fs))[1]
    later = sum(ms for _, ms in _singles(single, fs))
    n, cycles = sum(r.iterations for r, _ in singles), reads
    first = sum(ms for _, ms in singles)
    print(f"[{label}] wall (CUDA events, {card}), singles, batched, batched, singles: "
          f"batched {ms1:.3f}, {ms2:.3f} ms = {ms1 / cycles:.3f}, {ms2 / cycles:.3f} ms per "
          f"batched cycle ({cycles}), {ms1 / n:.3f}, {ms2 / n:.3f} ms per element-cycle ({n}); "
          f"the {len(singles)} single solves {first:.3f}, {later:.3f} ms = {first / n:.3f}, "
          f"{later / n:.3f} ms per element-cycle (first round each "
          f"{' '.join(f'{ms:.3f}' for _, ms in singles)})")
    one = lambda: mg.solve_batched(fs, cycles=1)      # noqa: E731
    ms = _timed_reads(one)[1]
    print(f"[{label}] one batched cycle (cycles=1, every element live): wall {ms:.3f} ms; "
          + profiled_solve(mg, ms, one))
    return singles, out, reads


def _batched_kernel_case(label, spec, fs, dev, card, jax_counts, packed_flag=None):
    """solve_batched of fs on the kernel path (the fine level on the
    kernels: one step per live element per cycle): each element's psi bit
    for bit its own solve()'s (under MGPOISSON_PACKED=packed_flag where
    given), its step count that solve's and the JAX package's, its err
    that solve's final err; one read per batched cycle; K2/K3 exactly
    loop_launches over the element-cycles, frozen cycles skipped; the walls
    beside the single solves'."""
    (_, rr, pc), _ = RANK[2]
    L = len(kernel_levels(spec))
    mg = MultigridPoisson(spec, device=dev)
    mg.solve_batched(fs)                                   # warm-up
    counts = _count_steps(mg, fs)
    cuda.reset_launches()
    psis, errs = mg.solve_batched(fs)
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    del mg._step
    cycles = max(counts)
    singles, (psis_t, _), reads = _batched_times(
        label, card, mg, _single_solver(spec, dev, packed_flag), fs)
    its = [r.iterations for r, _ in singles]
    print(f"[{label}] {spec.scheme} {spec.size}^2 f32 x {fs.shape[0]}, kernel_min_size "
          f"{spec.kernel_min_size} (kernel levels {kernel_levels(spec)}), the kernel path"
          f"{' beside a solver that packs its solve()' if mg._packed else ''}: element "
          f"cycles {counts}, their solve()s' {its}, the JAX package's {jax_counts}; "
          f"{cycles} batched cycles, {reads} device->host reads")
    for k, (res, _) in enumerate(singles):
        print(f"[{label}]   element {k}: err {errs[k].item():.6e}, its solve()'s final err "
              f"{res.final_err:.6e}; psi bit-equal to its solve()'s: "
              f"{torch.equal(psis[k], res.psi)}")
        check(torch.equal(psis[k], res.psi) and torch.equal(psis_t[k], res.psi),
              f"{label} element {k}: psi differs from its own solve()'s")
        check(errs[k].item() == res.final_err,
              f"{label} element {k}: err {errs[k].item()!r}, its solve()'s {res.final_err!r}")
    check(counts == its == jax_counts, f"{label}: element cycles {counts}, their solve()s' "
          f"{its}, the JAX package's {jax_counts}")
    check(reads == cycles, f"{label}: {reads} device->host reads in {cycles} batched cycles")
    want = loop_launches(rr, pc, L, sum(counts), sum(counts))
    check_launches(label, launches, _expected(want),
                   f"K2/K3 at the {L} kernel levels per element-cycle, {sum(counts)} of them "
                   "(frozen elements skipped), K3 with rnorm once each, nothing packed")
    print(f"[{label}] launches {({k: v for k, v in launches.items() if v})} = "
          f"loop_launches over {sum(counts)} element-cycles")


def phase_batched(dev, card):
    """solve_batched on the card (MultigridPoisson.solve_batched): the
    kernel path at the JAX package's batched serving setting (tuned f32
    1024^2, 4 RHS, identical and mixed, at kernel_min_size 256 and 2), the
    fast scheme's batch (unpacked, beside MGPOISSON_PACKED=0 solves), and
    the vmap path at VMAP_N^2 (plain ops)."""
    for kms in BATCH_KMS:
        spec = BATCH_SPEC.with_(kernel_min_size=kms)
        _batched_kernel_case(f"batched_identical_kms{kms}", spec,
                             batch_rhs(spec.size, 1, dev).expand(4, -1, -1).contiguous(),
                             dev, card, JAX_BATCHED["identical"])
        _batched_kernel_case(f"batched_mixed_kms{kms}", spec, batch_rhs(spec.size, 4, dev),
                             dev, card, JAX_BATCHED["mixed"])
    _batched_kernel_case("batched_fast", BATCH_SPEC.with_(scheme="fast"),
                         batch_rhs(BATCH_SPEC.size, 2, dev), dev, card, JAX_BATCHED["fast"],
                         packed_flag="0")

    # the vmap path: torch.func.vmap of the step, one launch per op for the batch
    label, spec = "batched_vmap", BATCH_SPEC.with_(size=VMAP_N)
    fs = batch_rhs(VMAP_N, 4, dev)
    mg = MultigridPoisson(spec, device=dev)
    mg.solve_batched(fs)                                   # warm-up
    cuda.reset_launches()
    psis, errs = mg.solve_batched(fs)
    check_launches(label, dict(cuda.launches), _expected({}), "plain ops only")
    singles, _, reads = _batched_times(label, card, mg, _single_solver(spec, dev), fs)
    its = [r.iterations for r, _ in singles]
    # an element's count: the cycle of its solve()'s history whose err its
    # batched err matches (the vmapped sums may round apart; consecutive
    # cycles' errs differ ~10x)
    counts = [1 + int(np.argmin(np.abs(np.log(r.errs.numpy() / errs[k].item()))))
              for k, (r, _) in enumerate(singles)]
    print(f"[{label}] tuned {VMAP_N}^2 f32 x 4 at kernel_min_size {spec.kernel_min_size}: "
          f"element cycles {counts} (by err), their solve()s' {its}; {reads} batched cycles")
    for k, (res, _) in enumerate(singles):
        d = nmax(psis[k], res.psi)[0]
        print(f"[{label}]   element {k}: err {errs[k].item():.6e}, its solve()'s "
              f"{res.final_err:.6e}; psi vs its solve()'s {d:.3e} normalized")
        check(d <= PARITY_TOL, f"{label} element {k}: psi {d:.3e} from its solve()'s")
    check(counts == its and reads == max(its),
          f"{label}: element cycles {counts}, {reads} batched cycles; the solve()s' {its}")


def phase_gs_lex(dev, card):
    """smoother='gs_lex' on the card (the plain ops at every level, one row
    at a time): GS_LEX_SPEC in f64, its cycles and each err against the JAX
    package's, no kernel launched, psi on the card; then in f32 to
    GS_LEX_F32_MAXITER cycles, its psi against the f64 psi."""
    label, t0 = "gs_lex", time.perf_counter()
    cuda.reset_launches()
    mg, res, ms, _ = _solve_timed(GS_LEX_SPEC, dev)
    launches = dict(cuda.launches)
    errs, jerrs = res.errs.tolist(), JAX_GS_LEX_ERRS
    print(f"[{label}] reference gs_lex 64^2 f64 on {res.psi.device}: {res.iterations} cycles "
          f"(the JAX package's {len(jerrs)}), converged={res.converged}, final err "
          f"{res.final_err:.6e}; wall {ms:.1f} ms, {ms / res.iterations:.2f} ms per cycle "
          f"(CUDA events, {card})")
    check(res.iterations == len(jerrs) and res.converged,
          f"{label}: {res.iterations} cycles, the JAX package takes {len(jerrs)}")
    worst = max(abs(e - ej) / (GS_LEX_ATOL * jerrs[0] + GS_LEX_RTOL * ej)
                for e, ej in zip(errs, jerrs))
    print(f"[{label}] errs against the JAX package's: at most {worst:.3f} of the bar "
          f"(rtol {GS_LEX_RTOL}, atol {GS_LEX_ATOL} x errs[0])")
    check(worst <= 1.0, f"{label}: errs {errs} vs the JAX package's {jerrs}")
    check(res.psi.device.type == "cuda" and res.psi.dtype == torch.float64,
          f"{label}: psi {res.psi.dtype} on {res.psi.device}")
    check_launches(label, launches, _expected({}), "plain ops only: gs_lex has no kernel")
    spec32 = GS_LEX_SPEC.with_(dtype="float32", maxiter=GS_LEX_F32_MAXITER)
    _, res32, ms32, _ = _solve_timed(spec32, dev)
    d = nmax(res32.psi, res.psi)[0]
    print(f"[{label}] the same in f32 to maxiter {spec32.maxiter}: {res32.iterations} cycles, "
          f"final err {res32.final_err:.6e}, psi vs the f64 "
          f"psi {d:.3e} normalized; wall {ms32:.1f} ms, {ms32 / res32.iterations:.2f} ms per "
          f"cycle ({card})")
    check(d <= PARITY_TOL, f"{label}: the f32 psi is {d:.3e} from the f64 psi")
    print(f"[{label}] the gs_lex phase: {time.perf_counter() - t0:.1f} s")


def phase_krylov_mgcg(dev):
    """krylov_mgcg: CG preconditioned by one tuned V-cycle from zero (MGCG)
    at 4096^2 against the JAX package's CPU runs, in f32 (the card's
    kernels: K2 from zero and K3 at every kernel level once per
    preconditioner call, iterations + 1 calls and reads; the wall after a
    warm-up run, the device ms of a profiled run, the preconditioner's
    share of the wall) and in f64 (plain ops, where x is resolved): the
    count, each relres within RELRES_TOL; the f32 xnorms within the
    rounding floor of x0 = -b, the f64 xnorms[-1] within XNORM_TOL."""
    label, n = "krylov_mgcg", MGCG_SPEC.size
    A = krylov.poisson_operator(1 / n)
    xs = {}
    for dt in ("float32", "float64"):
        spec = MGCG_SPEC.with_(dtype=dt)
        b = point_charge_rhs(n, dtype=getattr(torch, dt), device=dev)
        M, spans = krylov.mg_preconditioner(spec), []

        def timed_M(r):
            """M(r) between two CUDA events: the host enqueues slower than the
            card runs, so the span between them is the call's wall."""
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            z = M(r)
            ev[1].record()
            spans.append(ev)
            return z

        run = lambda: krylov.pcg(A, b, M=timed_M, tol=1e-10, maxiter=500)
        run()
        torch.cuda.synchronize()
        spans.clear()
        cuda.reset_launches()
        res, wall, reads = _timed_reads(run)
        launches = dict(cuda.launches)
        m_ms = sum(e0.elapsed_time(e1) for e0, e1 in spans)
        it, relres, xnorms = res.iterations, res.residuals.tolist(), res.xnorms.tolist()
        jax_relres, jax_xnorms = JAX_MGCG[dt]
        floor = torch.finfo(b.dtype).eps * float(b.abs().max())
        xs[dt] = res.x
        print(f"[{label}] pcg + mg_preconditioner(tuned {n}^2 {dt}), tol 1e-10: {it} iterations "
              f"(the JAX package {len(jax_relres)}), converged={res.converged}, {reads} "
              f"device->host reads; x0 = -b's rounding floor eps * max|b| = {floor:.3e}")
        for k, (e, ej, x, xj) in enumerate(zip(relres, jax_relres, xnorms, jax_xnorms), 1):
            print(f"[{label}]   iteration {k}: ||r||/||b|| {e:.6e}  jax {ej:.6e}  rel diff "
                  f"{abs(e - ej) / ej:.2e}; ||x||_inf {x:.9g}  jax {xj:.9g}  diff {x - xj:.3e}")
        check(res.converged and it == len(jax_relres),
              f"{label} {dt}: {it} iterations, converged={res.converged}; the JAX package "
              f"takes {len(jax_relres)}")
        for k, (e, ej) in enumerate(zip(relres, jax_relres), 1):
            check(abs(e - ej) <= RELRES_TOL * ej,
                  f"{label} {dt} iteration {k}: relres {e:.6e} vs the JAX package's {ej:.6e}")
        if dt == "float32":
            for k, (x, xj) in enumerate(zip(xnorms, jax_xnorms), 1):
                check(abs(x - xj) <= floor, f"{label} f32 iteration {k}: ||x||_inf {x:.9g} vs "
                      f"the JAX package's {xj:.9g}, beyond the rounding floor {floor:.3e}")
        else:
            check(abs(xnorms[-1] - jax_xnorms[-1]) <= XNORM_TOL * jax_xnorms[-1],
                  f"{label} f64: xnorms[-1] {xnorms[-1]:.12g} vs the JAX package's "
                  f"{jax_xnorms[-1]:.12g}")
        check(res.x.shape == b.shape and bool(torch.isfinite(res.x).all()),
              f"{label} {dt}: x is not a finite {tuple(b.shape)} array")
        check(reads == it + 1, f"{label} {dt}: {reads} device->host reads for {it} iterations")
        b64 = b.double()
        true64 = float(torch.linalg.vector_norm(b64 - ops.apply_operator(res.x.double(), 1 / n))
                       / torch.linalg.vector_norm(b64))
        del b64
        print(f"[{label}] {dt} launches {({k: v for k, v in launches.items() if v})}; "
              f"||b - A x||/||b|| of the returned x in f64 {true64:.6e}; wall {wall:.3f} ms "
              "(CUDA events, one run after a warm-up)")
        if dt == "float64":
            check_launches(f"{label} f64", launches, _expected({}), "f64: plain ops only")
            continue
        (_, rr, pc), _ = RANK[2]
        calls, L = it + 1, len(kernel_levels(spec))
        check_launches(f"{label} f32", launches,
                       _expected({rr: calls * L, rr + ".zero": calls * L, pc: calls * L}),
                       f"K2 from zero and K3 at each of the {L} kernel levels once per "
                       f"preconditioner call ({calls} calls)")
        print(f"[{label}] f32: the {len(spans)} preconditioner calls of the timed run "
              f"{m_ms:.3f} ms (CUDA events around each), {100 * m_ms / wall:.1f} % of its wall")
        spans.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        n_ev, dev_ms, mg_ms = device_summary(prof)
        print(f"[{label}] f32 profiled run: {n_ev} device launches, device {dev_ms:.4f} ms, "
              f"mg_* kernels {mg_ms:.4f} ms; device busy {100 * dev_ms / wall:.1f} % of the "
              "timed run's wall" if n_ev else
              f"[{label}] f32 profiled run: not measured (no device event)")
    d = nmax(xs["float32"], xs["float64"])
    print(f"[{label}] the f32 x against the f64 x: max|diff| {d[1]:.4e} ({d[0]:.3e} of max|x64|)")


def phase_converge_study(dev):
    """converge_study: bench.converge.run_study at CONVERGE_SIZES on the
    card (reference scheme, f64: plain ops), its files in a temporary
    directory, against the JAX package's CPU run, and its seconds per
    size."""
    label, seconds = "converge_study", {}
    with tempfile.TemporaryDirectory() as out:
        for n in CONVERGE_SIZES:
            cuda.reset_launches()
            t0 = time.perf_counter()
            study = converge.run_study(n, "reference", list(CONVERGE_SOLVERS), 1e-12,
                                       "float64", device=dev)
            converge.write_outputs(study, out)
            seconds[n] = time.perf_counter() - t0
            check_launches(f"{label} {n}^2", dict(cuda.launches), _expected({}),
                           "f64: plain ops only")
            kry = study["krylov"]
            got = (study["mg_iterations"],) + tuple(kry[k]["iterations"] for k in CONVERGE_SOLVERS)
            psi_mg = study["psi_mg"]
            gaps = {k: float(np.abs(v["psi"] - psi_mg).max() / np.abs(psi_mg).max())
                    for k, v in kry.items()}
            kb, rb = JAX_BICGSTAB_AT[n]
            got_b = float(kry["bicgstab"]["residuals"][kb - 1])
            print(f"[{label}] {n}^2: iterations (multigrid, {', '.join(CONVERGE_SOLVERS)}) "
                  f"{got}, the JAX package {JAX_CONVERGE[n]}; max|psi - psi_mg|/max|psi_mg| "
                  + " ".join(f"{k} {g:.3e}" for k, g in gaps.items())
                  + f"; bicgstab relres at iteration {kb} {got_b:.9e} (jax {rb:.9e}); "
                  f"{seconds[n]:.2f} s")
            for name, g, w in zip(("multigrid",) + CONVERGE_SOLVERS, got, JAX_CONVERGE[n]):
                check(g == w or name == "bicgstab",
                      f"{label} {n}^2 {name}: {g} iterations, the JAX package takes {w}")
            check(all(v["converged"] for v in kry.values()),
                  f"{label} {n}^2: not every Krylov solver converged")
            check(abs(got_b - rb) <= TRACK_TOL * rb,
                  f"{label} {n}^2: bicgstab relres at iteration {kb} {got_b:.9e}, the JAX "
                  f"package's {rb:.9e}")
            if n in JAX_CONVERGE_MG_GAP:
                want = JAX_CONVERGE_MG_GAP[n]
                psi_cg = kry["cg"]["psi"]
                for k, v in kry.items():
                    check(abs(gaps[k] - want) <= RELRES_TOL * want,
                          f"{label} {n}^2 {k}: {gaps[k]:.4e} from multigrid's psi, the JAX "
                          f"run {want:.4e}")
                    d = float(np.abs(v["psi"] - psi_cg).max() / np.abs(psi_cg).max())
                    check(d <= CONVERGE_TOL, f"{label} {n}^2 {k}: {d:.3e} from CG's psi")
            else:
                for k, g in gaps.items():
                    check(g <= CONVERGE_TOL, f"{label} {n}^2 {k}: {g:.3e} from multigrid's psi")
            check(os.path.exists(os.path.join(out, f"{n}.txt")), f"{label}: no {n}.txt")
    print(f"[{label}] seconds per size " + " ".join(f"{n}: {t:.2f}" for n, t in seconds.items())
          + f"; {sum(seconds.values()):.1f} s in all")


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

def _sharded_names(ndim, dtype=torch.float32):
    """(rr kernel, pc kernel, their tags, the single-device kernels' tags),
    the kernels' bf16 forms for a bf16 dtype."""
    sfx = BF16 if dtype == torch.bfloat16 else ""
    if ndim == 2:
        return "mg_sharded_rr" + sfx, "mg_sharded_pc" + sfx, ("K9", "K10"), ("K2", "K3")
    return "mg_sharded_rr3d" + sfx, "mg_sharded_pc3d" + sfx, ("K11", "K12"), ("K5", "K6")


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


def phase_parity_sharded(dev, worst, dtype=torch.float32):
    """K9-K12 against their plain versions at every block position of the
    (2, 2) and (4, 1) meshes and every side of sharded_sides, and their
    outputs stitched over the blocks against the single-device kernels on
    the whole grid.  Bit-equal: the stitched outputs (K9/K10 to K2/K3,
    K11/K12 to K5/K6) and every K11/K12 output to its plain version.  With
    dtype bf16 (parity_sharded_bf16), the bf16 forms of K9-K12 at the same
    sides, every output bit-equal to the plain sharded op in bf16 and,
    stitched, to the bf16 forms of K2/K3 (K5/K6), and also on the
    subnormal set (inputs x 2^-120) and at the spacings OFF_GRID_H: in 2D
    at SUBNORMAL_SIDES with SUBNORMAL_SETTINGS, in 3D at SUBNORMAL_SIDES_3D
    with SHARDED_SETTINGS (both tiles).  A 3D row names the tile each leg ran at its halo
    (csrc/stencil3d_zm.cuh mg3z_takes)."""
    bf16 = dtype == torch.bfloat16
    label = "parity_sharded_bf16" if bf16 else "parity_sharded"
    sides_of = sharded_sides()
    print(f"[{label}] global sides {sides_of} on the meshes {SHARDED_MESHES}")
    for ndim, sides in sides_of.items():
        k_rr, k_pc, (t_rr, t_pc), (s_rr, s_pc) = _sharded_names(ndim, dtype)
        cases = [(n, 1.0, SHARDED_SETTINGS, None) for n in sides]
        if bf16:
            small, sets = ((SUBNORMAL_SIDES, SUBNORMAL_SETTINGS) if ndim == 2
                           else (SUBNORMAL_SIDES_3D, SHARDED_SETTINGS))
            cases += [(n, SUBNORMAL_SCALE, sets, None) for n in small]
            cases += [(n, 1.0, sets, h) for h in OFF_GRID_H for n in small]
        for n, scale, settings, h_case in cases:
            u, f, V = ((t * scale).to(dtype) for t in _data(n, ndim, seed=n + 5, dev=dev))
            h = 1.0 / n if h_case is None else h_case
            for bc, (smoother, nu) in itertools.product(("ghost0", "face"), settings):
                row = [f"{_case_label(n, scale, h_case, ndim)} {bc} {smoother} nu={nu}"]
                w = _Worst(worst)
                # the blocks' outputs against the plain block ops
                exact = ndim == 3 or bf16 or (smoother, nu) in PATH_SETTINGS
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
                                                       rel_r2(g2, w2))
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
                        w.tags[f"{tag}.r2@{m}"] = rel_r2(r2[kind], whole[kind][1])
                    for tag, got, want in pairs:
                        w.note(None, tag, got, want, exact=True)
                    del st
                w.check(row)
                what = f"{t_rr}/{t_pc}: stitched bit-equal to {s_rr}/{s_pc}" + (
                    ", blocks bit-equal to plain" if exact else "")
                if ndim == 3:
                    tile = lambda halo: "z-marching" if cuda.zmarch3d(halo) else "cube"
                    what += (f"; tiles {t_rr} {tile(d)} (halo {d}), {t_pc} {tile(d - 1)} "
                             f"(halo {d - 1}), {t_pc} rnorm {tile(d)} (halo {d})")
                row.append(what if not w.unequal else
                           f"NOT bit-equal ({what}): " + "; ".join(w.unequal))
                torch.cuda.synchronize()
                print(f"[{label}] " + " ".join(row))
                check(not w.unequal, f"{label} {row[0]}: {t_rr}/{t_pc} not bit-equal where "
                      f"they must be: {'; '.join(w.unequal)}")
            del u, f, V, whole
            torch.cuda.empty_cache()


def phase_timing_sharded(dev, times, dtype=torch.float32):
    """K9/K10 on the (0, 0) block of a (2, 2) mesh at 16384^2 (8192^2) with
    the main path's settings, beside K2/K3 on a whole 8192^2 array; K11/K12
    on the (0, 0) block of 256^3 beside K5/K6 on the whole 256^3 per cell
    (`times`: phase_timing's 3D times); each with its plain version and
    bound.  With dtype bf16 (timing_sharded_bf16), the bf16 forms of
    K9-K12 on the same blocks beside their f32 forms' times in `times`, the
    bf16 forms of K2/K3 on the whole 8192^2 array and those of K5/K6 on the
    whole 256^3 per cell."""
    bf16 = dtype == torch.bfloat16
    label, sfx = ("timing_sharded_bf16", BF16) if bf16 else ("timing_sharded", "")
    out = {}
    d = exchange_depth(MAIN_SPEC)
    dv = ops.coarse_depth(d)
    for ndim, n in TIMING_SHARDED.items():
        k_rr, k_pc, _, _ = _sharded_names(ndim, dtype)
        u, f, V = (t.to(dtype) for t in _data(n, ndim, seed=17, dev=dev))
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
        out.update(_time_cases(label, cases, f"the (0, 0) block {shape} of {n}^{ndim}", cells,
                               "bf16" if bf16 else "f32"))
        del ub, fb, vb, us, fs, vs
        torch.cuda.empty_cache()
        if ndim == 3:
            rr, pc = (name + sfx for name in RANK[3][0][1:])
            for sharded, whole in ((k_rr, rr), (k_rr + ".zero", rr + ".zero"),
                                   (k_pc, pc), (k_pc + ".rnorm", pc + ".rnorm")):
                per, per_whole = (out[sharded]["kernel_ms"] / cells,
                                  times[whole]["kernel_ms"] / n ** 3)
                print(f"[{label}] {sharded} on the block {shape}: {1e6 * per:.4f} ns of "
                      f"device time per cell against {whole} on {n}^3: {1e6 * per_whole:.4f} "
                      f"ns ({per / per_whole:.3f}x)")
    # beside K9/K10: K2/K3 on a whole array of the block's side
    n = TIMING_SHARDED[2] // 2
    u, f, V = (t.to(dtype) for t in _data(n, 2, seed=19, dev=dev))
    h = 1.0 / n
    rr, pc = f"mg_smooth_rr{sfx}@{n}", f"mg_prolong_correct_smooth{sfx}@{n}"
    whole = {
        rr: (lambda m: m.smooth_residual_restrict(u, f, h, 3, "wjacobi", "ghost0"),
             (u, f), _work(2, 3, "wjacobi", "rr")),
        pc: (lambda m: m.prolong_correct_smooth(u, f, V, h, 3, "wjacobi", "face", "bilinear"),
             (u, f, V), _work(2, 3, "wjacobi", "pc", "bilinear")),
    }
    t = _time_cases(label, whole, f"{n}^2", n * n, "bf16" if bf16 else "f32")
    for sharded, single in (("mg_sharded_rr" + sfx, rr), ("mg_sharded_pc" + sfx, pc)):
        print(f"[{label}] {sharded} on a {n}^2 block against {single}: "
              + _beside(t[single], out[sharded]))
    if bf16:
        for name, row in out.items():
            print(f"[{label}] {name} against its f32 form: "
                  + _beside(times[name.replace(BF16, "")], row))
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
    fine_in = [_black(ub), fb, *map(_black, us[:2]), *fs[:2]]
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
                             (_black(up), fp), w_rr),
        f"mg_packed_pc@{m}": (
            lambda k: k.packed_prolong_correct_smooth(up, fp, V, hm, nu, "bilinear"),
            (_black(up), fp, V), w_pc),
        f"mg_packed_pc.rnorm@{m}": (
            lambda k: k.packed_prolong_correct_smooth_rnorm(up, fp, V, hm, nu, "bilinear"),
            (_black(up), fp, V), w_pcr),
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


def _cycle_spec(spec):
    """The spec of the V-cycle a solve of `spec` runs: its own, or under
    mixed precision that of SpmdCycle.inner (sweep_dtype, no mesh_shape)."""
    if spec.sweep_dtype in (None, spec.dtype):
        return spec
    return spec.with_(dtype=spec.sweep_dtype, mesh_shape=None)


def sharded_launches(spec, mesh_shape, it, measured=None):
    """One rank's launches in an `it`-cycle (or step) sharded solve, the
    kernels of its cycle's dtype (the bf16 forms of K9/K10 for bf16
    sweeps): the down-leg (from zero below the fine level) and the up-leg
    at every sharded kernel level, the up-leg with rnorm on the `measured`
    cycles, by default every cycle (never in a mixed step, which measures
    the residual it computes itself; its fine down-leg starts from a zeros
    array, not the zero flag); with a packed fine level, K13 and K14
    (rnorm) there, once per cycle; with cycle='fmg', the FMG pass's
    V-cycles on the sharded kernel levels before them."""
    cyc = _cycle_spec(spec)
    sides = sharded_kernel_levels(cyc, mesh_shape)
    L = len(sides)
    k_rr, k_pc, _, _ = _sharded_names(spec.ndim, getattr(torch, cyc.dtype))
    measured = it if measured is None else measured
    fmg = fmg_launches(spec, sides, k_rr, k_pc) if spec.cycle == "fmg" else {}
    if packed_sharded(spec, mesh_shape):
        return add_counts(fmg, {"mg_sharded_packed_rr": it, "mg_sharded_packed_pc": it,
                                "mg_sharded_packed_pc.rnorm": measured, k_rr: (L - 1) * it,
                                k_rr + ".zero": (L - 1) * it, k_pc: (L - 1) * it})
    return add_counts(fmg, loop_launches(k_rr, k_pc, L, it, measured if cyc is spec else 0))


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
        for i, (label, spec, mesh_shape, warm_up) in enumerate(cases):
            spec = spec.with_(mesh_shape=mesh_shape)
            t0 = time.perf_counter()
            if warm_up:
                _solve(spec, "cuda")
            cuda.reset_launches()
            # FMG and the adaptive stop run as a user calls them, with no
            # callback (a callback makes every cycle measure)
            new = spec.cycle == "fmg" or spec.stop_check == "adaptive"
            ms = None
            if new:
                mg, res, ms, _ = _solve_timed(spec, "cuda")
                cycle_ms = [ms / res.iterations]
            else:
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
                if new:
                    torch.save(psi.cpu(), out_dir / f"psi{i}.pt")
            results.append({"label": label, "iterations": res.iterations,
                            "n_metric_evals": res.n_metric_evals, "solve_ms": ms,
                            "seconds": time.perf_counter() - t0,
                            "errs": res.errs.tolist(), "errs_dtype": str(res.errs.dtype),
                            "converged": res.converged,
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


def _check_spmd(label, spec, mesh_shape, ranks, ref_errs, how, ref_count=None, single=None,
                psi_path=None):
    """Every rank's result of one sharded solve: identical histories, the
    reference's cycle count and per-cycle relres (within RELRES_TOL), the
    f64 re-check of the gathered iterate, exact launches.  A mixed solve
    (bf16 sweeps) takes the JAX package's step count (`ref_count`) or one
    more or fewer (the bars of phase_slice_mixed), or without `ref_count`
    the port's single-device mixed solve's (that of `ref_errs`) exactly;
    its first err is 1.0 and its history f32.  With `single` (an FMG or
    adaptive solve, _single_ref): its n_metric_evals and converged, and
    rank 0's gathered psi (at `psi_path`) within PARITY_TOL normalized of
    its psi; an adaptive solve's K10 (K14) with rnorm on the measured
    cycles."""
    r0 = ranks[0]
    it, errs = r0["iterations"], r0["errs"]
    mixed = _cycle_spec(spec) is not spec
    shape = f"{spec.size}^{spec.ndim} on {mesh_shape}"
    what = (f"{spec.scheme}{', fine level packed' if r0['packed'] else ''}"
            f"{', f32 with ' + spec.sweep_dtype + ' sweeps' if mixed else ''}")
    print(f"[{label}] {shape} {what}, {SPMD_WORLD} ranks ({how}): {it} cycles, converged="
          f"{r0['converged']}, blocks {r0['block']} on {r0['device']}")
    check(all(r["packed"] == packed_sharded(spec, mesh_shape) for r in ranks),
          f"{shape}: the ranks' packed fine level is not the rule's")
    for k, (e, ej) in enumerate(zip(errs, ref_errs), 1):
        print(f"[{label}]   cycle {k}: relres {e:.6e}  reference {ej:.6e}  "
              f"rel diff {abs(e - ej) / ej:.2e}")
    check(all(r["errs"] == errs and r["iterations"] == it for r in ranks),
          f"{shape}: the ranks' error histories differ")
    count = len(ref_errs) if ref_count is None else ref_count
    converges = single is None or single["converged"]
    check(r0["converged"] == converges and abs(it - count) <= (1 if mixed and ref_count else 0),
          f"{shape}: {it} cycles (converged={r0['converged']}), the reference takes {count}")
    if mixed:
        check(errs[0] == 1.0 and r0["errs_dtype"] == "torch.float32",
              f"{shape}: the first step's relres {errs[0]} (not 1.0, the incoming psi0's) "
              f"or the history {r0['errs_dtype']}")
    for k, (e, ej) in enumerate(zip(errs, ref_errs), 1):
        check(abs(e - ej) <= RELRES_TOL * ej, f"{shape} cycle {k}: relres {e:.6e} vs {ej:.6e}")
    check(r0["finite"] and r0["shape"] == list(spec.shape),
          f"{shape}: the gathered psi is not a finite {spec.shape} array")
    print(f"[{label}] f64 re-check of the gathered psi: ||r||/||r0|| = {r0['rel64']:.6e} "
          f"(tol {spec.tol})")
    check(not converges or r0["rel64"] < spec.tol, f"{shape}: f64 relres {r0['rel64']:.3e} >= tol")
    measured = None
    if single is not None:
        n = single["n_metric_evals"]
        check(all(r["n_metric_evals"] == n for r in ranks),
              f"{shape}: metric evaluations {[r['n_metric_evals'] for r in ranks]}, the "
              f"single-device solve's {n}")
        gap = nmax(torch.load(psi_path), single["psi"])[0]
        print(f"[{label}] {n} metric evaluations, as the single-device solve; psi against its "
              f"psi: normalized max |diff| {gap:.3e}; solve wall, rank 0..3 (CUDA events, no "
              "callback): " + " ".join(f"{r['solve_ms']:.3f}" for r in ranks) + " ms")
        check(gap <= PARITY_TOL, f"{shape}: psi {gap:.3e} from the single-device solve's")
        if spec.stop_check == "adaptive":
            measured = len(single["measured"])
    want = _expected(sharded_launches(spec, mesh_shape, it, measured))
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


def phase_spmd(dev, singles):
    """The sharded solves on 4 ranks sharing the card over gloo; the
    single-device 16384^2 solves (tuned, fast with its packed fine level,
    and mixed) and the single-device mixed 4096^2, 256^3 and 512^3 solves
    as the references of the sharded ones (the mixed 4096^2 and 256^3 step
    counts against the JAX package's, within one); the FMG and adaptive
    solves against the single-device ones of phase_fmg_adaptive
    (`singles`).  Returns the launches of the main paths' sharded solves and
    the seconds of the FMG and adaptive ones on rank 0."""
    refs = {"spmd4096": JAX_ERRS, "spmd256^3": JAX_ERRS_3D[256],
            "spmd4096fast": JAX_ERRS_FAST[MAIN_N],
            **{label: r["errs"] for label, r in singles.items()}}
    for label, spec in (("spmd16384", SPEC_16K), ("spmd16384fast", FAST_16K),
                        ("spmd4096mixed", MIXED_SPEC), ("spmd16384mixed", MIXED_16K),
                        ("spmd256^3mixed", MIXED_SPEC_3D), ("spmd512^3mixed", MIXED_512)):
        mg, res, cycle_ms = _solve(spec, dev)
        what = (f"{spec.scheme}{' packed' if mg._packed else ''} "
                f"{spec.dtype}{' with ' + spec.sweep_dtype + ' sweeps' if spec.sweep_dtype else ''}")
        shape = f"{spec.size}^{spec.ndim}"
        check(res.converged, f"the single-device {shape} {what} solve did not converge")
        check(mg._packed == (spec.scheme == "fast"), f"the single-device {shape} {what} solve")
        refs[label] = res.errs.tolist()
        print(f"[spmd] single-device {shape} {what}: {res.iterations} cycles, per-cycle "
              f"wall ms median {statistics.median(cycle_ms):.3f}")
        if spec is MIXED_SPEC_3D:   # its steps beside the JAX package's (CPU, xla)
            gap = max(abs(e - ej) / ej for e, ej in zip(refs[label], JAX_ERRS_MIXED_3D))
            print(f"[spmd] single-device {shape} {what} against the JAX package's "
                  f"{JAX_ITERATIONS_MIXED_3D} steps: {res.iterations} steps, relres per step "
                  f"within {gap:.3e} relative (the bf16 V-cycle rounds as torch does, not "
                  "as XLA on the CPU: phase slice_mixed3d)")
        del mg, res
        torch.cuda.empty_cache()
    counts = {"spmd4096mixed": JAX_ITERATIONS_MIXED, "spmd256^3mixed": JAX_ITERATIONS_MIXED_3D}
    t0 = time.perf_counter()
    ranks = _spawn_ranks("gloo", SPMD_CASES)
    print(f"[spmd] {SPMD_WORLD} ranks over gloo on {torch.cuda.device_count()} card(s): "
          f"{time.perf_counter() - t0:.1f} s for the spawn and every solve")
    launches = {}
    how = "4 ranks, one card, gloo" if torch.cuda.device_count() == 1 else "4 ranks, gloo"
    new_seconds = 0.0
    for i, (label, spec, mesh_shape, _) in enumerate(SPMD_CASES):
        launches[label, mesh_shape] = _check_spmd(
            label, spec, mesh_shape, [r[i] for r in ranks], refs[label], how,
            counts.get(label), singles.get(label), SPMD_DIR / "gloo" / f"psi{i}.pt")
        if label in singles:
            new_seconds += ranks[0][i]["seconds"]
    if torch.cuda.device_count() >= SPMD_WORLD:
        cases = [c for c in SPMD_CASES if c[0] in ("spmd4096", "spmd4096fast", "spmd4096mixed")
                 and c[2] == ((4, 1) if c[0] == "spmd4096fast" else (2, 2))]
        nccl = _spawn_ranks("nccl", cases)
        for i, (label, spec, mesh_shape, _) in enumerate(cases):
            _check_spmd(label, spec, mesh_shape, [r[i] for r in nccl], refs[label],
                        "4 ranks, 4 cards, nccl", counts.get(label))
    else:
        print(f"[spmd] NCCL: not run: {torch.cuda.device_count()} card(s), and NCCL refuses "
              f"two ranks on one GPU; the {SPMD_WORLD} ranks above ran over gloo")
    return {"2d": launches["spmd16384", (2, 2)], "3d": launches["spmd256^3", (2, 2)],
            "packed": launches["spmd16384fast", (4, 1)],
            "mixed": launches["spmd16384mixed", (2, 2)],
            "mixed3d": launches["spmd256^3mixed", (2, 2)]}, new_seconds


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
    probe_scalar_division(dev)
    phase_parity_bf16(dev, worst)
    times_bf16 = phase_timing(dev, MAIN_N, 2, torch.bfloat16)
    for name, t in times_bf16.items():
        f32 = name.replace(BF16, "")
        print(f"[timing_bf16] {name} against its f32 form: " + _beside(times[f32], t))
    times.update(times_bf16)
    solve_mixed = phase_slice_mixed(dev)
    phase_mixed_off_grid(dev)
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
    # ... and in bf16: the bf16 forms of K7/K8, the bf16 4096^2 and 1024^2
    # fast solves
    phase_parity_packed_bf16(dev, worst)
    times_bf16 = phase_timing_packed(dev, MAIN_N, torch.bfloat16)
    for name in ("mg_packed_rr_bf16", "mg_packed_pc_bf16", "mg_packed_pc_bf16.rnorm"):
        print(f"[timing_packed_bf16] {name} against its f32 form: "
              + _beside(times[name.replace(BF16, "")], times_bf16[name]))
    times.update(times_bf16)
    solve_fast_bf16 = phase_slice_fast_bf16(dev, MAIN_N, compare=True)
    phase_slice_fast_bf16(dev, 1024, compare=False)
    phase_strided(dev)
    # FMG and the adaptive stop on one card: tuned 4096^2 with FMG, with
    # the adaptive stop, the fast packed 4096^2 adaptive (and to a stop at
    # maxiter, and with FMG), 256^3 with both
    singles, new_seconds = phase_fmg_adaptive(dev)
    # the multigrid-vs-Krylov gate: MGCG at 4096^2 on K2/K3, then the
    # convergence study at 4 ... 128 on plain ops
    t0 = time.perf_counter()
    phase_krylov_mgcg(dev)
    phase_converge_study(dev)
    print(f"[krylov] the Krylov phases: {time.perf_counter() - t0:.1f} s")

    # the sharded solves (explicit partition): the strip kernels, the
    # packed strip kernels of the fast scheme on a mesh of one column, then
    # 4 ranks solving 4096^2, 256^3 and 16384^2 (tuned) and 4096^2 and
    # 16384^2 (fast, packed)
    phase_parity_sharded(dev, worst)
    times.update(phase_timing_sharded(dev, times))
    # ... and the bf16 forms of K9-K12, which the mixed solves under a mesh run
    phase_parity_sharded(dev, worst, torch.bfloat16)
    times.update(phase_timing_sharded(dev, times, torch.bfloat16))
    phase_parity_sharded_packed(dev, worst)
    times.update(phase_timing_sharded_packed(dev))
    solve_spmd, spmd_seconds = phase_spmd(dev, singles)
    print(f"[fmg_adaptive] the FMG and adaptive phases: {new_seconds:.1f} s on one card and "
          f"{spmd_seconds:.1f} s of the 4-rank spawn's solves (rank 0), "
          f"{new_seconds + spmd_seconds:.1f} s in all")
    # batched serving (solve_batched, K2/K3 per element) and the
    # reference's lexicographic Gauss-Seidel (plain ops on the card), after
    # every phase that reads the kernels' device time from torch.profiler
    t0 = time.perf_counter()
    phase_batched(dev, card)
    print(f"[batched] the batched phase: {time.perf_counter() - t0:.1f} s")
    phase_gs_lex(dev, card)

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
            solve = solve_fast_bf16 if name.endswith(BF16) else solve_fast
        if name.startswith("mg_sharded"):
            solve = solve_spmd["mixed3d" if name.endswith("3d" + BF16) else
                               "3d" if name.endswith("3d") else
                               "packed" if name.startswith("mg_sharded_packed") else
                               "mixed" if name.endswith(BF16) else "2d"]
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
