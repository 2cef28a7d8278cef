"""Times the leg kernels of two builds in one process, in turns.

    python3 -m mgpoisson_torch.bench.ab --old build/parent/mgpoisson_torch/csrc \\
        [--old-tile 32 | --old-table WARPS SMALL SHALLOW DEEP] [--sides 4096 ... 256]
        [--sharded 16384] [--sides3d 256 512] [--sharded3d 256] [--old-tile3d]
        [--old-strip3d] [--old-rounding3d] [--packed 4096 ...]
        [--sharded-packed 16384] [--old-packed-tile 32] [--old-packed-bf16]
        [--smooth3d] [--dtype {float32,bfloat16}] [--reps 25]

Builds the source tree given by --old (e.g. a parent commit's
``mgpoisson_torch/csrc``, unpacked with ``git archive``) beside this
checkout's, loads both libraries and runs the same wrappers of
``kernels.cuda`` on the same inputs through each: K1, K2, K2 from zero, K3
and K3 with rnorm at every side (wjacobi nu = 3, the tuned scheme's
settings of chip_smoke.py's timing phase) and at 4096^2 with rbgs nu = 1
(the fast scheme's coarse levels); then K9/K10 on the (0, 0) block of a
(2, 2) mesh of 16384^2; then the 3D legs K5, K5 from zero, K6 and K6
with rnorm at every --sides3d side, with wjacobi nu = 3 (and K4) and rbgs
nu = 1 (with --smooth3d K4 alone instead, at every setting of
SMOOTH3D_SETTINGS in both bcs);
then their strip entries K11, K11 from zero, K12 and K12 with rnorm on the
(0, 0) block of a (2, 2) mesh of --sharded3d^3, with the same two
settings (K11/K12 only with --sharded3d; an empty --sides or --sides3d,
or --sharded 0, skips that part); then the packed legs of the fast
scheme's fine level at every --packed side: K7, and K8 and K8 with rnorm
in both prolongation kinds, at rbgs nu = 1, 2, 3; then K13, K14 and K14
with rnorm (bilinear, nu = 1) on the interior (n/4, n) block of
--sharded-packed^2 on (4, 1), its strips as the solver exchanges them.  Each case is timed old, new, new, old,
each time two ways: CUDA events around each call, median of --reps calls
(`*_ms`, what chip_smoke.py reports; at small sides it is the host's
enqueue time), and the kernels' own device time per call from
torch.profiler over --reps calls (`*_kernel_ms`).  With each: the bound
(unique bytes over 3.35 TB/s; of a packed u only its black plane, the red
one being dead on input) and the largest normalized difference
between the two builds' outputs (0 where they round alike).  The old
build's up-leg writes one Sigma r^2 partial per block of its own tile, so
the partials are sized for it while it runs: by default the tile table of
this checkout (kernels.cuda.tile2d), with --old-table that table with the
other build's constants, with --old-tile T square T x T blocks (32: a
build whose 2D legs ran one thread per cell of a 32 x 32 tile); with
--old-tile3d the old build's whole-grid K6 runs the cube tile of
csrc/stencil3d.cuh at every halo (a build without the z-marching tile),
so its partials are one per T^3 block; with --old-strip3d the old build's
K12 does (a build whose strip entries K11/K12 keep the cube tile); with
--old-packed-tile T the old build's K8/K14 write one per T x T packed tile
(32: a build whose packed up-leg ran a shared-memory tile of 32 x 32
packed lanes, before the register tile); with --old-packed-bf16 the old
build's bf16 K8 writes one per block of the f32 register tile
(blocks2d at the halo 2 nu + 1: a build whose bf16 packed legs rounded
every op on f32 registers, before the packed word tile of
csrc/stencil_packed_w.cuh); with --old-rounding3d the old
build's bf16 K6/K12 run the f32 z-marching tile's geometry (a build whose
bf16 3D legs rounded every op on f32 registers, before the word tile of
csrc/stencil3d_zw.cuh), so their partials are per block of that tile.  Prints
the card, one JSON line per case and exits non-zero without a GPU.  Compares only inside one
call: two calls may get two cards.

With --dtype bfloat16 it times the bf16 forms of K1-K12 (the 2D legs at
every --sides side, the 3D legs at every --sides3d side, the packed legs
K7/K8 at every --packed side, by default the --sides, K9/K10 on the
(0, 0) block of --sharded^2 and K11/K12 on that of --sharded3d^3, as
above) and nothing else: the packed strip kernels K13/K14 are f32 only.
The other build must have the forms it times (an empty --sides3d times
K1-K3 alone, for a build whose 3D legs are f32 only; an empty --packed
skips K7/K8, for a build whose packed legs are f32 only; --sharded 0
skips K9/K10 and --sharded3d 0, the default, K11/K12, for a build whose
strip kernels are f32 only).
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from mgpoisson_torch.bench.profile import event_ms, kernel_ms
from mgpoisson_torch.bench.roofline import op_bytes, tensors
from mgpoisson_torch.kernels import build, cuda, exchange_depth, ops
from mgpoisson_torch.core.spec import Spec
from mgpoisson_torch.shard.spmd import block_from_grid

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, datasheet
# --smooth3d: K4's settings, halos 1-4 on the z-marching tiles (jacobi nu 1-4,
# wjacobi nu 1-3, rbgs nu 1-2)
SMOOTH3D_SETTINGS = tuple([("jacobi", nu) for nu in (1, 2, 3, 4)]
                          + [("wjacobi", nu) for nu in (1, 2, 3)]
                          + [("rbgs", nu) for nu in (1, 2)])


def _black(up):
    """A packed array's black plane: the red plane of u is dead on input
    (the first red step overwrites it), so a bound counts only this one."""
    return ops._planes(up)[1]


class Builds:
    """The two libraries and a switch between them for kernels.cuda."""

    def __init__(self, old_csrc: Path, old_tile: int, old_table=None, old_tile3d=False,
                 old_strip3d=False, old_packed_tile=0, old_rounding3d=False,
                 old_packed_bf16=False):
        root = build.BUILD_DIR.parent / "ab"
        self.libs = {"old": build.load_library(build.build(old_csrc, root)),
                     "new": build.load()}
        self.old_tile, self.old_tile3d, self.old_strip3d = old_tile, old_tile3d, old_strip3d
        self.old_packed_tile = old_packed_tile
        self.rnorm_partials = cuda.rnorm_partials
        self.strip_rnorm_partials = cuda.strip_rnorm_partials
        self.packed_rnorm_partials = cuda.packed_rnorm_partials
        self.table = {"new": (cuda.TILE_WARPS, cuda.TILE_ROWS),
                      "old": old_table or (cuda.TILE_WARPS, cuda.TILE_ROWS)}
        self.old_rounding3d = old_rounding3d
        self.old_packed_bf16 = old_packed_bf16

    def use(self, which):
        lib = self.libs[which]
        cuda.load = lambda: lib
        cuda.TILE_WARPS, cuda.TILE_ROWS = self.table[which]
        cuda.rnorm_partials = self.rnorm_partials
        cuda.strip_rnorm_partials = self.strip_rnorm_partials
        cuda.packed_rnorm_partials = self.packed_rnorm_partials
        if which == "new":
            return
        if self.old_packed_tile:
            pt = self.old_packed_tile
            cuda.packed_rnorm_partials = (lambda nl, n, nu, dtype=torch.float32:
                                          -(-(n // 2) // pt) * -(-nl // pt))
        elif self.old_packed_bf16:
            packed = self.packed_rnorm_partials
            cuda.packed_rnorm_partials = lambda nl, n, nu, dtype=torch.float32: packed(nl, n, nu)
        t, cube, base = self.old_tile, self.old_tile3d, self.rnorm_partials
        # the dtype whose z-marching geometry the old build's legs run
        geo = (lambda dtype: torch.float32) if self.old_rounding3d else (lambda dtype: dtype)

        def partials(shape, nu, smoother, n, dtype=torch.float32):
            if len(shape) == 3 and cube:
                return _cube_partials(shape, nu, smoother, n)
            if len(shape) == 2 and t:
                return -(-shape[0] // t) * -(-shape[1] // t)
            return base(shape, nu, smoother, n, geo(dtype))
        cuda.rnorm_partials = partials
        strip = self.strip_rnorm_partials
        if self.old_strip3d:
            cuda.strip_rnorm_partials = lambda shape, nu, smoother, n, dtype=torch.float32: (
                _cube_partials(shape, nu, smoother, n) if len(shape) == 3
                else strip(shape, nu, smoother, n, dtype))
        else:
            cuda.strip_rnorm_partials = lambda shape, nu, smoother, n, dtype=torch.float32: (
                strip(shape, nu, smoother, n, geo(dtype)))


def _cube_partials(shape, nu, smoother, n):
    """The Sigma r^2 partials of a 3D up-leg on the cube tile at every halo:
    one per T^3 block over the (shape[0], shape[1], n) array or block."""
    t = cuda.tile3d(cuda._steps(nu, smoother) + 1)
    return -(-n // t) * -(-shape[0] // t) * -(-shape[1] // t)


def _cases_whole(n, smoother, nu, dev, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(n + nu)
    u, f, V = (torch.randn((s, s), generator=g, device=dev).to(dtype)
               for s in (n, n, n // 2))
    h = 1.0 / n
    kind = "bilinear"
    cases = {
        "K2": lambda: cuda.smooth_residual_restrict(u, f, h, nu, smoother, "ghost0"),
        "K2.zero": lambda: cuda.smooth_residual_restrict_zero(f, h, nu, smoother, "face"),
        "K3": lambda: cuda.prolong_correct_smooth(u, f, V, h, nu, smoother, "face", kind),
        "K3.rnorm": lambda: cuda.prolong_correct_smooth_rnorm(u, f, V, h, nu, smoother,
                                                              "ghost0", kind),
    }
    if smoother == "wjacobi":
        cases["K1"] = lambda: cuda.smooth(u, f, h, nu, smoother, "ghost0")
    inputs = {"K1": (u, f), "K2": (u, f), "K2.zero": (f,), "K3": (u, f, V),
              "K3.rnorm": (u, f, V)}
    return cases, inputs


def _cases_whole3d(n, smoother, nu, dev, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(n + nu)
    u, f, V = (torch.randn((s,) * 3, generator=g, device=dev).to(dtype)
               for s in (n, n, n // 2))
    h = 1.0 / n
    cases = {
        "K5": lambda: cuda.smooth_residual_restrict(u, f, h, nu, smoother, "ghost0"),
        "K5.zero": lambda: cuda.smooth_residual_restrict_zero(f, h, nu, smoother, "face"),
        "K6": lambda: cuda.prolong_correct_smooth(u, f, V, h, nu, smoother, "face", "bilinear"),
        "K6.rnorm": lambda: cuda.prolong_correct_smooth_rnorm(u, f, V, h, nu, smoother,
                                                              "ghost0", "bilinear"),
    }
    if smoother == "wjacobi":
        cases["K4"] = lambda: cuda.smooth(u, f, h, nu, smoother, "ghost0")
    inputs = {"K4": (u, f), "K5": (u, f), "K5.zero": (f,), "K6": (u, f, V),
              "K6.rnorm": (u, f, V)}
    return cases, inputs


def _cases_smooth3d(n, dev, dtype=torch.float32):
    """K4 alone at side n, every SMOOTH3D_SETTINGS setting in both bcs."""
    g = torch.Generator(device=dev).manual_seed(n + 5)
    u, f = (torch.randn((n,) * 3, generator=g, device=dev).to(dtype) for _ in range(2))
    h = 1.0 / n
    cases = {f"K4 {sm} nu={nu} {bc}":
             (lambda sm=sm, nu=nu, bc=bc: cuda.smooth(u, f, h, nu, sm, bc))
             for sm, nu in SMOOTH3D_SETTINGS for bc in ("ghost0", "face")}
    return cases, dict.fromkeys(cases, (u, f))


def _cases_sharded(n, dev, dtype=torch.float32):
    spec = Spec(size=n, dtype="float32", scheme="tuned")
    d = exchange_depth(spec)
    g = torch.Generator(device=dev).manual_seed(17)
    u, f, V = (torch.randn((s, s), generator=g, device=dev).to(dtype)
               for s in (n, n, n // 2))
    shape = (n // 2, n // 2)
    ub, us = block_from_grid(u, (0, 0), shape, d)
    fb, fs = block_from_grid(f, (0, 0), shape, d)
    vb, vs = block_from_grid(V, (0, 0), (n // 4, n // 4), ops.coarse_depth(d))
    del u, f, V
    b, s = ((0, 0), n, 1.0 / n), (3, "wjacobi")
    cases = {
        "K9": lambda: cuda.smooth_rr_sharded(ub, fb, us, fs, *b, *s, "ghost0"),
        "K9.zero": lambda: cuda.smooth_rr_sharded(None, fb, None, fs, *b, *s, "face",
                                                  zero=True),
        "K10": lambda: cuda.pc_smooth_sharded(ub, fb, vb, us, fs, vs, *b, *s, "face",
                                              "bilinear"),
        "K10.rnorm": lambda: cuda.pc_smooth_sharded(ub, fb, vb, us, fs, vs, *b, *s, "ghost0",
                                                    "bilinear", rnorm=True),
    }
    inputs = {"K9": (ub, fb, us, fs), "K9.zero": (fb, fs), "K10": (ub, fb, vb, us, fs, vs),
              "K10.rnorm": (ub, fb, vb, us, fs, vs)}
    return cases, inputs


def _cases_sharded3d(n, smoother, nu, dev, dtype=torch.float32):
    spec = Spec(size=n, ndim=3, dtype="float32", scheme="tuned")
    d = exchange_depth(spec)
    g = torch.Generator(device=dev).manual_seed(n + nu + 1)
    u, f, V = (torch.randn((s,) * 3, generator=g, device=dev).to(dtype)
               for s in (n, n, n // 2))
    shape = (n // 2, n // 2, n)
    ub, us = block_from_grid(u, (0, 0), shape, d)
    fb, fs = block_from_grid(f, (0, 0), shape, d)
    vb, vs = block_from_grid(V, (0, 0), (n // 4, n // 4, n // 2), ops.coarse_depth(d))
    del u, f, V
    b, s = ((0, 0), n, 1.0 / n), (nu, smoother)
    cases = {
        "K11": lambda: cuda.smooth_rr_sharded(ub, fb, us, fs, *b, *s, "ghost0"),
        "K11.zero": lambda: cuda.smooth_rr_sharded(None, fb, None, fs, *b, *s, "face",
                                                   zero=True),
        "K12": lambda: cuda.pc_smooth_sharded(ub, fb, vb, us, fs, vs, *b, *s, "face",
                                              "bilinear"),
        "K12.rnorm": lambda: cuda.pc_smooth_sharded(ub, fb, vb, us, fs, vs, *b, *s, "ghost0",
                                                    "bilinear", rnorm=True),
    }
    inputs = {"K11": (ub, fb, us, fs), "K11.zero": (fb, fs), "K12": (ub, fb, vb, us, fs, vs),
              "K12.rnorm": (ub, fb, vb, us, fs, vs)}
    return cases, inputs


def _cases_packed(n, nu, dev, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(n + nu + 2)
    u, f, V = (torch.randn((s, s), generator=g, device=dev).to(dtype)
               for s in (n, n, n // 2))
    up, fp = cuda.pack_grid(u), cuda.pack_grid(f)
    del u, f
    h = 1.0 / n
    cases = {"K7": lambda: cuda.packed_smooth_residual_restrict(up, fp, h, nu)}
    inputs = {"K7": (_black(up), fp)}
    for kind in ("bilinear", "inject"):
        k = "" if kind == "bilinear" else " inject"
        cases["K8" + k] = lambda kind=kind: cuda.packed_prolong_correct_smooth(
            up, fp, V, h, nu, kind)
        cases["K8.rnorm" + k] = lambda kind=kind: cuda.packed_prolong_correct_smooth_rnorm(
            up, fp, V, h, nu, kind)
        inputs["K8" + k] = inputs["K8.rnorm" + k] = (_black(up), fp, V)
    return cases, inputs


def _cases_sharded_packed(n, dev):
    """K13/K14 on the interior block (n/4, n) at row n/4 of n^2 on (4, 1),
    rbgs nu = 1, bilinear: the sharded fast solve's fine block."""
    spec = Spec(size=n, dtype="float32", scheme="fast")
    d, nu, nl = exchange_depth(spec), 1, n // 4
    g = torch.Generator(device=dev).manual_seed(23)
    rand = lambda *shape: torch.randn(shape, generator=g, device=dev)
    ub, fb, vb = rand(nl, n), rand(nl, n), rand(nl // 2, n // 2)
    us, fs = (rand(d, n), rand(d, n), None, None), (rand(d, n), rand(d, n), None, None)
    vs = (rand(ops.coarse_depth(d), n // 2), rand(ops.coarse_depth(d), n // 2), None, None)
    b = ((nl, 0), n, 1.0 / n, nu)
    cases = {
        "K13": lambda: cuda.packed_rr_sharded(ub, fb, us, fs, *b),
        "K14": lambda: cuda.packed_pc_sharded(ub, fb, vb, us, fs, vs, *b, "bilinear"),
        "K14.rnorm": lambda: cuda.packed_pc_sharded(ub, fb, vb, us, fs, vs, *b, "bilinear",
                                                    rnorm=True),
    }
    fine = (_black(ub), fb, *map(_black, us[:2]), fs)
    inputs = {"K13": fine, "K14": (*fine, vb, vs), "K14.rnorm": (*fine, vb, vs)}
    return cases, inputs


def _run(builds, label, cases, inputs, reps):
    for name, call in cases.items():
        outs = {}
        for which in ("old", "new"):
            builds.use(which)
            outs[which] = [t.clone() for t in tensors(call())]
        diff = max(float((a.double() - b.double()).abs().max() / b.double().abs().max())
                   if b.abs().max() > 0 else float((a - b).abs().max())
                   for a, b in zip(outs["old"], outs["new"]))
        times, ktimes = {}, {}
        for which in ("old", "new", "new", "old"):
            builds.use(which)
            times.setdefault(which, []).append(event_ms(call, reps))
            ktimes.setdefault(which, []).append(kernel_ms(call, reps))
        builds.use("new")
        bound = 1e3 * op_bytes(inputs[name], outs["new"]) / PEAK_BYTES_PER_S
        new_ms, old_ms = statistics.median(times["new"]), statistics.median(times["old"])
        old_spread = abs(times["old"][0] - times["old"][1]) / min(times["old"])
        print(json.dumps({
            "case": f"{name} {label}", "old_ms": times["old"], "new_ms": times["new"],
            "old_kernel_ms": ktimes["old"], "new_kernel_ms": ktimes["new"],
            "bound_ms": bound, "new_pct_of_bound": 100 * bound / new_ms,
            "old_pct_of_bound": 100 * bound / old_ms, "new_over_old": new_ms / old_ms,
            "kernel_new_over_old": statistics.median(ktimes["new"])
            / statistics.median(ktimes["old"]),
            "old_spread": old_spread, "max_norm_diff_new_vs_old": diff}), flush=True)


def parse_args(argv=None):
    """The command line; with --dtype bfloat16 only the whole-grid legs
    (2D, 3D and packed; --packed by default the --sides) and K9-K12 run
    (--sharded-packed is cleared: K13/K14 are f32 only)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True, help="the other build's csrc")
    ap.add_argument("--old-tile", type=int, default=0,
                    help="the other build's square 2D tile side (its rnorm partials), 32 "
                    "before the register tile; 0: a register tile")
    ap.add_argument("--old-table", type=int, nargs=4,
                    metavar=("WARPS", "SMALL", "SHALLOW", "DEEP"),
                    help="a register tile's MG2_WARPS and MG2_ROWS_SMALL / _SHALLOW / _DEEP "
                    "where they differ from this checkout's")
    ap.add_argument("--sides", type=int, nargs="*", default=[4096, 2048, 1024, 512, 256])
    ap.add_argument("--sharded", type=int, default=16384,
                    help="global side of the (2, 2) mesh for K9/K10; 0 skips")
    ap.add_argument("--sides3d", type=int, nargs="*", default=[256, 512])
    ap.add_argument("--old-tile3d", action="store_true",
                    help="the other build's whole-grid K6 runs the cube tile at every halo "
                    "(before the z-marching tile)")
    ap.add_argument("--sharded3d", type=int, default=0,
                    help="global side of the (2, 2) mesh for K11/K12 (256: the sharded "
                    "256^3 solve's block); 0, the default, skips")
    ap.add_argument("--old-strip3d", action="store_true",
                    help="the other build's K12 runs the cube tile at every halo (before "
                    "the strip-fed z-marching tile)")
    ap.add_argument("--old-rounding3d", action="store_true",
                    help="the other build's bf16 K5/K6 and K11/K12 round every op on the f32 "
                    "z-marching tile (before the word tile)")
    ap.add_argument("--packed", type=int, nargs="*", default=None,
                    help="sides of the packed legs K7/K8 at rbgs nu = 1, 2, 3 (by default "
                    "none, in bf16 the --sides)")
    ap.add_argument("--sharded-packed", type=int, default=0,
                    help="global side of the (4, 1) mesh for K13/K14 (16384: the sharded "
                    "fast solve's block); 0, the default, skips")
    ap.add_argument("--old-packed-tile", type=int, default=0,
                    help="the other build's packed tile side (its K8/K14 rnorm partials, one "
                    "per T x T packed tile), 32 before the register tile; 0: the register tile")
    ap.add_argument("--old-packed-bf16", action="store_true",
                    help="the other build's bf16 K8 writes its rnorm partials per block of the "
                    "f32 register tile (before the packed word tile)")
    ap.add_argument("--smooth3d", action="store_true",
                    help="time K4 alone at every --sides3d side over SMOOTH3D_SETTINGS in "
                    "both bcs, instead of the 3D legs' two settings")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="bfloat16: the bf16 forms of K1-K12 only")
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)
    args.dtype = getattr(torch, args.dtype)
    if args.packed is None:
        args.packed = args.sides if args.dtype == torch.bfloat16 else []
    if args.dtype == torch.bfloat16:
        args.sharded_packed = 0
    return args


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    dev = torch.device("cuda")
    table = args.old_table and (args.old_table[0], tuple(args.old_table[1:]))
    builds = Builds(args.old, args.old_tile, table, args.old_tile3d, args.old_strip3d,
                    args.old_packed_tile, args.old_rounding3d, args.old_packed_bf16)
    settings = [(n, "wjacobi", 3) for n in args.sides]
    if 4096 in args.sides:
        settings.append((4096, "rbgs", 1))
    for n, smoother, nu in settings:
        cases, inputs = _cases_whole(n, smoother, nu, dev, args.dtype)
        dt = " bf16" if args.dtype == torch.bfloat16 else ""
        _run(builds, f"{n}^2{dt} {smoother} nu={nu}", cases, inputs, args.reps)
        del cases, inputs
        torch.cuda.empty_cache()
    if args.sharded:
        cases, inputs = _cases_sharded(args.sharded, dev, args.dtype)
        dt = " bf16" if args.dtype == torch.bfloat16 else ""
        _run(builds, f"(0, 0) block of {args.sharded}^2{dt} on (2, 2) wjacobi nu=3", cases,
             inputs, args.reps)
        del cases, inputs
        torch.cuda.empty_cache()
    for n in args.sides3d if args.smooth3d else ():
        cases, inputs = _cases_smooth3d(n, dev, args.dtype)
        dt = " bf16" if args.dtype == torch.bfloat16 else ""
        _run(builds, f"{n}^3{dt}", cases, inputs, args.reps)
        del cases, inputs
        torch.cuda.empty_cache()
    for n, (smoother, nu) in itertools.product(() if args.smooth3d else args.sides3d,
                                               (("wjacobi", 3), ("rbgs", 1))):
        cases, inputs = _cases_whole3d(n, smoother, nu, dev, args.dtype)
        dt = " bf16" if args.dtype == torch.bfloat16 else ""
        _run(builds, f"{n}^3{dt} {smoother} nu={nu}", cases, inputs, args.reps)
        del cases, inputs
        torch.cuda.empty_cache()
    for smoother, nu in (("wjacobi", 3), ("rbgs", 1)) if args.sharded3d else ():
        cases, inputs = _cases_sharded3d(args.sharded3d, smoother, nu, dev, args.dtype)
        dt = " bf16" if args.dtype == torch.bfloat16 else ""
        _run(builds, f"(0, 0) block of {args.sharded3d}^3{dt} on (2, 2) {smoother} nu={nu}",
             cases, inputs, args.reps)
        del cases, inputs
        torch.cuda.empty_cache()
    for n, nu in itertools.product(args.packed, (1, 2, 3)):
        cases, inputs = _cases_packed(n, nu, dev, args.dtype)
        dt = " bf16" if args.dtype == torch.bfloat16 else ""
        _run(builds, f"{n}^2{dt} packed rbgs nu={nu}", cases, inputs, args.reps)
        del cases, inputs
        torch.cuda.empty_cache()
    if args.sharded_packed:
        n = args.sharded_packed
        cases, inputs = _cases_sharded_packed(n, dev)
        _run(builds, f"({n // 4}, {n}) block at row {n // 4} of {n}^2 on (4, 1) rbgs nu=1",
             cases, inputs, args.reps)
        del cases, inputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
