"""Times the 2D leg kernels of two builds in one process, in turns.

    python3 -m mgpoisson_torch.bench.ab --old build/parent/mgpoisson_torch/csrc \\
        [--old-tile 32 | --old-table WARPS SMALL SHALLOW DEEP] [--sides 4096 ... 256]
        [--sharded 16384] [--reps 25]

Builds the source tree given by --old (e.g. a parent commit's
``mgpoisson_torch/csrc``, unpacked with ``git archive``) beside this
checkout's, loads both libraries and runs the same wrappers of
``kernels.cuda`` on the same inputs through each: K1, K2, K2 from zero, K3
and K3 with rnorm at every side (wjacobi nu = 3, the tuned scheme's
settings of chip_smoke.py's timing phase) and at 4096^2 with rbgs nu = 1
(the fast scheme's coarse levels); then K9/K10 on the (0, 0) block of a
(2, 2) mesh of 16384^2.  Each case is timed old, new, new, old, each
time two ways: CUDA events around each call, median of --reps calls
(`*_ms`, what chip_smoke.py reports; at small sides it is the host's
enqueue time), and the kernels' own device time per call from
torch.profiler over --reps calls (`*_kernel_ms`).  With each: the bound
(unique bytes over 3.35 TB/s) and the largest normalized difference
between the two builds' outputs (0 where they round alike).  The old
build's up-leg writes one Sigma r^2 partial per block of its own tile, so
the partials are sized for it while it runs: by default the tile table of
this checkout (kernels.cuda.tile2d), with --old-table that table with the
other build's constants, with --old-tile T square T x T blocks (32: the
build before the register tile, PR 5's).  Prints the card, one JSON
line per case and exits non-zero without a GPU.  Compares only inside one
call: two calls may get two cards.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from mgpoisson_torch.bench.profile import event_ms, kernel_ms
from mgpoisson_torch.kernels import build, cuda, exchange_depth, ops
from mgpoisson_torch.core.spec import Spec
from mgpoisson_torch.shard.spmd import block_from_grid

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, datasheet


def _flat(x):
    return [t for y in x for t in _flat(y)] if isinstance(x, (tuple, list)) else (
        [] if x is None else [x])


def _bytes(*xs):
    return sum(t.numel() * t.element_size() for t in _flat(xs) if torch.is_tensor(t))


class Builds:
    """The two libraries and a switch between them for kernels.cuda."""

    def __init__(self, old_csrc: Path, old_tile: int, old_table=None):
        root = build.BUILD_DIR.parent / "ab"
        self.libs = {"old": build.load_library(build.build(old_csrc, root)),
                     "new": build.load()}
        self.old_tile = old_tile
        self.rnorm_partials = cuda.rnorm_partials
        self.table = {"new": (cuda.TILE_WARPS, cuda.TILE_ROWS),
                      "old": old_table or (cuda.TILE_WARPS, cuda.TILE_ROWS)}

    def use(self, which):
        lib = self.libs[which]
        cuda.load = lambda: lib
        cuda.TILE_WARPS, cuda.TILE_ROWS = self.table[which]
        if which == "new" or not self.old_tile:
            cuda.rnorm_partials = self.rnorm_partials
        else:
            t = self.old_tile
            cuda.rnorm_partials = (
                lambda shape, nu, smoother, n: -(-shape[0] // t) * -(-shape[1] // t))


def _cases_whole(n, smoother, nu, dev):
    g = torch.Generator(device=dev).manual_seed(n + nu)
    u, f, V = (torch.randn((s, s), generator=g, device=dev) for s in (n, n, n // 2))
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


def _cases_sharded(n, dev):
    spec = Spec(size=n, dtype="float32", scheme="tuned")
    d = exchange_depth(spec)
    g = torch.Generator(device=dev).manual_seed(17)
    u, f, V = (torch.randn((s, s), generator=g, device=dev) for s in (n, n, n // 2))
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


def _run(builds, label, cases, inputs, reps):
    for name, call in cases.items():
        outs = {}
        for which in ("old", "new"):
            builds.use(which)
            outs[which] = [t.clone() for t in _flat(call())]
        diff = max(float((a.double() - b.double()).abs().max() / b.double().abs().max())
                   if b.abs().max() > 0 else float((a - b).abs().max())
                   for a, b in zip(outs["old"], outs["new"]))
        times, ktimes = {}, {}
        for which in ("old", "new", "new", "old"):
            builds.use(which)
            times.setdefault(which, []).append(event_ms(call, reps))
            ktimes.setdefault(which, []).append(kernel_ms(call, reps))
        builds.use("new")
        bound = 1e3 * (_bytes(inputs[name]) + _bytes(outs["new"])) / PEAK_BYTES_PER_S
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True, help="the other build's csrc")
    ap.add_argument("--old-tile", type=int, default=0,
                    help="the other build's square 2D tile side (its rnorm partials), 32 "
                    "before the register tile; 0: a register tile")
    ap.add_argument("--old-table", type=int, nargs=4,
                    metavar=("WARPS", "SMALL", "SHALLOW", "DEEP"),
                    help="a register tile's MG2_WARPS and MG2_ROWS_SMALL / _SHALLOW / _DEEP "
                    "where they differ from this checkout's")
    ap.add_argument("--sides", type=int, nargs="+", default=[4096, 2048, 1024, 512, 256])
    ap.add_argument("--sharded", type=int, default=16384,
                    help="global side of the (2, 2) mesh for K9/K10; 0 skips")
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    dev = torch.device("cuda")
    table = args.old_table and (args.old_table[0], tuple(args.old_table[1:]))
    builds = Builds(args.old, args.old_tile, table)
    settings = [(n, "wjacobi", 3) for n in args.sides]
    if 4096 in args.sides:
        settings.append((4096, "rbgs", 1))
    for n, smoother, nu in settings:
        cases, inputs = _cases_whole(n, smoother, nu, dev)
        _run(builds, f"{n}^2 {smoother} nu={nu}", cases, inputs, args.reps)
        del cases, inputs
        torch.cuda.empty_cache()
    if args.sharded:
        cases, inputs = _cases_sharded(args.sharded, dev)
        _run(builds, f"(0, 0) block of {args.sharded}^2 on (2, 2) wjacobi nu=3", cases,
             inputs, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
