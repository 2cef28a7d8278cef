"""Drives mgpoisson_torch's main path once on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device  — a CUDA device must be present; prints its name and power
             limit (nvidia-smi) and turns TF32 off.
2. build   — builds the three CUDA kernels from mgpoisson_torch/csrc.
3. parity  — each kernel against its plain torch version on the card, f32,
             at every level side the main path gives the kernels
             (4096 ... 256) x bc x smoother x nu; then the time of each at
             4096^2 beside the plain version's (CUDA events, median of 25).
4. slice   — the tuned-scheme 4096^2 f32 solve through
             MultigridPoisson(spec, device="cuda").solve(): the cycle count
             and per-cycle relres against the JAX package's, the returned
             psi re-checked in f64, the launch counters of that solve; then
             a traced V-cycle (the per-stage debugging path, the one caller
             of K1) with the counters zeroed again; then the same solve on
             plain ops (backend="torch") for comparison.

The last lines are a JSON object of the off-path kernel (K1, with its
launches in the traced cycle), the card's name and power limit, a JSON
object of the main path's kernels (K2, K3, with their launches in the
solve) and {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from mgpoisson_torch import MultigridPoisson, Spec
from mgpoisson_torch.core import level_sizes
from mgpoisson_torch.cycle.vcycle import v_cycle
from mgpoisson_torch.kernels import build, cuda, ops

# mgpoisson (the JAX package, backend='xla'), run on a CPU for
# Spec(size=4096, dtype='float32', scheme='tuned', stop='residual',
# tol=1e-10): 9 V-cycles, converged, with this relres per cycle.
JAX_ITERATIONS = 9
JAX_ERRS = [0.013347355648875237, 0.0006291550816968083, 4.472383079701103e-05,
            4.021771474072011e-06, 4.0204946571975597e-07, 4.2531766553111083e-08,
            4.677897180727086e-09, 5.301771799359756e-10, 6.155618376135763e-11]

PARITY_TOL = 1e-5          # normalized max |diff|, the ROADMAP's f32 kernel bar
RNORM_TOL = 1e-5           # relative, on sum(r^2): partials summed in another order
RELRES_TOL = 0.01          # per-cycle relres against the JAX package, relative
MAIN_N = 4096
MAIN_SPEC = Spec(size=MAIN_N, dtype="float32", scheme="tuned", stop="residual",
                 tol=1e-10)
# the level sides at which the main path runs the kernels
KERNEL_LEVELS = [s for s in level_sizes(MAIN_N) if s >= MAIN_SPEC.kernel_min_size]
TIMING_REPS = 25

# kernel -> (source, the Pallas kernel it replaces); K1 runs only on the
# traced cycle, K2 and K3 carry the solve
OFF_PATH = ("mg_smooth",)
KERNELS = {
    "mg_smooth": ("mgpoisson_torch/csrc/mg_smooth.cu",
                  "mgpoisson/kernels/pallas.py:587"),
    "mg_smooth_rr": ("mgpoisson_torch/csrc/mg_smooth_rr.cu",
                     "mgpoisson/kernels/pallas.py:2223"),
    "mg_prolong_correct_smooth": ("mgpoisson_torch/csrc/mg_prolong_correct_smooth.cu",
                                  "mgpoisson/kernels/pallas.py:2482"),
}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nmax(got, want):
    """(normalized max |diff|, max |diff|) of two tensors."""
    d = float((got.double() - want.double()).abs().max())
    return d / float(want.double().abs().max()), d


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


def phase_build():
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"[build] {lib_path.name} ready in {time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def _data(n, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev)
            for s in ((n, n), (n, n), (n // 2, n // 2))]


def phase_parity(dev):
    """Every kernel variant against its plain version; returns, per kernel,
    the largest normalized and absolute differences seen."""
    worst = {k: [0.0, 0.0] for k in KERNELS}

    def note(kernel, label, got, want, row):
        rel, ab = nmax(got, want)
        worst[kernel][0] = max(worst[kernel][0], rel)
        worst[kernel][1] = max(worst[kernel][1], ab)
        row.append(f"{label}={rel:.1e}")
        check(rel <= PARITY_TOL, f"{label} {row[0]}: normalized max |diff| "
              f"{rel:.3e} > {PARITY_TOL}")

    for n in KERNEL_LEVELS:
        u, f, V = _data(n, seed=n, dev=dev)
        h = 1.0 / n
        for bc in ("ghost0", "face"):
            for smoother in ("jacobi", "wjacobi", "rbgs"):
                for nu in ((1, 3, 7) if smoother == "jacobi" else (1, 3)):
                    row = [f"n={n} {bc} {smoother} nu={nu}"]
                    a = (h, nu, smoother, bc)
                    note("mg_smooth", "K1", cuda.smooth(u, f, *a),
                         ops.smooth(u, f, *a), row)
                    for tag, fk, fp, args in (
                            ("K2", cuda.smooth_residual_restrict,
                             ops.smooth_residual_restrict, (u, f)),
                            ("K2z", cuda.smooth_residual_restrict_zero,
                             ops.smooth_residual_restrict_zero, (f,))):
                        (gu, gR), (wu, wR) = fk(*args, *a), fp(*args, *a)
                        note("mg_smooth_rr", f"{tag}.u", gu, wu, row)
                        note("mg_smooth_rr", f"{tag}.R", gR, wR, row)
                    for kind in ("inject", "bilinear"):
                        pa = (u, f, V, h, nu, smoother, bc, kind)
                        tag = "K3" + kind[0]
                        note("mg_prolong_correct_smooth", tag,
                             cuda.prolong_correct_smooth(*pa),
                             ops.prolong_correct_smooth(*pa), row)
                        (gu, g2), (wu, w2) = (cuda.prolong_correct_smooth_rnorm(*pa),
                                              ops.prolong_correct_smooth_rnorm(*pa))
                        note("mg_prolong_correct_smooth", tag + "r.u", gu, wu, row)
                        rel2 = abs(float(g2) / float(w2) - 1.0)
                        row.append(f"{tag}r.r2={rel2:.1e}")
                        check(rel2 <= RNORM_TOL, f"{row[0]}: sum(r^2) relative "
                              f"difference {rel2:.3e} > {RNORM_TOL}")
                    torch.cuda.synchronize()
                    print("[parity] " + " ".join(row))
    return worst


def _time_ms(fn, reps=TIMING_REPS):
    """Median ms of one call, by CUDA events around each call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def phase_timing(dev):
    """Each kernel and its plain version at 4096^2 with the main path's
    settings (wjacobi, nu=3; ghost0 on the fine level, face where the
    kernel runs on coarse levels), alternating plain and kernel."""
    n = MAIN_N
    u, f, V = _data(n, seed=7, dev=dev)
    h = 1.0 / n
    cases = {
        "mg_smooth": (lambda m: m.smooth(u, f, h, 3, "wjacobi", "ghost0")),
        "mg_smooth_rr": (lambda m: m.smooth_residual_restrict(
            u, f, h, 3, "wjacobi", "ghost0")),
        "mg_smooth_rr.zero": (lambda m: m.smooth_residual_restrict_zero(
            f, h, 3, "wjacobi", "face")),
        "mg_prolong_correct_smooth": (lambda m: m.prolong_correct_smooth(
            u, f, V, h, 3, "wjacobi", "face", "bilinear")),
        "mg_prolong_correct_smooth.rnorm": (lambda m: m.prolong_correct_smooth_rnorm(
            u, f, V, h, 3, "wjacobi", "ghost0", "bilinear")),
    }
    out = {}
    for name, call in cases.items():
        p1 = _time_ms(lambda: call(ops))
        k1 = _time_ms(lambda: call(cuda))
        k2 = _time_ms(lambda: call(cuda))
        p2 = _time_ms(lambda: call(ops))
        out[name] = (statistics.median([k1, k2]), statistics.median([p1, p2]))
        print(f"[timing] {name} at {n}^2 f32: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms")
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


def phase_slice(dev):
    """Returns the launch counts of the solve and of the traced cycle, each
    read from its own run with the counters zeroed just before it."""
    spec = MAIN_SPEC
    _solve(spec, dev)                                  # warm-up
    cuda.reset_launches()
    mg, res, cycle_ms = _solve(spec, dev)
    after_solve = dict(cuda.launches)
    # the traced V-cycle (the per-stage debugging entry point) is the one
    # caller of K1
    f = mg.rhs()
    cuda.reset_launches()
    v_cycle(res.psi, f, spec.fine_h, spec, trace=[])
    torch.cuda.synchronize()
    after_trace = dict(cuda.launches)

    it = res.iterations
    errs = res.errs.tolist()
    print(f"[slice] tuned {MAIN_N}^2 f32 on {dev}: {it} cycles, converged="
          f"{res.converged}, final relres {res.final_err:.6e}")
    for k, (e, ej) in enumerate(zip(errs, JAX_ERRS), 1):
        print(f"[slice]   cycle {k}: relres {e:.6e}  jax {ej:.6e}  "
              f"rel diff {abs(e - ej) / ej:.2e}")
    check(res.converged, "the 4096^2 tuned solve did not converge")
    check(it == JAX_ITERATIONS, f"{it} cycles, the JAX package takes {JAX_ITERATIONS}")
    for k, (e, ej) in enumerate(zip(errs, JAX_ERRS), 1):
        check(abs(e - ej) <= RELRES_TOL * ej,
              f"cycle {k}: relres {e:.6e} vs the JAX package's {ej:.6e}")
    check(res.psi.shape == (MAIN_N, MAIN_N) and bool(torch.isfinite(res.psi).all()),
          "psi is not a finite 4096^2 array")

    # the returned psi, re-checked independently in f64 with the plain ops
    f64, psi64 = f.double(), res.psi.double()
    rel64 = float(ops.residual_norm(psi64, f64, spec.fine_h)
                  / ops.residual_norm(-f64, f64, spec.fine_h))
    print(f"[slice] f64 re-check: ||r||/||r0|| = {rel64:.6e} (tol {spec.tol})")
    check(rel64 < spec.tol, f"f64 relres of the returned psi {rel64:.3e} >= tol")

    L = len(KERNEL_LEVELS)
    want = {"mg_smooth": 0, "mg_smooth_rr": it * L, "mg_smooth_rr.zero": it * (L - 1),
            "mg_prolong_correct_smooth": it * L,
            "mg_prolong_correct_smooth.rnorm": it}
    print(f"[slice] kernel levels {KERNEL_LEVELS}; launches in the solve "
          f"{after_solve}; in the traced cycle {after_trace}")
    check(after_solve == want, f"launches in the solve {after_solve}, expected "
          f"{want}: one K2 and one K3 per cycle at every level >= "
          f"{spec.kernel_min_size}, K3 with rnorm once per cycle")
    check(after_trace["mg_smooth"] == 2 * L,
          f"the traced V-cycle ran K1 {after_trace['mg_smooth']} times, not "
          f"twice at each of the {L} kernel levels")

    _solve(spec.with_(backend="torch"), dev)           # warm-up
    cuda.reset_launches()
    _, res_t, cycle_ms_t = _solve(spec.with_(backend="torch"), dev)
    check(all(v == 0 for v in cuda.launches.values()),
          f"backend='torch' launched kernels: {cuda.launches}")
    check(res_t.iterations == it, f"backend='torch' took {res_t.iterations} "
          f"cycles, the kernels {it}")
    ms_k, ms_t = statistics.median(cycle_ms), statistics.median(cycle_ms_t)
    print(f"[slice] per-cycle wall ms, median (all): kernels {ms_k:.3f} "
          f"({' '.join(f'{c:.3f}' for c in cycle_ms)})")
    print(f"[slice] per-cycle wall ms, median (all): plain   {ms_t:.3f} "
          f"({' '.join(f'{c:.3f}' for c in cycle_ms_t)})")
    return after_solve, after_trace


def main():
    card = phase_device()
    dev = torch.device("cuda")
    phase_build()
    worst = phase_parity(dev)
    times = phase_timing(dev)
    after_solve, after_trace = phase_slice(dev)
    kernels, off_path = [], []
    for name, (source, replaces) in KERNELS.items():
        ms, plain_ms = times[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "max_abs_err": worst[name][1],
               "max_norm_err": worst[name][0], "ms": ms, "plain_ms": plain_ms}
        if name in OFF_PATH:
            off_path.append({**row, "trace_launches": after_trace[name]})
        else:
            kernels.append({**row, "launches": after_solve[name]})
    print(json.dumps({"off_path_kernels": off_path}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
