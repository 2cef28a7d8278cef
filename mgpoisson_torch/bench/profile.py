"""Profile one solve with torch.profiler (port of
``mgpoisson/bench/profile.py``).

    python -m mgpoisson_torch.bench.profile [--size 4096] [--ndim {2,3}]
        [--scheme {tuned,fast}] [--device cuda] [--kernel-min-size 256 2]
        [--tol 1e-10] [--out DIR]

For each kernel_min_size it runs the f32 residual-stop solve of the scheme
(tuned by default; fast runs the packed fine level on the card, see
``mgpoisson_torch.kernels.use_packed``) in 2D, or 3D with --ndim 3 (e.g.
--size 256 --ndim 3), three times on the device: a warm-up, one timed solve (wall ms per cycle from
the error callback, each cycle ending in a scalar readback) and one solve
under torch.profiler.  From the profiled solve it prints, per cycle, the
device launches, the device time (union of the device events' intervals)
and the time in the mg_* CUDA kernels, and the device busy share of the
timed solve's wall.  With --out, each profiled solve is also written as a
Chrome trace.  On a CPU device there are no device events: those fields
read "not measured".
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

from mgpoisson_torch.core.spec import Spec
from mgpoisson_torch.kernels import cuda as cuda_kernels
from mgpoisson_torch.solver.multigrid import MultigridPoisson


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(device, out: str | None = None):
    """Profile the enclosed block (CPU ops, plus the device's kernels on
    CUDA) and yield the profiler; queued device work is flushed before
    the capture closes.  With `out`, also export a Chrome trace there."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync(device)
    if out:
        prof.export_chrome_trace(out)


def device_summary(prof):
    """(launches, device ms, mg_* kernel ms) of a capture's device events;
    device ms is the union of their intervals."""
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    busy_us, mg_us, end = 0.0, 0.0, float("-inf")
    for e in evs:
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
        if e.name.startswith("mg_"):
            mg_us += t - s
    return len(evs), busy_us / 1e3, mg_us / 1e3


def profile_solve(spec, device, out: str | None = None):
    """Warm-up, timed and profiled solves of `spec`; returns a dict of the
    per-cycle numbers."""
    mg = MultigridPoisson(spec, device=device)
    mg.solve()                                          # warm-up
    stamps = []
    _sync(device)
    t0 = time.perf_counter()
    res = mg.solve(error_callback=lambda it, err: stamps.append(time.perf_counter()))
    cycle_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
    cuda_kernels.reset_launches()
    with trace(device, out) as prof:
        res_p = mg.solve()
    kernel_calls = dict(cuda_kernels.launches)
    it = res.iterations
    wall_ms = statistics.median(cycle_ms)
    row = {"size": spec.size, "ndim": spec.ndim, "scheme": spec.scheme,
           "packed": mg._packed, "kernel_min_size": spec.kernel_min_size,
           "device": str(device), "cycles": it, "converged": res.converged,
           "final_err": res.final_err, "profiled_cycles": res_p.iterations,
           "wall_ms_per_cycle": wall_ms, "cycle_ms": cycle_ms,
           "kernel_calls": kernel_calls}
    if device.type == "cuda":
        n_ev, dev_ms, mg_ms = device_summary(prof)
        k = res_p.iterations
        row.update(launches_per_cycle=n_ev / k, device_ms_per_cycle=dev_ms / k,
                   mg_kernel_ms_per_cycle=mg_ms / k,
                   device_busy_share=dev_ms / k / wall_ms)
    else:
        row.update(launches_per_cycle="not measured",
                   device_ms_per_cycle="not measured",
                   mg_kernel_ms_per_cycle="not measured",
                   device_busy_share="not measured")
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--ndim", type=int, choices=(2, 3), default=2)
    p.add_argument("--scheme", choices=("tuned", "fast"), default="tuned")
    p.add_argument("--device", default="cuda")
    p.add_argument("--kernel-min-size", type=int, nargs="+", default=[256])
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--out", default=None,
                   help="directory for one Chrome trace per solve")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
    rows = []
    for kms in args.kernel_min_size:
        spec = Spec(size=args.size, ndim=args.ndim, dtype="float32",
                    scheme=args.scheme, stop="residual", tol=args.tol,
                    kernel_min_size=kms)
        tag = ("" if args.ndim == 2 else "_3d") + ("" if args.scheme == "tuned" else "_fast")
        out = (str(Path(args.out) / f"solve_{args.size}{tag}_kms{kms}.json")
               if args.out else None)
        row = profile_solve(spec, device, out)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
