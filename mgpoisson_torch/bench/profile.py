"""Profile one solve with torch.profiler (port of
``mgpoisson/bench/profile.py``).

    python -m mgpoisson_torch.bench.profile [--size 4096] [--ndim {2,3}]
        [--scheme {tuned,fast}] [--device cuda] [--kernel-min-size 256 2]
        [--tol 1e-10] [--maxiter N] [--dtype {float32,float64,bfloat16}]
        [--sweep-dtype {float32,float64,bfloat16}] [--out DIR]
        [--mesh MX MY [--dist-backend gloo]]

For each kernel_min_size it runs the residual-stop solve of the scheme
(tuned by default; fast runs the packed fine level on the card, see
``mgpoisson_torch.kernels.use_packed``, on K7/K8 or, with --dtype
bfloat16, on their bf16 forms) in 2D, or 3D with --ndim 3 (e.g.
--size 256 --ndim 3), in --dtype (f32 by default; bfloat16 is the pure
bf16 solve, which levels off: give it --tol 1e-30 --maxiter 12) and, with
a --sweep-dtype other than it, as mixed-precision refinement (e.g.
--sweep-dtype bfloat16: an f32 solve whose V-cycle runs in bf16 on the
bf16 forms of K1-K3, or of K4-K6 with --ndim 3, one refinement step per
"cycle" below), three times
on the device: a warm-up, one timed solve (wall ms per cycle from
the error callback, each cycle ending in a scalar readback) and one solve
under torch.profiler.  From the profiled solve it prints, per cycle, the
device launches, the device time (union of the device events' intervals)
and the time in the mg_* CUDA kernels, and the device busy share of the
timed solve's wall, and the timed solve's history (``errs``, the relres of
each cycle).  With --out, each profiled solve is also written as a
Chrome trace.  On a CPU device there are no device events: those fields
read "not measured".

With --mesh, MX * MY ranks are spawned (torch.multiprocessing; a
--dist-backend process group through a file store under build/) and each
profiles its block of the sharded solve the same way, on
``shard.multihost.device_for(rank)``: one line per rank, with the host
time per cycle of the timed solve spent in the collectives
(``shard.spmd.comm_seconds``): the halo strips, staged through host memory
under gloo, and the all-gathers (the handoff to the replicated levels, the
all-reduced sums).  ``--scheme fast --mesh MX 1`` profiles the packed
sharded solve (``kernels.use_packed_sharded``: the fine level on the
packed strip kernels K13/K14, whose names start with mg_ like the others');
``--sweep-dtype bfloat16 --mesh MX MY`` the mixed-precision step under the
partition (``shard.spmd.SpmdCycle.step_mixed``: the one-cell exchange of
the residual, then the bf16 V-cycle on the bf16 forms of K9/K10, with
--ndim 3 of K11/K12, its strips exchanged in bf16).

Its timing helpers serve the other tools: ``event_ms`` (CUDA events around
each call), ``device_ms`` (the device's busy time per call, the port's
counterpart of the JAX package's ``chain_time``) and ``kernel_ms`` (the
mg_* kernels' part of it), both read from the same guarded captures;
``host_ms`` (the host clock, for CPU work); and ``call_ms`` / ``wall_ms``,
which pick the device's or the host's clock by the device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import statistics
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.autograd import DeviceType

from mgpoisson_torch.core.spec import Spec
from mgpoisson_torch.kernels import build
from mgpoisson_torch.kernels import cuda as cuda_kernels
from mgpoisson_torch.shard import multihost, spmd
from mgpoisson_torch.solver.multigrid import MultigridPoisson


DTYPES = ("float32", "float64", "bfloat16")
# device_ms, kernel_ms: the spin kernels launched at each end of a capture,
# each of SPIN_CYCLES clock cycles (~50 us on an H100: a run of ~15 ms), and
# the captures taken before a reading raises
SENTINELS = 300
SPIN_CYCLES = 100_000
TRIES = 8


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(device, out: str | None = None, host: bool = True):
    """Profile the enclosed block (CPU ops, plus the device's kernels on
    CUDA) and yield the profiler; queued device work is flushed before
    the capture closes.  With `out`, also export a Chrome trace there.
    With host=False, on CUDA the device's activity alone: a capture of
    ~10^4 launches costs the host's ops seconds more."""
    acts = [torch.profiler.ProfilerActivity.CPU] if host or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync(device)
    if out:
        prof.export_chrome_trace(out)


def _device_events(prof):
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def device_summary(prof):
    """(launches, device ms, mg_* kernel ms) of a capture's device events;
    device ms is the union of their intervals."""
    return _summary(_device_events(prof))


def _summary(evs):
    busy_us, mg_us, end = 0.0, 0.0, float("-inf")
    for e in evs:
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
        if e.name.removeprefix("void ").startswith("mg_"):   # templates: "void mg_..<..>(..)"
            mg_us += t - s
    return len(evs), busy_us / 1e3, mg_us / 1e3


def event_ms(fn, reps: int = 25) -> float:
    """Median ms of one call of fn on the card, by CUDA events around each
    call after 3 warm-up calls.  For a wrapper whose kernel is shorter than
    the host's time to enqueue the call, this is the host's time."""
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


def _sentinels():
    for _ in range(SENTINELS):
        torch.cuda._sleep(SPIN_CYCLES)


def _sentinel_name(device) -> str:
    """The name under which the profiler reports the spin kernel of
    ``_sentinels``, read from a capture of a run of them alone (the most
    common name; such a capture is taken again, up to TRIES times, while it
    holds no device event)."""
    for _ in range(TRIES):
        _sync(device)
        with trace(device, host=False) as prof:
            _sentinels()
        names = collections.Counter(e.name for e in _device_events(prof))
        if names:
            return names.most_common(1)[0][0]
    raise RuntimeError(f"{TRIES} captures of {SENTINELS} spin kernels held no device event")


def _timed_capture(fn, reps, device, sentinel):
    """The device events of `reps` calls of fn in one capture of the
    device's activity, between runs of SENTINELS spin kernels; None where
    the capture lost the whole run at either end, and so maybe some of
    fn's events.

    The profiler drops device events at an end of a capture: on an H100,
    late in a long process, 5 of 25 calls of K2 every time (with 20 ms or
    0.2 s of idle time in the capture too, and with the host's activity
    too), all of a capture of 128 spin kernels of ~1 us, the one kernel of
    a single call; so a capture without a margin reads short (K1 at 112 %
    of the HBM peak), and each run of spin kernels is longer than any of
    those losses, in events and in time."""
    _sync(device)
    with trace(device, host=False) as prof:
        _sentinels()
        for _ in range(reps):
            fn()
        _sentinels()
    evs = _device_events(prof)
    inner = [e for e in evs if e.name != sentinel]
    if not inner:
        return None
    first, last = inner[0].time_range.start, max(e.time_range.end for e in inner)
    marks = [e for e in evs if e.name == sentinel]
    if (any(e.time_range.end <= first for e in marks)
            and any(e.time_range.start >= last for e in marks)):
        return inner
    return None


def _whole_captures(fn, reps, device, who):
    """(device ms, mg_* kernel ms) of `reps` calls of fn: the mean of two
    whole captures (``_timed_capture``) that hold the same number of device
    events, none having held more; captures are taken until there are two
    such, up to TRIES, else this raises.  The one policy on lost events of
    ``device_ms`` and ``kernel_ms``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{who}: no device events on {device}; "
                         "time CPU work with host_ms")
    fn()
    sentinel = _sentinel_name(device)
    fullest, kept = 0, []
    for _ in range(TRIES):
        evs = _timed_capture(fn, reps, device, sentinel)
        if evs is None:
            continue
        n_ev, busy_ms, mg_ms = _summary(evs)
        if n_ev > fullest:
            fullest, kept = n_ev, []
        if n_ev == fullest:
            kept.append((busy_ms, mg_ms))
            if len(kept) == 2:
                return tuple(statistics.fmean(x) for x in zip(*kept))
    raise RuntimeError(f"{who}: no two whole captures of {reps} calls in {TRIES} held the "
                       f"same number of device events (the most seen: {fullest})")


def kernel_ms(fn, reps: int = 25, device="cuda") -> float:
    """The mg_* kernels' own device ms per call of fn, from the captures of
    ``device_ms``: the kernels' time without the host's nor the plain ops'.
    Raises where fn launched no mg_* kernel, and on a device other than
    CUDA (ValueError)."""
    mg_ms = _whole_captures(fn, reps, device, "kernel_ms")[1]
    if mg_ms <= 0:
        raise RuntimeError("kernel_ms: no mg_* kernel in the captures")
    return mg_ms / reps


def device_ms(fn, reps: int = 25, device="cuda") -> float:
    """The device's busy time per call of fn, in ms: the union of the
    intervals of every device event (the plain ops' kernels and copies as
    well as the mg_* kernels) over `reps` calls under torch.profiler,
    divided by `reps`.  The port's counterpart of the JAX package's
    ``chain_time`` (``mgpoisson/bench/timing.py``), which cancels the
    host's dispatch by difference: this reads the card's own clock, so a
    call whose wall is mostly host dispatch still reads its device time.

    A short capture is never read as a time.  Each capture (of the device's
    activity alone: the host's costs it seconds per ~10^4 launches) holds
    the calls between two runs of spin kernels and counts only if it kept
    some of each (``_timed_capture``); and captures are taken until two
    whole ones hold the same number of device events and none held more,
    up to TRIES (``_whole_captures``).  The reading is the two's mean busy
    time over `reps`; otherwise this raises.  fn must launch the same work
    on every call.  A device other than CUDA has no device events:
    ValueError (time with ``host_ms`` there)."""
    return _whole_captures(fn, reps, device, "device_ms")[0] / reps


def host_ms(fn, reps: int = 25) -> float:
    """Median ms of one call of fn by the host clock, after one warm-up
    call: the time of CPU work, where there is no device clock to read."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def call_ms(fn, device, reps: int = 25) -> float:
    """ms per call of fn: the device's own time on a CUDA device
    (``device_ms``), the host clock's on the CPU (``host_ms``)."""
    if torch.device(device).type == "cuda":
        return device_ms(fn, reps, device)
    return host_ms(fn, reps)


def wall_ms(fn, device, reps: int = 25) -> float:
    """ms per call of fn as its caller waits for it: CUDA events around
    each call on a CUDA device (``event_ms``), the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        return event_ms(fn, reps)
    return host_ms(fn, reps)


def profile_solve(spec, device, out: str | None = None):
    """Warm-up, timed and profiled solves of `spec`; returns a dict of the
    per-cycle numbers."""
    mg = MultigridPoisson(spec, device=device)
    mg.solve()                                          # warm-up
    stamps = []
    _sync(device)
    spmd.reset_comm_seconds()
    t0 = time.perf_counter()
    res = mg.solve(error_callback=lambda it, err: stamps.append(time.perf_counter()))
    cycle_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
    comm_ms = {k: 1e3 * v / res.iterations for k, v in spmd.comm_seconds.items()}
    cuda_kernels.reset_launches()
    with trace(device, out) as prof:
        res_p = mg.solve()
    kernel_calls = dict(cuda_kernels.launches)
    it = res.iterations
    wall_ms = statistics.median(cycle_ms)
    row = {"size": spec.size, "ndim": spec.ndim, "scheme": spec.scheme,
           "dtype": spec.dtype, "sweep_dtype": spec.sweep_dtype, "packed": mg._packed, "kernel_min_size": spec.kernel_min_size,
           "device": str(mg.device), "cycles": it, "converged": res.converged,
           "final_err": res.final_err, "errs": res.errs.tolist(),
           "profiled_cycles": res_p.iterations,
           "wall_ms_per_cycle": wall_ms, "cycle_ms": cycle_ms,
           "kernel_calls": kernel_calls}
    k = res_p.iterations
    if mg.mesh is not None:
        row.update(rank=mg.mesh.rank, mesh=list(mg.mesh.shape),
                   **{f"{name}_ms_per_cycle": ms for name, ms in comm_ms.items()})
    if device.type == "cuda":
        n_ev, dev_ms, mg_ms = device_summary(prof)
        row.update(launches_per_cycle=n_ev / k, device_ms_per_cycle=dev_ms / k,
                   mg_kernel_ms_per_cycle=mg_ms / k,
                   device_busy_share=dev_ms / k / wall_ms)
    else:
        row.update(launches_per_cycle="not measured",
                   device_ms_per_cycle="not measured",
                   mg_kernel_ms_per_cycle="not measured",
                   device_busy_share="not measured")
    return row


def _rank(rank, backend, store, specs, device, outs):
    """One rank of a --mesh run: profiles its block of each spec's solve."""
    mx, my = specs[0].mesh_shape
    multihost.initialize(backend, f"file://{store}", mx * my, rank)
    try:
        if device == "cuda":
            torch.cuda.set_device(multihost.device_for(rank))
        for spec, out in zip(specs, outs):
            row = profile_solve(spec, torch.device(device), out and out.format(rank=rank))
            print(json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--ndim", type=int, choices=(2, 3), default=2)
    p.add_argument("--scheme", choices=("tuned", "fast"), default="tuned")
    p.add_argument("--device", default="cuda")
    p.add_argument("--kernel-min-size", type=int, nargs="+", default=[256])
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--maxiter", type=int, default=Spec.maxiter)
    p.add_argument("--dtype", choices=DTYPES, default="float32")
    p.add_argument("--sweep-dtype", choices=DTYPES, default=None,
                   help="another dtype for the V-cycle: mixed-precision refinement")
    p.add_argument("--out", default=None,
                   help="directory for one Chrome trace per solve")
    p.add_argument("--mesh", type=int, nargs=2, default=None, metavar=("MX", "MY"),
                   help="profile the sharded solve on MX * MY spawned ranks")
    p.add_argument("--dist-backend", choices=("gloo", "nccl"), default="gloo")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
    specs, outs = [], []
    for kms in args.kernel_min_size:
        specs.append(Spec(size=args.size, ndim=args.ndim, dtype=args.dtype,
                          sweep_dtype=args.sweep_dtype, scheme=args.scheme, stop="residual",
                          tol=args.tol, maxiter=args.maxiter, kernel_min_size=kms,
                          mesh_shape=None if args.mesh is None else tuple(args.mesh)))
        tag = ("" if args.ndim == 2 else "_3d") + ("" if args.scheme == "tuned" else "_fast")
        tag += "" if args.dtype == "float32" else f"_{args.dtype}"
        tag += "" if args.sweep_dtype in (None, args.dtype) else f"_sweep_{args.sweep_dtype}"
        if args.mesh is not None:
            tag += "_mesh{}x{}".format(*args.mesh) + "_rank{rank}"
        outs.append(str(Path(args.out) / f"solve_{args.size}{tag}_kms{kms}.json")
                    if args.out else None)
    if args.mesh is None:
        rows = []
        for spec, out in zip(specs, outs):
            row = profile_solve(spec, device, out)
            print(json.dumps(row), flush=True)
            rows.append(row)
        return rows
    if device.type == "cuda":
        build.load()            # once here, not in every rank
    store = build.BUILD_DIR.parent / "profile_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    mp.start_processes(_rank, args=(args.dist_backend, str(store), specs, args.device, outs),
                       nprocs=args.mesh[0] * args.mesh[1], join=True, start_method="spawn")
    return None


if __name__ == "__main__":
    main()
