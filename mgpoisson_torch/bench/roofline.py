"""Per-op bandwidth roofline (port of ``mgpoisson/bench/roofline.py``).

    python3 -m mgpoisson_torch.bench.roofline [--size 4096] [--dtype float32]
        [--nu 2] [--device cuda]

Times each hot op of the tuned V-cycle at one size and reports the
achieved GB/s against the card's HBM peak: the JAX report's seven rows,
under its labels and with its byte counts (``op_bytes``: each input read
once, each output written once).  Each op is the one
``kernels.get_ops(spec, size, device)`` picks, so on the card at 4096^2
the fused rows run K1, K2 and K3 (their bf16 forms with --dtype
bfloat16); the unfused round trip and the V-cycle's coarse levels run
the plain ops.

``seconds`` is the device's busy time per call (``bench.profile.
device_ms``, the port's counterpart of the JAX package's ``chain_time``),
so ``gbps`` and ``pct_peak`` are the card's own; ``wall_seconds`` beside
it is the wall per call by CUDA events, which at these sizes holds the
host's time to enqueue the call too.  On the CPU the host clock times
each row and the peak is None, as the JAX report has it for a platform
it does not know.
"""

from __future__ import annotations

import argparse

import torch

from mgpoisson_torch.bench.profile import call_ms, wall_ms
from mgpoisson_torch.core.rhs import point_charge_rhs
from mgpoisson_torch.core.spec import Spec
from mgpoisson_torch.cycle.vcycle import v_cycle
from mgpoisson_torch.kernels import get_ops

# HBM peak of each card, GB/s (NVIDIA's data sheet, at a 700 W power limit)
HBM_PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}


def tensors(x):
    """The tensors in x, depth first through nested tuples and lists (None
    and other values dropped)."""
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in tensors(y)]
    return [x] if torch.is_tensor(x) else []


def op_bytes(inputs, outputs) -> int:
    """The bytes an op must move at least: each input tensor read once and
    each output tensor written once (nested tuples and lists are walked;
    None and other values count nothing).  A packed leg's caller passes
    u's black plane only, the red one being dead on input.  The bound of
    every timed kernel counts its bytes here (``chip_smoke.py``
    ``bound_ms``, ``bench/ab.py``)."""
    return sum(t.numel() * t.element_size() for t in tensors(inputs) + tensors(outputs))


def peak_gbps(device):
    """The HBM peak of `device`'s card, or None (the CPU, or a card not in
    HBM_PEAK_GBPS)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return HBM_PEAK_GBPS.get(torch.cuda.get_device_name(device))


def entries(size: int = 4096, dtype: str = "float32", nu: int = 2, device="cuda"):
    """The report's rows: (label, fn, bytes) with fn() running the row's op
    once on the JAX report's operands (f a point charge of -1e6 at the
    centre, u = -f, V zeros), bytes None for the V-cycle."""
    spec = Spec(size=size, dtype=dtype, scheme="tuned", backend="auto",
                pre_smooth=nu, post_smooth=nu)
    ops = get_ops(spec, size, device)
    h = spec.fine_h
    f = point_charge_rhs(size, 2, getattr(torch, dtype), device)
    u = -f
    V = torch.zeros((size // 2, size // 2), dtype=f.dtype, device=f.device)
    # (V has the shape of the down-leg's R)
    grid, down, up = op_bytes((u, f), u), op_bytes((u, f), (u, V)), op_bytes((u, f, V), u)
    return [
        (f"smooth wjacobi x{nu} (fused)",
         lambda: ops.smooth(u, f, h, nu, "wjacobi", "ghost0"), grid),
        (f"smooth rbgs x{nu} (fused)",
         lambda: ops.smooth(u, f, h, nu, "rbgs", "ghost0"), grid),
        (f"smooth jacobi x{nu} (fused)",
         lambda: ops.smooth(u, f, h, nu, "jacobi", "ghost0"), grid),
        # the two fused half-levels exactly as the V-cycle runs them
        (f"smooth x{nu} + residual + restrict (fused)",
         lambda: ops.smooth_residual_restrict(u, f, h, nu, "wjacobi", "ghost0"), down),
        (f"prolong + correct + smooth x{nu} (fused)",
         lambda: ops.prolong_correct_smooth(u, f, V, h, nu, "wjacobi", "ghost0", "bilinear"),
         up),
        # the unfused transfer-op round trip (for comparison): R is written
        # by the first op and read by the second
        ("residual_restrict + prolong_correct (bilinear)",
         lambda: ops.prolong_correct(u, ops.residual_restrict(u, f, h, "ghost0"), "bilinear"),
         op_bytes((u, f, V), (u, V))),
        ("full V-cycle (tuned)", lambda: v_cycle(u, f, h, spec), None),
    ]


def report(size: int = 4096, dtype: str = "float32", nu: int = 2, device="cuda"):
    """Times every row of ``entries`` and prints the table; returns the rows
    as dicts: op, seconds (device time per call; host time on the CPU),
    gbps, pct_peak (None without bytes or peak), bytes, wall_seconds."""
    device = torch.device(device)
    peak = peak_gbps(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={name} size={size} dtype={dtype} nu={nu} peak={peak} GB/s "
          f"(seconds: {'device' if device.type == 'cuda' else 'host'} time)")
    print(f"{'op':48s} {'ms':>9s} {'wall ms':>9s} {'GB/s':>9s} {'% peak':>8s}")
    rows = []
    for label, fn, nbytes in entries(size, dtype, nu, device):
        t = call_ms(fn, device) / 1e3
        wall = wall_ms(fn, device) / 1e3
        gbps = nbytes / t / 1e9 if nbytes else None
        pct = 100 * gbps / peak if (gbps and peak) else None
        rows.append({"op": label, "seconds": t, "gbps": gbps, "pct_peak": pct,
                     "bytes": nbytes, "wall_seconds": wall})
        print(f"{label:48s} {t * 1e3:9.4f} {wall * 1e3:9.4f} "
              f"{gbps if gbps else float('nan'):9.1f} {pct if pct else float('nan'):8.1f}")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--nu", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return report(args.size, args.dtype, args.nu, args.device)


if __name__ == "__main__":
    main()
