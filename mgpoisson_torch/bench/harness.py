"""Seconds per V-cycle per variant and size (port of
``mgpoisson/bench/harness.py``).

    python3 -m mgpoisson_torch.bench.harness [--sizes 64,256,1024]
        [--variants torch,auto] [--tries 3] [--cycles 4] [--out bench_out]
        [--device cuda]

The JAX harness's variant ladder, in the port's terms:

  cpu    — the oracle's role: plain torch ops on the CPU in float64 with
           the oracle's settings (tuned scheme, rbgs 2+2), timed by the
           host clock (``bench.profile.host_ms``: the median of `cycles`
           V-cycles, best of `tries`);
  torch  — xla's role: backend='torch', plain ops at every level;
  cuda   — pallas's role: backend='cuda' with kernel_min_size=2, the
           kernels at every level their caps allow (the JAX package's
           'pallas' backend ignores pallas_min_size);
  auto   — backend='auto' at the default kernel_min_size=256.

The JAX harness's 'native' variant (the framework-free C++ solver) is
not ported.  The accelerator variants run the JAX harness's spec (f32,
tuned, from -f of a point charge of -1e6 at the centre) on `device` and
report the DEVICE seconds per V-cycle, the best of `tries` captures of
`cycles` cycles (``bench.profile.device_ms``, the port's ``chain_time``);
the wall per cycle (CUDA events) is printed beside it.  On the CPU they
take the host clock, as the cpu variant does.

Writes <out>/times.tsv (size, variant, best seconds per V-cycle) and,
when matplotlib imports, <out>/times.png.  A variant that needs the card
is skipped, with the reason printed, where torch.cuda.is_available() is
False; any other error is raised, and an unknown variant is a
ValueError.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

import torch

from mgpoisson_torch.bench.profile import call_ms, wall_ms
from mgpoisson_torch.core.rhs import point_charge_rhs
from mgpoisson_torch.core.spec import Spec
from mgpoisson_torch.cycle.vcycle import v_cycle

VARIANTS = ("cpu", "torch", "cuda", "auto")


def variant_spec(variant: str, size: int) -> Spec:
    """The Spec a variant's V-cycles run."""
    if variant == "cpu":
        return Spec(size=size, dtype="float64", scheme="tuned", smoother="rbgs",
                    pre_smooth=2, post_smooth=2, backend="torch")
    if variant == "cuda":
        return Spec(size=size, dtype="float32", scheme="tuned", backend="cuda",
                    kernel_min_size=2)
    if variant in ("torch", "auto"):
        return Spec(size=size, dtype="float32", scheme="tuned", backend=variant)
    raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")


def _time_variant(variant: str, size: int, cycles: int, tries: int, device):
    """(seconds per V-cycle, wall seconds per V-cycle) of a variant: the
    best of `tries`."""
    spec = variant_spec(variant, size)
    device = torch.device("cpu" if variant == "cpu" else device)
    f = point_charge_rhs(size, 2, getattr(torch, spec.dtype), device)
    psi0, h = -f, spec.fine_h
    cycle = lambda: v_cycle(psi0, f, h, spec)
    best = min(call_ms(cycle, device, cycles) for _ in range(tries))
    wall = wall_ms(cycle, device, cycles) if device.type == "cuda" else best
    return best / 1e3, wall / 1e3


def run_harness(sizes: List[int], variants: List[str], tries: int, cycles: int,
                out_dir: str, device="cuda") -> Dict:
    """Times each variant at each size; returns {"rows": [(size, variant,
    seconds)]} and writes out_dir/times.tsv (and times.png)."""
    for variant in variants:
        variant_spec(variant, 2)          # an unknown variant raises before any run
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for size in sizes:
        for variant in variants:
            on_card = variant != "cpu" and torch.device(device).type == "cuda"
            if (on_card or variant == "cuda") and not torch.cuda.is_available():
                print(f"size={size} variant={variant}: skipped (needs a CUDA device; "
                      "torch.cuda.is_available() is False)")
                continue
            t, wall = _time_variant(variant, size, cycles, tries, device)
            rows.append((size, variant, t))
            print(f"size={size:6d} variant={variant:7s} {t * 1e3:9.4f} ms/V-cycle "
                  f"({'device' if on_card else 'host'}), "
                  f"wall {wall * 1e3:9.4f} ms")

    tsv = os.path.join(out_dir, "times.tsv")
    with open(tsv, "w") as fh:
        fh.write("size\tvariant\tseconds_per_vcycle\n")
        for size, variant, t in rows:
            fh.write(f"{size}\t{variant}\t{t:.6e}\n")
    print(f"wrote {tsv}")

    try:
        import matplotlib
    except ImportError as e:
        print(f"plot skipped ({e})")
        return {"rows": rows}
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    for variant in variants:
        pts = [(s, t) for s, v, t in rows if v == variant]
        if pts:
            ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", label=variant)
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.set_xlabel("grid side")
    ax.set_ylabel("seconds per V-cycle (device; cpu: host)")
    if rows:
        ax.legend()
    ax.set_title("mgpoisson_torch V-cycle time")
    png = os.path.join(out_dir, "times.png")
    fig.savefig(png, dpi=120)
    plt.close(fig)
    print(f"wrote {png}")
    return {"rows": rows}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--sizes", default="64,256,1024")
    p.add_argument("--variants", default="torch,auto")
    p.add_argument("--tries", type=int, default=3)
    p.add_argument("--cycles", type=int, default=4)
    p.add_argument("--out", default="bench_out")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return run_harness([int(s) for s in args.sizes.split(",")], args.variants.split(","),
                       args.tries, args.cycles, args.out, args.device)


if __name__ == "__main__":
    main()
