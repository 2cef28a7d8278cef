"""Debug and validation tools (port of ``mgpoisson/utils/debug.py``).

The reference's debug mode dumps every V-cycle stage (f, u, r, R, V, v
per level) in one format, so that two implementations' traces can be
diffed, and stops on any non-finite value ("found a nan").  Here, with
the JAX package's names, signatures, messages and report dicts:

- ``validate_cycle`` runs one traced V-cycle of the port
  (``cycle.vcycle.v_cycle`` with a trace: K1 at every kernel level in 2D,
  K4 in 3D, on the card), checks every stage finite (raising
  NonFiniteError naming the stage and level) and returns the trace;
- ``compare_traces`` diffs two stage traces stage by stage: the port's
  against the JAX package's, or the card's against plain torch;
- ``dump_trace`` prints the stages in the reference's dump format,
  character for character the JAX package's.

Stages may be tensors on any device and in any dtype, or numpy arrays
(a JAX trace's arrays too): they are read on the host, bf16 as f32.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


class NonFiniteError(RuntimeError):
    """Raised when a stage contains NaN/Inf ("found a nan")."""


def _host(arr) -> np.ndarray:
    """arr as a numpy array on the host: a tensor copied off its device,
    bf16 read as f32 (numpy has no bf16)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(arr)


def check_finite(name: str, arr, level_size: int = None) -> None:
    if isinstance(arr, torch.Tensor):
        # counted where the tensor lives: only the count crosses to the host
        n_bad = int((~torch.isfinite(arr)).sum())
    else:
        n_bad = int((~np.isfinite(np.asarray(arr))).sum())
    if n_bad:
        where = f" at level size {level_size}" if level_size else ""
        raise NonFiniteError(
            f"found a nan: stage {name!r}{where} has {n_bad} non-finite "
            f"value(s)")


def validate_cycle(spec, u, f):
    """Run one V-cycle with stage tracing and finite-checking.

    Returns (u_new, trace) where trace is [(stage, level_size, tensor)],
    the stages on u's device."""
    from mgpoisson_torch.cycle.vcycle import v_cycle
    trace = []
    u_new = v_cycle(u, f, spec.fine_h, spec, trace=trace)
    for name, lsize, arr in trace:
        check_finite(name, arr, lsize)
    check_finite("u_out", u_new)
    return u_new, trace


def compare_traces(ta: Sequence[Tuple], tb: Sequence[Tuple],
                   rtol: float = 1e-6, atol: float = 1e-8) -> List[dict]:
    """Stage-by-stage diff of two cycle traces.

    Returns a report: one dict per stage with the max abs/rel deviation
    and an `ok` flag.  Raises ValueError if the stage structures differ
    (different algorithm paths)."""
    sa = [(n, s) for n, s, _ in ta]
    sb = [(n, s) for n, s, _ in tb]
    if sa != sb:
        raise ValueError(f"trace structures differ: {sa} vs {sb}")
    report = []
    for (name, lsize, a), (_, _, b) in zip(ta, tb):
        a = _host(a).astype(np.float64)
        b = _host(b).astype(np.float64)
        adiff = np.abs(a - b).max() if a.size else 0.0
        scale = max(np.abs(b).max(), 1e-300)
        report.append({
            "stage": name,
            "level_size": lsize,
            "max_abs_diff": float(adiff),
            "max_rel_diff": float(adiff / scale),
            "ok": bool(adiff <= atol + rtol * scale),
        })
    return report


def dump_trace(trace, file=None) -> None:
    """Print a trace in the reference's dump style: the level, the stage
    name, then the grid row by row (a level of side <= 16 in 2D), else
    one summary line."""
    import sys
    out = file or sys.stdout
    for name, lsize, arr in trace:
        print(f"L {lsize}", file=out)
        print(name, file=out)
        a = _host(arr)
        if a.ndim == 2 and lsize <= 16:
            for row in a:
                print(" " + " ".join(f"{v:.17g}" for v in row), file=out)
        else:
            print(f"  shape={a.shape} min={a.min():.6e} max={a.max():.6e} "
                  f"norm={np.sqrt((a * a).sum()):.6e}", file=out)
