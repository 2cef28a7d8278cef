"""Hand-written CUDA kernels for the hot 2D ops on Hopper (port of the
public entry points of ``mgpoisson/kernels/pallas.py``).

Three kernels, built from ``mgpoisson_torch/csrc`` by
``kernels.build`` at first use, carry the V-cycle:

  K1 ``mg_smooth``                  — ``smooth``
  K2 ``mg_smooth_rr``               — ``smooth_residual_restrict``,
                                      ``smooth_residual_restrict_zero``
  K3 ``mg_prolong_correct_smooth``  — ``prolong_correct_smooth``,
                                      ``prolong_correct_smooth_rnorm``

Each wrapper has the signature of its counterpart in
``kernels.ops`` (the plain version beside it).  A tensor on the CPU goes to
that plain version.  A CUDA tensor launches the kernel, or raises if the
kernel does not take it: f32, 2D, square, contiguous, 0 <= nu <= 8
(<= 4 for rbgs).  Which levels reach these wrappers at all is decided by
one rule, ``mgpoisson_torch.kernels.use_kernels``.  Outputs are fresh
``torch.empty`` buffers (no in-place writes: a tile reads its neighbours'
rows as halo), and launches go on the current stream.

The ops that have no kernel (residual, prolong, coarse_solve, ...) are
the plain ones on every device, as the Pallas module delegates them to
the XLA ops.
"""

from __future__ import annotations

import ctypes

import torch

from mgpoisson_torch.kernels import ops
from mgpoisson_torch.kernels.build import load

SMOOTHERS = {"jacobi": 0, "wjacobi": 1, "rbgs": 2}
BCS = {"ghost0": 0, "face": 1}
PROLONG_KINDS = {"inject": 0, "bilinear": 1}
# per-call sweep cap: the shared-memory halo grows by the dependency
# radius per sweep (1 for the Jacobi variants, 2 for red-black GS)
MAX_NU = {"jacobi": 8, "wjacobi": 8, "rbgs": 4}
TILE = 32   # interior cells per block side; MG_TILE in csrc/stencil.cuh

# Launches per kernel, counted where the wrapper launches it; ".zero" and
# ".rnorm" count the flagged launches among them.  Read and reset by
# chip_smoke.py to show that a run went through the kernels.
launches = dict.fromkeys(("mg_smooth", "mg_smooth_rr", "mg_smooth_rr.zero",
                          "mg_prolong_correct_smooth",
                          "mg_prolong_correct_smooth.rnorm"), 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def supports(n: int, dtype: torch.dtype, nu: int, smoother: str) -> bool:
    """Whether the kernels take an (n, n) level of this dtype with nu
    sweeps of this smoother."""
    return (dtype == torch.float32 and n >= 2 and smoother in MAX_NU
            and 0 <= nu <= MAX_NU[smoother])


def _check(name, u, nu, smoother, bc, *others):
    if u.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {u.device}")
    if u.ndim != 2 or u.shape[0] != u.shape[1]:
        raise ValueError(f"{name}: needs a square 2D array, got {tuple(u.shape)}")
    if not supports(u.shape[0], u.dtype, nu, smoother) or bc not in BCS:
        raise ValueError(f"{name}: no kernel for n={u.shape[0]} {u.dtype} "
                         f"nu={nu} smoother={smoother!r} bc={bc!r}")
    for t, shape in ((u, u.shape), *others):
        if t.device != u.device or t.dtype != u.dtype or t.shape != shape:
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match {tuple(shape)} "
                             f"{u.dtype} on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _scalars(h):
    """1/h^2, 1/adiag and adiag of the 2D 5-point operator, as the plain
    ops use them (adiag = -4/h^2)."""
    hsq = h * h
    adiag = -4.0 / hsq
    return ctypes.c_float(1.0 / hsq), ctypes.c_float(1.0 / adiag), ctypes.c_float(adiag)


def _launch(name, u, *args):
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        lib = load()
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{lib.mg_error_string(rc).decode()}")
    launches[name] += 1


def smooth(u, f, h, nu, smoother="jacobi", bc="ghost0"):
    """nu smoother sweeps in one pass (K1)."""
    if u.device.type == "cpu":
        return ops.smooth(u, f, h, nu, smoother, bc)
    _check("mg_smooth", u, nu, smoother, bc, (f, u.shape))
    if nu == 0:
        return u
    out = torch.empty_like(u)
    inv_hsq, inv_adiag, _ = _scalars(h)
    _launch("mg_smooth", u, u.data_ptr(), f.data_ptr(), out.data_ptr(),
            u.shape[0], nu, SMOOTHERS[smoother], BCS[bc], inv_hsq, inv_adiag)
    return out


def _rr(u, f, h, nu, smoother, bc, zero):
    n = f.shape[0]
    out = torch.empty_like(f)
    R = torch.empty((n // 2, n // 2), dtype=f.dtype, device=f.device)
    inv_hsq, inv_adiag, adiag = _scalars(h)
    _launch("mg_smooth_rr", f, None if zero else u.data_ptr(), f.data_ptr(),
            out.data_ptr(), R.data_ptr(), n, nu, SMOOTHERS[smoother], BCS[bc],
            inv_hsq, inv_adiag, adiag, int(zero))
    if zero:
        launches["mg_smooth_rr.zero"] += 1
    return out, R


def smooth_residual_restrict(u, f, h, nu, smoother="jacobi", bc="ghost0"):
    """nu sweeps, then R = restrict(residual). Returns (u, R) (K2)."""
    if u.device.type == "cpu":
        return ops.smooth_residual_restrict(u, f, h, nu, smoother, bc)
    _check("mg_smooth_rr", u, nu, smoother, bc, (f, u.shape))
    return _rr(u, f, h, nu, smoother, bc, zero=False)


def smooth_residual_restrict_zero(f, h, nu, smoother="jacobi", bc="ghost0"):
    """The down-leg from u identically zero; reads f only (K2, from zero)."""
    if f.device.type == "cpu":
        return ops.smooth_residual_restrict_zero(f, h, nu, smoother, bc)
    _check("mg_smooth_rr", f, nu, smoother, bc)
    return _rr(None, f, h, nu, smoother, bc, zero=True)


def _pc(u, f, V, h, nu, smoother, bc, kind, rnorm):
    if kind not in PROLONG_KINDS:
        raise ValueError(f"mg_prolong_correct_smooth: unknown prolongation {kind!r}")
    n = u.shape[0]
    _check("mg_prolong_correct_smooth", u, nu, smoother, bc, (f, u.shape),
           (V, (n // 2, n // 2)))
    out = torch.empty_like(u)
    tiles = -(-n // TILE)
    partials = (torch.empty(tiles * tiles, dtype=torch.float32, device=u.device)
                if rnorm else None)
    inv_hsq, inv_adiag, adiag = _scalars(h)
    _launch("mg_prolong_correct_smooth", u, u.data_ptr(), f.data_ptr(),
            V.data_ptr(), out.data_ptr(),
            partials.data_ptr() if rnorm else None, n, nu,
            SMOOTHERS[smoother], BCS[bc], PROLONG_KINDS[kind], inv_hsq,
            inv_adiag, adiag, int(rnorm))
    if rnorm:
        launches["mg_prolong_correct_smooth.rnorm"] += 1
    return out, partials


def prolong_correct_smooth(u, f, V, h, nu, smoother="jacobi", bc="ghost0",
                           kind="inject"):
    """u += P(V), then nu sweeps (K3)."""
    if u.device.type == "cpu":
        return ops.prolong_correct_smooth(u, f, V, h, nu, smoother, bc, kind)
    return _pc(u, f, V, h, nu, smoother, bc, kind, rnorm=False)[0]


def prolong_correct_smooth_rnorm(u, f, V, h, nu, smoother="jacobi",
                                 bc="ghost0", kind="inject"):
    """The up-leg and sum(r^2) of the result's zero-ghost residual:
    (u, sum(r^2)).  The kernel writes one f32 partial per block; they are
    summed here in a fixed order (K3 with rnorm)."""
    if u.device.type == "cpu":
        return ops.prolong_correct_smooth_rnorm(u, f, V, h, nu, smoother, bc,
                                                kind)
    out, partials = _pc(u, f, V, h, nu, smoother, bc, kind, rnorm=True)
    return out, torch.sum(partials)


# the ops the cycle also reaches through this module that have no kernel:
# the plain versions on every device
residual = ops.residual
prolong = ops.prolong
prolong_correct = ops.prolong_correct
residual_restrict = ops.residual_restrict
coarse_solve = ops.coarse_solve
