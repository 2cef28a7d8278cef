"""The pure bf16 fast solve with the packed residual's neighbour sum in two
orders.

    python3 -m mgpoisson_torch.bench.packed_order [--size 4096] [--maxiter 12]
        [--device cuda]

Runs ``Spec(size, scheme="fast", dtype="bfloat16", stop="residual",
tol=1e-30, maxiter)`` three times, the packed legs on their plain versions
(``kernels.ops``, which the bf16 forms of K7/K8 equal bit for bit), every
other leg as the solver runs it: packed, with the packed
residual's neighbour sum in the reference's order, ((up + dn) + same) +
partner (``mgpoisson/kernels/pallas.py`` ``_packed_residual``, which the
port follows); packed, with it pairwise, (up + dn) + (same + partner), the
grouping of the unpacked residual's sum; and unpacked
(``MGPOISSON_PACKED=0``).  Prints one JSON line per run: the relres of
every cycle and the relres of the returned psi recomputed in f64.  It
measures a question about the reference's arithmetic in bf16; the port
keeps the reference's order.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from unittest import mock

import torch

from mgpoisson_torch.core.spec import Spec
from mgpoisson_torch.kernels import cuda, ops
from mgpoisson_torch.solver.multigrid import MultigridPoisson


def _pairwise_residual(xr, xb, fr, fb, inv_hsq, rows=None):
    """ops._packed_residual with the neighbour sum grouped in pairs."""
    if rows is None:
        rows = ops._rows(0, xr.shape[0], xr.device)
    er = rows % 2 == 0
    nr = ((ops._rows_dn(xb) + ops._rows_up(xb))
          + (xb + torch.where(er, ops._lane_r(xb), ops._lane_l(xb))))
    nb = ((ops._rows_dn(xr) + ops._rows_up(xr))
          + (xr + torch.where(er, ops._lane_l(xr), ops._lane_r(xr))))
    return fr - (nr - 4.0 * xr) * inv_hsq, fb - (nb - 4.0 * xb) * inv_hsq


@contextlib.contextmanager
def _variant(order, packed):
    """The plain packed legs in place of the kernels' wrappers, the packed
    residual in `order`, MGPOISSON_PACKED on or off."""
    patches = [mock.patch.dict(os.environ, {"MGPOISSON_PACKED": "1" if packed else "0"})]
    for name in ("packed_smooth_residual_restrict", "packed_prolong_correct_smooth",
                 "packed_prolong_correct_smooth_rnorm"):
        patches.append(mock.patch.object(cuda, name, getattr(ops, name)))
    if order == "pairwise":
        patches.append(mock.patch.object(ops, "_packed_residual", _pairwise_residual))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield


def run(size, maxiter, device):
    """One row per variant: its relres per cycle and the f64 relres of psi."""
    spec = Spec(size=size, scheme="fast", dtype="bfloat16", stop="residual", tol=1e-30,
                maxiter=maxiter)
    rows = []
    for order, packed in (("reference", True), ("pairwise", True), ("reference", False)):
        with _variant(order, packed):
            mg = MultigridPoisson(spec, device=device)
            res = mg.solve()
        f = mg.rhs().double()
        h = spec.fine_h
        rel64 = float(ops.residual_norm(res.psi.double(), f, h)
                      / ops.residual_norm(-f, f, h))
        rows.append({"size": size, "packed": mg._packed, "order": order if packed else None,
                     "cycles": res.iterations, "relres": res.errs.tolist(),
                     "f64_relres": rel64})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--maxiter", type=int, default=12)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return run(args.size, args.maxiter, args.device)


if __name__ == "__main__":
    main()
