"""Multigrid-vs-Krylov convergence study (port of
``mgpoisson/bench/converge.py``): the rebuild of
`test/converge-multigrid-vs-krylov.lua`, the reference's correctness gate
(agreement between two unrelated solver families).

Per size (reference: {4,8,16,32,64,128}, `:15`):
- run multigrid recording the per-iteration solution L-inf norm via the
  errorCallback hook (`:19-29`)
- run CG (and optionally CR / BiCGStab / GMRES / MGCG) against the same
  matrix-free zero-ghost 5-point operator (`:46-58`)
- emit converge/<size>.txt (per-iteration columns) and, with
  matplotlib, the three reference plots: log-y convergence curves,
  solution surfaces for both methods, and the log-scale |difference|
  surface (`:87-125`); without matplotlib it prints "plots skipped"
- print how far each Krylov solution is from multigrid's (the gate)

On the card (the default): multigrid with backend 'auto', so the CUDA
kernels run at levels of side >= kernel_min_size in the dtypes that have
them (f32, bf16) and the plain ops elsewhere; the Krylov solvers run the
plain operator.

Usage: python -m mgpoisson_torch.bench.converge [--sizes 4,8,16,32,64,128]
          [--scheme reference|tuned] [--solvers cg,cr,bicgstab,gmres,mgcg]
          [--out converge]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np

from mgpoisson_torch import MultigridPoisson, Spec
from mgpoisson_torch.compare import krylov


def _np(t) -> np.ndarray:
    return t.detach().double().cpu().numpy()


def run_study(size: int, scheme: str = "reference",
              solvers: List[str] = ("cg",), epsilon: float = 1e-12,
              dtype: str = "float64", device="cuda") -> Dict:
    spec = Spec(size=size, dtype=dtype, scheme=scheme, tol=epsilon,
                maxiter=2000, backend="auto")
    mg = MultigridPoisson(spec, device=device)
    f = mg.rhs()

    mg_norms = []   # ||psi||_inf per iteration — the reference's metric
    mg_errs = []    # the stopping metric (update RMS), kept alongside

    def cb(it, err, psi):
        # the reference hook records ||psi||_inf per iteration by
        # closing over the live solver (`:23-27`); here the iterate is
        # passed to the 3-parameter callback directly
        mg_errs.append(err)
        mg_norms.append(float(psi.abs().max()))
        return False

    res = mg.solve(error_callback=cb)
    psi_mg = _np(res.psi)

    A = krylov.poisson_operator(spec.fine_h)
    out = {"size": size, "mg_norms": mg_norms, "mg_errs": mg_errs,
           "mg_iterations": res.iterations, "psi_mg": psi_mg, "krylov": {}}
    for name in solvers:
        fn = {"cg": krylov.cg, "cr": krylov.conjugate_residual,
              "bicgstab": krylov.bicgstab, "gmres": krylov.gmres,
              "mgcg": krylov.pcg}[name]
        kw = {"M": krylov.mg_preconditioner(spec)} \
            if name == "mgcg" else {}
        kres = fn(A, f, tol=epsilon, maxiter=50 * size, **kw)
        out["krylov"][name] = {
            "iterations": kres.iterations,
            "converged": kres.converged,
            "residuals": _np(kres.residuals),
            "xnorms": _np(kres.xnorms),
            "psi": _np(kres.x),
        }
    return out


def write_outputs(study: Dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    size = study["size"]

    # per-iteration TSV (reference writes converge/<size>.txt, `:87`);
    # columns are per-iteration ||psi||_inf for every solver — the
    # reference's recorded quantity (`:24-27,59-67`)
    path = os.path.join(out_dir, f"{size}.txt")
    cols = [study["mg_norms"]] + [list(v["xnorms"])
                                  for v in study["krylov"].values()]
    depth = max(len(c) for c in cols)
    with open(path, "w") as fh:
        fh.write("\t".join(["multigrid"] + list(study["krylov"])) + "\n")
        for i in range(depth):
            fh.write("\t".join(
                f"{c[i]:.6e}" if i < len(c) else "nan" for c in cols) + "\n")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        # log-y curves of the recorded ||psi||_inf (`:98-108`), plus a
        # second panel with the convergence metrics (update-RMS /
        # relative residual) the reference prints but does not plot
        fig, (ax, ax2) = plt.subplots(1, 2, figsize=(11, 4))
        ax.semilogy(range(1, len(study["mg_norms"]) + 1), study["mg_norms"],
                    label="multigrid")
        for name, v in study["krylov"].items():
            ax.semilogy(range(1, len(v["xnorms"]) + 1), v["xnorms"],
                        label=name)
        ax.set_xlabel("iteration")
        ax.set_ylabel(r"$\|\psi\|_\infty$")
        ax.set_title(f"solution norm, size {size}")
        ax.legend()
        ax2.semilogy(range(1, len(study["mg_errs"]) + 1), study["mg_errs"],
                     label="multigrid (update RMS)")
        for name, v in study["krylov"].items():
            ax2.semilogy(range(1, len(v["residuals"]) + 1), v["residuals"],
                         label=f"{name} (rel. residual)")
        ax2.set_xlabel("iteration")
        ax2.set_ylabel("convergence metric")
        ax2.set_title("stopping metrics")
        ax2.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir,
                                 f"{size}-multigrid-vs-krylov.png"), dpi=120)
        plt.close(fig)

        # solution surfaces (`:110-117`) + |diff| surface (`:119-125`)
        first = next(iter(study["krylov"].values()), None)
        if first is not None and study["psi_mg"].ndim == 2:
            fig = plt.figure(figsize=(12, 4))
            for i, (title, Z) in enumerate([
                    ("multigrid", study["psi_mg"]),
                    (next(iter(study["krylov"])), first["psi"]),
            ]):
                axp = fig.add_subplot(1, 3, i + 1, projection="3d")
                X, Y = np.meshgrid(range(size), range(size))
                axp.plot_surface(X, Y, Z, cmap="viridis")
                axp.set_title(title)
            axd = fig.add_subplot(1, 3, 3, projection="3d")
            X, Y = np.meshgrid(range(size), range(size))
            diff = np.abs(first["psi"] - study["psi_mg"]) + 1e-30
            axd.plot_surface(X, Y, np.log10(diff), cmap="magma")
            axd.set_title("log10 |difference|")
            fig.savefig(os.path.join(out_dir, f"{size}-result.png"), dpi=120)
            plt.close(fig)
    except Exception as e:
        print(f"plots skipped ({e})")


def main(argv=None, device="cuda"):
    """The CLI; `device` is where the study runs (the card; the tests pass
    "cpu")."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sizes", default="4,8,16,32,64,128")
    p.add_argument("--scheme", default="reference",
                   choices=["reference", "tuned"])
    p.add_argument("--solvers", default="cg")
    p.add_argument("--epsilon", type=float, default=1e-12)
    p.add_argument("--out", default="converge")
    args = p.parse_args(argv)

    for size in (int(s) for s in args.sizes.split(",")):
        print(f"solving for size {size}")
        study = run_study(size, args.scheme, args.solvers.split(","),
                          args.epsilon, device=device)
        write_outputs(study, args.out)
        for name, v in study["krylov"].items():
            d = np.abs(v["psi"] - study["psi_mg"]).max()
            scale = max(np.abs(study["psi_mg"]).max(), 1e-30)
            print(f"  {name}: iters={v['iterations']} "
                  f"max|diff|/max|psi| = {d / scale:.3e}")


if __name__ == "__main__":
    main()
