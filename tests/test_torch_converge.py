"""The port's convergence study (``mgpoisson_torch.bench.converge``) against
the JAX package's (``mgpoisson.bench.converge``), on the CPU.

``run_study(16, "tuned", [all five solvers], 1e-10)`` on both: multigrid's
cycle count and per-cycle ||psi||_inf, and each Krylov solver's count and
per-iteration ||x||_inf.  BiCGStab's count is not held: its history
follows the rounding of its operations (48 iterations in the JAX package,
50 in the port at this point charge; tests/test_torch_krylov.py), so its
history is held through BICG_TRACK iterations and its x to multigrid's.
Then ``write_outputs``' 16.txt against the JAX package's file, and the CLI,
both without matplotlib as on the card's machine.
"""

import sys

import numpy as np
import pytest

from mgpoisson.bench import converge as jax_converge
from mgpoisson_torch.bench import converge

SOLVERS = ["cg", "cr", "bicgstab", "gmres", "mgcg"]
NORM_RTOL = 1e-10     # ||psi||_inf per multigrid cycle, relative
XNORM_RTOL = 1e-6     # ||x||_inf per Krylov iteration, relative
BICG_TRACK = 20
GATE = 1e-8           # a Krylov psi against multigrid's, normalized (tests/test_krylov.py)


@pytest.fixture(scope="module")
def studies():
    """(JAX study, port study), each run once per module."""
    args = (16, "tuned", SOLVERS, 1e-10)
    return jax_converge.run_study(*args), converge.run_study(*args, device="cpu")


def test_multigrid_matches_jax(studies):
    want, got = studies
    assert got["mg_iterations"] == want["mg_iterations"]
    assert len(got["mg_norms"]) == got["mg_iterations"]
    np.testing.assert_allclose(got["mg_norms"], want["mg_norms"], rtol=NORM_RTOL)
    np.testing.assert_allclose(got["psi_mg"], want["psi_mg"], rtol=0,
                               atol=1e-12 * np.abs(want["psi_mg"]).max())


@pytest.mark.parametrize("name", SOLVERS)
def test_krylov_solver_matches_jax(name, studies):
    want, got = studies[0]["krylov"][name], studies[1]["krylov"][name]
    assert got["converged"] and want["converged"]
    k = BICG_TRACK if name == "bicgstab" else want["iterations"]
    if name != "bicgstab":
        assert got["iterations"] == want["iterations"]
    assert got["xnorms"].shape == got["residuals"].shape == (got["iterations"],)
    np.testing.assert_allclose(got["xnorms"][:k], want["xnorms"][:k], rtol=XNORM_RTOL)
    psi_mg = studies[1]["psi_mg"]
    assert np.abs(got["psi"] - psi_mg).max() / np.abs(psi_mg).max() < GATE


@pytest.fixture
def no_matplotlib(monkeypatch):
    """As on the card's machine: no matplotlib, so write_outputs writes
    the TSV and prints "plots skipped"."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_write_outputs_matches_jax_file(studies, tmp_path, no_matplotlib, capsys):
    converge.write_outputs(studies[1], str(tmp_path / "port"))
    assert capsys.readouterr().out.startswith("plots skipped")
    jax_converge.write_outputs(studies[0], str(tmp_path / "jax"))
    got = (tmp_path / "port" / "16.txt").read_text().splitlines()
    want = (tmp_path / "jax" / "16.txt").read_text().splitlines()
    assert got[0] == want[0] == "\t".join(["multigrid"] + SOLVERS)
    assert len(got) == len(want)
    assert all(len(row.split("\t")) == len(SOLVERS) + 1 for row in got[1:])


def test_main_runs(tmp_path, no_matplotlib, capsys):
    converge.main(["--sizes", "4,8", "--out", str(tmp_path)], device="cpu")
    assert (tmp_path / "4.txt").exists() and (tmp_path / "8.txt").exists()
    out = capsys.readouterr().out
    assert "solving for size 8" in out and "cg: iters=33" in out
