"""mgpoisson_torch.bench.profile: the profiled solve on the CPU."""

import pytest

from mgpoisson_torch import MultigridPoisson, Spec
from mgpoisson_torch.bench import profile


@pytest.mark.parametrize("kms", [256, 2])
def test_profile_rows_match_a_plain_solve(kms, tmp_path, capsys):
    rows = profile.main(["--size", "32", "--device", "cpu", "--tol", "1e-6",
                         "--kernel-min-size", str(kms), "--out", str(tmp_path)])
    assert len(rows) == 1
    row = rows[0]
    spec = Spec(size=32, dtype="float32", scheme="tuned", stop="residual",
                tol=1e-6, kernel_min_size=kms)
    res = MultigridPoisson(spec, device="cpu").solve()
    assert row["cycles"] == row["profiled_cycles"] == res.iterations
    assert row["converged"] is True and row["final_err"] == res.final_err
    assert len(row["cycle_ms"]) == res.iterations
    assert all(v == 0 for v in row["kernel_calls"].values())   # CPU: no kernels
    assert row["device_busy_share"] == "not measured"
    assert (tmp_path / f"solve_32_kms{kms}.json").stat().st_size > 0
    assert '"size": 32' in capsys.readouterr().out


def test_profile_reads_a_packed_fast_solve(tmp_path, monkeypatch):
    """--scheme fast: the packed fine level (forced on for CPU tensors),
    timed through its 2-parameter callback without leaving the packed
    loop."""
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    rows = profile.main(["--size", "256", "--scheme", "fast", "--device", "cpu",
                         "--tol", "1e-8", "--out", str(tmp_path)])
    row = rows[0]
    spec = Spec(size=256, dtype="float32", scheme="fast", stop="residual", tol=1e-8)
    res = MultigridPoisson(spec, device="cpu").solve()
    assert row["scheme"] == "fast" and row["packed"] is True
    assert row["cycles"] == row["profiled_cycles"] == res.iterations
    assert row["final_err"] == res.final_err
    assert all(v == 0 for v in row["kernel_calls"].values())
    assert (tmp_path / "solve_256_fast_kms256.json").stat().st_size > 0


def test_profile_reads_a_3d_solve(tmp_path):
    rows = profile.main(["--size", "16", "--ndim", "3", "--device", "cpu",
                         "--tol", "1e-6", "--out", str(tmp_path)])
    row = rows[0]
    spec = Spec(size=16, ndim=3, dtype="float32", scheme="tuned",
                stop="residual", tol=1e-6)
    res = MultigridPoisson(spec, device="cpu").solve()
    assert row["ndim"] == 3 and row["cycles"] == res.iterations
    assert row["converged"] is True and row["final_err"] == res.final_err
    assert all(v == 0 for v in row["kernel_calls"].values())
    assert row["device_busy_share"] == "not measured"
    assert (tmp_path / "solve_16_3d_kms256.json").stat().st_size > 0
