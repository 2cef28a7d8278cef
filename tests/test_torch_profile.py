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


def test_device_summary_counts_the_templated_kernels():
    """Device events of a trace: the union of their intervals, and the time
    in the mg_* kernels, whose template instances the trace names
    "void mg_..<..>(..)", the packed strip kernels of a sharded fast solve
    among them."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType

    def ev(name, start, end):
        return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                               time_range=SimpleNamespace(start=start, end=end))

    prof = SimpleNamespace(events=lambda: [
        ev("void mg_smooth_rr_kernel<false>(float const*)", 0.0, 10.0),
        ev("mg_packed_rr_kernel(float const*)", 5.0, 15.0),
        ev("void at::native::elementwise_kernel<128, 2>()", 20.0, 30.0),
        ev("mg_sharded_packed_rr_kernel(float const*, MgpRows, MgpStrips)", 30.0, 40.0)])
    assert profile.device_summary(prof) == (4, 0.035, 0.03)


def test_sass_diff_compares_the_shared_functions():
    """mgpoisson_torch.bench.sass_diff on two cuobjdump listings: the
    functions both hold, same code whatever the addresses and encodings."""
    from mgpoisson_torch.bench import sass_diff

    def listing(*funcs):
        lines = ["Fatbin elf code:", "================"]
        for name, code in funcs:
            lines.append(f"        Function : {name}")
            lines += [f"        /*{16 * k:04x}*/   {op} ;   /* 0x{k:016x} */"
                      for k, op in enumerate(code)]
        return "\n".join(lines)

    k2 = ("_Z19mg_smooth_rr_kernelPKfS0_PfS1_iiiiifff", ["LDC R1, c[0x0][0x28]", "EXIT"])
    old = sass_diff.functions(listing(k2, ("_Z4gonev", ["EXIT"])))
    new = sass_diff.functions(listing(k2, ("_Z4morev", ["NOP", "EXIT"]),
                                      ("_Z4gonev", ["IADD3 R0, R1, 0x1, RZ", "EXIT"])))
    assert old[k2[0]] == ["LDC R1, c[0x0][0x28]", "EXIT"]
    assert sass_diff.compare(old, new) == [
        {"function": k2[0], "instructions_old": 2, "instructions_new": 2, "identical": True},
        {"function": "_Z4gonev", "instructions_old": 1, "instructions_new": 2,
         "identical": False, "differing": 2,
         "first_differences": [[0, "EXIT", "IADD3 R0, R1, 0x1, RZ"]], "registers_only": False}]


def test_sass_diff_tells_a_register_renaming():
    """Code that differs only in which registers it was given is flagged
    registers_only; a changed instruction, immediate or operand kind is
    not."""
    from mgpoisson_torch.bench import sass_diff
    old = ["S2R R19, SR_TID.X", "IMAD R23, R19, UR4, -R5", "@!P1 STG.E [R23], R19", "EXIT"]
    renamed = ["S2R R7, SR_TID.X", "IMAD R9, R7.reuse, UR4, -R5", "@!P0 STG.E [R9], R7",
               "EXIT"]
    changed = ["S2R R7, SR_TID.X", "IMAD R9, R7, 0x4, -R7", "@!P0 STG.E [R9], R7", "EXIT"]
    rows = sass_diff.compare({"f": old, "g": old}, {"f": renamed, "g": changed})
    assert [(r["identical"], r["registers_only"]) for r in rows] == [(False, True),
                                                                     (False, False)]


@pytest.mark.parametrize("flags,dtype,sweep", [
    (["--sweep-dtype", "bfloat16"], "float32", "bfloat16"),
    (["--dtype", "bfloat16", "--tol", "1e-30", "--maxiter", "3"], "bfloat16", None)])
def test_profile_reads_the_bf16_solves(flags, dtype, sweep, tmp_path):
    """--sweep-dtype: the mixed-precision refinement solve (one row per
    kernel_min_size, a refinement step per cycle); --dtype bfloat16 with
    --maxiter: the pure bf16 solve, which levels off."""
    args = ["--size", "32", "--device", "cpu", "--tol", "1e-6", "--out", str(tmp_path)]
    row = profile.main(args + flags)[0]
    spec = Spec(size=32, dtype=dtype, sweep_dtype=sweep, scheme="tuned", stop="residual",
                tol=1e-30 if sweep is None else 1e-6, maxiter=3 if sweep is None else 1000)
    res = MultigridPoisson(spec, device="cpu").solve()
    assert (row["dtype"], row["sweep_dtype"]) == (dtype, sweep)
    assert row["cycles"] == row["profiled_cycles"] == res.iterations
    assert row["final_err"] == res.final_err
    assert row["converged"] is (sweep is not None)
    tag = "_sweep_bfloat16" if sweep else "_bfloat16"
    assert (tmp_path / f"solve_32{tag}_kms256.json").stat().st_size > 0


@pytest.mark.parametrize("flags,tag", [
    (["--sweep-dtype", "bfloat16", "--tol", "1e-6"], "_3d_sweep_bfloat16"),
    (["--dtype", "bfloat16", "--tol", "1e-30", "--maxiter", "2"], "_3d_bfloat16")])
def test_profile_reads_the_3d_bf16_solves(flags, tag, tmp_path):
    """The mixed and the pure bf16 solves of a cube: rows of a 3D cell,
    traces named as one."""
    row = profile.main(["--size", "16", "--ndim", "3", "--device", "cpu", "--out",
                        str(tmp_path)] + flags)[0]
    mixed = "--sweep-dtype" in flags
    spec = Spec(size=16, ndim=3, dtype="float32" if mixed else "bfloat16",
                sweep_dtype="bfloat16" if mixed else None, scheme="tuned", stop="residual",
                tol=1e-6 if mixed else 1e-30, maxiter=1000 if mixed else 2)
    res = MultigridPoisson(spec, device="cpu").solve()
    assert (row["size"], row["ndim"], row["dtype"]) == (16, 3, spec.dtype)
    assert row["cycles"] == res.iterations and row["final_err"] == res.final_err
    assert all(v == 0 for v in row["kernel_calls"].values())
    assert (tmp_path / f"solve_16{tag}_kms256.json").stat().st_size > 0


def test_ab_takes_the_bf16_forms_only():
    """bench/ab.py --dtype bfloat16 times the bf16 forms of K1-K6 at the 2D
    and 3D sides and clears every f32-only part."""
    import torch
    from mgpoisson_torch.bench import ab
    args = ab.parse_args(["--old", "x", "--dtype", "bfloat16", "--sides", "4096", "1024",
                          "--packed", "4096", "--sharded3d", "256"])
    assert args.dtype == torch.bfloat16 and args.sides == [4096, 1024]
    assert args.sides3d == [256, 512]
    assert (args.sharded, args.sharded3d, args.packed, args.sharded_packed) == (0, 0, [], 0)
    args = ab.parse_args(["--old", "x", "--packed", "4096"])
    assert args.dtype == torch.float32 and args.sharded == 16384 and args.packed == [4096]
    assert args.sides3d == [256, 512]
    cases, inputs = ab._cases_whole(8, "wjacobi", 3, torch.device("cpu"), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in inputs["K3"])
    assert set(cases) == {"K1", "K2", "K2.zero", "K3", "K3.rnorm"}
    cases, inputs = ab._cases_whole3d(8, "wjacobi", 3, torch.device("cpu"), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in inputs["K6"])
    assert set(cases) == {"K4", "K5", "K5.zero", "K6", "K6.rnorm"}
