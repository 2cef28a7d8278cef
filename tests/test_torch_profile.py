"""mgpoisson_torch.bench.profile: the profiled solve on the CPU."""

from pathlib import Path

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
    assert row["errs"] == res.errs.tolist() and row["errs"][-1] == res.final_err
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


def test_profile_reads_a_packed_bf16_fast_solve(tmp_path, monkeypatch):
    """--scheme fast --dtype bfloat16: the pure bf16 solve with its fine
    level packed (forced on for CPU tensors), one row per kernel_min_size."""
    monkeypatch.setenv("MGPOISSON_PACKED", "1")
    rows = profile.main(["--size", "256", "--scheme", "fast", "--dtype", "bfloat16",
                         "--device", "cpu", "--tol", "1e-30", "--maxiter", "2",
                         "--kernel-min-size", "256", "2", "--out", str(tmp_path)])
    spec = Spec(size=256, dtype="bfloat16", scheme="fast", stop="residual", tol=1e-30,
                maxiter=2)
    res = MultigridPoisson(spec, device="cpu").solve()
    assert [row["kernel_min_size"] for row in rows] == [256, 2]
    for row in rows:
        assert row["packed"] is True and row["dtype"] == "bfloat16"
        assert row["cycles"] == row["profiled_cycles"] == res.iterations == 2
        assert all(v == 0 for v in row["kernel_calls"].values())
    assert rows[0]["final_err"] == res.final_err
    assert (tmp_path / "solve_256_fast_bfloat16_kms2.json").stat().st_size > 0


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
    """bench/ab.py --dtype bfloat16 times the bf16 forms of K1-K12 at the
    2D, 3D and packed sides (the packed ones by default the 2D ones) and on
    the (2, 2) blocks, and clears every f32-only part (K13/K14)."""
    import torch
    from mgpoisson_torch.bench import ab, roofline
    args = ab.parse_args(["--old", "x", "--dtype", "bfloat16", "--sides", "4096", "1024",
                          "--packed", "4096", "--sharded3d", "256", "--sharded-packed",
                          "16384"])
    assert args.dtype == torch.bfloat16 and args.sides == [4096, 1024]
    assert args.sides3d == [256, 512]
    # K9-K12 have bf16 forms: --sharded and --sharded3d stay; K13/K14 are f32 only
    assert (args.sharded, args.sharded3d, args.packed, args.sharded_packed) == (
        16384, 256, [4096], 0)
    args = ab.parse_args(["--old", "x", "--dtype", "bfloat16", "--sides", "4096", "1024"])
    assert args.packed == [4096, 1024]
    assert ab.parse_args(["--old", "x", "--dtype", "bfloat16", "--packed"]).packed == []
    args = ab.parse_args(["--old", "x", "--packed", "4096"])
    assert args.dtype == torch.float32 and args.sharded == 16384 and args.packed == [4096]
    assert ab.parse_args(["--old", "x"]).packed == []
    assert args.sides3d == [256, 512]
    cases, inputs = ab._cases_packed(8, 1, torch.device("cpu"), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in inputs["K8.rnorm"])
    assert set(cases) == {"K7", "K8", "K8.rnorm", "K8 inject", "K8.rnorm inject"}
    cases, inputs = ab._cases_whole(8, "wjacobi", 3, torch.device("cpu"), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in inputs["K3"])
    assert set(cases) == {"K1", "K2", "K2.zero", "K3", "K3.rnorm"}
    cases, inputs = ab._cases_whole3d(8, "wjacobi", 3, torch.device("cpu"), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in inputs["K6"])
    assert set(cases) == {"K4", "K5", "K5.zero", "K6", "K6.rnorm"}
    cases, inputs = ab._cases_sharded(16, torch.device("cpu"), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in roofline.tensors(inputs["K10.rnorm"]))
    assert set(cases) == {"K9", "K9.zero", "K10", "K10.rnorm"}
    cases, inputs = ab._cases_sharded3d(16, "wjacobi", 3, torch.device("cpu"), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in roofline.tensors(inputs["K12.rnorm"]))
    assert set(cases) == {"K11", "K11.zero", "K12", "K12.rnorm"}


def test_ab_sizes_the_parents_bf16_packed_partials(monkeypatch):
    """--old-packed-bf16: while the other build runs, the bf16 K8's Sigma
    r^2 partials are sized by the f32 register tile (blocks2d at the halo
    2 nu + 1, a build before the packed word tile); this build's by the
    word tile (kernels.cuda.tile_packed_w)."""
    import torch
    from mgpoisson_torch.bench import ab
    from mgpoisson_torch.kernels import cuda
    assert ab.parse_args(["--old", "x", "--old-packed-bf16"]).old_packed_bf16
    assert not ab.parse_args(["--old", "x"]).old_packed_bf16
    for name in ("load", "TILE_WARPS", "TILE_ROWS", "rnorm_partials",
                 "strip_rnorm_partials", "packed_rnorm_partials"):
        monkeypatch.setattr(cuda, name, getattr(cuda, name))   # restored after the test
    monkeypatch.setattr(ab.build, "build", lambda csrc, root: csrc)
    monkeypatch.setattr(ab.build, "load_library", lambda path: "old library")
    monkeypatch.setattr(ab.build, "load", lambda: "new library")
    builds = ab.Builds(Path("x"), 0, old_packed_bf16=True)
    for n, nu in ((4096, 1), (1024, 3), (256, 2)):
        f32 = cuda.blocks2d(n, n, 2 * nu + 1)
        rows, cols = cuda.tile_packed_w(2 * nu + 1)
        word = -(-n // rows) * -(-(n // 2) // cols)
        assert word != f32
        builds.use("old")
        assert cuda.load() == "old library"
        assert cuda.packed_rnorm_partials(n, n, nu, torch.bfloat16) == f32
        assert cuda.packed_rnorm_partials(n, n, nu) == f32
        builds.use("new")
        assert cuda.packed_rnorm_partials(n, n, nu, torch.bfloat16) == word
        assert cuda.packed_rnorm_partials(n, n, nu) == f32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_packed_bound_counts_u_by_its_black_plane(dtype):
    """The bounds of the packed legs (bench/ab.py, chip_smoke.py) count u's
    black plane only: its red plane is dead on input, the first red step
    overwriting it from the black plane alone.  The plain packed legs give
    the same outputs, bit for bit, whatever u's red plane holds."""
    import importlib.util
    import torch
    from mgpoisson_torch.bench import ab, roofline
    where = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", where)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from mgpoisson_torch.kernels import ops
    dtype = getattr(torch, dtype)
    n, h = 16, 1.0 / 16
    cases, inputs = ab._cases_packed(n, 1, torch.device("cpu"), dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    assert roofline.op_bytes(inputs["K7"], ()) == (n * n // 2 + n * n) * size
    assert roofline.op_bytes(inputs["K8.rnorm"], ()) == (n * n // 2 + n * n + n * n // 4) * size
    g = torch.Generator().manual_seed(5)
    up, fp = (torch.randn((n, n), generator=g).to(dtype) for _ in range(2))
    V = torch.randn((n // 2, n // 2), generator=g).to(dtype)
    assert torch.equal(chip_smoke._black(up), ops._planes(up)[1])
    assert torch.equal(ab._black(up), ops._planes(up)[1])
    other = up.clone()
    other[:, :n // 2] = torch.randn((n, n // 2), generator=g).to(dtype) * 1e3
    for nu in (1, 3):
        for a, b in zip(ops.packed_smooth_residual_restrict(up, fp, h, nu),
                        ops.packed_smooth_residual_restrict(other, fp, h, nu)):
            assert torch.equal(a, b)
        for kind in ("inject", "bilinear"):
            a, a2 = ops.packed_prolong_correct_smooth_rnorm(up, fp, V, h, nu, kind)
            b, b2 = ops.packed_prolong_correct_smooth_rnorm(other, fp, V, h, nu, kind)
            assert torch.equal(a, b) and torch.equal(a2, b2)


def test_packed_order_compares_the_residual_orders():
    """bench/packed_order.py on the CPU: the packed bf16 fast solve with
    the reference's and the pairwise neighbour sum, and unpacked, one row
    each; after one cycle the three iterates' f64 relres agree within the
    bf16 bar, while the bf16 relres, which reads the residual in each
    order, does not."""
    from mgpoisson_torch.bench import packed_order
    rows = packed_order.main(["--size", "256", "--maxiter", "1", "--device", "cpu"])
    assert [(r["packed"], r["order"]) for r in rows] == [(True, "reference"),
                                                         (True, "pairwise"), (False, None)]
    assert all(r["cycles"] == 1 and len(r["relres"]) == 1 for r in rows)
    f64 = [r["f64_relres"] for r in rows]
    assert max(f64) <= 1.05 * min(f64)
    assert rows[0]["relres"] != rows[1]["relres"]


def test_sass_diff_compares_a_renamed_kernel():
    """--rename OLD_FN NEW_FN: the old build's function compared under its
    new name (a kernel whose template argument was dropped); a pair the
    old listing lacks changes nothing."""
    from mgpoisson_torch.bench import sass_diff
    old = {"_Z1kILi16ELb1EEvv": ["NOP", "EXIT"], "_Z1gv": ["EXIT"]}
    new = {"_Z1kILi16EEvv": ["NOP", "EXIT"], "_Z1gv": ["EXIT"]}
    assert [r["function"] for r in sass_diff.compare(old, new)] == ["_Z1gv"]
    renamed = sass_diff.rename(old, [("_Z1kILi16ELb1EEvv", "_Z1kILi16EEvv"), ("_Z1xv", "_Z1yv")])
    rows = sass_diff.compare(renamed, new)
    assert [(r["function"], r["identical"]) for r in rows] == [("_Z1kILi16EEvv", True),
                                                               ("_Z1gv", True)]
    assert "_Z1kILi16ELb1EEvv" in old    # the listing itself is left as it was


def test_ab_times_k4_alone_with_smooth3d():
    """--smooth3d: K4 alone at each --sides3d side over SMOOTH3D_SETTINGS
    (halos 1-4: jacobi nu 1-4, wjacobi nu 1-3, rbgs nu 1-2) in both bcs,
    each case a K4 call whose output is the plain op's on the CPU."""
    import torch
    from mgpoisson_torch.bench import ab
    from mgpoisson_torch.kernels import ops
    assert ab.parse_args(["--old", "x", "--smooth3d"]).smooth3d
    assert not ab.parse_args(["--old", "x"]).smooth3d
    halos = {2 * nu if sm == "rbgs" else nu for sm, nu in ab.SMOOTH3D_SETTINGS}
    assert halos == {1, 2, 3, 4}
    cases, inputs = ab._cases_smooth3d(8, torch.device("cpu"))
    assert len(cases) == 2 * len(ab.SMOOTH3D_SETTINGS) and set(inputs) == set(cases)
    u, f = inputs["K4 rbgs nu=2 face"]
    assert torch.equal(cases["K4 rbgs nu=2 face"](), ops.smooth(u, f, 1.0 / 8, 2, "rbgs", "face"))
