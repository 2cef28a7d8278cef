"""The port's measuring tools against the JAX package's, on the CPU.

mgpoisson_torch.bench.parity, roofline, harness and tune_scheme, and
bench.profile.device_ms.  On the CPU there are no kernels and no device
clock, so these hold what the tools compute and compare, not what they
time: the parity sweep's case list against the JAX sweep's and each
case's plain (reference) side against the JAX xla op the JAX sweep
compares with; the roofline's rows, byte counts and ops against the JAX
report's; the harness's cpu variant against the NumPy oracle; the tune
rows' cycle counts against the JAX solves'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgpoisson
from mgpoisson import oracle
from mgpoisson.bench import parity as jax_parity
from mgpoisson.bench import roofline as jax_roofline
from mgpoisson.cycle.vcycle import v_cycle as jax_v_cycle
from mgpoisson.kernels import get_ops as jax_get_ops
from mgpoisson.kernels import xla
from mgpoisson_torch.bench import harness, parity, profile, roofline, tune_scheme
from mgpoisson_torch.core.rhs import point_charge_rhs
from mgpoisson_torch.cycle.vcycle import v_cycle
from mgpoisson_torch.kernels import ops

# one intra-op thread per process: tier-1 runs six test workers at once
torch.set_num_threads(1)

# the toy sides of the reference-side test: every branch of the sweep at
# 64^2, its fixed sides shrunk from 1024, 2048 and 256^3
TOY = dict(n_wide=32, n_packed=64, n3=16)
TOY_CASES = parity.cases(True, (64,), "cpu", **TOY)
F32_TOL, BF16_TOL = 1e-6, 5e-2     # the JAX package's bf16 bar (ROADMAP Differences)
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _nerr(got, ref):
    """The sweeps' error: max |got - ref| over max |ref|, in f32."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / max(float(np.max(np.abs(ref))), 1e-30))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _sq_sum(r):
    """sum(r^2) of a JAX residual, in f64: the reference for a sum that the
    JAX sweep takes in the case's dtype.  XLA's f32 sum on the CPU is
    itself off the f64 sum by up to 1.6e-6 relative here (shard_pc3d_f32 at
    16^3: 92771368 against 92771516.8), where the port's plain sum of the
    same residual, bit for bit the same cells, reads 92771512."""
    r = np.asarray(r, np.float64)
    return np.asarray([np.sum(r * r)])


def jax_reference(case):
    """What the JAX sweep compares the case's Pallas path with: its xla
    ops on the same draws, unpacked (a sum of r^2 in f64, _sq_sum)."""
    dt = JAX_DT[case.dtype]
    u, f, V = (None if a is None else jnp.asarray(a, dt) for a in case.arrays())
    h, nu = case.h, case.nu
    if case.layout.startswith("packed"):
        if case.leg == "rr":
            us = xla.smooth(u, f, h, nu, "rbgs", "ghost0")
            return us, xla.residual_restrict(us, f, h, "ghost0")
        u2 = xla.smooth(xla.prolong_correct(u, V, case.kind), f, h, nu, "rbgs", "ghost0")
        return u2 if case.leg == "pc" else (u2, _sq_sum(xla.residual(u2, f, h, "ghost0")))
    a = (h, nu, case.smoother, case.bc)
    if case.leg == "smooth":
        return xla.smooth(u, f, *a)
    if case.leg == "rr":
        return xla.smooth_residual_restrict(u, f, *a)
    if case.leg == "rr_zero":
        us = xla.smooth(jnp.zeros_like(f), f, *a)
        return us, xla.residual_restrict(us, f, h, case.bc)
    u2 = xla.prolong_correct_smooth(u, f, V, *a, case.kind)
    if case.leg == "pc":
        return u2
    return u2, _sq_sum(xla.residual(u2, f, h, "ghost0"))


@pytest.fixture(scope="module")
def jax_sweep_names():
    """The JAX sweep's case names at (512,): on the CPU every case fails
    ("Only interpret mode is supported on CPU backend"), so its failures
    are its whole case list."""
    out = jax_parity.run_parity(full=False, sizes=(512,))
    assert out["n_cases"] == 0
    return sorted(out["failures"])


def test_parity_cases_cover_the_jax_sweep(jax_sweep_names):
    port = {c.name: c for c in parity.cases(False, (512,), "cpu")}
    assert len(jax_sweep_names) == 55
    missing = [name for name in jax_sweep_names if name not in port]
    assert not missing
    # the port's own cases: the kernels the JAX list never reaches
    added = sorted(set(port) - set(jax_sweep_names))
    assert {port[name].kernel for name in added} >= {
        "K13", "K14", "K14.rnorm", "K4.bf16", "K5.bf16", "K6.bf16", "K11.bf16",
        "K12.bf16.rnorm", "K5.zero"}
    # every port kernel, f32 and bf16, is on the default sweep
    kernels = {c.kernel.split(".")[0] + (".bf16" if ".bf16" in c.kernel else "")
               for c in port.values()}
    assert kernels == {f"K{i}" for i in range(1, 15)} | {f"K{i}.bf16" for i in range(1, 13)}
    # a TPU geometry named by the JAX sweep is recorded beside the port's kernel
    assert port["packed_rr_512_f32_nu1_bm32"].tpu.startswith("bm=32")
    assert port["packed_rr_512_f32_nu1_bm256"].kernel == "K7"
    assert port["wide_rr_bf16"].kernel == "K2.bf16" and port["wide_rr_bf16"].tpu


def test_parity_full_sweep_adds_the_jax_full_settings():
    """--full: the jacobi nu 7 setting, the face bc and the packed nu 2, as
    the JAX sweep's full list adds them."""
    base = {c.name for c in parity.cases(False, (512, 2048), "cpu")}
    full = {c.name for c in parity.cases(True, (512, 2048), "cpu")}
    assert base < full
    assert {"smooth_2048_bf16_jacobi_face", "pcr_512_f32_jacobi",
            "packed_pcr_2048_bf16_nu2_bm32", "shard_packed_pcr_512_f32_nu2"} <= full - base


@pytest.mark.parametrize("case", TOY_CASES, ids=lambda c: c.name)
def test_parity_reference_side_matches_xla(case):
    got = case.run(ops)
    ref = jax_reference(case)
    tol = BF16_TOL if case.dtype == "bf16" else F32_TOL
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        assert _nerr(_np(g), np.asarray(r, np.float32)) <= tol


def test_parity_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        parity.run_parity(device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        parity.run_parity(full=True, sizes=(64,), device="cpu")


def test_parity_err_is_the_jax_normalized_max():
    ref = torch.tensor([[1.0, -4.0], [2.0, 0.5]])
    got = ref + torch.tensor([[0.0, 0.02], [-0.01, 0.0]])
    assert parity._err(got, ref) == pytest.approx(0.02 / 4.0, rel=1e-6)
    assert parity._err(torch.zeros(3), torch.zeros(3)) == 0.0
    assert parity._err(got.to(torch.bfloat16), ref.to(torch.bfloat16)) <= BF16_TOL


def test_parity_names_the_tpu_packed_stripes():
    """The JAX sweep names its packed cases by the TPU plan's stripe height
    and a forced bm=32: 256 at 512 and 2048 in f32 and bf16, nu 1 and 2."""
    for n in (512, 2048):
        for itemsize in (4, 2):
            for nu in (1, 2):
                assert parity._tpu_packed_stripes(n, nu, itemsize) == [256, 32]
    assert parity._tpu_packed_stripes(64, 1, 4) == [32]      # no TPU plan below 256


@pytest.fixture(scope="module")
def jax_roofline_rows():
    return jax_roofline.report(size=256, dtype="float64", nu=1)


def test_roofline_rows_match_jax(jax_roofline_rows):
    rows = roofline.report(256, "float64", 1, device="cpu")
    assert [r["op"] for r in rows] == [r["op"] for r in jax_roofline_rows]
    for mine, theirs in zip(rows, jax_roofline_rows):
        assert mine["seconds"] > 0 and mine["wall_seconds"] > 0
        assert mine["pct_peak"] is None                          # no peak on the CPU
        if theirs["gbps"] is None:
            assert mine["bytes"] is None and mine["gbps"] is None
            continue
        want = theirs["gbps"] * 1e9 * theirs["seconds"]
        assert abs(mine["bytes"] - want) <= 1e-9 * want
        assert abs(mine["gbps"] * 1e9 * mine["seconds"] - want) <= 1e-9 * want
    assert [r["bytes"] for r in rows[:6]] == [1572864] * 3 + [1703936] * 2 + [1835008]


def test_roofline_entries_match_the_jax_ops():
    """Each row's op at 64^2 f64 against the JAX report's (its ops from
    get_ops: the xla ops on the CPU; its V-cycle)."""
    n, nu = 64, 2
    spec = mgpoisson.Spec(size=n, dtype="float64", scheme="tuned", backend="auto",
                          pre_smooth=nu, post_smooth=nu)
    xo, h = jax_get_ops(spec, n), spec.fine_h
    f = jnp.zeros((n, n), jnp.float64).at[n // 2, n // 2].set(-1e6)
    u, V = -f, jnp.zeros((n // 2, n // 2), jnp.float64)
    want = [xo.smooth(u, f, h, nu, "wjacobi", "ghost0"),
            xo.smooth(u, f, h, nu, "rbgs", "ghost0"),
            xo.smooth(u, f, h, nu, "jacobi", "ghost0"),
            xo.smooth_residual_restrict(u, f, h, nu, "wjacobi", "ghost0"),
            xo.prolong_correct_smooth(u, f, V, h, nu, "wjacobi", "ghost0", "bilinear"),
            xo.prolong_correct(u, xo.residual_restrict(u, f, h, "ghost0"), "bilinear"),
            jax.jit(lambda u, f: jax_v_cycle(u, f, h, spec))(u, f)]   # eager: 13 s of op compiles
    rows = roofline.entries(n, "float64", nu, "cpu")
    assert len(rows) == len(want)
    for (label, fn, _), w in zip(rows, want):
        got = fn()
        got, w = (got, w) if isinstance(got, tuple) else ((got,), (w,))
        for g, ww in zip(got, w):
            assert _nerr(g.numpy(), np.asarray(ww)) <= 1e-12, label


def test_roofline_peak_is_known_only_on_the_card():
    assert roofline.peak_gbps("cpu") is None
    assert roofline.HBM_PEAK_GBPS["NVIDIA H100 80GB HBM3"] == 3350.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_op_bytes_is_the_bound_count(dtype):
    """op_bytes of K1's, K2's and K3's operands and outputs: the JAX
    roofline's counts, 3 cells and 3 cells + cells/4 of the item size."""
    n = 16
    g = torch.Generator().manual_seed(0)
    u, f, V = (torch.randn((s, s), generator=g).to(dtype) for s in (n, n, n // 2))
    h, cells, item = 1.0 / n, n * n, dtype.itemsize
    a = (h, 3, "wjacobi", "ghost0")
    assert roofline.op_bytes((u, f), ops.smooth(u, f, *a)) == 3 * cells * item
    assert roofline.op_bytes((u, f), ops.smooth_residual_restrict(u, f, *a)) == \
        (3 * cells + cells // 4) * item
    assert roofline.op_bytes((u, f, V), ops.prolong_correct_smooth(u, f, V, *a, "bilinear")) \
        == (3 * cells + cells // 4) * item
    # nested, None and non-tensor operands count nothing more
    assert roofline.op_bytes([(u, None), 3.0], (f,)) == 2 * cells * item


def test_wall_time_harness(tmp_path, capsys):
    out = harness.run_harness([16, 32], ["cpu", "torch"], 1, 2, str(tmp_path), device="cpu")
    lines = (tmp_path / "times.tsv").read_text().splitlines()
    assert lines[0] == "size\tvariant\tseconds_per_vcycle"
    assert len(lines) == 5
    rows = out["rows"]
    assert {(s, v) for s, v, _ in rows} == {(16, "cpu"), (16, "torch"), (32, "cpu"),
                                           (32, "torch")}
    assert all(t > 0 for _, _, t in rows)
    capsys.readouterr()
    out = harness.run_harness([16], ["cuda"], 1, 1, str(tmp_path / "c"), device="cpu")
    if not torch.cuda.is_available():
        assert out["rows"] == []
        assert "variant=cuda: skipped (needs a CUDA device" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown variant"):
        harness.run_harness([16], ["nope"], 1, 1, str(tmp_path / "n"), device="cpu")


def test_harness_cpu_variant_is_the_oracle_cycle():
    n = 32
    f = oracle.point_charge_rhs(n)
    want = oracle.v_cycle(-f, f, 1.0 / n, pre_smooth=2, post_smooth=2, smoother="rbgs",
                          scheme="tuned")
    spec = harness.variant_spec("cpu", n)
    ft = point_charge_rhs(n, 2, torch.float64, "cpu")
    assert np.array_equal(ft.numpy(), f)
    got = v_cycle(-ft, ft, 1.0 / n, spec)
    assert _nerr(got.numpy(), want) <= 1e-12


def test_harness_variants_are_the_jax_ladder():
    assert harness.variant_spec("cuda", 64).kernel_min_size == 2
    assert harness.variant_spec("cuda", 64).backend == "cuda"
    assert harness.variant_spec("auto", 64).kernel_min_size == 256
    assert harness.variant_spec("torch", 64).backend == "torch"
    assert harness.variant_spec("cpu", 64).dtype == "float64"
    with pytest.raises(ValueError):
        harness.variant_spec("native", 64)


@pytest.fixture(scope="module")
def jax_tune_counts():
    counts = {}
    for sm, pre, post in tune_scheme.CANDIDATES:
        res = mgpoisson.MultigridPoisson(mgpoisson.Spec(
            size=64, dtype="float64", scheme="tuned", smoother=sm, pre_smooth=pre,
            post_smooth=post, backend="xla", stop="residual", tol=1e-10)).solve()
        counts[(sm, f"{pre}+{post}")] = int(res.iterations) if res.converged else -1
    return counts


def test_tune_counts_match_jax(jax_tune_counts):
    rows = tune_scheme.tune(64, dtype="float64", device="cpu")
    assert [(r["smoother"], r["nu"]) for r in rows] == list(jax_tune_counts)
    for row in rows:
        assert "error" not in row
        assert row["cycles"] == jax_tune_counts[(row["smoother"], row["nu"])]
        assert row["vcycle_ms"] > 0 and row["vcycle_wall_ms"] > 0 and row["solve_wall_s"] > 0
        assert row["cycles_x_vcycle_ms"] == row["cycles"] * row["vcycle_ms"]


def test_tune_reports_a_failing_candidate(capsys):
    """A candidate that raises gets "error" in its row, and the sweep goes
    on: here the solver's refusal of a card that is not there."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    rows = tune_scheme.tune(64, dtype="float64", device="cuda")
    assert len(rows) == 4 and all(r["error"].startswith("RuntimeError") for r in rows)
    assert capsys.readouterr().out.count('"error"') == 4


def test_device_ms_is_not_a_host_clock():
    """No device events on the CPU: device_ms raises, and the tools take
    the host clock there (call_ms, wall_ms)."""
    with pytest.raises(ValueError, match="no device events"):
        profile.device_ms(lambda: None, device="cpu")
    x = torch.ones(64)
    assert profile.call_ms(lambda: x * 2, "cpu", reps=3) > 0
    assert profile.wall_ms(lambda: x * 2, "cpu", reps=3) > 0


def _capture(n, head=True, tail=True, name="k"):
    """A fake profiler capture: n device events of 1 us each (named in turn
    from `name`, a name or a tuple of names), between runs of spin kernels
    at its head and tail (either one lost)."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType

    def ev(name, start, end):
        return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                               time_range=SimpleNamespace(start=start, end=end))
    evs = [ev("spin", 0.0, 0.5)] if head else []
    names = (name,) if isinstance(name, str) else name
    evs += [ev(names[i % len(names)], 1.0 + 2 * i, 2.0 + 2 * i) for i in range(n)]
    evs += [ev("spin", 2.0 + 2 * n, 2.5 + 2 * n)] if tail else []
    return SimpleNamespace(events=lambda: evs)


@pytest.fixture
def fake_profiler(monkeypatch):
    """profile.trace yields the captures put in the returned list, in turn;
    no spin kernel is launched and nothing synchronised."""
    import contextlib
    queue = []

    @contextlib.contextmanager
    def fake_trace(device, out=None, host=True):
        yield queue.pop(0)

    monkeypatch.setattr(profile, "trace", fake_trace)
    monkeypatch.setattr(profile, "_sentinels", lambda: None)
    monkeypatch.setattr(profile, "_sync", lambda device: None)
    return queue


def test_device_ms_reads_only_whole_captures(fake_profiler):
    """A capture counts only where it kept some spin kernels before and
    after the calls; whole captures are taken until two hold the same
    number of device events and none held more, and their mean busy time
    over reps is the reading.  Without such a pair in TRIES captures, or
    with no event in the spin kernels' own capture, device_ms raises."""
    # the spin kernels' name, a capture that lost its tail run, a short
    # whole one, two full ones: 4 events of 1 us over 2 calls
    fake_profiler[:] = [_capture(0), _capture(4, tail=False), _capture(3), _capture(4),
                        _capture(4)]
    assert profile.device_ms(lambda: None, reps=2) == pytest.approx(4e-3 / 2)
    assert not fake_profiler
    fake_profiler[:] = [_capture(0)] + [_capture(n) for n in range(1, 9)]   # none repeats
    with pytest.raises(RuntimeError, match="no two whole captures .* most seen: 8"):
        profile.device_ms(lambda: None, reps=2)
    fake_profiler[:] = [_capture(0)] + [_capture(4, head=False)] * 8
    with pytest.raises(RuntimeError, match="most seen: 0"):
        profile.device_ms(lambda: None, reps=2)
    # the spin kernels' own capture is taken again while it holds nothing
    fake_profiler[:] = [_capture(0, head=False, tail=False), _capture(0), _capture(2),
                        _capture(2)]
    assert profile.device_ms(lambda: None, reps=2) == pytest.approx(2e-3 / 2)
    fake_profiler[:] = [_capture(0, head=False, tail=False)] * profile.TRIES
    with pytest.raises(RuntimeError, match="held no device event"):
        profile.device_ms(lambda: None, reps=2)


def test_kernel_ms_reads_the_mg_kernels_of_the_same_captures(fake_profiler):
    """kernel_ms takes device_ms's whole captures, under the same policy on
    lost events, and reads the mg_* kernels' time in them (template
    instances too), not the plain ops'; it raises where the calls launched
    no mg_* kernel, and on the CPU."""
    both = ("void mg_smooth<3, true>(float*)", "plain")
    fake_profiler[:] = [_capture(0), _capture(4, name=both, tail=False), _capture(4, name=both),
                        _capture(4, name=both)]
    assert profile.kernel_ms(lambda: None, reps=2) == pytest.approx(2e-3 / 2)
    assert not fake_profiler
    fake_profiler[:] = [_capture(0), _capture(4, name=both), _capture(4, name=both)]
    assert profile.device_ms(lambda: None, reps=2) == pytest.approx(4e-3 / 2)
    fake_profiler[:] = [_capture(0), _capture(2), _capture(2)]
    with pytest.raises(RuntimeError, match="no mg_\\* kernel"):
        profile.kernel_ms(lambda: None, reps=2)
    fake_profiler[:] = [_capture(0)] + [_capture(4, name=both, head=False)] * profile.TRIES
    with pytest.raises(RuntimeError, match="kernel_ms: no two whole captures"):
        profile.kernel_ms(lambda: None, reps=2)
    with pytest.raises(ValueError, match="no device events"):
        profile.kernel_ms(lambda: None, device="cpu")
