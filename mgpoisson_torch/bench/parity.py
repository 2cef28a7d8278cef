"""On-device kernel parity sweep (port of ``mgpoisson/bench/parity.py``).

    python3 -m mgpoisson_torch.bench.parity [--full]

The CPU tests hold the plain ops (``kernels.ops``) to the JAX package;
this sweep holds every CUDA kernel (``kernels.cuda``) to those plain ops
on the card where the kernels run, so that a miscompiled branch shows as
a number, not as slower convergence.  The JAX sweep compares each Pallas
path against its XLA formulation; here the plain torch op is the
reference side, run on the same card from the same inputs.

The cases follow the JAX sweep's, case for case and under its names
(``cases``), with the inputs it draws: ``numpy.random.default_rng(seed)
.normal`` with its seeds, cast to the case's dtype.  Where a JAX name
encodes a geometry only the TPU has, the port runs its own kernel under
that name and records the TPU geometry beside it (``Case.tpu``): the
packed stripes ``bm256`` / ``bm32`` (K7/K8 have none), the two-axis
``wide`` blocks (K1-K3, K7/K8 take every side with one tile) and the
packed write-through ``wt`` variants (not ported).  The JAX sweep skips a
case where its TPU planner has no plan (``rr_zero`` below 2048, the packed
cases below 256, the 3D cases below 32 MiB); the port runs every case its
kernels take.  It adds the kernels the JAX list never reaches, named in
its style: the packed strip kernels K13/K14 (``shard_packed_*``), the bf16
forms of K4-K6 and K11/K12 (``*3d_bf16``) and K5 from zero
(``rr3d_zero_*``), so that every port kernel is on one sweep.

Each case's error is the JAX sweep's: the max |kernel - plain| over the
max |plain|, computed on the card, one scalar per output crossing to the
host; a tuple output reports one entry per element, ``name[i]``.  A
case that raises is recorded in ``failures`` and the sweep goes on, so
one run lists every broken path.  The bars are the caller's
(``chip_smoke.py``, phase bench_tools).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from mgpoisson_torch.kernels import cuda, ops
from mgpoisson_torch.shard.spmd import block_from_grid

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the JAX sweep's fixed sides: the wide kernels', the packed wide and
# write-through cases', the 3D cases'
N_WIDE, N_PACKED, N3 = 1024, 2048, 256
# the JAX sweep's per-size settings
SMOOTHERS, SMOOTHERS_FULL = (("wjacobi", 3), ("rbgs", 2)), (("jacobi", 7),)
SHARD = ("wjacobi", 3)
# the TPU's packed plan, which names the JAX sweep's packed cases
# (pallas.py packed_plan and _pick_bm at the default 16 MiB VMEM budget)
_TPU_VMEM_BUDGET = 16 << 20
_TPU_BF16_RBGS_MAX_BM = 256


@dataclasses.dataclass(frozen=True)
class Case:
    """One comparison: what both sides compute (`leg` on `layout`), from
    which seeded inputs, through which port kernel.

    leg: 'smooth', 'rr' (sweeps, residual, restriction), 'rr_zero' (the
    same from u = 0), 'pc' (prolong, correct, sweeps) or 'pcr' (the same
    and sum(r^2) of the zero-ghost residual, reported as a 1-element
    tensor).  layout: 'grid' (the whole-grid op), 'packed' (the packed
    fine level, packed from the inputs and unpacked after), 'block' (the
    whole grid as the one block of a (1, 1) mesh: every edge global, zero
    strips all round), 'block_nocol' (the same without column strips, a
    mesh of one column) or 'packed_block' (the packed grid as one block of
    whole rows).  Every output is compared in the unpacked layout."""

    name: str
    kernel: str
    leg: str
    layout: str
    n: int
    ndim: int
    dtype: str
    seed: int
    seed_v: int | None
    nu: int
    smoother: str
    bc: str = "ghost0"
    kind: str = "inject"
    tpu: str = ""
    device: str = "cuda"

    @property
    def h(self) -> float:
        return 1.0 / self.n

    def arrays(self):
        """(u, f, V) as float64 numpy arrays: the JAX sweep's _mkdata draws
        (V None where the leg has no coarse operand)."""
        u, f = _draws((self.n,) * self.ndim, self.seed)
        V = None if self.seed_v is None else _draws((self.n // 2,) * self.ndim, self.seed_v)[0]
        return u, f, V

    def run(self, m, cache=None):
        """The case through op module m (``kernels.cuda`` or ``kernels.ops``)
        on its device; `cache` keeps the inputs between cases."""
        cache = {} if cache is None else cache
        dt, dev = DTYPES[self.dtype], torch.device(self.device)
        u, f = _tensors((self.n,) * self.ndim, self.seed, dt, dev, cache)
        V = None if self.seed_v is None else _tensors(
            (self.n // 2,) * self.ndim, self.seed_v, dt, dev, cache)[0]
        return _LAYOUTS[self.layout](self, m, u, f, V)


def _draws(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape), rng.normal(size=shape)


def _tensors(shape, seed, dtype, device, cache):
    key = (shape, seed, dtype)
    if key not in cache:
        cache[key] = tuple(torch.from_numpy(a).to(dtype).to(device)
                           for a in _draws(shape, seed))
    return cache[key]


def _r2(out):
    """(u, sum(r^2)) with the sum as a 1-element tensor, as the JAX sweep
    compares it."""
    return out[0], out[1].reshape(1)


def _grid(c, m, u, f, V):
    a = (c.h, c.nu, c.smoother, c.bc)
    if c.leg == "smooth":
        return m.smooth(u, f, *a)
    if c.leg == "rr":
        return m.smooth_residual_restrict(u, f, *a)
    if c.leg == "rr_zero":
        return m.smooth_residual_restrict_zero(f, *a)
    if c.leg == "pc":
        return m.prolong_correct_smooth(u, f, V, *a, c.kind)
    return _r2(m.prolong_correct_smooth_rnorm(u, f, V, *a, c.kind))


def _packed(c, m, u, f, V):
    up, fp = ops.pack_grid(u), ops.pack_grid(f)
    if c.leg == "rr":
        out, R = m.packed_smooth_residual_restrict(up, fp, c.h, c.nu)
        return ops.unpack_grid(out), R
    if c.leg == "pc":
        return ops.unpack_grid(m.packed_prolong_correct_smooth(up, fp, V, c.h, c.nu, c.kind))
    out, r2 = _r2(m.packed_prolong_correct_smooth_rnorm(up, fp, V, c.h, c.nu, c.kind))
    return ops.unpack_grid(out), r2


def _block(c, m, u, f, V):
    cols = c.layout == "block"
    reach = ops.sweep_radius(c.smoother) * c.nu + 1
    (ub, us), (fb, fs) = (block_from_grid(x, (0, 0), x.shape[:2], reach, cols) for x in (u, f))
    b = ((0, 0), c.n, c.h, c.nu, c.smoother, c.bc)
    if c.leg == "rr":
        return m.smooth_rr_sharded(ub, fb, us, fs, *b)
    vb, vs = block_from_grid(V, (0, 0), V.shape[:2], ops.coarse_depth(reach), cols)
    out = m.pc_smooth_sharded(ub, fb, vb, us, fs, vs, *b, c.kind, rnorm=c.leg == "pcr")
    return _r2(out) if c.leg == "pcr" else out


def _packed_block(c, m, u, f, V):
    reach = 2 * c.nu + 1
    (ub, us), (fb, fs) = (block_from_grid(ops.pack_grid(x), (0, 0), x.shape, reach, cols=False)
                          for x in (u, f))
    b = ((0, 0), c.n, c.h, c.nu)
    if c.leg == "rr":
        out, R = m.packed_rr_sharded(ub, fb, us, fs, *b)
        return ops.unpack_grid(out), R
    vb, vs = block_from_grid(V, (0, 0), V.shape, ops.coarse_depth(reach), cols=False)
    out = m.packed_pc_sharded(ub, fb, vb, us, fs, vs, *b, c.kind, rnorm=c.leg == "pcr")
    if c.leg == "pcr":
        out, r2 = _r2(out)
        return ops.unpack_grid(out), r2
    return ops.unpack_grid(out)


_LAYOUTS = {"grid": _grid, "packed": _packed, "block": _block, "block_nocol": _block,
            "packed_block": _packed_block}


def _tpu_packed_stripes(n, nu, itemsize):
    """The stripe heights the JAX sweep names its packed cases by: the TPU
    plan's where it has one, and the forced bm = 32."""
    halo = -(-(2 * nu + 1) // 8) * 8
    cap = min(_TPU_BF16_RBGS_MAX_BM if itemsize < 4 else n, n // 2)
    bm = n
    while bm > 8 and not (bm <= cap and n % bm == 0
                          and 5 * (bm + 2 * halo) * n * itemsize <= _TPU_VMEM_BUDGET):
        bm //= 2
    planned = (n >= 256 and n % 256 == 0 and n // bm >= 2 and bm > 2 * halo
               and bm % 16 == 0 and halo <= 14)
    return [bm, 32] if planned and bm != 32 else [32]


def _k(name, dt, flag=""):
    return name + (".bf16" if dt == "bf16" else "") + flag


def cases(full: bool = False, sizes=(512, 2048), device="cuda", *, n_wide: int = N_WIDE,
          n_packed: int = N_PACKED, n3: int = N3) -> list:
    """The sweep's cases, in the JAX sweep's order, without running any:
    per side in `sizes` and dtype (f32, bf16) the smoother legs (wjacobi
    nu 3, rbgs nu 2, with `full` jacobi nu 7; bc ghost0, with `full` face
    too) and the rnorm up-leg, the strip legs (wjacobi nu 3, with and
    without column strips); the packed legs (nu 1, with `full` 2) and,
    added, the packed strip legs; the from-zero down-leg; then the packed
    wide and write-through names at n_packed (f32), the wide names at
    n_wide, the 3D legs and their strip legs at n3 (f32, and added, bf16
    and K5 from zero).  A case is included where the port's kernel takes
    it (``cuda.supports``, ``packed_supports``, ``sharded_supports``)."""
    dev = str(torch.device(device))
    out = []

    def add(name, kernel, leg, layout, n, dt, seed, seed_v, nu, smoother, bc="ghost0",
            kind="inject", tpu="", ndim=2):
        out.append(Case(name, kernel, leg, layout, n, ndim, dt, seed, seed_v, nu, smoother,
                        bc, kind, tpu, dev))

    settings = SMOOTHERS + (SMOOTHERS_FULL if full else ())
    bcs = ("ghost0", "face") if full else ("ghost0",)
    for n in sizes:
        for dt, dtype in DTYPES.items():
            for sm, nu in settings:
                if not cuda.supports(n, dtype, nu, sm):
                    continue
                for bc in bcs:
                    tag = f"{n}_{dt}_{sm}_{bc}"
                    kind = "bilinear" if bc == "face" else "inject"
                    add(f"smooth_{tag}", _k("K1", dt), "smooth", "grid", n, dt, 0, None,
                        nu, sm, bc)
                    add(f"rr_{tag}", _k("K2", dt), "rr", "grid", n, dt, 0, None, nu, sm, bc)
                    add(f"pc_{tag}", _k("K3", dt), "pc", "grid", n, dt, 0, 3, nu, sm, bc, kind)
                add(f"pcr_{n}_{dt}_{sm}", _k("K3", dt, ".rnorm"), "pcr", "grid", n, dt, 0, 3,
                    nu, sm)
            sm, nu = SHARD
            if cuda.sharded_supports(2, dtype) and cuda.supports(n, dtype, nu, sm):
                add(f"shard_rr_{n}_{dt}", _k("K9", dt), "rr", "block", n, dt, 5, None, nu, sm)
                add(f"shard_rr_nocol_{n}_{dt}", _k("K9", dt), "rr", "block_nocol", n, dt, 5,
                    None, nu, sm)
                add(f"shard_pc_nocol_{n}_{dt}", _k("K10", dt), "pc", "block_nocol", n, dt, 5, 6,
                    nu, sm, kind="bilinear")
    for n in sizes:
        for dt, dtype in DTYPES.items():
            for nu in ((1, 2) if full else (1,)):
                if not cuda.packed_supports(n, dtype, nu):
                    continue
                for bm in _tpu_packed_stripes(n, nu, dtype.itemsize):
                    tag = f"{n}_{dt}_nu{nu}_bm{bm}"
                    tpu = f"bm={bm} stripes (the port's packed tile has none)"
                    add(f"packed_rr_{tag}", _k("K7", dt), "rr", "packed", n, dt, 11, None, nu,
                        "rbgs", tpu=tpu)
                    for kind in ("inject", "bilinear"):
                        add(f"packed_pc_{kind}_{tag}", _k("K8", dt), "pc", "packed", n, dt, 11,
                            12, nu, "rbgs", kind=kind, tpu=tpu)
                    add(f"packed_pcr_{tag}", _k("K8", dt, ".rnorm"), "pcr", "packed", n, dt, 11,
                        12, nu, "rbgs", tpu=tpu)
                if dt == "f32":
                    # the port's own: the packed strip kernels on the grid as
                    # one block of whole rows
                    tag = f"{n}_f32_nu{nu}"
                    add(f"shard_packed_rr_{tag}", "K13", "rr", "packed_block", n, dt, 11, None,
                        nu, "rbgs")
                    add(f"shard_packed_pc_bilinear_{tag}", "K14", "pc", "packed_block", n, dt,
                        11, 12, nu, "rbgs", kind="bilinear")
                    add(f"shard_packed_pcr_{tag}", "K14.rnorm", "pcr", "packed_block", n, dt,
                        11, 12, nu, "rbgs")
    for n in sizes:
        for dt, dtype in DTYPES.items():
            if cuda.supports(n, dtype, 3, "wjacobi"):
                add(f"rr_zero_{n}_{dt}", _k("K2", dt, ".zero"), "rr_zero", "grid", n, dt, 13,
                    None, 3, "wjacobi")
    n = n_packed
    if cuda.packed_supports(n, torch.float32, 1):
        for what, tpu in (("wide", "two-axis blocks (hr 8, bm 128, bcp 256)"),
                          ("wt", "write-through (not ported)")):
            add(f"packed_rr_{what}_{n}_f32", "K7", "rr", "packed", n, "f32", 14, None, 1, "rbgs",
                tpu=tpu)
            add(f"packed_pc_{what}_{n}_f32", "K8", "pc", "packed", n, "f32", 14, 15, 1, "rbgs",
                tpu=tpu)
    n = n_wide
    tpu = "two-axis blocks (hr 8, bm 256, bcw 256)"
    for dt, dtype in DTYPES.items():
        if cuda.supports(n, dtype, 3, "wjacobi"):
            add(f"wide_smooth_{dt}", _k("K1", dt), "smooth", "grid", n, dt, 7, None, 3,
                "wjacobi", tpu=tpu)
            add(f"wide_rr_{dt}", _k("K2", dt), "rr", "grid", n, dt, 7, None, 3, "wjacobi",
                tpu=tpu)
            add(f"wide_pc_{dt}", _k("K3", dt), "pc", "grid", n, dt, 7, 8, 3, "wjacobi", "face",
                "bilinear", tpu=tpu)
    n = n3
    for dt, dtype in DTYPES.items():
        if not (cuda.supports(n, dtype, 3, "wjacobi", 3)
                and cuda.sharded_supports(3, dtype)):
            continue
        a = dict(n=n, dt=dt, seed=9, nu=3, smoother="wjacobi", ndim=3)
        add(f"smooth3d_{dt}", _k("K4", dt), "smooth", "grid", seed_v=None, **a)
        add(f"rr3d_{dt}", _k("K5", dt), "rr", "grid", seed_v=None, **a)
        add(f"pc3d_{dt}", _k("K6", dt), "pc", "grid", seed_v=10, **a)
        if dt == "f32":
            add("shard_rr3d_ysplit_f32", "K11", "rr", "block", seed_v=None, **a)
            add("shard_pc3d_ysplit_f32", "K12", "pc", "block", seed_v=10, kind="bilinear", **a)
        add(f"shard_rr3d_{dt}", _k("K11", dt), "rr", "block_nocol", seed_v=None, **a)
        add(f"shard_pc3d_{dt}", _k("K12", dt, ".rnorm"), "pcr", "block_nocol", seed_v=10,
            kind="bilinear", **a)
        add(f"rr3d_zero_{dt}", _k("K5", dt, ".zero"), "rr_zero", "grid", seed_v=None, **a)
    return out


def _err(got, ref) -> float:
    """Normalized max |diff| in f32, computed on the device: only the
    scalar crosses to the host."""
    got, ref = got.float(), ref.float()
    scale = torch.clamp(ref.abs().max(), min=1e-30)
    return float((got - ref).abs().max() / scale)


def run_parity(full: bool = False, sizes=(512, 2048), device="cuda") -> dict:
    """Every case of ``cases(full, sizes, device)`` through the
    kernel and its plain version on the card.  Returns the JAX sweep's
    dict: max_err, max_err_f32, worst_f32, max_err_bf16, worst, n_cases,
    cases ({name: err}), failures ({name: error}), n_failures; and
    kernels ({name: the port kernel that ran under it}).  A device other
    than CUDA raises ValueError: there the wrappers would run the plain
    ops on both sides."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"run_parity: the kernels run only on a CUDA device, got {device}")
    results, failures, kernels, cache = {}, {}, {}, {}
    for case in cases(full, sizes, device):
        kernels[case.name] = case.kernel
        try:
            got, ref = case.run(cuda, cache), case.run(ops, cache)
            if isinstance(got, tuple):
                for i, (g, r) in enumerate(zip(got, ref)):
                    results[f"{case.name}[{i}]"] = _err(g, r)
            else:
                results[case.name] = _err(got, ref)
        except Exception as e:   # one broken path must not hide the others
            failures[case.name] = f"{type(e).__name__}: {str(e)[:200]}"
    cache.clear()
    f32 = {k: v for k, v in results.items() if "bf16" not in k}
    bf16 = {k: v for k, v in results.items() if "bf16" in k}
    return {"max_err": max(results.values()) if results else None,
            "max_err_f32": max(f32.values()) if f32 else None,
            "worst_f32": max(f32, key=f32.get) if f32 else None,
            "max_err_bf16": max(bf16.values()) if bf16 else None,
            "worst": max(results, key=results.get) if results else None,
            "n_cases": len(results), "cases": results,
            "failures": failures, "n_failures": len(failures), "kernels": kernels}


def main(argv=None):
    import json

    argv = sys.argv[1:] if argv is None else argv
    out = run_parity(full="--full" in argv)
    top = dict(sorted(out["cases"].items(), key=lambda kv: -kv[1])[:10])
    print(json.dumps({"max_err": out["max_err"], "max_err_f32": out["max_err_f32"],
                      "worst_f32": out["worst_f32"], "max_err_bf16": out["max_err_bf16"],
                      "worst": out["worst"], "n_cases": out["n_cases"], "top10": top,
                      "failures": out["failures"]}, indent=2))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
