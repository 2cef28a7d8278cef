"""Solver API (port of the single-device path of
``mgpoisson/solver/multigrid.py``).

- construct with a Spec and a device (the card unless told otherwise);
- ``step()`` = one cycle + the stopping metric;
- ``solve()`` = iterate to maxiter, stopping on err < tol, a non-finite
  err, or a truthy error_callback.

The JAX package runs the solve loop on the device in a
``lax.while_loop``; this port runs it on the host with one scalar readback
per cycle, under the same stop rule (continue while it == 0, or err >= tol
and err is finite) and with the same error history.

With a sweep_dtype other than dtype, ``step()`` is the JAX package's
mixed-precision refinement step: the residual of psi in dtype, one cycle
in sweep_dtype on the error equation A e = r from e = 0, psi += e, and the
stopping metric of the INCOMING iterate (||r||/||r0||) or the update RMS;
the first reported residual error is therefore 1.0.  The error history is
f32 for a bf16 solve, as in the JAX package.

Where ``kernels.use_packed`` holds (the fast scheme's rbgs fine level),
``solve()`` packs psi and f once, carries the packed state through the
loop (``cycle.packed``) and unpacks psi at the end, unless a callback asks
for psi; ``step()`` stays unpacked, as in the JAX package.

With cycle='fmg', ``init_state()`` is a full-multigrid pass
(``cycle.vcycle.fmg``, under a mesh ``SpmdCycle.fmg``), run unpacked; the
relative residual is still taken against the -f guess, and a given psi0
skips the pass.  With stop_check='adaptive' and no callback, ``solve()``
runs the JAX package's adaptive loop on the host: a cycle measures
||r||/||r0|| (and reads it back) only where a learned contraction model
predicts it near tol, at least every ADAPTIVE_MAX_SKIP cycles and always
first; a skipped cycle runs the metric-free cycle, reads nothing and
records the prediction.  With a callback every cycle measures.

With a mesh (``spec.mesh_shape``, or a ``shard.mesh.ProcessMesh``) the
solver is one rank of the explicit partition (``shard.spmd``): ``rhs()``,
``init_state()``, ``step()`` and ``solve()`` take and give this rank's
block, and the error history is the all-reduced one, the same on every
rank; with a sweep_dtype, ``step()`` is the partition's mixed-precision
refinement step (``SpmdCycle.step_mixed``).  Where
``kernels.use_packed_sharded`` holds (the fast scheme on a mesh of one
column), ``solve()`` packs the rank's psi and f blocks once and carries
them through ``SpmdCycle.step_packed`` under the same callback rule.

``solve_batched(fs)`` solves a batch of right-hand sides, each from -f,
with the unpacked step (the JAX package's serving API): by
``torch.func.vmap`` of the step where the fine level runs the plain ops,
else one step per live element per cycle on the host, skipping the
frozen ones; one device->host read per cycle.  It runs on one device.

Every entry (``solve``, ``step``, ``init_state``, ``solve_batched``)
takes f and psi as tensors of any strides and offset, as the JAX package
takes any array: it hands the cycle dense row-major tensors at an 8-byte
boundary, which is what the kernels take (``_dense``), copying only a
tensor that is not one and never writing a caller's tensor.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Callable, Optional

import numpy as np
import torch

from mgpoisson_torch.core.rhs import initial_guess, point_charge_block, point_charge_rhs
from mgpoisson_torch.core.spec import Spec
from mgpoisson_torch.cycle import packed
from mgpoisson_torch.cycle.vcycle import fmg, make_cycle
from mgpoisson_torch.kernels import ops, use_kernels, use_packed, use_packed_sharded
from mgpoisson_torch.shard import multihost, spmd
from mgpoisson_torch.shard.mesh import build_mesh


@dataclasses.dataclass
class SolveResult:
    psi: torch.Tensor
    iterations: int
    errs: torch.Tensor       # stopping-metric history, length `iterations`, on the CPU
    converged: bool
    final_err: float
    # exact-metric evaluations: == iterations unless stop_check='adaptive'
    # skipped some (errs then holds the model's prediction at those entries)
    n_metric_evals: Optional[int] = None

    def __iter__(self):
        yield self.psi
        yield self.errs


def _dense(x: torch.Tensor) -> torch.Tensor:
    """x as a dense row-major tensor whose data starts at an 8-byte
    boundary (the 2D kernels move 8 bytes per lane and refuse other
    operands): x itself where it is one, else a fresh copy."""
    if x.is_contiguous() and x.data_ptr() % 8 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def read_scalar(t: torch.Tensor) -> float:
    """A 0-d tensor as a Python float: the solve loop's one way from the
    device to the host (a synchronisation on the card)."""
    return t.item()


def read_errs(t: torch.Tensor) -> list:
    """A (batch,) tensor as a list of floats: the batched loop's one
    device->host read per cycle where it steps the elements one by one."""
    return t.tolist()


def _callback_arity(cb) -> int:
    """Positional parameters without defaults: a 3-parameter callback
    also receives the live iterate, cb(it, err, psi).  A 2-parameter
    callback with an extra keyword default is handed (it, err) only, so
    to receive psi, declare it required."""
    try:
        params = inspect.signature(cb).parameters.values()
    except (TypeError, ValueError):
        return 2
    return sum(1 for p in params
               if p.default is inspect.Parameter.empty
               and p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                              inspect.Parameter.POSITIONAL_OR_KEYWORD))


class MultigridPoisson:
    """Geometric multigrid Poisson solver on one torch device, or one rank
    of a sharded solve."""

    # Adaptive stop_check: measure the exact residual once the predicted
    # relres is within SAFETY of tol, and at least every MAX_SKIP cycles
    # (bounds both a mis-learned rho and the NaN-detection latency).
    ADAPTIVE_SAFETY = 100.0
    ADAPTIVE_MAX_SKIP = 4

    def __init__(self, spec: Spec, device="cuda", mesh=None):
        """device: where the solver's tensors live, the card by default;
        without one this raises, and device='cpu' solves on the CPU.
        The device of the tensors decides between the CUDA kernels and
        the plain ops (see ``mgpoisson_torch.kernels.use_kernels``); the
        solver never moves work to another device by itself.

        mesh: a ``shard.mesh.ProcessMesh``, or None to build one from
        spec.mesh_shape over the default process group when the spec has
        a mesh.  Under a mesh, "cuda" means this rank's card,
        ``shard.multihost.device_for(rank)``, and partition 'auto' is the
        explicit partition 'spmd'."""
        if spec.stop_check == "adaptive" and spec.sweep_dtype not in (None, spec.dtype):
            # the JAX solver's check and message (mgpoisson/solver/multigrid.py)
            raise ValueError("stop_check='adaptive' buys nothing under "
                             "mixed-precision refinement: the "
                             "refinement step computes the "
                             "full-precision residual every cycle "
                             "anyway; use stop_check='every'")
        if mesh is not None and spec.mesh_shape is None:
            spec = spec.with_(mesh_shape=tuple(mesh.shape))
        if mesh is None and spec.mesh_shape is not None:
            mesh = build_mesh(spec.mesh_shape)
        self.spec = spec
        self.mesh = mesh
        self.partition = None if mesh is None else "spmd"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"MultigridPoisson: device {str(self.device)!r} but "
                "torch.cuda.is_available() is False; pass device=\"cpu\" to "
                "solve on the CPU")
        if mesh is not None and self.device == torch.device("cuda"):
            self.device = multihost.device_for(mesh.rank)
        self._dtype = getattr(torch, spec.dtype)
        # the error history: the solve's dtype, at least f32
        self._err_dtype = ops._acc_dtype(self._dtype)
        use_kernels(spec, spec.size, self.device)   # rejects backend='cuda' on CPU
        self._want_rnorm = spec.stop == "residual"
        self._spmd = None if mesh is None else spmd.SpmdCycle(spec, mesh)
        self._sweep_dtype = None
        if spec.sweep_dtype not in (None, spec.dtype):
            # mixed-precision refinement: the cycle runs in sweep_dtype on
            # the error equation, never packed (the JAX solver's refinement
            # branch comes before its packed one); under a mesh it is the
            # partition's (SpmdCycle.step_mixed)
            self._sweep_dtype = getattr(torch, spec.sweep_dtype)
            if mesh is None:
                self._cycle = make_cycle(spec.with_(dtype=spec.sweep_dtype), rnorm=False)
        else:
            self._cycle = make_cycle(spec, rnorm=self._want_rnorm)
        if mesh is None:
            self._packed = use_packed(spec, self.device)
        else:
            self._packed = use_packed_sharded(spec, mesh, self.device)
        if self._packed and mesh is None:
            self._packed_cycle = packed.make_packed_cycle(spec, rnorm=self._want_rnorm)

    def _adaptive_cycles(self):
        """The adaptive loop's (plain, measured, remeasure) on the state its
        solve carries (packed where self._packed): plain(psi, f) -> psi',
        measured(psi, f) -> (psi', sum(r^2) of psi' over the grid), and
        remeasure(psi, f) -> ||r|| of psi."""
        spec, h = self.spec, self.spec.fine_h
        if self._spmd is not None:
            sc, pk = self._spmd, self._packed
            remeasure = ((lambda p, f: sc.residual_norm(packed.unpack(p), packed.unpack(f)))
                         if pk else sc.residual_norm)
            return (lambda p, f: sc.cycle_bare(p, f, pk),
                    lambda p, f: sc.cycle_bare(p, f, pk, want_r2=True), remeasure)
        if self._packed:
            plain = packed.make_packed_cycle(spec, rnorm=False)
            return (lambda p, f: plain(p, f, h), lambda p, f: self._packed_cycle(p, f, h),
                    lambda p, f: packed.residual_norm_packed(p, f, h))
        plain = make_cycle(spec, rnorm=False)
        return (lambda p, f: plain(p, f, h), lambda p, f: self._cycle(p, f, h),
                lambda p, f: ops.residual_norm(p, f, h))

    # ------------------------------------------------------------ state

    def rhs(self) -> torch.Tensor:
        """Default point-charge RHS (under a mesh, this rank's block of it)."""
        spec = self.spec
        if self.mesh is not None:
            return point_charge_block(spec.size, spmd.block_origin(spec.size, self.mesh),
                                      spmd.block_shape(spec.size, spec.ndim, self.mesh),
                                      self._dtype, self.device)
        return point_charge_rhs(spec.size, spec.ndim, self._dtype, self.device)

    def init_state(self, f: Optional[torch.Tensor] = None) -> torch.Tensor:
        """psi0 = -f, dense and row-major whatever f's strides; with
        cycle='fmg', the full-multigrid pass's iterate instead (under a
        mesh this rank's block of it)."""
        f = self.rhs() if f is None else _dense(f)
        if self.spec.cycle != "fmg":
            return initial_guess(f)
        if self._spmd is not None:
            return self._spmd.fmg(f)
        return fmg(f, self.spec.fine_h, self.spec)

    # ------------------------------------------------------------- step

    def step(self, psi, f):
        """One cycle + error. Returns (psi_new, err)."""
        psi, f = _dense(psi), _dense(f)
        return self._step(psi, f, self._r0(psi, f))

    def _step(self, psi, f, r0, packed_state=False):
        """err per spec.stop: 'update' — RMS of the iterate update (on
        packed state too: it is permutation-invariant); 'residual' —
        ||r||/||r0||, with ||r||^2 fused into the cycle's fine up-leg.
        packed_state: psi and f are packed (the packed fine level)."""
        if self._spmd is not None:
            step = (self._spmd.step_packed if packed_state
                    else self._spmd.step_mixed if self._sweep_dtype is not None
                    else self._spmd.step)
            psi_new, err_upd, rn = step(psi, f)
            return psi_new, (rn / r0 if self._want_rnorm else err_upd)
        if self._sweep_dtype is not None:
            return self._refine(psi, f, r0)
        cycle = self._packed_cycle if packed_state else self._cycle
        h = self.spec.fine_h
        if self._want_rnorm:
            psi_new, r2 = cycle(psi, f, h)
            return psi_new, torch.sqrt(r2).to(r0.dtype) / r0
        psi_new = cycle(psi, f, h)
        return psi_new, ops.rms_update(psi_new, psi)

    def _refine(self, psi, f, r0):
        """One mixed-precision refinement step (the JAX package's, from
        mgpoisson/solver/multigrid.py): r = f - A psi in dtype (the plain
        op: no kernel has it), e from one sweep_dtype cycle on A e = r
        starting at e = 0 (a zeros array, so the fine level runs the down-leg
        from u, as the JAX package's does), psi + e.  err is ||r||/||r0||
        of the INCOMING iterate, accumulated in at least f32, or the
        update RMS."""
        h = self.spec.fine_h
        r = ops.residual(psi, f, h, "ghost0")
        e = self._cycle(torch.zeros_like(r, dtype=self._sweep_dtype),
                        r.to(self._sweep_dtype), h)
        psi_new = psi + e.to(psi.dtype)
        if self._want_rnorm:
            ra = r.to(ops._acc_dtype(r.dtype))
            return psi_new, torch.sqrt(torch.sum(ra * ra)).to(r0.dtype) / r0
        return psi_new, ops.rms_update(psi_new, psi)

    def _r0(self, psi, f):
        if self.spec.stop == "residual":
            return self.residual_norm(psi, f)
        return torch.ones((), dtype=self._dtype, device=self.device)

    def residual_norm(self, psi, f):
        if self._spmd is not None:
            return self._spmd.residual_norm(psi, f)
        return ops.residual_norm(psi, f, self.spec.fine_h)

    def rel_err(self, psi, psi_old):
        """The reference's secondary masked relative-change metric."""
        if self._spmd is not None:
            return self._spmd.rel_err(psi, psi_old)
        return ops.rel_err(psi, psi_old)

    # ------------------------------------------------------------ solve

    def solve(self, f=None, *, psi0=None,
              error_callback: Optional[Callable[..., Optional[bool]]] = None
              ) -> SolveResult:
        """Iterate cycles until the stopping metric drops below tol, goes
        non-finite, or maxiter cycles run.

        error_callback(iter, err) is called after every cycle (1-based
        iter); a truthy return stops the solve.  A callback with three
        required positional parameters gets the live iterate too:
        error_callback(iter, err, psi)."""
        spec = self.spec
        f = (self.rhs() if f is None
             else _dense(torch.as_tensor(f, dtype=self._dtype, device=self.device)))
        if psi0 is None:
            psi = self.init_state(f)
            # the relative residual's baseline is the -f guess, not the FMG
            # iterate, whose residual is already near the target (tol * r0
            # would be out of reach)
            r0 = self._r0(initial_guess(f) if spec.cycle == "fmg" else psi, f)
        else:
            # a dense row-major copy, never the caller's tensor
            psi = torch.as_tensor(psi0, dtype=self._dtype, device=self.device).clone(
                memory_format=torch.contiguous_format)
            r0 = self._r0(psi, f)

        wants_psi = (error_callback is not None
                     and _callback_arity(error_callback) >= 3)
        # the packed fine level: pack once (the grid, or this rank's block),
        # carry packed state, unpack at the end; a callback that takes psi
        # gets the unpacked step
        packed_state = self._packed and not wants_psi
        if packed_state:
            psi, f = packed.pack(psi), packed.pack(f)
        if spec.stop_check == "adaptive" and error_callback is None:
            psi, errs, n_evals, final_err = self._adaptive_loop(psi, f, r0)
            it = len(errs)
            converged = final_err < spec.tol and math.isfinite(final_err)
        else:
            errs = []
            converged = False
            it = 0
            for it in range(1, spec.maxiter + 1):
                psi, err = self._step(psi, f, r0, packed_state)
                err_f = read_scalar(err)   # the one device->host readback per cycle
                errs.append(err_f)
                if error_callback is not None and (
                        error_callback(it, err_f, psi) if wants_psi
                        else error_callback(it, err_f)):
                    break
                if not (err_f >= spec.tol and math.isfinite(err_f)):
                    converged = err_f < spec.tol
                    break
            n_evals, final_err = it, errs[-1] if errs else float("inf")
        if packed_state:
            psi = packed.unpack(psi)
        return SolveResult(psi=psi, iterations=it,
                           errs=torch.tensor(errs, dtype=self._err_dtype),
                           converged=converged, final_err=final_err,
                           n_metric_evals=n_evals)

    def _adaptive_loop(self, psi, f, r0):
        """The JAX package's adaptive solve loop (its _build_adaptive_loop)
        on the host: returns (psi, errs, n_metric_evals, final_err).

        The contraction model is kept in the error history's dtype (numpy
        f32 for an f32 or bf16 solve, f64 for f64), as the JAX loop keeps
        it, so the same errors take the same decisions near the safety
        line.  A measured cycle reads its ||r||/||r0|| back (``read_scalar``),
        a skipped one reads nothing: every decision uses values already on
        the host.  The relres of the initial guess is 1, so the model starts
        from (1 at cycle 0) with an optimistic rho of 0.05, and the first
        cycle always measures."""
        spec = self.spec
        plain, measured, remeasure = self._adaptive_cycles()
        rdt = np.float64 if self._err_dtype == torch.float64 else np.float32
        tol, safety = rdt(spec.tol), rdt(self.ADAPTIVE_SAFETY * spec.tol)
        relres = lambda x: rdt(read_scalar((x / r0).to(self._err_dtype)))
        errs = []
        it, meas_err, meas_it, rho, n_evals = 0, rdt(1.0), 0, rdt(0.05), 0
        with np.errstate(divide="ignore", over="ignore", under="ignore", invalid="ignore"):
            while it < spec.maxiter and (it == 0 or (meas_err >= tol and np.isfinite(meas_err))):
                gap = it + 1 - meas_it             # cycles since the last measurement
                pred = meas_err * rho ** rdt(gap)
                if pred < safety or gap >= self.ADAPTIVE_MAX_SKIP or it == 0:
                    psi, r2 = measured(psi, f)
                    err = relres(torch.sqrt(r2))
                    # learn rho from the contraction over the gap (clipped:
                    # never skip forever, never predict below fp noise)
                    rho_obs = np.power(np.maximum(err / np.maximum(meas_err, rdt(1e-300)),
                                                  rdt(1e-30)), rdt(1.0) / rdt(gap))
                    rho = np.clip(rho_obs, rdt(0.02), rdt(0.95))
                    meas_err, meas_it = err, it + 1
                    n_evals += 1
                else:
                    psi, err = plain(psi, f), pred
                errs.append(err)
                it += 1
        if meas_it != it:
            # a stop at maxiter on a skipped cycle: measure the returned
            # iterate (the metric alone, no cycle), not an older one
            meas_err = errs[-1] = relres(remeasure(psi, f))
            n_evals += 1
        # the JAX loop returns its final err in the solve's dtype
        final = torch.tensor(float(meas_err), dtype=self._err_dtype).to(self._dtype)
        return psi, [float(e) for e in errs], n_evals, float(final)

    # ---------------------------------------------------------- batched

    def solve_batched(self, fs, *, cycles: Optional[int] = None):
        """Solve a batch of right-hand sides: fs of shape (batch,
        *spec.shape), of any strides, taken in the solver's dtype on its
        device.  Every element starts from psi = -f (never an FMG pass,
        whatever spec.cycle says) and runs step()'s unpacked cycle, so a
        fast-scheme batch never packs.

        cycles: run exactly that many cycles on every element, reading
        nothing back until the end.  None: iterate while it < maxiter and
        (it == 0, or the worst element's metric is >= tol and finite: a
        NaN anywhere stops the batch); an element whose metric is below
        tol is frozen, its psi and err kept as they were.

        Returns (psis, errs): errs of shape (batch,), in psis' dtype on the
        solver's device, each element's final metric.  Under a mesh this
        raises NotImplementedError."""
        if self._spmd is not None:
            raise NotImplementedError(
                "solve_batched under a mesh is not in mgpoisson_torch yet: ROADMAP "
                "Queue 1 item 12")
        fs = _dense(torch.as_tensor(fs, dtype=self._dtype, device=self.device))
        if tuple(fs.shape[1:]) != self.spec.shape or fs.shape[0] < 1:
            raise ValueError(f"solve_batched: fs of shape {tuple(fs.shape)}, expected "
                             f"(batch, *{self.spec.shape})")
        return self._batched_loop(fs, cycles)

    def _batched_loop(self, fs, cycles, use_vmap=None):
        """The batched loop of solve_batched on dense fs, in one of the JAX
        package's two forms; use_vmap=None picks by its rule, vmap where
        the fine level runs the plain ops (``use_kernels``):

        - vmap: torch.func.vmap of the step over the batch, one launch per
          op for the whole batch (what amortises a small grid's launches);
          a frozen element's new psi and err are dropped by torch.where;
          the until-converged loop reads back the worst err per cycle;
        - loop: one step per live element per cycle, a frozen element's
          cycle skipped (the JAX lax.cond), so that each element runs the
          kernels, and has the r0, that its own solve() has; the
          until-converged loop reads back the (batch,) errs per cycle in
          one copy (``read_errs``), which the skips need.

        The freeze and the stop compare the errs with tol rounded to the
        solve's dtype, as the JAX loop compares with its weak-typed tol."""
        spec, h = self.spec, self.spec.fine_h
        if use_vmap is None:
            use_vmap = not use_kernels(spec, spec.size, self.device)
        B = fs.shape[0]
        tol = float(torch.tensor(spec.tol, dtype=self._dtype))
        freeze = cycles is None
        n_cycles = spec.maxiter if freeze else cycles
        errs = torch.full((B,), math.inf, dtype=self._dtype, device=self.device)

        def go_on(worst):
            return worst >= tol and math.isfinite(worst)

        if use_vmap:
            psis = initial_guess(fs)
            r0s = (torch.func.vmap(lambda p, f: ops.residual_norm(p, f, h))(psis, fs)
                   if spec.stop == "residual"
                   else torch.ones((B,), dtype=self._dtype, device=self.device))
            vstep = torch.func.vmap(self._step)
            for _ in range(n_cycles):
                new_psis, new_errs = vstep(psis, fs, r0s)
                new_errs = new_errs.to(self._dtype)
                if not freeze:
                    psis, errs = new_psis, new_errs
                    continue
                # errs starts at +inf, so nothing is frozen before cycle 1
                done = errs < tol
                psis = torch.where(done.view((B,) + (1,) * spec.ndim), psis, new_psis)
                errs = torch.where(done, errs, new_errs)
                if not go_on(read_scalar(torch.max(errs))):
                    break
            return psis, errs

        fl = [_dense(f) for f in fs]
        psl = [initial_guess(f) for f in fl]
        r0l = [self._r0(p, f) for p, f in zip(psl, fl)]
        errl = list(errs.unbind())
        errs_h = [math.inf] * B
        for _ in range(n_cycles):
            for k in range(B):
                if freeze and errs_h[k] < tol:
                    continue
                psl[k], err = self._step(psl[k], fl[k], r0l[k])
                errl[k] = err.to(self._dtype)
            errs = torch.stack(errl)
            if freeze:
                errs_h = read_errs(errs)
                if not go_on(float(np.max(errs_h))):    # np.max keeps a NaN
                    break
        return torch.stack(psl), errs
