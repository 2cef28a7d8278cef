"""The explicit partition on torch.distributed (port of the `step_local`
part of ``mgpoisson/shard/spmd.py``).

One process per block of the grid, the V-cycle written out per rank with
its communication explicit:

- one deep-halo exchange per smoothing leg: the neighbours' edge lines,
  D = radius * nu + 1 deep (the deeper of the two legs), arrive as strips
  (``shift``, non-wrapping, so zeros arrive at the grid's edges: that zero
  fill is the zero-ghost boundary); f is exchanged once per level and serves
  both legs, u again before the up-leg, the coarse correction V at the
  coarse depth.  Each leg is one strip kernel (K9-K12, kernels.cuda) where
  ``kernels.use_sharded_kernels`` holds, else its plain version
  (kernels.ops), which sweeps an extended block with the boundary taken
  from the global index (the JAX package's fix_ghost).
- below `replicate_below`, where the next level would not split evenly, or
  where a block is thinner than twice the coarse strips' depth (the strips
  would need more than the immediate neighbour's block), the level is
  all-gathered and every rank runs the rest of the cycle on the whole
  coarse grid (cycle.vcycle._cycle, the single-device cycle on this rank's
  device), then keeps its block: small grids are latency-bound, so stop
  communicating.  (The JAX package sweeps such thin blocks with one
  exchange per sweep until replicate_below; the values are the same.)
- sums are local sums, then ``all_reduce_sum``.
- mixed-precision refinement (a spec's sweep_dtype other than its dtype:
  ``step_mixed``, the JAX package's step_mixed_local): the residual in
  dtype after a one-cell exchange, one cycle in sweep_dtype on A e = r from
  a zeros array (in bf16 the bf16 forms of K9/K10 in 2D and of K11/K12 in
  3D, its strips exchanged in bf16), psi += e in dtype.
- the fast scheme on a mesh of one column (``kernels.use_packed_sharded``)
  keeps each rank's fine block checkerboard-packed for the whole solve
  (``cycle_packed``, ``step_packed``): a block of whole rows packs to the
  same rows of the packed grid, so its halo is plain row strips of the
  neighbours' packed blocks, and the fine legs are the packed strip kernels
  K13/K14; below them runs the unpacked sharded cycle on the unpacked
  coarse rhs K13 emits.

Under the gloo backend, card tensors are staged through pinned host memory
for every collective (gloo's point-to-point is host-only); under NCCL they
go as they are.  The backend is the caller's choice
(``multihost.initialize``): nothing here switches it.

- the full-multigrid initialisation (``fmg``, the JAX package's fmg_local):
  f restricted block by block while the level is sharded, gathered once at
  the replicated hand-off, the coarse solve and the replicated levels run on
  the whole grid, then going up each sharded level prolongs its coarse block
  with one-line coarse strips (``ops.prolong_sharded``, no gather) and runs
  one sharded V-cycle.
- the bare cycles of the adaptive stop (``cycle_bare``): one cycle on the
  block, unpacked or packed, without the metric or with the all-reduced
  sum(r^2).
- the pure bf16 solve (a spec of dtype bfloat16): ``step`` on bf16 blocks,
  the cycle on the bf16 forms of K9/K10 (K11/K12 in 3D), the per-cycle
  sum(r^2) all-reduced in f32 as the JAX package's spmd step takes it; its
  r0 (``SpmdCycle.residual_norm``) sums as the JAX solver does on the
  global array.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Tuple

import torch
import torch.distributed as dist

from mgpoisson_torch.cycle.vcycle import _cycle as _replicated_cycle
from mgpoisson_torch.kernels import cuda, exchange_depth, ops, use_sharded_kernels
from mgpoisson_torch.shard.mesh import ProcessMesh


# ------------------------------------------------------------ block geometry

def shardable(g: int, mesh: ProcessMesh) -> bool:
    """Every rank keeps an even block of at least 2 cells per sharded axis."""
    return all(g % m == 0 and g // m >= 2 and (g // m) % 2 == 0
               for m in mesh.shape)


def block_shape(g: int, ndim: int, mesh: ProcessMesh) -> Tuple[int, ...]:
    """This rank's block of a grid of side g."""
    return (g // mesh.shape[0], g // mesh.shape[1]) + (g,) * (ndim - 2)


def block_origin(g: int, mesh: ProcessMesh) -> Tuple[int, int]:
    """Global index of the block's first cell on the two sharded axes."""
    cx, cy = mesh.coords
    return cx * (g // mesh.shape[0]), cy * (g // mesh.shape[1])


def block_slices(g: int, mesh: ProcessMesh) -> Tuple[slice, slice]:
    """This rank's block of a grid of side g as slices of axes 0 and 1."""
    (r0, c0), (nl, ml) = block_origin(g, mesh), block_shape(g, 2, mesh)
    return slice(r0, r0 + nl), slice(c0, c0 + ml)


# --------------------------------------------------------------- collectives

# Host seconds spent in the collectives, by kind: the halo strips and the
# all-gathers (the handoff to the replicated levels, the all-reduced sums).
# Read and reset by bench/profile.py.  Under gloo the staging copies
# synchronise, so these are the transfers' wall time; under NCCL they are
# the time to enqueue them.
comm_seconds = dict.fromkeys(("halo_exchange", "all_gather"), 0.0)


def reset_comm_seconds() -> None:
    for k in comm_seconds:
        comm_seconds[k] = 0.0


@contextlib.contextmanager
def _timed(kind):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        comm_seconds[kind] += time.perf_counter() - t0


def _staged(mesh: ProcessMesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


def _to_wire(mesh, t):
    """t as the backend takes it: a pinned host copy under gloo for a card
    tensor, else t itself (contiguous)."""
    t = t.contiguous()
    if not _staged(mesh, t):
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _wire_buffer(mesh, shape, like):
    if _staged(mesh, like):
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def shift(mesh: ProcessMesh, axis: int, to_hi: torch.Tensor, to_lo: torch.Tensor):
    """The non-wrapping neighbour transfer along mesh axis `axis`: to_hi goes
    to the neighbour at +1 and to_lo to the one at -1; returns (from_lo,
    from_hi), what those two sent, on the same device, zeros where there is
    no neighbour (the grid's edge: that zero fill is the zero-ghost
    boundary).
    All sends and receives are posted in one ``batch_isend_irecv`` before
    any is waited on, so no order of the ranks can deadlock."""
    lo, hi = mesh.neighbour(axis, -1), mesh.neighbour(axis, +1)
    with _timed("halo_exchange"):
        p2p, bufs = [], []
        for peer, t in ((hi, to_hi), (lo, to_lo)):
            if peer is not None:
                p2p.append(dist.P2POp(dist.isend, _to_wire(mesh, t), peer, mesh.group))
        for peer, shape in ((lo, to_hi.shape), (hi, to_lo.shape)):
            buf = None
            if peer is not None:
                buf = _wire_buffer(mesh, shape, to_hi)
                p2p.append(dist.P2POp(dist.irecv, buf, peer, mesh.group))
            bufs.append((buf, shape))
        if p2p:
            for req in dist.batch_isend_irecv(p2p):
                req.wait()
        return tuple(to_hi.new_zeros(shape) if buf is None else buf.to(to_hi.device)
                     for buf, shape in bufs)


def strips(a: torch.Tensor, depth: int, mesh: ProcessMesh):
    """(top, bot, left, right) halo strips of block a, `depth` deep, in the
    layout of kernels.ops (top/bot the axis-0 neighbours' edge lines;
    left/right the axis-1 neighbours' edge columns of their row-extended
    blocks, so the sequential per-axis exchange carries the corners; None
    on a mesh of one column).  Two batches: axis 0, then axis 1."""
    n, m = a.shape[0], a.shape[1]
    top, bot = shift(mesh, 0, a[n - depth:], a[:depth])
    if mesh.shape[1] == 1:
        return top, bot, None, None
    lcol = torch.cat([top[:, m - depth:], a[:, m - depth:], bot[:, m - depth:]])
    rcol = torch.cat([top[:, :depth], a[:, :depth], bot[:, :depth]])
    left, right = shift(mesh, 1, lcol, rcol)
    return top, bot, left, right


def block_from_grid(G: torch.Tensor, origin, shape, depth: int, cols: bool = True):
    """The block of whole grid G at `origin` of `shape` and the strips,
    `depth` deep, that ``strips`` would deliver to its rank (zeros outside
    the grid; no left/right without `cols`, a mesh of one column).  For
    holding one block's ops against the whole grid's without ranks."""
    pad = [0, 0] * (G.ndim - 2) + [depth] * 4
    Gp = torch.nn.functional.pad(G, pad)
    (r0, c0), (nl, ml) = (origin[0] + depth, origin[1] + depth), shape[:2]
    cut = lambda r, c: Gp[r, c].contiguous()
    strips = (cut(slice(r0 - depth, r0), slice(c0, c0 + ml)),
              cut(slice(r0 + nl, r0 + nl + depth), slice(c0, c0 + ml)))
    rows = slice(r0 - depth, r0 + nl + depth)
    strips += ((cut(rows, slice(c0 - depth, c0)), cut(rows, slice(c0 + ml, c0 + ml + depth)))
               if cols else (None, None))
    return cut(slice(r0, r0 + nl), slice(c0, c0 + ml)), strips


def all_gather(x: torch.Tensor, mesh: ProcessMesh) -> List[torch.Tensor]:
    """Every rank's x, in rank order, on x's device."""
    with _timed("all_gather"):
        wire = _to_wire(mesh, x)
        out = [torch.empty_like(wire) for _ in range(mesh.size)]
        dist.all_gather(out, wire, group=mesh.group)
        return [t.to(x.device) for t in out]


def all_reduce_sum(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """The sum of x over the ranks, taken in rank order from an all-gather:
    every rank gets the same bits, so every rank takes the same stop
    decision, and a run repeats exactly."""
    return torch.stack(all_gather(x, mesh)).sum(dim=0)


def gather_full(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """The whole grid from every rank's block (axes 0 and 1 tiled)."""
    blocks = all_gather(x, mesh)
    my = mesh.shape[1]
    rows = [torch.cat(blocks[i * my:(i + 1) * my], dim=1) for i in range(mesh.shape[0])]
    return torch.cat(rows, dim=0)


def slice_local(full: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """This rank's block of a whole grid."""
    return full[block_slices(full.shape[0], mesh)].contiguous()


# --------------------------------------------------------------- the cycle

def residual(u, f, h, mesh: ProcessMesh):
    """This rank's block of the zero-ghost residual r = f - A u, in u's
    dtype: one one-cell exchange, then the plain residual (ops.residual's
    operations, so the blocks tile the whole grid's r bit for bit)."""
    ue = ops.extend(u, strips(u, 1, mesh))
    nbr = ops.neighbor_sum(ue, "ghost0")[1:-1, 1:-1]
    hsq, adiag, _, _ = ops._level(h, u.ndim, u.dtype)
    return f - (nbr / hsq + adiag * u)


def _sq_sum(x):
    """sum(x^2) accumulated in at least f32 (never below x's dtype)."""
    x = x.to(ops._acc_dtype(x.dtype))
    return torch.sum(x * x)


def residual_sq_sum(u, f, h, mesh: ProcessMesh):
    """This rank's share of sum(r^2) of the zero-ghost residual, accumulated
    in at least f32."""
    return _sq_sum(residual(u, f, h, mesh))


class SpmdCycle:
    """The per-rank V/W-cycle and step of a spec on a mesh."""

    def __init__(self, spec, mesh: ProcessMesh):
        if spec.cycle not in ("v", "w", "fmg"):
            raise ValueError(f"unknown cycle {spec.cycle!r}")
        self.spec = spec
        self.mesh = mesh
        self.gamma = 2 if spec.cycle == "w" else 1
        self.depth = exchange_depth(spec)
        self.cdepth = ops.coarse_depth(self.depth)
        # mixed-precision refinement: the error equation's cycle, on this
        # mesh in sweep_dtype.  Its spec carries no mesh_shape (the mesh is
        # this one).
        self.inner = None
        if spec.sweep_dtype not in (None, spec.dtype):
            self.inner = SpmdCycle(spec.with_(dtype=spec.sweep_dtype, mesh_shape=None), mesh)

    def cycle(self, u, f, h, g, fine_level, want_r2=False):
        """One cycle of the level of global side g on this rank's block f
        (u None: u is identically zero, every coarse entry).  Returns (u,
        local sum(r^2) or None): with want_r2 the fine up-leg adds the
        block's Σr² of the result, where the strip path runs it."""
        spec, mesh = self.spec, self.mesh
        bc = "ghost0" if fine_level else spec.coarse_bc
        if (g <= spec.replicate_below or not shardable(g // 2, mesh)
                or min(f.shape[:2]) < 2 * self.cdepth):
            # replicated handoff: gather once, run the rest of the cycle on
            # the whole grid, keep this rank's block
            full = _replicated_cycle(None if u is None else gather_full(u, mesh),
                                     gather_full(f, mesh), h, spec, self.gamma,
                                     fine_level, None)
            return slice_local(full, mesh), None
        origin = block_origin(g, mesh)
        smoother = spec.smoother_resolved
        m = cuda if use_sharded_kernels(spec, g, f.shape, f.device) else ops
        fs = strips(f, self.depth, mesh)          # f is level-invariant: once
        us = None if u is None else strips(u, self.depth, mesh)
        u, R = m.smooth_rr_sharded(u, f, us, fs, origin, g, h, spec.nu_pre, smoother,
                                   bc, zero=u is None)
        V = self._coarse(R, h, g)
        out = m.pc_smooth_sharded(u, f, V, strips(u, self.depth, mesh), fs,
                                  strips(V, self.cdepth, mesh), origin, g, h,
                                  spec.nu_post, smoother, bc, spec.prolong_kind,
                                  rnorm=want_r2 and fine_level)
        return out if want_r2 and fine_level else (out, None)

    def _coarse(self, R, h, g):
        V = self.cycle(None, R, 2 * h, g // 2, False)[0]
        for _ in range(self.gamma - 1):
            V = self.cycle(V, R, 2 * h, g // 2, False)[0]
        return V

    def cycle_packed(self, up, fp, want_r2=False):
        """One cycle on this rank's PACKED fine block (up, fp) of a mesh of
        one column (``kernels.use_packed_sharded``): K13, the unpacked
        sharded cycle on its coarse rhs from zero, K14 (the plain packed
        block ops on the CPU).  Returns (up', local sum(r^2) or None)."""
        spec, mesh = self.spec, self.mesh
        g, h, d = spec.size, spec.fine_h, self.depth
        origin = block_origin(g, mesh)
        fs = strips(fp, d, mesh)          # f is level-invariant: once
        up, R = cuda.packed_rr_sharded(up, fp, strips(up, d, mesh), fs, origin, g, h,
                                       spec.nu_pre)
        V = self._coarse(R, h, g)
        out = cuda.packed_pc_sharded(up, fp, V, strips(up, d, mesh), fs,
                                     strips(V, self.cdepth, mesh), origin, g, h,
                                     spec.nu_post, spec.prolong_kind, rnorm=want_r2)
        return out if want_r2 else (out, None)

    def fmg(self, f):
        """The full-multigrid initial iterate (``cycle.vcycle.fmg``) on this
        rank's block f of the fine level: f restricted block by block down
        to the replicated hand-off (replicate_below, or where a level would
        not split evenly), gathered once there, the rest of the down sweep
        and the coarse solve on the whole grid; going up, a replicated level
        prolongs and runs the single-device V-cycle, the first sharded one
        prolongs the whole coarse solution and keeps its block, every other
        sharded one prolongs its coarse block (``_prolong``), and each
        sharded level runs one sharded V-cycle.  Returns this rank's block
        (a fine level at or below replicate_below runs replicated and is
        sliced back)."""
        spec, mesh = self.spec, self.mesh
        g, h, cur = spec.size, spec.fine_h, f
        shd = g > spec.replicate_below and shardable(g, mesh)
        if not shd:
            cur = gather_full(cur, mesh)
        levels = [(cur, h, g, shd)]        # finest first: (f, h, side, sharded)
        while g > spec.coarse_size:
            gn = g // 2
            if shd and (gn <= spec.replicate_below or not shardable(gn, mesh)):
                cur, shd = gather_full(cur, mesh), False
            cur = ops.restrict(cur)        # a block's own 2^ndim cells
            g, h = gn, 2 * h
            levels.append((cur, h, g, shd))

        fL, hL, _, shdL = levels[-1]
        if shdL:                           # only where size == coarse_size
            fL = gather_full(fL, mesh)
        bcL = "ghost0" if len(levels) == 1 else spec.coarse_bc
        u = ops.coarse_solve(torch.zeros_like(fL), fL, hL, spec.smoother_resolved, bcL)
        if shdL:
            u = slice_local(u, mesh)

        for lvl in range(len(levels) - 2, -1, -1):
            f_l, h_l, g_l, shd_l = levels[lvl]
            if shd_l and not levels[lvl + 1][3]:
                u = slice_local(ops.prolong(u, spec.prolong_kind), mesh)
            elif shd_l:
                u = self._prolong(u, g_l)
            else:
                u = ops.prolong(u, spec.prolong_kind)
            if shd_l:
                u = self.cycle(u, f_l, h_l, g_l, lvl == 0)[0]
            else:
                u = _replicated_cycle(u, f_l, h_l, spec, 1, lvl == 0, None)
        return u if levels[0][3] else slice_local(u, mesh)

    def _prolong(self, V, g):
        """P(V) on this rank's block of the sharded level of side g from its
        coarse block V and V's one-line strips (the bilinear +-1 coarse
        neighbour), as the up-leg's plain version prolongs."""
        return ops.prolong_sharded(V, strips(V, 1, self.mesh), block_origin(g, self.mesh), g,
                                   self.spec.prolong_kind)

    def cycle_bare(self, psi, f, packed=False, want_r2=False):
        """One cycle on this rank's fine block (packed: the packed block,
        ``cycle_packed``) for the adaptive stop: psi_new, or with want_r2
        (psi_new, sum(r^2) of psi_new over the whole grid, all-reduced, in
        at least f32)."""
        if packed:
            psi_new, r2 = self.cycle_packed(psi, f, want_r2)
        else:
            psi_new, r2 = self.cycle(psi, f, self.spec.fine_h, self.spec.size, True, want_r2)
        return (psi_new, self._global_r2(psi_new, r2, f)) if want_r2 else psi_new

    def _global_r2(self, psi_new, r2, f):
        """sum(r^2) of psi_new over the whole grid, all-reduced, in at least
        f32 and never below psi's dtype: from the block's fused Σr² r2, or
        a separate residual pass where the cycle fused none (a replicated
        fine level)."""
        if r2 is None:
            r2 = residual_sq_sum(psi_new, f, self.spec.fine_h, self.mesh)
        return all_reduce_sum(r2.to(ops._acc_dtype(psi_new.dtype)), self.mesh)

    def step(self, psi, f):
        """One cycle on this rank's block: (psi_new, rms_update, residual
        norm), the two metrics all-reduced and the same on every rank; only
        the one spec.stop selects is computed, the other is 0."""
        h = self.spec.fine_h
        return self._step(psi, f, lambda want_r2: self.cycle(psi, f, h, self.spec.size, True,
                                                              want_r2))

    def step_packed(self, pp, fp):
        """``step`` on the rank's packed block (``cycle_packed``); the
        update RMS is that of the packed difference, which the permutation
        leaves as it is."""
        return self._step(pp, fp, lambda want_r2: self.cycle_packed(pp, fp, want_r2))

    def step_mixed(self, psi, f):
        """One mixed-precision refinement step on this rank's block (the
        JAX package's step_mixed_local, mgpoisson/shard/spmd.py; the
        single-device MultigridPoisson._refine is its twin): r = f - A psi
        in dtype, e from one cycle of ``inner`` on A e = r from a zeros
        array (so the fine level runs the down-leg from u, as the JAX
        package's does), psi + e in dtype.  Returns (psi_new, rms_update,
        residual norm) as ``step``; the residual norm is ||r|| of the
        INCOMING iterate, accumulated in at least f32."""
        spec, mesh, h = self.spec, self.mesh, self.spec.fine_h
        r = residual(psi, f, h, mesh)
        sd = getattr(torch, self.inner.spec.dtype)
        e = self.inner.cycle(torch.zeros_like(r, dtype=sd), r.to(sd), h, spec.size, True)[0]
        psi_new = psi + e.to(psi.dtype)
        zero = torch.zeros((), dtype=psi.dtype, device=psi.device)
        if spec.stop == "update":
            return psi_new, self._update_rms(psi_new, psi), zero
        return psi_new, zero, torch.sqrt(all_reduce_sum(_sq_sum(r), mesh)).to(psi.dtype)

    def _update_rms(self, psi_new, psi):
        """The RMS of the update over the whole grid, all-reduced."""
        spec = self.spec
        sq = all_reduce_sum(_sq_sum(psi_new - psi), self.mesh)
        return torch.sqrt(sq / spec.size ** spec.ndim)

    def _step(self, psi, f, cycle):
        spec = self.spec
        zero = torch.zeros((), dtype=psi.dtype, device=psi.device)
        if spec.stop == "update":
            psi_new = cycle(False)[0]
            return psi_new, self._update_rms(psi_new, psi), zero
        psi_new, r2 = cycle(True)
        return psi_new, zero, torch.sqrt(self._global_r2(psi_new, r2, f)).to(psi.dtype)

    def residual_norm(self, psi, f):
        """||r|| of the zero-ghost residual over the whole grid, summed as
        the JAX solver sums it on the global array (xla.residual_norm, the
        solve's r0): the squares in psi's dtype, accumulated in at least f32
        (each rank's share, then all-reduced), the sum rounded once to psi's
        dtype and its root taken there.  XLA on the CPU reduces a bf16 array
        so, in f32 with one rounding; in f32 and f64 this is the plain sum."""
        r = residual(psi, f, self.spec.fine_h, self.mesh)
        sq = r * r
        s = all_reduce_sum(torch.sum(sq.to(ops._acc_dtype(sq.dtype))), self.mesh)
        return torch.sqrt(s.to(psi.dtype))

    def rel_err(self, psi, psi_old):
        """ops.rel_err over the whole grid: the masked sum and its count
        all-reduced."""
        mask = (psi_old != 0) & (psi_old != psi)
        vals = torch.where(mask, torch.abs(1.0 - psi / torch.where(mask, psi_old, 1.0)), 0.0)
        tot = all_reduce_sum(torch.stack([torch.sum(vals).double(),
                                          torch.sum(mask).double()]), self.mesh)
        return torch.where(tot[1] > 0, tot[0] / torch.clamp(tot[1], min=1), 0.0).to(psi.dtype)
