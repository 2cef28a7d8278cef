// K3 mg_prolong_correct_smooth and K10 mg_sharded_pc: the V-cycle up-leg.
// u += P(V), with P the piecewise-constant (inject) or face-adapted
// bilinear prolongation, then nu smoother sweeps; writes u.  With a
// partials buffer (the rnorm flag) it also writes one f32 partial of
// sum(r^2) per block, r being the ZERO-GHOST residual of the result
// whatever the level's bc (the solver's stopping metric), over the cells
// the launch stores; the caller sums the partials, so runs are
// deterministic.
//
// K3 replaces the Pallas kernels behind prolong_correct_smooth and
// prolong_correct_smooth_rnorm: _pc_smooth_fused (row stripes), _pc_whole
// (whole array) and _pc_fused_wide (two-axis blocks),
// mgpoisson/kernels/pallas.py.
//
// K10 replaces _pc_sharded, mgpoisson/kernels/pallas.py, behind
// pc_smooth_sharded: the same leg on one rank's (nl x ml) block of a
// sharded level, the fine halo read from the u and f strips and the coarse
// halo from V's coarse strips (stencil.cuh MgStrips), with the boundary,
// the colour and the bilinear edge weights from the global index.
//
// Bound: HBM bytes, 3.25 arrays (read u, f, V; write u); the strips add
// 4D/nl + 4D/ml of an array for u and f and 4 DV/nl + 4 DV/ml of V.
// Design (stencil.cuh): one warp per 64-column register tile with H =
// steps + 1 whether or not rnorm reads the extra ring (one instance for
// both); lane L's coarse column is its pair's parent, so a coarse row is
// one 4-byte load per lane, and the bilinear taps across pairs come from
// the lanes beside it (the two outer lanes load theirs).  Sum(r^2) is a
// butterfly of shuffles per warp and an ordered sum of the block's warps.
#include "stencil.cuh"

// Coarse cell (lI, lJ) of the block's V (global (gI, gJ)), 0 outside the
// coarse grid: from the array or, fed by strips, from the one that holds it.
template <bool kStrips>
static __device__ __forceinline__ float mg2_coarse(const float* __restrict__ V,
                                                   const MgStrips& vs, const Mg2Tile& t, int lI,
                                                   int lJ, int gI, int gJ) {
  const int nc = t.n / 2;
  if (!mg_in(gI, nc) || !mg_in(gJ, nc)) return 0.f;
  if (kStrips) return mg_fetch(V, vs, lI, lJ, t.nl / 2, t.ml / 2);
  return V[(size_t)gI * nc + gJ];
}

// P(V) of one fine cell in ops.prolong's order: per axis the bilinear
// weights are (a, b) = (0.75, 0.25) inside and (0.5, 0) at the GLOBAL fine
// edges, R the parent, S0 the coarse neighbour across rows on the side of
// the cell's row parity, S1 across columns, S01 across both.
static __device__ __forceinline__ float mg2_blend(float R, float S0, float S1, float S01,
                                                  bool row_edge, bool col_edge) {
  const float a0 = row_edge ? 0.5f : 0.75f, b0 = row_edge ? 0.f : 0.25f;
  const float a1 = col_edge ? 0.5f : 0.75f, b1 = col_edge ? 0.f : 0.25f;
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a0 * a1, R), __fmul_rn(a0 * b1, S1)),
                             __fmul_rn(b0 * a1, S0)),
                   __fmul_rn(b0 * b1, S01));
}

// u += P(V) on the warp's in-grid cells.  Fine row i of the tile lies in
// coarse row i/2 (the origin is even), so coarse rows -1 .. R/2 of the
// tile cover the bilinear +-1 shifts; vc[k] is the lane's coarse column in
// coarse row k - 1.
template <int R, bool kStrips, bool kEdge>
static __device__ __forceinline__ void mg2_correct(Mg2Pair<R>& u, const Mg2Args& a,
                                                   const Mg2Tile& t) {
  constexpr int K = R / 2 + 2;
  const int lI0 = t.li0 / 2 - 1, gI0 = t.gi0 / 2 - 1;
  const int lJ = t.lj0 / 2 + t.lane, gJ = t.gj0 / 2 + t.lane;
  const bool outer = t.lane == 0 || t.lane == 31;
  const int side = t.lane == 0 ? -1 : 1;
  const Mg2Cols c = mg2_cols_of(t);
  float vc[K];
  if (!kEdge) {
    const float* p = a.V + (size_t)lI0 * (t.ml / 2) + lJ;
#pragma unroll
    for (int k = 0; k < K; ++k) vc[k] = __ldg(p + (size_t)k * (t.ml / 2));
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      vc[k] = mg2_coarse<kStrips>(a.V, a.vs, t, lI0 + k, lJ, gI0 + k, gJ);
  }
  if (a.kind == MG_INJECT) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool in = !kEdge || (c.in && mg_in(t.gi0 + i, t.n));
      if (in) {
        u.x0[i] = __fadd_rn(u.x0[i], vc[i / 2 + 1]);
        u.x1[i] = __fadd_rn(u.x1[i], vc[i / 2 + 1]);
      }
    }
    return;
  }
  // the coarse columns left (l) and right (r) of the lane's, from the lanes
  // beside it; lanes 0 and 31 load their outer one
  auto side_of = [&](int k, float& l, float& r) {
    float e = 0.f;
    if (outer)
      e = kEdge ? mg2_coarse<kStrips>(a.V, a.vs, t, lI0 + k, lJ + side, gI0 + k, gJ + side)
                : __ldg(a.V + (size_t)(lI0 + k) * (t.ml / 2) + (lJ + side));
    const float fl = mg2_from_left(vc[k]), fr = mg2_from_right(vc[k]);
    l = t.lane == 0 ? e : fl;
    r = t.lane == 31 ? e : fr;
  };
  // coarse rows k - 1, k, k + 1 of the tile (m, c, p), rolled down the rows
  float lm, rm, lc, rc;
  side_of(0, lm, rm);
  side_of(1, lc, rc);
#pragma unroll
  for (int k = 1; k < K - 1; ++k) {
    float lp, rp;
    side_of(k + 1, lp, rp);
#pragma unroll
    for (int d = 0; d < 2; ++d) {   // fine row i: even rows shift up, odd rows down
      const int i = 2 * (k - 1) + d, gi = t.gi0 + i;
      const bool row_edge = kEdge && (gi == 0 || gi == t.n - 1);
      const bool in = !kEdge || (c.in && mg_in(gi, t.n));
      const float S0 = d ? vc[k + 1] : vc[k - 1];
      const float p0 = mg2_blend(vc[k], S0, lc, d ? lp : lm, row_edge, kEdge && c.lo0);
      const float p1 = mg2_blend(vc[k], S0, rc, d ? rp : rm, row_edge, kEdge && c.hi1);
      if (in) {
        u.x0[i] = __fadd_rn(u.x0[i], p0);
        u.x1[i] = __fadd_rn(u.x1[i], p1);
      }
    }
    lm = lc;
    rm = rc;
    lc = lp;
    rc = rp;
  }
}

template <int kSm, int R, bool kStrips, bool kEdge>
static __device__ __forceinline__ float mg2_pc_tile(const Mg2Args& a, const Mg2Tile& t) {
  Mg2Pair<R> u;
  Mg2Pair<R> f;
  mg2_load<R, kStrips, kEdge>(u, a.U, a.us, t);
  mg2_correct<R, kStrips, kEdge>(u, a, t);
  mg2_load<R, kStrips, kEdge>(f, a.F, a.fs, t);
  mg2_sweeps<kSm, R, kEdge>(u, f, t, a.nu, a.bc, a.inv_hsq, a.inv_adiag);
  mg2_store<R, kEdge>(a.Uout, u, t);
  if (a.partials == nullptr) return 0.f;
  return mg2_rsq<R, kEdge>(u, f, t, a.inv_hsq, a.adiag);
}

// The leg on the block a.blk; each entry point below instantiates it.
template <int kSm, int R, bool kStrips>
static __device__ __forceinline__ void mg2_pc_body(const Mg2Args& a) {
  const Mg2Tile t = mg2_tile<R>(a.blk, a.H);
  float acc = 0.f;
  if (mg2_owns(t))
    acc = mg2_inside<R>(t) ? mg2_pc_tile<kSm, R, kStrips, false>(a, t)
                           : mg2_pc_tile<kSm, R, kStrips, true>(a, t);
  if (a.partials != nullptr) mg2_partial(acc, a.partials);
}

// K3: the whole n x n grid.
template <int kSm, int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_pc_kernel(const Mg2Args a) {
  mg2_pc_body<kSm, R, false>(a);
}

struct MgPcLaunch {
  template <int kSm, int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2Args& a) {
    mg_pc_kernel<kSm, R><<<grid, block, 0, stream>>>(a);
  }
};

// K10: one rank's block, its fine halo from the u and f strips and its
// coarse halo from V's.
template <int kSm, int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_sharded_pc_kernel(const Mg2Args a) {
  mg2_pc_body<kSm, R, true>(a);
}

struct MgShardedPcLaunch {
  template <int kSm, int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2Args& a) {
    mg_sharded_pc_kernel<kSm, R><<<grid, block, 0, stream>>>(a);
  }
};

extern "C" int mg_prolong_correct_smooth(const float* u, const float* f, const float* V,
                                         float* out, float* partials, int n, int nu,
                                         int smoother, int bc, int kind, float inv_hsq,
                                         float inv_adiag, float adiag, int rnorm,
                                         cudaStream_t stream) {
  const int H = mg_steps(nu, smoother) + 1;
  if (n < 2 || n & 1 || nu < 0 || mg2_halo(H) > MG2_MAX_HALO) return (int)cudaErrorInvalidValue;
  if (!mg2_aligned(u, f, out)) return (int)cudaErrorMisalignedAddress;
  Mg2Args a{};
  a.U = u;
  a.F = f;
  a.V = V;
  a.Uout = out;
  a.partials = rnorm ? partials : nullptr;
  a.blk = MgBlock{n, n, n, 0, 0};
  a.H = H;
  a.nu = nu;
  a.bc = bc;
  a.kind = kind;
  a.inv_hsq = inv_hsq;
  a.inv_adiag = inv_adiag;
  a.adiag = adiag;
  return mg2_launch<MgPcLaunch>(smoother, mg2_rows(n, n, H),
                                          mg2_grid(n, n, H), stream, a);
}

// One rank's (nl x ml) block at global (r0, c0) of an n x n level; u and f
// strips D >= steps (+ 1 with rnorm) deep, V's coarse strips DV >=
// ceil(D'/2) + 1 for that depth D' (the left/right ones null on a mesh of
// one column).  The tile's halo is steps + 1 either way: a halo cell
// beyond the strips reads 0 and stays outside the exact region.  With
// rnorm, one partial per block of mg2_grid (kernels/cuda.py tile2d).
extern "C" int mg_sharded_pc(const float* u, const float* f, const float* V, float* out,
                             float* partials, const float* ut, const float* ub,
                             const float* ul, const float* ur, const float* ft,
                             const float* fb, const float* fl, const float* fr,
                             const float* vt, const float* vb, const float* vl,
                             const float* vr, int n, int nl, int ml, int r0, int c0, int D,
                             int DV, int nu, int smoother, int bc, int kind, float inv_hsq,
                             float inv_adiag, float adiag, int rnorm, cudaStream_t stream) {
  const int reach = mg_steps(nu, smoother) + (rnorm ? 1 : 0), H = mg_steps(nu, smoother) + 1;
  if (nl < 2 || ml < 2 || (nl | ml | r0 | c0) & 1 || nu < 0 || D < reach ||
      DV < (reach + 1) / 2 + 1 || mg2_halo(H) > MG2_MAX_HALO)
    return (int)cudaErrorInvalidValue;
  if (!mg2_aligned(u, f, out, ut, ub, ft, fb)) return (int)cudaErrorMisalignedAddress;
  Mg2Args a{};
  a.U = u;
  a.F = f;
  a.V = V;
  a.Uout = out;
  a.partials = rnorm ? partials : nullptr;
  a.blk = MgBlock{n, nl, ml, r0, c0};
  a.us = MgStrips{ut, ub, ul, ur, D};
  a.fs = MgStrips{ft, fb, fl, fr, D};
  a.vs = MgStrips{vt, vb, vl, vr, DV};
  a.H = H;
  a.nu = nu;
  a.bc = bc;
  a.kind = kind;
  a.inv_hsq = inv_hsq;
  a.inv_adiag = inv_adiag;
  a.adiag = adiag;
  return mg2_launch<MgShardedPcLaunch>(smoother, mg2_rows(nl, ml, H),
                                                 mg2_grid(nl, ml, H), stream, a);
}
