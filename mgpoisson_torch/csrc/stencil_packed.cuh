// The 2D register tile of stencil.cuh on checkerboard-packed state: the
// pieces of the fast scheme's packed fine-level legs that differ from the
// unpacked legs' (the loader, the store, the packed ops' sweep, residual,
// restriction and bilinear blend), for the down-leg K7 mg_packed_rr and its
// strip entry K13 mg_sharded_packed_rr, and the up-leg K8 mg_packed_pc and
// its strip entry K14 mg_sharded_packed_pc.  Geometry, checked and
// unchecked bodies, shuffles, strip picks and the Sigma r^2 partial are
// stencil.cuh's, unchanged.
//
// The fine level stays packed for the whole fast solve (kernels/ops.py
// pack_grid): an (n, n) array whose left half holds the red cells and right
// half the black,
//
//   up[i][j]     = u[i][2j + i%2]        (red, parity 0)
//   up[i][w + j] = u[i][2j + 1 - i%2]    (black), w = n/2.
//
// The fine geometry of an n x n packed level is the register tile's on an
// n x n unpacked one: lane L of a warp holds fine columns 2J and 2J + 1, J
// = its packed lane, in (x0, x1).  On an even row those are red J and black
// J, on an odd row black J and red J, so the loader reads row[J] and
// row[w + J] (two coalesced 4-byte loads per lane, 128 bytes per warp and
// plane) and swaps them on odd rows; the store swaps back.  Every tile
// origin is even (the halo Hr is), so the swap of each unrolled row is
// known at compile time and costs nothing.  The coarse column of the pair
// is packed lane J too, so the UNPACKED (n/2, n/2) coarse arrays are read
// (V, as K3 reads it) and written (Rc, as K2 writes R) lane by lane.
//
// In the pair's terms the packed neighbours of a cell are the unpacked
// ones: for x0 the "same lane" neighbour of the other colour is x1 and the
// "partner lane" the x1 of the lane to the left, for x1 they are x0 and the
// x0 to the right, on either row parity.  Red is the colour of (i, 2J) on
// even rows, so red-black colour steps are stencil.cuh's (colour P: x0 on
// rows with i % 2 == P, x1 on the others).  The arithmetic is that of the
// packed ops (ops._packed_core, _packed_residual, _packed_prolong,
// packed_smooth_residual_restrict), which differs from the unpacked legs'
// in form and order:
//
//   sweep     X = ((up + dn) + (same + partner)) * 0.25 + f * (-h^2/4)
//   residual  r = f - ((((up + dn) + same) + partner) - 4 x) * (1/h^2)
//   restrict  Rc = ((r_red + r_black on row 2I) + (the same on row 2I + 1))
//             * 0.25: the rows' sums first, where mg2_restrict sums the
//             columns first
//   prolong   B = a0 V + b0 V(partner coarse row), then a1 B + b1 B(lane
//             beside), each pass with (0.5, 0) at the grid's edge lines
//
// each add and multiply rounded on its own (__fadd_rn, __fmul_rn), so every
// output equals the plain packed ops bit for bit.  The bf16 forms of K7/K8
// run the packed word tile (stencil_packed_w.cuh), which takes mg2p_mix and
// MG2P_MAX_NU from here.  The bc is ghost0 (the fine level's by
// definition): cells outside the grid load 0 and are never updated.  Halo:
// H = 2 nu steps, + 1 where a residual reads one more ring (the down-leg,
// the up-leg with rnorm); the tile rounds it up to even.
#pragma once

#include "stencil.cuh"

#define MG2P_MAX_NU 3   // the JAX package's packed cap (pallas.py packed_plan)

// Everything a packed leg takes: V, vs, kind and partials (only with
// rnorm) for the up-leg, Rout for the down-leg.
struct Mg2pArgs {
  const float* U;
  const float* F;
  const float* V;
  float* Uout;
  float* partials;
  MgBlock blk;
  MgStrips us, fs, vs;
  int H, nu, kind;
  float mhq, inv_hsq;   // -h^2/4 and 1/h^2, as the plain packed ops
  float* Rout;
};

// Loads the warp's R rows of the packed X (a block of whole rows, c0 = 0)
// into x: row i's red and black lane J in (x0, x1) on even rows and in
// (x1, x0) on odd ones; cells outside the grid read 0.
template <int R, bool kStrips, bool kEdge>
static __device__ __forceinline__ void mg2p_load(Mg2Pair<R>& x, const float* __restrict__ X,
                                                 const MgStrips& s, const Mg2Tile& t) {
  const int w = t.n / 2, J = t.lj0 / 2 + t.lane;
  if (!kEdge) {
    const float* p = X + (size_t)t.li0 * t.ml + J;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float a = __ldg(p + (size_t)i * t.ml), b = __ldg(p + (size_t)i * t.ml + w);
      x.x0[i] = i & 1 ? b : a;
      x.x1[i] = i & 1 ? a : b;
    }
    return;
  }
  const bool col_in = mg_in(t.gj0 + 2 * t.lane, t.n);   // n and the column even: J < w
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float a = 0.f, b = 0.f;
    if (col_in && mg_in(t.gi0 + i, t.n)) {
      if (kStrips) {
        a = mg_fetch(X, s, t.li0 + i, J, t.nl, t.ml);
        b = mg_fetch(X, s, t.li0 + i, w + J, t.nl, t.ml);
      } else {
        const float* p = X + (size_t)(t.gi0 + i) * t.n + J;
        a = p[0];
        b = p[w];
      }
    }
    x.x0[i] = i & 1 ? b : a;
    x.x1[i] = i & 1 ? a : b;
  }
}

// Writes the warp's interior back to the block's packed (nl x n) array.
template <int R, bool kEdge>
static __device__ __forceinline__ void mg2p_store(float* __restrict__ out, const Mg2Pair<R>& u,
                                                  const Mg2Tile& t) {
  if (!mg2_lane_owns<kEdge>(t)) return;
  const int w = t.n / 2;
  float* p = out + (t.lj0 / 2 + t.lane);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int li = t.li0 + i;
    if (i >= t.hr && i < R - t.hr && (!kEdge || mg_in(li, t.nl))) {
      float* q = p + (size_t)li * t.ml;
      q[0] = i & 1 ? u.x1[i] : u.x0[i];   // red
      q[w] = i & 1 ? u.x0[i] : u.x1[i];   // black
    }
  }
}

// One weighted pair a x + b y, as the packed prolongation's blends.
static __device__ __forceinline__ float mg2p_mix(float a, float x, float b, float y) {
  return __fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y));
}

// up += P(V) on the warp's in-grid cells (ops._packed_prolong).  vc[k] is
// the lane's coarse column in coarse row k - 1 of the tile, as in K3's
// mg2_correct; the bilinear row blend B of the lane's own column and of the
// columns beside it (from the lanes beside it, lanes 0 and 31 load their
// outer one), then the lane blend: x0 with the column to the left, x1 with
// the one to the right.
template <int R, bool kStrips, bool kEdge>
static __device__ __forceinline__ void mg2p_correct(Mg2Pair<R>& u, const Mg2pArgs& a,
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
  auto side_of = [&](int k, float& l, float& r) {
    float e = 0.f;
    if (outer)
      e = kEdge ? mg2_coarse<kStrips>(a.V, a.vs, t, lI0 + k, lJ + side, gI0 + k, gJ + side)
                : __ldg(a.V + (size_t)(lI0 + k) * (t.ml / 2) + (lJ + side));
    const float fl = mg2_from_left(vc[k]), fr = mg2_from_right(vc[k]);
    l = t.lane == 0 ? e : fl;
    r = t.lane == 31 ? e : fr;
  };
  // the lane blend's weights: (0.5, 0) where the column beside is off the grid
  const float a1l = kEdge && c.lo0 ? 0.5f : 0.75f, b1l = kEdge && c.lo0 ? 0.f : 0.25f;
  const float a1r = kEdge && c.hi1 ? 0.5f : 0.75f, b1r = kEdge && c.hi1 ? 0.f : 0.25f;
  // coarse rows k - 1, k, k + 1 of the tile (m, c, p), rolled down the rows
  float lm, rm, lc, rc;
  side_of(0, lm, rm);
  side_of(1, lc, rc);
#pragma unroll
  for (int k = 1; k < K - 1; ++k) {
    float lp, rp;
    side_of(k + 1, lp, rp);
#pragma unroll
    for (int d = 0; d < 2; ++d) {   // fine row i: even rows blend up, odd rows down
      const int i = 2 * (k - 1) + d, gi = t.gi0 + i;
      const bool row_edge = kEdge && (gi == 0 || gi == t.n - 1);
      const bool in = !kEdge || (c.in && mg_in(gi, t.n));
      const float a0 = row_edge ? 0.5f : 0.75f, b0 = row_edge ? 0.f : 0.25f;
      const float B = mg2p_mix(a0, vc[k], b0, d ? vc[k + 1] : vc[k - 1]);
      const float Bl = mg2p_mix(a0, lc, b0, d ? lp : lm);
      const float Br = mg2p_mix(a0, rc, b0, d ? rp : rm);
      if (in) {
        u.x0[i] = __fadd_rn(u.x0[i], mg2p_mix(a1l, B, b1l, Bl));
        u.x1[i] = __fadd_rn(u.x1[i], mg2p_mix(a1r, B, b1r, Br));
      }
    }
    lm = lc;
    rm = rc;
    lc = lp;
    rc = rp;
  }
}

// The packed sweep's update of one cell (ops._packed_core).
static __device__ __forceinline__ float mg2p_relax(float up, float dn, float same, float partner,
                                                   float f, float mhq) {
  return __fadd_rn(__fmul_rn(__fadd_rn(__fadd_rn(up, dn), __fadd_rn(same, partner)), 0.25f),
                   __fmul_rn(f, mhq));
}

// The packed residual of one cell (ops._packed_residual).
static __device__ __forceinline__ float mg2p_resid(float x, float up, float dn, float same,
                                                   float partner, float f, float inv_hsq) {
  const float nbr = __fadd_rn(__fadd_rn(__fadd_rn(up, dn), same), partner);
  return __fsub_rn(f, __fmul_rn(__fsub_rn(nbr, __fmul_rn(4.f, x)), inv_hsq));
}

// One colour step: cells with (global row + column) % 2 == P, red for P = 0
// (see stencil.cuh mg2_colour); cells outside the grid keep their 0.
template <int P, int R, bool kEdge>
static __device__ __forceinline__ void mg2p_colour(Mg2Pair<R>& u, const Mg2Pair<R>& f,
                                                   const Mg2Tile& t, const Mg2Cols& c,
                                                   float mhq) {
#pragma unroll
  for (int i = 1; i < R - 1; ++i) {
    const bool in = !kEdge || (c.in && mg_in(t.gi0 + i, t.n));
    if ((i & 1) == P) {
      const float v = mg2p_relax(u.x0[i - 1], u.x0[i + 1], u.x1[i], mg2_from_left(u.x1[i]),
                                 f.x0[i], mhq);
      if (in) u.x0[i] = v;
    } else {
      const float v = mg2p_relax(u.x1[i - 1], u.x1[i + 1], u.x0[i], mg2_from_right(u.x0[i]),
                                 f.x1[i], mhq);
      if (in) u.x1[i] = v;
    }
  }
}

// nu red-black sweeps, red first, on the warp's registers.
template <int R, bool kEdge>
static __device__ __forceinline__ void mg2p_sweeps(Mg2Pair<R>& u, const Mg2Pair<R>& f,
                                                   const Mg2Tile& t, int nu, float mhq) {
  const Mg2Cols c = mg2_cols_of(t);
#pragma unroll 1
  for (int s = 0; s < nu; ++s) {
    // the checked body's row tests, made anew each sweep (see mg2_sweeps)
    Mg2Tile ts = t;
    if (kEdge) asm volatile("" : "+r"(ts.gi0));
    mg2p_colour<0, R, kEdge>(u, f, ts, c, mhq);
    mg2p_colour<1, R, kEdge>(u, f, ts, c, mhq);
  }
}

// The ghost0 residual of row i's pair (x0, x1) (ops._packed_residual).
template <int R>
static __device__ __forceinline__ float2 mg2p_resid2(const Mg2Pair<R>& u, const Mg2Pair<R>& f,
                                                     int i, float inv_hsq) {
  const float x0 = u.x0[i], x1 = u.x1[i];
  return make_float2(
      mg2p_resid(x0, u.x0[i - 1], u.x0[i + 1], x1, mg2_from_left(x1), f.x0[i], inv_hsq),
      mg2p_resid(x1, u.x1[i - 1], u.x1[i + 1], x0, mg2_from_right(x0), f.x1[i], inv_hsq));
}

// sum(r^2) of the ghost0 residual over the warp's owned cells.
template <int R, bool kEdge>
static __device__ __forceinline__ float mg2p_rsq(const Mg2Pair<R>& u, const Mg2Pair<R>& f,
                                                 const Mg2Tile& t, float inv_hsq) {
  const bool owns = mg2_lane_owns<kEdge>(t);
  float acc = 0.f;
#pragma unroll
  for (int i = 1; i < R - 1; ++i) {
    if (i < t.hr || i >= R - t.hr) continue;   // the same for every lane
    const float2 r = mg2p_resid2<R>(u, f, i, inv_hsq);
    if (owns && (!kEdge || mg_in(t.li0 + i, t.nl))) {
      acc = __fmaf_rn(r.x, r.x, acc);
      acc = __fmaf_rn(r.y, r.y, acc);
    }
  }
  return acc;
}

// The ghost0 residual of the warp's interior, restricted into the block's
// UNPACKED (nl/2 x n/2) coarse rhs: a lane's pair over a row pair is one
// coarse cell, coarse column J = its packed lane (mg2_restrict's geometry),
// one coalesced 4-byte store per lane and row pair.  The pair holds red and
// black on either row parity (swapped on odd rows), so each row's r_red +
// r_black is x0's plus x1's in that order or the other, the same sum.
template <int R, bool kEdge>
static __device__ __forceinline__ void mg2p_restrict(float* __restrict__ Rout,
                                                     const Mg2Pair<R>& u, const Mg2Pair<R>& f,
                                                     const Mg2Tile& t, float inv_hsq) {
  const int J = t.lj0 / 2 + t.lane, w = t.n / 2;
  const bool owns = mg2_lane_owns<kEdge>(t);
#pragma unroll
  for (int i = 2; i < R - 2; i += 2) {
    if (i < t.hr || i >= R - t.hr) continue;   // the same for every lane
    const float2 r0 = mg2p_resid2<R>(u, f, i, inv_hsq);
    const float2 r1 = mg2p_resid2<R>(u, f, i + 1, inv_hsq);
    const int I = (t.li0 + i) / 2;
    if (owns && (!kEdge || mg_in(I, t.nl / 2)))
      Rout[(size_t)I * w + J] =
          __fmul_rn(__fadd_rn(__fadd_rn(r0.x, r0.y), __fadd_rn(r1.x, r1.y)), 0.25f);
  }
}

template <int R, bool kStrips, bool kEdge>
static __device__ __forceinline__ float mg2p_pc_tile(const Mg2pArgs& a, const Mg2Tile& t) {
  Mg2Pair<R> u;
  Mg2Pair<R> f;
  mg2p_load<R, kStrips, kEdge>(u, a.U, a.us, t);
  mg2p_correct<R, kStrips, kEdge>(u, a, t);
  mg2p_load<R, kStrips, kEdge>(f, a.F, a.fs, t);
  mg2p_sweeps<R, kEdge>(u, f, t, a.nu, a.mhq);
  mg2p_store<R, kEdge>(a.Uout, u, t);
  if (a.partials == nullptr) return 0.f;
  return mg2p_rsq<R, kEdge>(u, f, t, a.inv_hsq);
}

// The packed up-leg on the block a.blk ({n, n, n, 0, 0} for the grid).
template <int R, bool kStrips>
static __device__ __forceinline__ void mg2p_pc_body(const Mg2pArgs& a) {
  const Mg2Tile t = mg2_tile<R>(a.blk, a.H);
  float acc = 0.f;
  if (mg2_owns(t))
    acc = mg2_inside<R>(t) ? mg2p_pc_tile<R, kStrips, false>(a, t)
                           : mg2p_pc_tile<R, kStrips, true>(a, t);
  if (a.partials != nullptr) mg2_partial(acc, a.partials);
}

template <int R, bool kStrips, bool kEdge>
static __device__ __forceinline__ void mg2p_rr_tile(const Mg2pArgs& a, const Mg2Tile& t) {
  Mg2Pair<R> u;
  Mg2Pair<R> f;
  mg2p_load<R, kStrips, kEdge>(u, a.U, a.us, t);
  mg2p_load<R, kStrips, kEdge>(f, a.F, a.fs, t);
  mg2p_sweeps<R, kEdge>(u, f, t, a.nu, a.mhq);
  mg2p_store<R, kEdge>(a.Uout, u, t);
  mg2p_restrict<R, kEdge>(a.Rout, u, f, t, a.inv_hsq);
}

// The packed down-leg on the block a.blk ({n, n, n, 0, 0} for the grid).
template <int R, bool kStrips>
static __device__ __forceinline__ void mg2p_rr_body(const Mg2pArgs& a) {
  const Mg2Tile t = mg2_tile<R>(a.blk, a.H);
  if (!mg2_owns(t)) return;
  if (mg2_inside<R>(t))
    mg2p_rr_tile<R, kStrips, false>(a, t);
  else
    mg2p_rr_tile<R, kStrips, true>(a, t);
}

// Launches L::go<R, kStrips> (one leg's instances) for the tile table's R
// on the (nl x n) block a.blk at halo a.H; returns the launch's error.
template <class L, bool kStrips>
static __host__ int mg2p_launch(const Mg2pArgs& a, cudaStream_t stream) {
  const int R = mg2_rows(a.blk.nl, a.blk.ml, a.H);
  const dim3 grid = mg2_grid(a.blk.nl, a.blk.ml, a.H), block(32, MG2_WARPS);
  if (R == MG2_ROWS_DEEP)
    L::template go<MG2_ROWS_DEEP, kStrips>(grid, block, stream, a);
  else if (R == MG2_ROWS_SHALLOW)
    L::template go<MG2_ROWS_SHALLOW, kStrips>(grid, block, stream, a);
  else
    L::template go<MG2_ROWS_SMALL, kStrips>(grid, block, stream, a);
  return (int)cudaGetLastError();
}
