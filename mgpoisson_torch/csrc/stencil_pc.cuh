// The up-leg of the 2D register tile (stencil.cuh) on a block of the grid,
// shared by the sources that instance it: K3 mg_prolong_correct_smooth and
// K10 mg_sharded_pc with K3's bf16 form (mg_prolong_correct_smooth.cu), and
// K10's bf16 form (mg_sharded_pc_bf16.cu, a source of its own so that nvcc
// builds its instances in parallel with the others).  See
// mg_prolong_correct_smooth.cu.
#pragma once

#include "stencil.cuh"

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

// u += (p0, p1) on row i of a lane's registers, (p0, p1) P(V) of its two
// cells: two f32 adds; on words P rounded once to a pair (as torch rounds
// the f32 blend to bf16) and one bf16x2 add.
template <int R>
static __device__ __forceinline__ void mg2_add_p(Mg2Pair<R>& u, int i, float p0, float p1) {
  u.x0[i] = __fadd_rn(u.x0[i], p0);
  u.x1[i] = __fadd_rn(u.x1[i], p1);
}
template <int R>
static __device__ __forceinline__ void mg2_add_p(Mg2Word<R>& u, int i, float p0, float p1) {
  u.w[i] = Mg2X2::add(u.w[i], Mg2X2::pack(p0, p1));
}

// u += P(V) on the warp's in-grid cells.  Fine row i of the tile lies in
// coarse row i/2 (the origin is even), so coarse rows -1 .. R/2 of the
// tile cover the bilinear +-1 shifts; vc[k] is the lane's coarse column in
// coarse row k - 1.
template <int R, bool kStrips, bool kEdge, class T, class U>
static __device__ __forceinline__ void mg2_correct(U& u, const Mg2ArgsOf<T>& a,
                                                   const Mg2Tile& t) {
  using E = Mg2Elem<T>;
  constexpr int K = R / 2 + 2;
  const int lI0 = t.li0 / 2 - 1, gI0 = t.gi0 / 2 - 1;
  const int lJ = t.lj0 / 2 + t.lane, gJ = t.gj0 / 2 + t.lane;
  const bool outer = t.lane == 0 || t.lane == 31;
  const int side = t.lane == 0 ? -1 : 1;
  const Mg2Cols c = mg2_cols_of(t);
  float vc[K];
  if (!kEdge) {
    const T* p = a.V + (size_t)lI0 * (t.ml / 2) + lJ;
#pragma unroll
    for (int k = 0; k < K; ++k) vc[k] = E::ldg(p + (size_t)k * (t.ml / 2));
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      vc[k] = mg2_coarse<kStrips>(a.V, a.vs, t, lI0 + k, lJ, gI0 + k, gJ);
  }
  if (a.kind == MG_INJECT) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool in = !kEdge || (c.in && mg_in(t.gi0 + i, t.n));
      if (in) mg2_add_p(u, i, vc[i / 2 + 1], vc[i / 2 + 1]);
    }
    return;
  }
  // the coarse columns left (l) and right (r) of the lane's, from the lanes
  // beside it; lanes 0 and 31 load their outer one
  auto side_of = [&](int k, float& l, float& r) {
    float e = 0.f;
    if (outer)
      e = kEdge ? mg2_coarse<kStrips>(a.V, a.vs, t, lI0 + k, lJ + side, gI0 + k, gJ + side)
                : E::ldg(a.V + (size_t)(lI0 + k) * (t.ml / 2) + (lJ + side));
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
      if (in) mg2_add_p(u, i, p0, p1);
    }
    lm = lc;
    rm = rc;
    lc = lp;
    rc = rp;
  }
}

template <int kSm, int R, bool kStrips, bool kEdge, class T>
static __device__ __forceinline__ float mg2_pc_tile(const Mg2ArgsOf<T>& a, const Mg2Tile& t) {
  Mg2Regs<T, R> u;
  Mg2Regs<T, R> f;
  mg2_load<R, kStrips, kEdge>(u, a.U, a.us, t);
  mg2_correct<R, kStrips, kEdge>(u, a, t);
  mg2_load<R, kStrips, kEdge>(f, a.F, a.fs, t);
  mg2_sweeps<kSm, R, kEdge>(u, f, t, a.nu, a.bc, a.inv_hsq, a.inv_adiag);
  mg2_store<R, kEdge>(a.Uout, u, t);
  if (a.partials == nullptr) return 0.f;
  return mg2_rsq<R, kEdge>(u, f, t, a.inv_hsq, a.adiag);
}

// The leg on the block a.blk; each entry point below instantiates it.
template <int kSm, int R, bool kStrips, class T>
static __device__ __forceinline__ void mg2_pc_body(const Mg2ArgsOf<T>& a) {
  const Mg2Tile t = mg2_tile<R>(a.blk, a.H);
  float acc = 0.f;
  if (mg2_owns(t))
    acc = mg2_inside<R>(t) ? mg2_pc_tile<kSm, R, kStrips, false>(a, t)
                           : mg2_pc_tile<kSm, R, kStrips, true>(a, t);
  if (a.partials != nullptr) mg2_partial(acc, a.partials);
}

// The C entry of a strip kernel (K10, its bf16 form) on one rank's (nl x ml)
// block at global (r0, c0) of an n x n level, launching L with argument
// struct A; u and f strips D >= steps (+ 1 with rnorm) deep, V's coarse
// strips DV >= ceil(D'/2) + 1 for that depth D' (the left/right ones null on
// a mesh of one column).
template <class L, class A, class T>
static int mg_sharded_pc_entry(const T* u, const T* f, const T* V, T* out, float* partials,
                               const T* ut, const T* ub, const T* ul, const T* ur,
                               const T* ft, const T* fb, const T* fl, const T* fr,
                               const T* vt, const T* vb, const T* vl, const T* vr, int n,
                               int nl, int ml, int r0, int c0, int D, int DV, int nu,
                               int smoother, int bc, int kind, float inv_hsq, float inv_adiag,
                               float adiag, int rnorm, cudaStream_t stream) {
  using S = MgStripsOf<T>;
  const int reach = mg_steps(nu, smoother) + (rnorm ? 1 : 0), H = mg_steps(nu, smoother) + 1;
  if (nl < 2 || ml < 2 || (nl | ml | r0 | c0) & 1 || nu < 0 || D < reach ||
      DV < (reach + 1) / 2 + 1 || mg2_halo(H) > MG2_MAX_HALO)
    return (int)cudaErrorInvalidValue;
  if (!mg2_aligned<T>(u, f, out, ut, ub, ft, fb)) return (int)cudaErrorMisalignedAddress;
  A a{};
  a.U = u;
  a.F = f;
  a.V = V;
  a.Uout = out;
  a.partials = rnorm ? partials : nullptr;
  a.blk = MgBlock{n, nl, ml, r0, c0};
  a.us = S{ut, ub, ul, ur, D};
  a.fs = S{ft, fb, fl, fr, D};
  a.vs = S{vt, vb, vl, vr, DV};
  a.H = H;
  a.nu = nu;
  a.bc = bc;
  a.kind = kind;
  a.inv_hsq = inv_hsq;
  a.inv_adiag = inv_adiag;
  a.adiag = adiag;
  return mg2_launch<L>(smoother, mg2_rows(nl, ml, H), mg2_grid(nl, ml, H), stream, a);
}
