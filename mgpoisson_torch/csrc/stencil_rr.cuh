// The down-leg of the 2D register tile (stencil.cuh) on a block of the grid,
// shared by the sources that instance it: K2 mg_smooth_rr and K9
// mg_sharded_rr with K2's bf16 form (mg_smooth_rr.cu), and K9's bf16 form
// (mg_sharded_rr_bf16.cu, a source of its own so that nvcc builds its
// instances in parallel with the others).  See mg_smooth_rr.cu.
#pragma once

#include "stencil.cuh"

template <int kSm, int R, bool kStrips, bool kEdge, class T>
static __device__ __forceinline__ void mg2_rr_tile(const Mg2ArgsOf<T>& a, const Mg2Tile& t) {
  Mg2Regs<T, R> u;
  Mg2Regs<T, R> f;
  if (a.U)
    mg2_load<R, kStrips, kEdge>(u, a.U, a.us, t);
  else
    u = {};
  mg2_load<R, kStrips, kEdge>(f, a.F, a.fs, t);
  mg2_sweeps<kSm, R, kEdge>(u, f, t, a.nu, a.bc, a.inv_hsq, a.inv_adiag, a.U == nullptr);
  mg2_store<R, kEdge>(a.Uout, u, t);
  mg2_restrict<R, kEdge>(a.Rout, u, f, t, a.bc, a.inv_hsq, a.adiag);
}

// The leg on the block a.blk; each entry point below instantiates it.
template <int kSm, int R, bool kStrips, class T>
static __device__ __forceinline__ void mg2_rr_body(const Mg2ArgsOf<T>& a) {
  const Mg2Tile t = mg2_tile<R>(a.blk, a.H);
  if (!mg2_owns(t)) return;
  if (mg2_inside<R>(t))
    mg2_rr_tile<kSm, R, kStrips, false>(a, t);
  else
    mg2_rr_tile<kSm, R, kStrips, true>(a, t);
}

// The C entry of a strip kernel (K9, its bf16 form) on one rank's (nl x ml)
// block at global (r0, c0) of an n x n level, launching L with argument
// struct A on warps of L::rows(R) loaded rows for the tile table's R; u and
// f strips D >= H deep (ut..ur unused from zero; ul/ur and fl/fr null on a
// mesh of one column).
template <class L, class A, class T>
static int mg_sharded_rr_entry(const T* u, const T* f, T* out, T* R, const T* ut, const T* ub,
                               const T* ul, const T* ur, const T* ft, const T* fb,
                               const T* fl, const T* fr, int n, int nl, int ml, int r0, int c0,
                               int D, int nu, int smoother, int bc, float inv_hsq,
                               float inv_adiag, float adiag, int zero, cudaStream_t stream) {
  using S = MgStripsOf<T>;
  const int H = mg_steps(nu, smoother) + 1;
  if (nl < 2 || ml < 2 || (nl | ml | r0 | c0) & 1 || nu < 0 || D < H ||
      mg2_halo(H) > MG2_MAX_HALO)
    return (int)cudaErrorInvalidValue;
  if (!mg2_aligned<T>(f, ft, fb, out) || (!zero && !mg2_aligned<T>(u, ut, ub)))
    return (int)cudaErrorMisalignedAddress;
  A a{};
  a.U = zero ? nullptr : u;
  a.F = f;
  a.Uout = out;
  a.Rout = R;
  a.blk = MgBlock{n, nl, ml, r0, c0};
  a.us = zero ? S{nullptr, nullptr, nullptr, nullptr, D} : S{ut, ub, ul, ur, D};
  a.fs = S{ft, fb, fl, fr, D};
  a.H = H;
  a.nu = nu;
  a.bc = bc;
  a.inv_hsq = inv_hsq;
  a.inv_adiag = inv_adiag;
  a.adiag = adiag;
  const int rows = L::rows(mg2_rows(nl, ml, H));
  return mg2_launch<L>(smoother, rows, mg2_grid_rows(nl, ml, H, rows), stream, a);
}
