// K2 mg_smooth_rr and K9 mg_sharded_rr: the V-cycle down-leg.  nu smoother
// sweeps, then the residual r = f - A u with the level's bc, then the
// 2x2-mean restriction; writes u and R.  With U == nullptr (the from-zero
// flag) u starts identically zero and is never read.
//
// K2 replaces the Pallas kernels behind smooth_residual_restrict and
// smooth_residual_restrict_zero: _smooth_rr_fused (row stripes), _rr_whole
// (whole array), _rr_fused_wide (two-axis blocks) and _rr_fused_zero (from
// zero), mgpoisson/kernels/pallas.py.  The from-zero form is valid at
// every size here, where the TPU used it only at n >= 4096.
//
// K9 replaces _rr_sharded, mgpoisson/kernels/pallas.py, behind
// smooth_rr_sharded: the same leg on one rank's (nl x ml) block of a
// sharded level, its halo read from the neighbours' strips (stencil.cuh
// MgStrips) and the boundary applied only where the block's edge is the
// grid's.  The TPU kernel assembles its halo by DMA into a VMEM stripe with
// a 128-lane column window; here the loader of a warp at the block's edge
// picks body or strip per row of each lane's pair, and the global index
// does what the TPU's edge flags did.
//
// Bound: HBM bytes, 3.25 arrays (read u, f; write u, R), 2.25 from zero;
// the strips add 4D/nl + 4D/ml of an array (both u and f).  Design
// (stencil.cuh): one warp per 64-column register tile, H = steps + 1 so
// the ring the residual reads stays exact, the sweeps' loop on nu at run
// time over rows unrolled at compile time; each kernel is instanced per
// smoother and per row count of the tile table, and each warp takes the
// unchecked or the checked body.  The residual and the restriction run on
// the registers: each lane's pair of columns and two rows are one coarse
// cell.
#include "stencil.cuh"

template <int kSm, int R, bool kStrips, bool kEdge>
static __device__ __forceinline__ void mg2_rr_tile(const Mg2Args& a, const Mg2Tile& t) {
  Mg2Pair<R> u;
  Mg2Pair<R> f;
  if (a.U) {
    mg2_load<R, kStrips, kEdge>(u, a.U, a.us, t);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) u.put(i, make_float2(0.f, 0.f));
  }
  mg2_load<R, kStrips, kEdge>(f, a.F, a.fs, t);
  mg2_sweeps<kSm, R, kEdge>(u, f, t, a.nu, a.bc, a.inv_hsq, a.inv_adiag, a.U == nullptr);
  mg2_store<R, kEdge>(a.Uout, u, t);
  mg2_restrict<R, kEdge>(a.Rout, u, f, t, a.bc, a.inv_hsq, a.adiag);
}

// The leg on the block a.blk; each entry point below instantiates it.
template <int kSm, int R, bool kStrips>
static __device__ __forceinline__ void mg2_rr_body(const Mg2Args& a) {
  const Mg2Tile t = mg2_tile<R>(a.blk, a.H);
  if (!mg2_owns(t)) return;
  if (mg2_inside<R>(t))
    mg2_rr_tile<kSm, R, kStrips, false>(a, t);
  else
    mg2_rr_tile<kSm, R, kStrips, true>(a, t);
}

// K2: the whole n x n grid.
template <int kSm, int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_smooth_rr_kernel(const Mg2Args a) {
  mg2_rr_body<kSm, R, false>(a);
}

struct MgRrLaunch {
  template <int kSm, int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2Args& a) {
    mg_smooth_rr_kernel<kSm, R><<<grid, block, 0, stream>>>(a);
  }
};

// K9: one rank's block, its halo from strips.
template <int kSm, int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_sharded_rr_kernel(const Mg2Args a) {
  mg2_rr_body<kSm, R, true>(a);
}

struct MgShardedRrLaunch {
  template <int kSm, int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2Args& a) {
    mg_sharded_rr_kernel<kSm, R><<<grid, block, 0, stream>>>(a);
  }
};

extern "C" int mg_smooth_rr(const float* u, const float* f, float* out, float* R, int n,
                            int nu, int smoother, int bc, float inv_hsq, float inv_adiag,
                            float adiag, int zero, cudaStream_t stream) {
  const int H = mg_steps(nu, smoother) + 1;
  if (n < 2 || n & 1 || nu < 0 || mg2_halo(H) > MG2_MAX_HALO) return (int)cudaErrorInvalidValue;
  if (!mg2_aligned(zero ? nullptr : u, f, out)) return (int)cudaErrorMisalignedAddress;
  Mg2Args a{};
  a.U = zero ? nullptr : u;
  a.F = f;
  a.Uout = out;
  a.Rout = R;
  a.blk = MgBlock{n, n, n, 0, 0};
  a.H = H;
  a.nu = nu;
  a.bc = bc;
  a.inv_hsq = inv_hsq;
  a.inv_adiag = inv_adiag;
  a.adiag = adiag;
  return mg2_launch<MgRrLaunch>(smoother, mg2_rows(n, n, H),
                                          mg2_grid(n, n, H), stream, a);
}

// One rank's (nl x ml) block at global (r0, c0) of an n x n level; u and f
// strips D >= H deep (ut..ur unused from zero; ul/ur and fl/fr null on a
// mesh of one column).
extern "C" int mg_sharded_rr(const float* u, const float* f, float* out, float* R,
                             const float* ut, const float* ub, const float* ul,
                             const float* ur, const float* ft, const float* fb,
                             const float* fl, const float* fr, int n, int nl, int ml, int r0,
                             int c0, int D, int nu, int smoother, int bc, float inv_hsq,
                             float inv_adiag, float adiag, int zero, cudaStream_t stream) {
  const int H = mg_steps(nu, smoother) + 1;
  if (nl < 2 || ml < 2 || (nl | ml | r0 | c0) & 1 || nu < 0 || D < H ||
      mg2_halo(H) > MG2_MAX_HALO)
    return (int)cudaErrorInvalidValue;
  if (!mg2_aligned(f, ft, fb, out) || (!zero && !mg2_aligned(u, ut, ub)))
    return (int)cudaErrorMisalignedAddress;
  Mg2Args a{};
  a.U = zero ? nullptr : u;
  a.F = f;
  a.Uout = out;
  a.Rout = R;
  a.blk = MgBlock{n, nl, ml, r0, c0};
  a.us = zero ? MgStrips{nullptr, nullptr, nullptr, nullptr, D} : MgStrips{ut, ub, ul, ur, D};
  a.fs = MgStrips{ft, fb, fl, fr, D};
  a.H = H;
  a.nu = nu;
  a.bc = bc;
  a.inv_hsq = inv_hsq;
  a.inv_adiag = inv_adiag;
  a.adiag = adiag;
  return mg2_launch<MgShardedRrLaunch>(smoother, mg2_rows(nl, ml, H),
                                                 mg2_grid(nl, ml, H), stream, a);
}
