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
//
// The bf16 forms of K2 (mg_smooth_rr_bf16, here) and K9
// (mg_sharded_rr_bf16, in mg_sharded_rr_bf16.cu), with the from-zero flag,
// run the same tile on bf16 u, f and R (and bf16 strips, MgStripsBf16),
// in bf16x2 words and arithmetic, each op rounded once as plain torch
// rounds it in bf16 (stencil.cuh, Mg2Word and Mg2X2): bound 1.625
// arrays of f32 bytes, 1.125 from zero.  The leg itself is in
// stencil_rr.cuh.
#include "stencil_rr.cuh"

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
  static constexpr int rows(int R) { return R; }
  template <int kSm, int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2Args& a) {
    mg_sharded_rr_kernel<kSm, R><<<grid, block, 0, stream>>>(a);
  }
};

// K2 in bf16: the whole n x n grid.
template <int kSm, int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_smooth_rr_bf16_kernel(const Mg2ArgsBf16 a) {
  mg2_rr_body<kSm, R, false>(a);
}

struct MgRrBf16Launch {
  template <int kSm, int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2ArgsBf16& a) {
    mg_smooth_rr_bf16_kernel<kSm, R><<<grid, block, 0, stream>>>(a);
  }
};

template <class L, class A, class T>
static int mg_smooth_rr_entry(const T* u, const T* f, T* out, T* R, int n, int nu,
                              int smoother, int bc, float inv_hsq, float inv_adiag, float adiag,
                              int zero, cudaStream_t stream) {
  const int H = mg_steps(nu, smoother) + 1;
  if (n < 2 || n & 1 || nu < 0 || mg2_halo(H) > MG2_MAX_HALO) return (int)cudaErrorInvalidValue;
  if (!mg2_aligned<T>(zero ? nullptr : u, f, out)) return (int)cudaErrorMisalignedAddress;
  A a{};
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
  return mg2_launch<L>(smoother, mg2_rows(n, n, H), mg2_grid(n, n, H), stream, a);
}

extern "C" int mg_smooth_rr(const float* u, const float* f, float* out, float* R, int n,
                            int nu, int smoother, int bc, float inv_hsq, float inv_adiag,
                            float adiag, int zero, cudaStream_t stream) {
  return mg_smooth_rr_entry<MgRrLaunch, Mg2Args>(u, f, out, R, n, nu, smoother, bc, inv_hsq,
                                                 inv_adiag, adiag, zero, stream);
}

extern "C" int mg_smooth_rr_bf16(const __nv_bfloat16* u, const __nv_bfloat16* f,
                                 __nv_bfloat16* out, __nv_bfloat16* R, int n, int nu,
                                 int smoother, int bc, float inv_hsq, float inv_adiag,
                                 float adiag, int zero, cudaStream_t stream) {
  return mg_smooth_rr_entry<MgRrBf16Launch, Mg2ArgsBf16>(u, f, out, R, n, nu, smoother, bc,
                                                         inv_hsq, inv_adiag, adiag, zero,
                                                         stream);
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
  return mg_sharded_rr_entry<MgShardedRrLaunch, Mg2Args>(
      u, f, out, R, ut, ub, ul, ur, ft, fb, fl, fr, n, nl, ml, r0, c0, D, nu, smoother, bc,
      inv_hsq, inv_adiag, adiag, zero, stream);
}
