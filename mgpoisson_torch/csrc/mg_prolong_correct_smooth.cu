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
//
// The bf16 forms of K3 (mg_prolong_correct_smooth_bf16, here) and K10
// (mg_sharded_pc_bf16, in mg_sharded_pc_bf16.cu), with the rnorm flag, run
// the same tile on bf16 u, f and V (and bf16 strips, MgStripsBf16),
// in bf16x2 words and arithmetic, each op rounded once as plain torch
// rounds it in bf16 (stencil.cuh, Mg2Word and Mg2X2); P(V) is
// blended in f32 and rounded once, as ops._up_leg_correct and
// ops.pc_smooth_sharded do in a sub-f32 dtype and as the Pallas up-legs do
// (pallas.py _bilinear_blend_2d); the partials stay f32.  Bound 1.625
// arrays of f32 bytes.  The leg itself is in stencil_pc.cuh.
#include "stencil_pc.cuh"

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

// K3 in bf16: the whole n x n grid.
template <int kSm, int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_pc_bf16_kernel(const Mg2ArgsBf16 a) {
  mg2_pc_body<kSm, R, false>(a);
}

struct MgPcBf16Launch {
  template <int kSm, int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2ArgsBf16& a) {
    mg_pc_bf16_kernel<kSm, R><<<grid, block, 0, stream>>>(a);
  }
};

template <class L, class A, class T>
static int mg_pc_entry(const T* u, const T* f, const T* V, T* out, float* partials, int n,
                       int nu, int smoother, int bc, int kind, float inv_hsq, float inv_adiag,
                       float adiag, int rnorm, cudaStream_t stream) {
  const int H = mg_steps(nu, smoother) + 1;
  if (n < 2 || n & 1 || nu < 0 || mg2_halo(H) > MG2_MAX_HALO) return (int)cudaErrorInvalidValue;
  if (!mg2_aligned<T>(u, f, out)) return (int)cudaErrorMisalignedAddress;
  A a{};
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
  return mg2_launch<L>(smoother, mg2_rows(n, n, H), mg2_grid(n, n, H), stream, a);
}

extern "C" int mg_prolong_correct_smooth(const float* u, const float* f, const float* V,
                                         float* out, float* partials, int n, int nu,
                                         int smoother, int bc, int kind, float inv_hsq,
                                         float inv_adiag, float adiag, int rnorm,
                                         cudaStream_t stream) {
  return mg_pc_entry<MgPcLaunch, Mg2Args>(u, f, V, out, partials, n, nu, smoother, bc, kind,
                                          inv_hsq, inv_adiag, adiag, rnorm, stream);
}

extern "C" int mg_prolong_correct_smooth_bf16(const __nv_bfloat16* u, const __nv_bfloat16* f,
                                              const __nv_bfloat16* V, __nv_bfloat16* out,
                                              float* partials, int n, int nu, int smoother,
                                              int bc, int kind, float inv_hsq, float inv_adiag,
                                              float adiag, int rnorm, cudaStream_t stream) {
  return mg_pc_entry<MgPcBf16Launch, Mg2ArgsBf16>(u, f, V, out, partials, n, nu, smoother, bc,
                                                  kind, inv_hsq, inv_adiag, adiag, rnorm,
                                                  stream);
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
  return mg_sharded_pc_entry<MgShardedPcLaunch, Mg2Args>(
      u, f, V, out, partials, ut, ub, ul, ur, ft, fb, fl, fr, vt, vb, vl, vr, n, nl, ml, r0,
      c0, D, DV, nu, smoother, bc, kind, inv_hsq, inv_adiag, adiag, rnorm, stream);
}
