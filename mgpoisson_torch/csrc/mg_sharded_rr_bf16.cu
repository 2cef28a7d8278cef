// K9.bf16 mg_sharded_rr_bf16: the bf16 form of K9 mg_sharded_rr, the
// down-leg on one rank's block of a sharded level with its halo from bf16
// strips (MgStripsBf16), one instance per smoother and tile row count (16
// and 24: see MgShardedRrBf16Launch).  It replaces _rr_sharded,
// mgpoisson/kernels/pallas.py, in bf16 (the JAX package's sharded_plan
// admits bf16).  The leg and its C entry are stencil_rr.cuh's; this source
// is its own so that nvcc builds these instances in parallel with K2/K9's
// (mg_smooth_rr.cu).  Bound: HBM bytes, 1.625 arrays of f32 bytes (read u,
// f; write u, R), 1.125 from zero, plus the strips.
#include "stencil_rr.cuh"

// K9 in bf16: one rank's block, its halo from bf16 strips.
template <int kSm, int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_sharded_rr_bf16_kernel(const Mg2ArgsBf16 a) {
  mg2_rr_body<kSm, R, true>(a);
}

// Deep halos run the shallow tile's 24 rows: a deep halo (jacobi/wjacobi
// nu >= 4, rbgs nu >= 2) is off the main path, so this kernel has no
// 40-row instance.  (With a round after every f32 op its Jacobi variants
// spilled at 40 rows; on bf16x2 words K2.bf16's 40-row instances take
// 145-210 registers, ptxas, sm_90a.)
struct MgShardedRrBf16Launch {
  static constexpr int rows(int R) { return R == MG2_ROWS_DEEP ? MG2_ROWS_SHALLOW : R; }
  template <int kSm, int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2ArgsBf16& a) {
    mg_sharded_rr_bf16_kernel<kSm, rows(R)><<<grid, block, 0, stream>>>(a);
  }
};

// The same on bf16 arrays and strips (4-byte aligned).
extern "C" int mg_sharded_rr_bf16(const __nv_bfloat16* u, const __nv_bfloat16* f,
                                  __nv_bfloat16* out, __nv_bfloat16* R,
                                  const __nv_bfloat16* ut, const __nv_bfloat16* ub,
                                  const __nv_bfloat16* ul, const __nv_bfloat16* ur,
                                  const __nv_bfloat16* ft, const __nv_bfloat16* fb,
                                  const __nv_bfloat16* fl, const __nv_bfloat16* fr, int n,
                                  int nl, int ml, int r0, int c0, int D, int nu, int smoother,
                                  int bc, float inv_hsq, float inv_adiag, float adiag,
                                  int zero, cudaStream_t stream) {
  return mg_sharded_rr_entry<MgShardedRrBf16Launch, Mg2ArgsBf16>(
      u, f, out, R, ut, ub, ul, ur, ft, fb, fl, fr, n, nl, ml, r0, c0, D, nu, smoother, bc,
      inv_hsq, inv_adiag, adiag, zero, stream);
}
