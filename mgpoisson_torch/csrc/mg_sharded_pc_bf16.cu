// K10.bf16 mg_sharded_pc_bf16: the bf16 form of K10 mg_sharded_pc, the
// up-leg on one rank's block of a sharded level with its fine halo from
// bf16 u and f strips and its coarse halo from V's (MgStripsBf16), with the
// rnorm flag (f32 partials), one instance per smoother and tile row count.
// It replaces _pc_sharded, mgpoisson/kernels/pallas.py, in bf16 (P(V)
// blended in f32 and rounded once, as _bilinear_blend_2d).  The leg and its
// C entry are stencil_pc.cuh's; this source is its own so that nvcc builds
// these instances in parallel with K3/K10's (mg_prolong_correct_smooth.cu).
// Bound: HBM bytes, 1.625 arrays of f32 bytes (read u, f, V; write u), plus
// the strips.
#include "stencil_pc.cuh"

// K10 in bf16: one rank's block, its halo from bf16 strips.
template <int kSm, int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_sharded_pc_bf16_kernel(const Mg2ArgsBf16 a) {
  mg2_pc_body<kSm, R, true>(a);
}

struct MgShardedPcBf16Launch {
  template <int kSm, int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2ArgsBf16& a) {
    mg_sharded_pc_bf16_kernel<kSm, R><<<grid, block, 0, stream>>>(a);
  }
};

// The same on bf16 arrays and strips (4-byte aligned); the partials f32.
extern "C" int mg_sharded_pc_bf16(const __nv_bfloat16* u, const __nv_bfloat16* f,
                                  const __nv_bfloat16* V, __nv_bfloat16* out, float* partials,
                                  const __nv_bfloat16* ut, const __nv_bfloat16* ub,
                                  const __nv_bfloat16* ul, const __nv_bfloat16* ur,
                                  const __nv_bfloat16* ft, const __nv_bfloat16* fb,
                                  const __nv_bfloat16* fl, const __nv_bfloat16* fr,
                                  const __nv_bfloat16* vt, const __nv_bfloat16* vb,
                                  const __nv_bfloat16* vl, const __nv_bfloat16* vr, int n,
                                  int nl, int ml, int r0, int c0, int D, int DV, int nu,
                                  int smoother, int bc, int kind, float inv_hsq,
                                  float inv_adiag, float adiag, int rnorm,
                                  cudaStream_t stream) {
  return mg_sharded_pc_entry<MgShardedPcBf16Launch, Mg2ArgsBf16>(
      u, f, V, out, partials, ut, ub, ul, ur, ft, fb, fl, fr, vt, vb, vl, vr, n, nl, ml, r0,
      c0, D, DV, nu, smoother, bc, kind, inv_hsq, inv_adiag, adiag, rnorm, stream);
}
