// K7.bf16 mg_packed_rr_bf16: the bf16 form of the fast scheme's fine-level
// down-leg on packed state (K7, mg_packed_rr.cu), on the packed word tile
// of stencil_packed_w.cuh.  nu red-black sweeps, the ghost0 residual and
// the 2x2 restriction; writes the packed u and the UNPACKED coarse rhs,
// each op rounded to bf16 as the plain packed ops round it in bf16.
//
// Replaces the Pallas kernels behind packed_smooth_residual_restrict in
// bf16: _packed_rr_fused (and its write-through variant) and
// _packed_rr_fused_wide, mgpoisson/kernels/pallas.py.  K13, its strip
// entry, has no bf16 form, as in the reference.
//
// Bound: HBM bytes, 2.75 bf16 arrays (read up's black plane, fp; write
// up', Rc).  Design: a lane's two packed columns of both planes as two
// bf16x2 words per row, every op one bf16x2 instruction, halo H = 2 nu + 1
// (stencil_packed_w.cuh).
#include "stencil_packed_w.cuh"

template <int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2W_MIN_BLOCKS(R))
mg_packed_rr_bf16_kernel(const Mg2wArgs a) {
  mg2w_rr_body<R>(a);
}

struct MgPackedRrBf16Launch {
  template <int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2wArgs& a) {
    mg_packed_rr_bf16_kernel<R><<<grid, block, 0, stream>>>(a);
  }
};

extern "C" int mg_packed_rr_bf16(const __nv_bfloat16* up, const __nv_bfloat16* fp,
                                 __nv_bfloat16* out, __nv_bfloat16* Rc, int n, int nu,
                                 float mhq, float inv_hsq, cudaStream_t stream) {
  if (n < 2 || n % 2 || nu < 1 || nu > MG2P_MAX_NU) return (int)cudaErrorInvalidValue;
  Mg2wArgs a{};
  a.U = up;
  a.F = fp;
  a.Uout = out;
  a.Rout = Rc;
  a.n = n;
  a.H = 2 * nu + 1;
  a.nu = nu;
  a.mhq = mhq;
  a.inv_hsq = inv_hsq;
  return mg2w_launch<MgPackedRrBf16Launch>(a, stream);
}
