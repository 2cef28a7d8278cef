// K8.bf16 mg_packed_pc_bf16: the bf16 form of the fast scheme's fine-level
// up-leg on packed state (K8, mg_packed_pc.cu), on the packed word tile of
// stencil_packed_w.cuh.  up += P(V), V the UNPACKED coarse correction (the
// bilinear P(V) blended in f32 and rounded once), then nu red-black
// sweeps; writes the packed u.  With a partials buffer (the rnorm flag) it
// also writes one f32 partial of sum(r^2) per block, r the ghost0 residual
// of the result in bf16, squared in f32; the caller sums the partials in a
// fixed order.
//
// Replaces the Pallas kernels behind packed_prolong_correct_smooth and
// packed_prolong_correct_smooth_rnorm in bf16: _packed_pc_fused (and its
// write-through variant) and _packed_pc_fused_wide,
// mgpoisson/kernels/pallas.py.  K14, its strip entry, has no bf16 form, as
// in the reference.
//
// Bound: HBM bytes, 2.75 bf16 arrays (read up's black plane, fp, V;
// write up').  Design: the packed word tile (stencil_packed_w.cuh), halo
// H = 2 nu (+1 with rnorm).
#include "stencil_packed_w.cuh"

template <int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2W_MIN_BLOCKS(R))
mg_packed_pc_bf16_kernel(const Mg2wArgs a) {
  mg2w_pc_body<R>(a);
}

struct MgPackedPcBf16Launch {
  template <int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2wArgs& a) {
    mg_packed_pc_bf16_kernel<R><<<grid, block, 0, stream>>>(a);
  }
};

// With rnorm, one partial per block of mg2w_grid at the halo 2 nu + 1
// (kernels/cuda.py packed_rnorm_partials in bf16).
extern "C" int mg_packed_pc_bf16(const __nv_bfloat16* up, const __nv_bfloat16* fp,
                                 const __nv_bfloat16* V, __nv_bfloat16* out, float* partials,
                                 int n, int nu, int kind, float mhq, float inv_hsq, int rnorm,
                                 cudaStream_t stream) {
  if (n < 2 || n & 1 || nu < 1 || nu > MG2P_MAX_NU || (kind != MG_INJECT && kind != MG_BILINEAR))
    return (int)cudaErrorInvalidValue;
  Mg2wArgs a{};
  a.U = up;
  a.F = fp;
  a.V = V;
  a.Uout = out;
  a.partials = rnorm ? partials : nullptr;
  a.n = n;
  a.H = 2 * nu + (rnorm ? 1 : 0);
  a.nu = nu;
  a.kind = kind;
  a.mhq = mhq;
  a.inv_hsq = inv_hsq;
  return mg2w_launch<MgPackedPcBf16Launch>(a, stream);
}
