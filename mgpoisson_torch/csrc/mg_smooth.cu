// K1 mg_smooth: nu smoother sweeps (jacobi / wjacobi / rbgs; ghost0 / face)
// in one pass over u and f.
//
// Replaces the Pallas kernels behind mgpoisson.kernels.pallas.smooth:
// _smooth_fused (row stripes), _smooth_whole (whole array in VMEM) and
// _smooth_fused_wide (two-axis blocks), mgpoisson/kernels/pallas.py.
// Bound: HBM bytes, 3 arrays (read u, f; write u).  It runs the register
// tile of K2/K3 (stencil.cuh) with H = steps.  Its bf16 form
// (mg_smooth_bf16) runs the same tile on bf16 arrays in bf16x2 words and
// arithmetic, each op rounded once as plain torch rounds it in bf16
// (stencil.cuh, Mg2Word and Mg2X2): half the bytes.
#include "stencil.cuh"

template <int kSm, int R, bool kEdge, class T>
static __device__ __forceinline__ void mg2_smooth_tile(const Mg2ArgsOf<T>& a,
                                                       const Mg2Tile& t) {
  Mg2Regs<T, R> u;
  Mg2Regs<T, R> f;
  mg2_load<R, false, kEdge>(u, a.U, a.us, t);
  mg2_load<R, false, kEdge>(f, a.F, a.fs, t);
  mg2_sweeps<kSm, R, kEdge>(u, f, t, a.nu, a.bc, a.inv_hsq, a.inv_adiag);
  mg2_store<R, kEdge>(a.Uout, u, t);
}

template <int kSm, int R, class T>
static __device__ __forceinline__ void mg2_smooth_body(const Mg2ArgsOf<T>& a) {
  const Mg2Tile t = mg2_tile<R>(a.blk, a.H);
  if (!mg2_owns(t)) return;
  if (mg2_inside<R>(t))
    mg2_smooth_tile<kSm, R, false>(a, t);
  else
    mg2_smooth_tile<kSm, R, true>(a, t);
}

template <int kSm, int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_smooth_kernel(const Mg2Args a) {
  mg2_smooth_body<kSm, R>(a);
}

struct MgSmoothLaunch {
  template <int kSm, int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2Args& a) {
    mg_smooth_kernel<kSm, R><<<grid, block, 0, stream>>>(a);
  }
};

// The bf16 form.
template <int kSm, int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_smooth_bf16_kernel(const Mg2ArgsBf16 a) {
  mg2_smooth_body<kSm, R>(a);
}

struct MgSmoothBf16Launch {
  template <int kSm, int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2ArgsBf16& a) {
    mg_smooth_bf16_kernel<kSm, R><<<grid, block, 0, stream>>>(a);
  }
};

template <class L, class A, class T>
static int mg_smooth_entry(const T* u, const T* f, T* out, int n, int nu, int smoother, int bc,
                           float inv_hsq, float inv_adiag, cudaStream_t stream) {
  const int H = mg_steps(nu, smoother);
  if (n < 2 || n & 1 || nu < 0 || mg2_halo(H) > MG2_MAX_HALO) return (int)cudaErrorInvalidValue;
  if (!mg2_aligned<T>(u, f, out)) return (int)cudaErrorMisalignedAddress;
  A a{};
  a.U = u;
  a.F = f;
  a.Uout = out;
  a.blk = MgBlock{n, n, n, 0, 0};
  a.H = H;
  a.nu = nu;
  a.bc = bc;
  a.inv_hsq = inv_hsq;
  a.inv_adiag = inv_adiag;
  return mg2_launch<L>(smoother, mg2_rows(n, n, H), mg2_grid(n, n, H), stream, a);
}

extern "C" int mg_smooth(const float* u, const float* f, float* out, int n, int nu,
                         int smoother, int bc, float inv_hsq, float inv_adiag,
                         cudaStream_t stream) {
  return mg_smooth_entry<MgSmoothLaunch, Mg2Args>(u, f, out, n, nu, smoother, bc, inv_hsq,
                                                  inv_adiag, stream);
}

extern "C" int mg_smooth_bf16(const __nv_bfloat16* u, const __nv_bfloat16* f,
                              __nv_bfloat16* out, int n, int nu, int smoother, int bc,
                              float inv_hsq, float inv_adiag, cudaStream_t stream) {
  return mg_smooth_entry<MgSmoothBf16Launch, Mg2ArgsBf16>(u, f, out, n, nu, smoother, bc,
                                                          inv_hsq, inv_adiag, stream);
}

extern "C" const char* mg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
