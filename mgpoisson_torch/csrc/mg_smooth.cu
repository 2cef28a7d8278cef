// K1 mg_smooth: nu smoother sweeps (jacobi / wjacobi / rbgs; ghost0 / face)
// in one pass over u and f.
//
// Replaces the Pallas kernels behind mgpoisson.kernels.pallas.smooth:
// _smooth_fused (row stripes), _smooth_whole (whole array in VMEM) and
// _smooth_fused_wide (two-axis blocks), mgpoisson/kernels/pallas.py.
// Bound: HBM bytes, 3 arrays (read u, f; write u).  It runs the register
// tile of K2/K3 (stencil.cuh) with H = steps.
#include "stencil.cuh"

template <int kSm, int R, bool kEdge>
static __device__ __forceinline__ void mg2_smooth_tile(const Mg2Args& a, const Mg2Tile& t) {
  Mg2Pair<R> u;
  Mg2Pair<R> f;
  mg2_load<R, false, kEdge>(u, a.U, a.us, t);
  mg2_load<R, false, kEdge>(f, a.F, a.fs, t);
  mg2_sweeps<kSm, R, kEdge>(u, f, t, a.nu, a.bc, a.inv_hsq, a.inv_adiag);
  mg2_store<R, kEdge>(a.Uout, u, t);
}

template <int kSm, int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_smooth_kernel(const Mg2Args a) {
  const Mg2Tile t = mg2_tile<R>(a.blk, a.H);
  if (!mg2_owns(t)) return;
  if (mg2_inside<R>(t))
    mg2_smooth_tile<kSm, R, false>(a, t);
  else
    mg2_smooth_tile<kSm, R, true>(a, t);
}

struct MgSmoothLaunch {
  template <int kSm, int R>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2Args& a) {
    mg_smooth_kernel<kSm, R><<<grid, block, 0, stream>>>(a);
  }
};

extern "C" int mg_smooth(const float* u, const float* f, float* out, int n, int nu,
                         int smoother, int bc, float inv_hsq, float inv_adiag,
                         cudaStream_t stream) {
  const int H = mg_steps(nu, smoother);
  if (n < 2 || n & 1 || nu < 0 || mg2_halo(H) > MG2_MAX_HALO) return (int)cudaErrorInvalidValue;
  if (!mg2_aligned(u, f, out)) return (int)cudaErrorMisalignedAddress;
  Mg2Args a{};
  a.U = u;
  a.F = f;
  a.Uout = out;
  a.blk = MgBlock{n, n, n, 0, 0};
  a.H = H;
  a.nu = nu;
  a.bc = bc;
  a.inv_hsq = inv_hsq;
  a.inv_adiag = inv_adiag;
  return mg2_launch<MgSmoothLaunch>(smoother, mg2_rows(n, n, H),
                                              mg2_grid(n, n, H), stream, a);
}

extern "C" const char* mg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
