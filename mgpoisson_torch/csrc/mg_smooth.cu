// K1 mg_smooth: nu smoother sweeps (jacobi / wjacobi / rbgs; ghost0 / face)
// in one pass over u and f.
//
// Replaces the Pallas kernels behind mgpoisson.kernels.pallas.smooth:
// _smooth_fused (row stripes), _smooth_whole (whole array in VMEM) and
// _smooth_fused_wide (two-axis blocks), mgpoisson/kernels/pallas.py.
// Bound: HBM bytes, 3 arrays (read u, f; write u).
#include "stencil.cuh"

__global__ void __launch_bounds__(MG_THREADS)
mg_smooth_kernel(const float* __restrict__ U, const float* __restrict__ F,
                 float* __restrict__ Uout, int n, int H, int nu, int smoother, int bc,
                 float inv_hsq, float inv_adiag) {
  extern __shared__ float smem[];
  const MgTile t = mg_tile(n, H);
  float* a = smem;
  float* b = a + t.S * t.S;
  float* sf = b + t.S * t.S;
  mg_load(a, sf, U, F, t);
  __syncthreads();
  const float* r = mg_sweeps(a, b, sf, t, nu, smoother, bc, inv_hsq, inv_adiag);
  mg_store(Uout, r, t);
}

extern "C" int mg_smooth(const float* u, const float* f, float* out, int n, int nu,
                         int smoother, int bc, float inv_hsq, float inv_adiag,
                         cudaStream_t stream) {
  const int H = mg_steps(nu, smoother);
  const size_t bytes = mg_tile_floats(H) * sizeof(float);
  if (bytes > MG_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const dim3 grid(mg_tiles(n), mg_tiles(n));
  mg_smooth_kernel<<<grid, MG_THREADS, bytes, stream>>>(u, f, out, n, H, nu, smoother, bc,
                                                         inv_hsq, inv_adiag);
  return (int)cudaGetLastError();
}

extern "C" const char* mg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
