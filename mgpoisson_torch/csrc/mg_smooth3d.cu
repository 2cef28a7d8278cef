// K4 mg_smooth3d: nu 7-point smoother sweeps (jacobi / wjacobi / rbgs;
// ghost0 / face) on an (n, n, n) array in one pass over u and f.
//
// Replaces _smooth_fused_3d, mgpoisson/kernels/pallas.py, the Pallas
// kernel behind mgpoisson.kernels.pallas.smooth for 3D arrays.
// Bound: HBM bytes, 3 arrays (read u, f; write u).  The design
// (stencil3d.cuh) reads each array once from HBM per block tile and pays
// for the deep halo with redundant shared-memory work instead of extra
// passes: (T + 2H)^3 / T^3 cells loaded per interior cell, 2.6 at T = 16,
// H = 3 (the tuned scheme's wjacobi nu = 3).  Its bf16 form
// (mg_smooth3d_bf16) runs the same tile on bf16 arrays, rounding as plain
// torch does in bf16 (stencil3d.cuh, Mg3Elem): half the bytes.
#include "stencil3d.cuh"

template <class T>
static __device__ __forceinline__ void mg_smooth3d_body(const T* __restrict__ U,
                                                        const T* __restrict__ F,
                                                        T* __restrict__ Uout, int n, int side,
                                                        int H, int nu, int smoother, int bc,
                                                        float inv_hsq, float inv_adiag) {
  extern __shared__ float smem[];
  const Mg3Tile t = mg3_tile(n, side, H);
  const int S3 = t.S * t.S * t.S;
  float* a = smem;
  float* b = a + S3;
  float* sf = b + S3;
  mg3_load(a, sf, U, F, t);
  __syncthreads();
  const float* r = mg3_sweeps<T>(a, b, sf, t, nu, smoother, bc, inv_hsq, inv_adiag);
  mg3_store(Uout, r, t);
}

__global__ void __launch_bounds__(MG3_THREADS)
mg_smooth3d_kernel(const float* __restrict__ U, const float* __restrict__ F,
                   float* __restrict__ Uout, int n, int T, int H, int nu, int smoother,
                   int bc, float inv_hsq, float inv_adiag) {
  mg_smooth3d_body(U, F, Uout, n, T, H, nu, smoother, bc, inv_hsq, inv_adiag);
}

// The bf16 form.
__global__ void __launch_bounds__(MG3_THREADS)
mg_smooth3d_bf16_kernel(const __nv_bfloat16* __restrict__ U, const __nv_bfloat16* __restrict__ F,
                        __nv_bfloat16* __restrict__ Uout, int n, int T, int H, int nu,
                        int smoother, int bc, float inv_hsq, float inv_adiag) {
  mg_smooth3d_body(U, F, Uout, n, T, H, nu, smoother, bc, inv_hsq, inv_adiag);
}

template <class T>
static int mg_smooth3d_entry(void (*kernel)(const T*, const T*, T*, int, int, int, int, int,
                                            int, float, float),
                             const T* u, const T* f, T* out, int n, int tile, int nu,
                             int smoother, int bc, float inv_hsq, float inv_adiag,
                             cudaStream_t stream) {
  const int H = mg_steps(nu, smoother);
  const size_t bytes = mg3_tile_floats(tile, H) * sizeof(float);
  const Mg3Block grid{n, n, n, 0, 0};
  const int rc = mg3_prepare((const void*)kernel, grid, tile, bytes);
  if (rc != 0) return rc;
  kernel<<<mg3_grid(grid, tile), MG3_THREADS, bytes, stream>>>(u, f, out, n, tile, H, nu,
                                                                smoother, bc, inv_hsq,
                                                                inv_adiag);
  return (int)cudaGetLastError();
}

extern "C" int mg_smooth3d(const float* u, const float* f, float* out, int n, int tile,
                           int nu, int smoother, int bc, float inv_hsq, float inv_adiag,
                           cudaStream_t stream) {
  return mg_smooth3d_entry(mg_smooth3d_kernel, u, f, out, n, tile, nu, smoother, bc, inv_hsq,
                           inv_adiag, stream);
}

extern "C" int mg_smooth3d_bf16(const __nv_bfloat16* u, const __nv_bfloat16* f,
                                __nv_bfloat16* out, int n, int tile, int nu, int smoother,
                                int bc, float inv_hsq, float inv_adiag, cudaStream_t stream) {
  return mg_smooth3d_entry(mg_smooth3d_bf16_kernel, u, f, out, n, tile, nu, smoother, bc,
                           inv_hsq, inv_adiag, stream);
}
