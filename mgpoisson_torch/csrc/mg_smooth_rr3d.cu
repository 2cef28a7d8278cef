// K5 mg_smooth_rr3d: the 3D V-cycle down-leg.  nu 7-point smoother sweeps,
// then the residual r = f - A u with the level's bc, then the 2x2x2-mean
// restriction (x 0.125); writes u and R.  With U == nullptr (the from-zero
// flag) u starts identically zero and is never read.
//
// Replaces _rr_fused_3d, mgpoisson/kernels/pallas.py, the Pallas kernel
// behind smooth_residual_restrict for 3D arrays and, through the explicit
// zeros array of smooth_residual_restrict_zero, its from-zero form.  The
// flag reads f only: the same values with one array pass fewer in and
// none out for the zeros.
// Bound: HBM bytes, 3.125 arrays (read u, f; write u, R), 2.125 from zero.
// The design (stencil3d.cuh) reads each array once per block tile; the
// halo costs (T + 2H)^3 / T^3 = 3.4 cells loaded per interior cell at
// T = 16, H = 4 (wjacobi nu = 3 plus the residual ring).
#include "stencil3d.cuh"

__global__ void __launch_bounds__(MG3_THREADS)
mg_smooth_rr3d_kernel(const float* __restrict__ U, const float* __restrict__ F,
                      float* __restrict__ Uout, float* __restrict__ Rout, int n, int T,
                      int H, int nu, int smoother, int bc, float inv_hsq,
                      float inv_adiag, float adiag) {
  extern __shared__ float smem[];
  const Mg3Tile t = mg3_tile(n, T, H);
  const int S3 = t.S * t.S * t.S;
  float* a = smem;
  float* b = a + S3;
  float* sf = b + S3;
  mg3_load(a, sf, U, F, t);
  __syncthreads();
  const float* u = mg3_sweeps(a, b, sf, t, nu, smoother, bc, inv_hsq, inv_adiag);
  mg3_store(Uout, u, t);

  // the tile origin is even on all three axes, so each coarse cell's
  // 2x2x2 fine cells lie in this tile; the halo keeps the ring the
  // residual reads exact
  const int nc = n / 2, T2 = T / 2;
  for (int k = threadIdx.x; k < T2 * T2 * T2; k += blockDim.x) {
    const int cl = k % T2, q = k / T2, cj = q % T2, ci = q / T2;
    const int gI = (int)blockIdx.z * T2 + ci, gJ = (int)blockIdx.y * T2 + cj,
              gK = (int)blockIdx.x * T2 + cl;
    if (!mg_in(gI, nc) || !mg_in(gJ, nc) || !mg_in(gK, nc)) continue;
    const int i = H + 2 * ci, j = H + 2 * cj, l = H + 2 * cl;
    float r[8];
#pragma unroll
    for (int d = 0; d < 8; ++d)
      r[d] = mg3_residual(u, sf, t, i + (d >> 2), j + ((d >> 1) & 1), l + (d & 1), bc,
                          inv_hsq, adiag);
    const float s = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    Rout[((size_t)gI * nc + gJ) * nc + gK] = s * 0.125f;
  }
}

extern "C" int mg_smooth_rr3d(const float* u, const float* f, float* out, float* R, int n,
                              int tile, int nu, int smoother, int bc, float inv_hsq,
                              float inv_adiag, float adiag, int zero, cudaStream_t stream) {
  const int H = mg_steps(nu, smoother) + 1;
  const size_t bytes = mg3_tile_floats(tile, H) * sizeof(float);
  const int rc = mg3_prepare((const void*)mg_smooth_rr3d_kernel, n, tile, bytes);
  if (rc != 0) return rc;
  mg_smooth_rr3d_kernel<<<mg3_grid(n, tile), MG3_THREADS, bytes, stream>>>(
      zero ? nullptr : u, f, out, R, n, tile, H, nu, smoother, bc, inv_hsq, inv_adiag,
      adiag);
  return (int)cudaGetLastError();
}
