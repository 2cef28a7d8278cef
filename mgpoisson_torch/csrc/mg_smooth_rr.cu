// K2 mg_smooth_rr: the V-cycle down-leg.  nu smoother sweeps, then the
// residual r = f - A u with the level's bc, then the 2x2-mean restriction;
// writes u and R.  With U == nullptr (the from-zero flag) u starts
// identically zero and is never read.
//
// Replaces the Pallas kernels behind smooth_residual_restrict and
// smooth_residual_restrict_zero: _smooth_rr_fused (row stripes), _rr_whole
// (whole array), _rr_fused_wide (two-axis blocks) and _rr_fused_zero (from
// zero), mgpoisson/kernels/pallas.py.  The from-zero form is valid at
// every size here, where the TPU used it only at n >= 4096.
// Bound: HBM bytes, 3.25 arrays (read u, f; write u, R), 2.25 from zero.
#include "stencil.cuh"

__global__ void __launch_bounds__(MG_THREADS)
mg_smooth_rr_kernel(const float* __restrict__ U, const float* __restrict__ F,
                    float* __restrict__ Uout, float* __restrict__ Rout, int n, int H,
                    int nu, int smoother, int bc, float inv_hsq, float inv_adiag,
                    float adiag) {
  extern __shared__ float smem[];
  const MgTile t = mg_tile(n, H);
  float* a = smem;
  float* b = a + t.S * t.S;
  float* sf = b + t.S * t.S;
  mg_load(a, sf, U, F, t);
  __syncthreads();
  const float* u = mg_sweeps(a, b, sf, t, nu, smoother, bc, inv_hsq, inv_adiag);
  mg_store(Uout, u, t);

  // the tile origin is even, so each coarse cell's 2x2 fine cells lie in
  // this tile; the halo keeps the ring the residual reads exact
  const int nc = n / 2, T2 = MG_TILE / 2;
  for (int k = threadIdx.x; k < T2 * T2; k += blockDim.x) {
    const int ci = k / T2, cj = k % T2;
    const int gI = (int)blockIdx.y * T2 + ci, gJ = (int)blockIdx.x * T2 + cj;
    if (!mg_in(gI, nc) || !mg_in(gJ, nc)) continue;
    const int i = t.H + 2 * ci, j = t.H + 2 * cj;
    const float r00 = mg_residual(u, sf, t, i, j, bc, inv_hsq, adiag);
    const float r10 = mg_residual(u, sf, t, i + 1, j, bc, inv_hsq, adiag);
    const float r01 = mg_residual(u, sf, t, i, j + 1, bc, inv_hsq, adiag);
    const float r11 = mg_residual(u, sf, t, i + 1, j + 1, bc, inv_hsq, adiag);
    Rout[(size_t)gI * nc + gJ] = ((r00 + r10) + (r01 + r11)) * 0.25f;
  }
}

extern "C" int mg_smooth_rr(const float* u, const float* f, float* out, float* R, int n,
                            int nu, int smoother, int bc, float inv_hsq, float inv_adiag,
                            float adiag, int zero, cudaStream_t stream) {
  const int H = mg_steps(nu, smoother) + 1;
  const size_t bytes = mg_tile_floats(H) * sizeof(float);
  if (bytes > MG_SMEM_LIMIT || n < 2) return (int)cudaErrorInvalidValue;
  const dim3 grid(mg_tiles(n), mg_tiles(n));
  mg_smooth_rr_kernel<<<grid, MG_THREADS, bytes, stream>>>(
      zero ? nullptr : u, f, out, R, n, H, nu, smoother, bc, inv_hsq, inv_adiag, adiag);
  return (int)cudaGetLastError();
}
