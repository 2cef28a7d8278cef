// K7 mg_packed_rr: the fast scheme's fine-level down-leg on packed state.
// nu red-black sweeps, the ghost0 residual and the 2x2 restriction; writes
// the packed u and the UNPACKED (n/2, n/2) coarse rhs.  A coarse cell is one
// packed lane over a row pair, red plus black (coarse column J = lane J), so
// with the tile's even row origin the restriction is tile-local.
//
// Replaces the Pallas kernels behind packed_smooth_residual_restrict:
// _packed_rr_fused (row stripes, and its write-through variant) and
// _packed_rr_fused_wide (two-axis blocks), mgpoisson/kernels/pallas.py.
// Bound: HBM bytes, 3.25 arrays (read up, fp; write up', Rc).
#include "packed.cuh"

__global__ void __launch_bounds__(MGP_TX * MGP_TY)
mg_packed_rr_kernel(const float* __restrict__ U, const float* __restrict__ F,
                    float* __restrict__ Uout, float* __restrict__ Rout, int n, int nu,
                    float mhq, float inv_hsq) {
  extern __shared__ float smem[];
  const MgpTile t = mgp_tile(n, 2 * nu + 1);
  const int SS = t.S * t.S;
  float* xr = smem;
  float* xb = xr + SS;
  float* fr = xb + SS;
  float* fb = fr + SS;
  mgp_load(xr, xb, U, t);
  mgp_load(fr, fb, F, t);
  __syncthreads();
  mgp_sweeps(xr, xb, fr, fb, t, nu, mhq);
  mgp_store(Uout, xr, xb, t);

  // ((r_r + r_b) on row 2I + (r_r + r_b) on row 2I+1) / 4, as
  // ops.packed_smooth_residual_restrict; the halo keeps the ring the
  // residual reads exact
  const int T2 = MGP_TILE / 2;
  for (int ci = threadIdx.y; ci < T2; ci += blockDim.y) {
    const int gI = (int)blockIdx.y * T2 + ci, li = t.G + 2 * ci;
    if (gI >= n / 2) continue;
    for (int tj = threadIdx.x; tj < MGP_TILE; tj += blockDim.x) {
      const int lj = t.G + tj, gj = t.gj0 + lj;
      if (gj >= t.w) continue;
      const float s0 = mgp_residual(xr, xb, fr, t, li, lj, 0, inv_hsq) +
                       mgp_residual(xb, xr, fb, t, li, lj, 1, inv_hsq);
      const float s1 = mgp_residual(xr, xb, fr, t, li + 1, lj, 0, inv_hsq) +
                       mgp_residual(xb, xr, fb, t, li + 1, lj, 1, inv_hsq);
      Rout[(size_t)gI * t.w + gj] = (s0 + s1) * 0.25f;
    }
  }
}

extern "C" int mg_packed_rr(const float* up, const float* fp, float* out, float* Rc, int n,
                            int nu, float mhq, float inv_hsq, cudaStream_t stream) {
  const int S = mgp_side(2 * nu + 1);
  const size_t bytes = 4 * (size_t)S * S * sizeof(float);
  if (n < 2 || n % 2 || nu < 1 || nu > MGP_MAX_NU || bytes > MGP_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(mgp_tiles(n / 2), mgp_tiles(n)), block(MGP_TX, MGP_TY);
  mg_packed_rr_kernel<<<grid, block, bytes, stream>>>(up, fp, out, Rc, n, nu, mhq, inv_hsq);
  return (int)cudaGetLastError();
}
