// K3 mg_prolong_correct_smooth: the V-cycle up-leg.  u += P(V), with P the
// piecewise-constant (inject) or face-adapted bilinear prolongation, then
// nu smoother sweeps; writes u.  With a partials buffer (the rnorm flag) it
// also writes one f32 partial of sum(r^2) per block, r being the ZERO-GHOST
// residual of the result whatever the level's bc (the solver's stopping
// metric); the caller sums the partials, so runs are deterministic.
//
// Replaces the Pallas kernels behind prolong_correct_smooth and
// prolong_correct_smooth_rnorm: _pc_smooth_fused (row stripes), _pc_whole
// (whole array) and _pc_fused_wide (two-axis blocks),
// mgpoisson/kernels/pallas.py.
// Bound: HBM bytes, 3.25 arrays (read u, f, V; write u).
#include "stencil.cuh"

// The coarse tile covers the fine tile plus the bilinear +-1 coarse shift:
// ceil(H/2) + 1 coarse halo cells.
static __host__ __device__ inline int mg_coarse_halo(int H) { return (H + 1) / 2 + 1; }

static __host__ __device__ inline int mg_coarse_side(int H) {
  return MG_TILE / 2 + 2 * mg_coarse_halo(H);
}

// P(V) at in-domain fine cell (gi, gj), in ops.prolong's order.  Per axis
// the bilinear weights are (0.75, 0.25) inside and (0.5, 0) at the GLOBAL
// fine edges; the shifted tap is the coarse neighbour on the side of the
// cell's parity, zero outside the domain (the tile loads those as 0).
static __device__ __forceinline__ float mg_prolong(const float* sv, int SV, int cI0, int cJ0,
                                                   int gi, int gj, int n, int kind) {
  const int li = (gi >> 1) - cI0, lj = (gj >> 1) - cJ0;
  const float R = sv[li * SV + lj];
  if (kind == MG_INJECT) return R;
  const int di = (gi & 1) ? 1 : -1, dj = (gj & 1) ? 1 : -1;
  const float S0 = sv[(li + di) * SV + lj];
  const float S1 = sv[li * SV + lj + dj];
  const float S01 = sv[(li + di) * SV + lj + dj];
  const bool ei = gi == 0 || gi == n - 1, ej = gj == 0 || gj == n - 1;
  const float a0 = ei ? 0.5f : 0.75f, b0 = ei ? 0.f : 0.25f;
  const float a1 = ej ? 0.5f : 0.75f, b1 = ej ? 0.f : 0.25f;
  return (((a0 * a1) * R + (a0 * b1) * S1) + (b0 * a1) * S0) + (b0 * b1) * S01;
}

__global__ void __launch_bounds__(MG_THREADS)
mg_pc_kernel(const float* __restrict__ U, const float* __restrict__ F,
             const float* __restrict__ V, float* __restrict__ Uout,
             float* __restrict__ partials, int n, int H, int nu, int smoother, int bc,
             int kind, float inv_hsq, float inv_adiag, float adiag) {
  extern __shared__ float smem[];
  const MgTile t = mg_tile(n, H);
  const int S = t.S;
  float* a = smem;
  float* b = a + S * S;
  float* sf = b + S * S;
  float* sv = sf + S * S;
  const int nc = n / 2, CH = mg_coarse_halo(H), SV = mg_coarse_side(H);
  // the fine tile origin is even, so its coarse origin is blockIdx * T/2
  const int cI0 = (int)blockIdx.y * (MG_TILE / 2) - CH;
  const int cJ0 = (int)blockIdx.x * (MG_TILE / 2) - CH;
  for (int k = threadIdx.x; k < SV * SV; k += blockDim.x) {
    const int gI = cI0 + k / SV, gJ = cJ0 + k % SV;
    sv[k] = mg_in(gI, nc) && mg_in(gJ, nc) ? V[(size_t)gI * nc + gJ] : 0.f;
  }
  mg_load(a, sf, U, F, t);
  __syncthreads();
  for (int k = threadIdx.x; k < S * S; k += blockDim.x) {
    const int gi = t.gi0 + k / S, gj = t.gj0 + k % S;
    if (mg_in(gi, n) && mg_in(gj, n)) a[k] = a[k] + mg_prolong(sv, SV, cI0, cJ0, gi, gj, n, kind);
  }
  __syncthreads();
  const float* u = mg_sweeps(a, b, sf, t, nu, smoother, bc, inv_hsq, inv_adiag);
  mg_store(Uout, u, t);
  if (partials == nullptr) return;

  float acc = 0.f;
  for (int k = threadIdx.x; k < MG_TILE * MG_TILE; k += blockDim.x) {
    const int i = H + k / MG_TILE, j = H + k % MG_TILE;
    if (!mg_in(t.gi0 + i, n) || !mg_in(t.gj0 + j, n)) continue;
    const float r = mg_residual(u, sf, t, i, j, MG_GHOST0, inv_hsq, adiag);
    acc += r * r;
  }
  float* red = sv + SV * SV;   // fixed-order tree: the same sum every run
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

extern "C" int mg_prolong_correct_smooth(const float* u, const float* f, const float* V,
                                         float* out, float* partials, int n, int nu,
                                         int smoother, int bc, int kind, float inv_hsq,
                                         float inv_adiag, float adiag, int rnorm,
                                         cudaStream_t stream) {
  const int H = mg_steps(nu, smoother) + (rnorm ? 1 : 0);
  const int SV = mg_coarse_side(H);
  const size_t bytes = (mg_tile_floats(H) + (size_t)SV * SV + MG_THREADS) * sizeof(float);
  if (bytes > MG_SMEM_LIMIT || n < 2) return (int)cudaErrorInvalidValue;
  const dim3 grid(mg_tiles(n), mg_tiles(n));
  mg_pc_kernel<<<grid, MG_THREADS, bytes, stream>>>(u, f, V, out, rnorm ? partials : nullptr,
                                                     n, H, nu, smoother, bc, kind, inv_hsq,
                                                     inv_adiag, adiag);
  return (int)cudaGetLastError();
}
