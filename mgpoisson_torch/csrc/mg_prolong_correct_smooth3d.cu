// K6 mg_prolong_correct_smooth3d: the 3D V-cycle up-leg.  u += P(V), with P
// the piecewise-constant (inject) or face-adapted trilinear prolongation,
// then nu 7-point smoother sweeps; writes u.  With a partials buffer (the
// rnorm flag) it also writes one f32 partial of sum(r^2) per block, r being
// the ZERO-GHOST residual of the result whatever the level's bc (the
// solver's stopping metric); the caller sums the partials, so runs are
// deterministic.
//
// Replaces _pc_fused_3d, mgpoisson/kernels/pallas.py, the Pallas kernel
// behind prolong_correct_smooth and prolong_correct_smooth_rnorm for 3D
// arrays.
// Bound: HBM bytes, 3.125 arrays (read u, f, V; write u).  The design
// (stencil3d.cuh) reads each array once per block tile; the halo costs
// (T + 2H)^3 / T^3 = 3.4 cells loaded per interior cell at T = 16, H = 4
// (wjacobi nu = 3 plus the residual ring of rnorm), 2.6 at H = 3.
#include "stencil3d.cuh"

// The coarse tile covers the fine tile plus the trilinear +-1 coarse
// shift: ceil(H/2) + 1 coarse halo cells.
static __host__ __device__ inline int mg3_coarse_halo(int H) { return (H + 1) / 2 + 1; }

static __host__ __device__ inline int mg3_coarse_side(int T, int H) {
  return T / 2 + 2 * mg3_coarse_halo(H);
}

// P(V) at in-domain fine cell (gz, gy, gx), in ops.prolong's order: the
// 2^3 taps (z, y, x picks, x fastest), each weighted by the product of its
// per-axis weights taken in axis order.  Per axis the trilinear weights are
// (0.75, 0.25) inside and (0.5, 0) at the GLOBAL fine edges; the shifted
// tap is the coarse neighbour on the side of the cell's parity, zero
// outside the domain (the tile loads those as 0).
static __device__ __forceinline__ float mg3_prolong(const float* sv, int SV, int cz0, int cy0,
                                                    int cx0, int gz, int gy, int gx, int n,
                                                    int kind) {
  const int k = (((gz >> 1) - cz0) * SV + ((gy >> 1) - cy0)) * SV + ((gx >> 1) - cx0);
  const float R = sv[k];
  if (kind == MG_INJECT) return R;
  const int dz = (gz & 1) ? SV * SV : -SV * SV, dy = (gy & 1) ? SV : -SV,
            dx = (gx & 1) ? 1 : -1;
  const bool ez = gz == 0 || gz == n - 1, ey = gy == 0 || gy == n - 1,
             ex = gx == 0 || gx == n - 1;
  const float a0 = ez ? 0.5f : 0.75f, b0 = ez ? 0.f : 0.25f;
  const float a1 = ey ? 0.5f : 0.75f, b1 = ey ? 0.f : 0.25f;
  const float a2 = ex ? 0.5f : 0.75f, b2 = ex ? 0.f : 0.25f;
  float out = ((a0 * a1) * a2) * R;
  out = out + ((a0 * a1) * b2) * sv[k + dx];
  out = out + ((a0 * b1) * a2) * sv[k + dy];
  out = out + ((a0 * b1) * b2) * sv[k + dy + dx];
  out = out + ((b0 * a1) * a2) * sv[k + dz];
  out = out + ((b0 * a1) * b2) * sv[k + dz + dx];
  out = out + ((b0 * b1) * a2) * sv[k + dz + dy];
  out = out + ((b0 * b1) * b2) * sv[k + dz + dy + dx];
  return out;
}

__global__ void __launch_bounds__(MG3_THREADS)
mg_pc3d_kernel(const float* __restrict__ U, const float* __restrict__ F,
               const float* __restrict__ V, float* __restrict__ Uout,
               float* __restrict__ partials, int n, int T, int H, int nu, int smoother,
               int bc, int kind, float inv_hsq, float inv_adiag, float adiag) {
  extern __shared__ float smem[];
  const Mg3Tile t = mg3_tile(n, T, H);
  const int S = t.S, S3 = S * S * S;
  float* a = smem;
  float* b = a + S3;
  float* sf = b + S3;
  float* sv = sf + S3;
  const int nc = n / 2, CH = mg3_coarse_halo(H), SV = mg3_coarse_side(T, H);
  // the fine tile origin is even, so its coarse origin is blockIdx * T/2
  const int cz0 = (int)blockIdx.z * (T / 2) - CH, cy0 = (int)blockIdx.y * (T / 2) - CH,
            cx0 = (int)blockIdx.x * (T / 2) - CH;
  for (int k = threadIdx.x; k < SV * SV * SV; k += blockDim.x) {
    const int gK = cx0 + k % SV, q = k / SV, gJ = cy0 + q % SV, gI = cz0 + q / SV;
    sv[k] = mg_in(gI, nc) && mg_in(gJ, nc) && mg_in(gK, nc)
                ? V[((size_t)gI * nc + gJ) * nc + gK]
                : 0.f;
  }
  mg3_load(a, sf, U, F, t);
  __syncthreads();
  for (int k = threadIdx.x; k < S3; k += blockDim.x) {
    const int l = k % S, q = k / S, j = q % S, i = q / S;
    if (mg3_in(t, i, j, l))
      a[k] = a[k] + mg3_prolong(sv, SV, cz0, cy0, cx0, t.gz0 + i, t.gy0 + j, t.gx0 + l, n,
                                kind);
  }
  __syncthreads();
  const float* u = mg3_sweeps(a, b, sf, t, nu, smoother, bc, inv_hsq, inv_adiag);
  mg3_store(Uout, u, t);
  if (partials == nullptr) return;

  float acc = 0.f;
  for (int k = threadIdx.x; k < T * T * T; k += blockDim.x) {
    const int l = H + k % T, q = k / T, j = H + q % T, i = H + q / T;
    if (!mg3_in(t, i, j, l)) continue;
    const float r = mg3_residual(u, sf, t, i, j, l, MG_GHOST0, inv_hsq, adiag);
    acc += r * r;
  }
  float* red = sv + SV * SV * SV;   // fixed-order tree: the same sum every run
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    partials[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = red[0];
}

extern "C" int mg_prolong_correct_smooth3d(const float* u, const float* f, const float* V,
                                           float* out, float* partials, int n, int tile,
                                           int nu, int smoother, int bc, int kind,
                                           float inv_hsq, float inv_adiag, float adiag,
                                           int rnorm, cudaStream_t stream) {
  const int H = mg_steps(nu, smoother) + (rnorm ? 1 : 0);
  const size_t SV = (size_t)mg3_coarse_side(tile, H);
  const size_t bytes = (mg3_tile_floats(tile, H) + SV * SV * SV + MG3_THREADS) * sizeof(float);
  const int rc = mg3_prepare((const void*)mg_pc3d_kernel, n, tile, bytes);
  if (rc != 0) return rc;
  mg_pc3d_kernel<<<mg3_grid(n, tile), MG3_THREADS, bytes, stream>>>(
      u, f, V, out, rnorm ? partials : nullptr, n, tile, H, nu, smoother, bc, kind, inv_hsq,
      inv_adiag, adiag);
  return (int)cudaGetLastError();
}
