// K8 mg_packed_pc: the fast scheme's fine-level up-leg on packed state.
// up += P(V), V the UNPACKED (n/2, n/2) coarse correction, then nu red-black
// sweeps; writes the packed u.  With a partials buffer (the rnorm flag) it
// also writes one f32 partial of sum(r^2) per block, r the ghost0 residual
// of the result (the solver's stopping metric), from a fixed-order tree;
// the caller sums the partials, so runs are deterministic.
//
// Replaces the Pallas kernels behind packed_prolong_correct_smooth and
// packed_prolong_correct_smooth_rnorm: _packed_pc_fused (row stripes, and
// its write-through variant) and _packed_pc_fused_wide (two-axis blocks),
// mgpoisson/kernels/pallas.py.
// Bound: HBM bytes, 3.25 arrays (read up, fp, V; write up').
#include "packed.cuh"

enum { MGP_INJECT = 0, MGP_BILINEAR = 1 };

// The coarse tile: coarse row I = gi >> 1 of every fine row of the tile,
// with the +-1 row of the bilinear blend (ceil(G/2) + 1 coarse rows of halo),
// and coarse column J = packed lane J of every lane, with the +-1 lane of
// the blend (G + 1 lanes of halo).
static __host__ __device__ inline int mgp_coarse_halo(int G) { return (G + 1) / 2 + 1; }

static __host__ __device__ inline int mgp_coarse_rows(int G) {
  return MGP_TILE / 2 + 2 * mgp_coarse_halo(G);
}

static __host__ __device__ inline int mgp_coarse_lanes(int G) { return MGP_TILE + 2 * (G + 1); }

// P(V) of both colours at in-grid fine row gi, packed lane gj, whose coarse
// cell is sv[k], in ops._packed_prolong's order: the row blend B = a0 V +
// b0 V(partner row), (a0, b0) = (0.5, 0) at global rows 0 and n-1, then the
// lane blend a1 B + b1 B(partner lane), the partner lane j-1 on even rows and
// j+1 on odd for red, the mirror for black, (a1, b1) = (0.5, 0) where the
// partner lane is off the grid (global columns 0 and n-1).  Off-grid coarse
// cells are 0 in the tile.
static __device__ __forceinline__ void mgp_prolong(const float* sv, int SC, int k, int gi,
                                                   int gj, int n, int kind, float& pr,
                                                   float& pb) {
  if (kind == MGP_INJECT) {
    pr = pb = sv[k];
    return;
  }
  const int odd = gi & 1, w = n / 2, kd = odd ? k + SC : k - SC;
  const bool e0 = gi == 0 || gi == n - 1;
  const float a0 = e0 ? 0.5f : 0.75f, b0 = e0 ? 0.f : 0.25f;
  const float Bm = a0 * sv[k - 1] + b0 * sv[kd - 1];
  const float B0 = a0 * sv[k] + b0 * sv[kd];
  const float Bp = a0 * sv[k + 1] + b0 * sv[kd + 1];
  const int dr = odd ? 1 : -1;   // red's partner lane; black's is -dr
  const bool er = !mgp_in(gj + dr, w), eb = !mgp_in(gj - dr, w);
  pr = (er ? 0.5f : 0.75f) * B0 + (er ? 0.f : 0.25f) * (odd ? Bp : Bm);
  pb = (eb ? 0.5f : 0.75f) * B0 + (eb ? 0.f : 0.25f) * (odd ? Bm : Bp);
}

__global__ void __launch_bounds__(MGP_TX * MGP_TY)
mg_packed_pc_kernel(const float* __restrict__ U, const float* __restrict__ F,
                    const float* __restrict__ V, float* __restrict__ Uout,
                    float* __restrict__ partials, int n, int nu, int kind, float mhq,
                    float inv_hsq) {
  extern __shared__ float smem[];
  const MgpTile t = mgp_tile(n, 2 * nu + (partials != nullptr ? 1 : 0));
  const int SS = t.S * t.S;
  float* xr = smem;
  float* xb = xr + SS;
  float* fr = xb + SS;
  float* fb = fr + SS;
  float* sv = fb + SS;
  const int SR = mgp_coarse_rows(t.G), SC = mgp_coarse_lanes(t.G);
  // the fine tile's row origin is even, so its coarse row origin is
  // blockIdx.y * T/2; coarse lanes are packed lanes
  const int cI0 = (int)blockIdx.y * (MGP_TILE / 2) - mgp_coarse_halo(t.G);
  const int cJ0 = t.gj0 - 1;
  for (int a = threadIdx.y; a < SR; a += blockDim.y) {
    const int gI = cI0 + a;
    for (int b = threadIdx.x; b < SC; b += blockDim.x) {
      const int gJ = cJ0 + b;
      sv[a * SC + b] = mgp_in(gI, n / 2) && mgp_in(gJ, t.w) ? V[(size_t)gI * t.w + gJ] : 0.f;
    }
  }
  mgp_load(xr, xb, U, t);
  mgp_load(fr, fb, F, t);
  __syncthreads();
  for (int li = threadIdx.y; li < t.S; li += blockDim.y) {
    const int gi = t.gi0 + li;
    if (!mgp_in(gi, n)) continue;
    const int crow = ((gi >> 1) - cI0) * SC;
    for (int lj = threadIdx.x; lj < t.S; lj += blockDim.x) {
      const int gj = t.gj0 + lj;
      if (!mgp_in(gj, t.w)) continue;
      float pr, pb;
      mgp_prolong(sv, SC, crow + gj - cJ0, gi, gj, n, kind, pr, pb);
      const int k = li * t.S + lj;
      xr[k] = xr[k] + pr;
      xb[k] = xb[k] + pb;
    }
  }
  __syncthreads();
  mgp_sweeps(xr, xb, fr, fb, t, nu, mhq);
  mgp_store(Uout, xr, xb, t);
  if (partials == nullptr) return;

  float acc = 0.f;
  for (int ti = threadIdx.y; ti < MGP_TILE; ti += blockDim.y) {
    const int li = t.G + ti;
    if (!mgp_in(t.gi0 + li, n)) continue;
    for (int tj = threadIdx.x; tj < MGP_TILE; tj += blockDim.x) {
      const int lj = t.G + tj;
      if (!mgp_in(t.gj0 + lj, t.w)) continue;
      const float rr = mgp_residual(xr, xb, fr, t, li, lj, 0, inv_hsq);
      const float rb = mgp_residual(xb, xr, fb, t, li, lj, 1, inv_hsq);
      acc += rr * rr;
      acc += rb * rb;
    }
  }
  float* red = sv + SR * SC;   // fixed-order tree: the same sum every run
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  red[tid] = acc;
  __syncthreads();
  for (int s = blockDim.x * blockDim.y / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

extern "C" int mg_packed_pc(const float* up, const float* fp, const float* V, float* out,
                            float* partials, int n, int nu, int kind, float mhq,
                            float inv_hsq, int rnorm, cudaStream_t stream) {
  const int G = 2 * nu + (rnorm ? 1 : 0), S = mgp_side(G);
  const size_t bytes = (4 * (size_t)S * S + (size_t)mgp_coarse_rows(G) * mgp_coarse_lanes(G) +
                        MGP_TX * MGP_TY) * sizeof(float);
  if (n < 2 || n % 2 || nu < 1 || nu > MGP_MAX_NU || bytes > MGP_SMEM_LIMIT ||
      (kind != MGP_INJECT && kind != MGP_BILINEAR))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(mgp_tiles(n / 2), mgp_tiles(n)), block(MGP_TX, MGP_TY);
  mg_packed_pc_kernel<<<grid, block, bytes, stream>>>(up, fp, V, out, rnorm ? partials : nullptr,
                                                      n, nu, kind, mhq, inv_hsq);
  return (int)cudaGetLastError();
}
