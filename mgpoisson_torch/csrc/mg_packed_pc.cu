// K8 mg_packed_pc and K14 mg_sharded_packed_pc: the fast scheme's fine-level
// up-leg on packed state.  up += P(V), V the UNPACKED coarse correction,
// then nu red-black sweeps; writes the packed u.  With a partials buffer
// (the rnorm flag) it also writes one f32 partial of sum(r^2) per block, r
// the ghost0 residual of the result (the solver's stopping metric) over the
// cells the launch owns, from a fixed-order tree; the caller sums the
// partials, so runs are deterministic.
//
// K8 replaces the Pallas kernels behind packed_prolong_correct_smooth and
// packed_prolong_correct_smooth_rnorm: _packed_pc_fused (row stripes, and
// its write-through variant) and _packed_pc_fused_wide (two-axis blocks),
// mgpoisson/kernels/pallas.py.
//
// K14 replaces _packed_pc_sharded, mgpoisson/kernels/pallas.py, behind
// packed_pc_sharded: the same leg on one rank's block of nl whole packed
// rows of a row-sharded mesh, the fine halo rows from the u and f strips
// and the coarse halo rows of V (ceil(G/2) + 1 of them, the ones the
// bilinear row blend of the tile's edge rows reads) from V's coarse strips.
// The TPU kernel writes a row of column partials accumulated over its
// sequential stripes; here each block writes one partial.
// Bound: HBM bytes, 3.25 arrays (read up, fp, V; write up'); K14's strips
// add (4D + Dv)/nl of an array.
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

// The leg on the block `blk` ({n, 0} for the grid); each entry point below
// instantiates it once.
template <bool kStrips>
static __device__ __forceinline__ void mgp_pc_body(
    const float* __restrict__ U, const float* __restrict__ F, const float* __restrict__ V,
    float* __restrict__ Uout, float* __restrict__ partials, const MgpTile& t,
    const MgpRows& blk, const MgpStrips& us, const MgpStrips& fs, const MgpStrips& vs, int nu,
    int kind, float mhq, float inv_hsq) {
  extern __shared__ float smem[];
  const int n = t.n;
  const int SS = t.S * t.S;
  float* xr = smem;
  float* xb = xr + SS;
  float* fr = xb + SS;
  float* fb = fr + SS;
  float* sv = fb + SS;
  const int SR = mgp_coarse_rows(t.G), SC = mgp_coarse_lanes(t.G);
  // the fine tile's row origin is even, so its global coarse row origin is
  // r0/2 + blockIdx.y * T/2; coarse lanes are packed lanes
  const int cI0 = blk.r0 / 2 + (int)blockIdx.y * (MGP_TILE / 2) - mgp_coarse_halo(t.G);
  const int cJ0 = t.gj0 - 1;
  for (int a = threadIdx.y; a < SR; a += blockDim.y) {
    const int gI = cI0 + a;
    if constexpr (kStrips) {
      // the coarse block's rows are r0/2 .. (r0 + nl)/2, its strips Dv deep
      const float* row =
          mgp_in(gI, n / 2) ? mgp_row(V, vs, gI - blk.r0 / 2, blk.nl / 2, t.w) : nullptr;
      for (int b = threadIdx.x; b < SC; b += blockDim.x) {
        const int gJ = cJ0 + b;
        sv[a * SC + b] = row != nullptr && mgp_in(gJ, t.w) ? row[gJ] : 0.f;
      }
    } else {
      for (int b = threadIdx.x; b < SC; b += blockDim.x) {
        const int gJ = cJ0 + b;
        sv[a * SC + b] =
            mgp_in(gI, n / 2) && mgp_in(gJ, t.w) ? V[(size_t)gI * t.w + gJ] : 0.f;
      }
    }
  }
  if constexpr (kStrips) {
    mgp_load_strips(xr, xb, U, us, t, blk);
    mgp_load_strips(fr, fb, F, fs, t, blk);
  } else {
    mgp_load(xr, xb, U, t);
    mgp_load(fr, fb, F, t);
  }
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
  if constexpr (kStrips)
    mgp_store_block(Uout, xr, xb, t, blk);
  else
    mgp_store(Uout, xr, xb, t);
  if (partials == nullptr) return;

  float acc = 0.f;
  for (int ti = threadIdx.y; ti < MGP_TILE; ti += blockDim.y) {
    const int li = t.G + ti;
    if (!mgp_in(t.gi0 + li - blk.r0, blk.nl)) continue;   // the block's own rows
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

// K8: the whole n x n grid.
__global__ void __launch_bounds__(MGP_TX * MGP_TY)
mg_packed_pc_kernel(const float* __restrict__ U, const float* __restrict__ F,
                    const float* __restrict__ V, float* __restrict__ Uout,
                    float* __restrict__ partials, int n, int nu, int kind, float mhq,
                    float inv_hsq) {
  mgp_pc_body<false>(U, F, V, Uout, partials,
                     mgp_tile(n, 2 * nu + (partials != nullptr ? 1 : 0)), MgpRows{n, 0},
                     MgpStrips{}, MgpStrips{}, MgpStrips{}, nu, kind, mhq, inv_hsq);
}

// K14: one rank's block of whole rows, its halo rows from strips.
__global__ void __launch_bounds__(MGP_TX * MGP_TY)
mg_sharded_packed_pc_kernel(const float* __restrict__ U, const float* __restrict__ F,
                            const float* __restrict__ V, float* __restrict__ Uout,
                            float* __restrict__ partials, MgpRows blk, MgpStrips us,
                            MgpStrips fs, MgpStrips vs, int n, int nu, int kind, float mhq,
                            float inv_hsq) {
  mgp_pc_body<true>(U, F, V, Uout, partials,
                    mgp_tile_block(n, 2 * nu + (partials != nullptr ? 1 : 0), blk.r0), blk, us,
                    fs, vs, nu, kind, mhq, inv_hsq);
}

static size_t mgp_pc_bytes(int G) {
  const int S = mgp_side(G);
  return (4 * (size_t)S * S + (size_t)mgp_coarse_rows(G) * mgp_coarse_lanes(G) +
          MGP_TX * MGP_TY) * sizeof(float);
}

extern "C" int mg_packed_pc(const float* up, const float* fp, const float* V, float* out,
                            float* partials, int n, int nu, int kind, float mhq,
                            float inv_hsq, int rnorm, cudaStream_t stream) {
  const size_t bytes = mgp_pc_bytes(2 * nu + (rnorm ? 1 : 0));
  if (n < 2 || n % 2 || nu < 1 || nu > MGP_MAX_NU || bytes > MGP_SMEM_LIMIT ||
      (kind != MGP_INJECT && kind != MGP_BILINEAR))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(mgp_tiles(n / 2), mgp_tiles(n)), block(MGP_TX, MGP_TY);
  mg_packed_pc_kernel<<<grid, block, bytes, stream>>>(up, fp, V, out, rnorm ? partials : nullptr,
                                                      n, nu, kind, mhq, inv_hsq);
  return (int)cudaGetLastError();
}

// One rank's packed (nl x n) block from global row r0 of an n x n level, V
// its (nl/2 x n/2) coarse block; u and f row strips (D x n) D >= G deep, V's
// (Dv x n/2) Dv >= ceil(G/2) + 1 deep, G = 2 nu (+1 with rnorm).
extern "C" int mg_sharded_packed_pc(const float* up, const float* fp, const float* V,
                                    float* out, float* partials, const float* ut,
                                    const float* ub, const float* ft, const float* fb,
                                    const float* vt, const float* vb, int n, int nl, int r0,
                                    int D, int Dv, int nu, int kind, float mhq, float inv_hsq,
                                    int rnorm, cudaStream_t stream) {
  const int G = 2 * nu + (rnorm ? 1 : 0);
  const size_t bytes = mgp_pc_bytes(G);
  if (n < 2 || n % 2 || nl < 2 || (nl | r0) & 1 || r0 < 0 || r0 + nl > n || nu < 1 ||
      nu > MGP_MAX_NU || D < G || Dv < mgp_coarse_halo(G) || bytes > MGP_SMEM_LIMIT ||
      (kind != MGP_INJECT && kind != MGP_BILINEAR))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(mgp_tiles(n / 2), mgp_tiles(nl)), block(MGP_TX, MGP_TY);
  mg_sharded_packed_pc_kernel<<<grid, block, bytes, stream>>>(
      up, fp, V, out, rnorm ? partials : nullptr, MgpRows{nl, r0}, MgpStrips{ut, ub, D},
      MgpStrips{ft, fb, D}, MgpStrips{vt, vb, Dv}, n, nu, kind, mhq, inv_hsq);
  return (int)cudaGetLastError();
}
