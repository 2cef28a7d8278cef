// K3 mg_prolong_correct_smooth and K10 mg_sharded_pc: the V-cycle up-leg.
// u += P(V), with P the piecewise-constant (inject) or face-adapted
// bilinear prolongation, then nu smoother sweeps; writes u.  With a
// partials buffer (the rnorm flag) it also writes one f32 partial of
// sum(r^2) per block, r being the ZERO-GHOST residual of the result
// whatever the level's bc (the solver's stopping metric), over the cells
// the launch stores; the caller sums the partials, so runs are
// deterministic.
//
// K3 replaces the Pallas kernels behind prolong_correct_smooth and
// prolong_correct_smooth_rnorm: _pc_smooth_fused (row stripes), _pc_whole
// (whole array) and _pc_fused_wide (two-axis blocks),
// mgpoisson/kernels/pallas.py.
//
// K10 replaces _pc_sharded, mgpoisson/kernels/pallas.py, behind
// pc_smooth_sharded: the same leg on one rank's (nl x ml) block of a
// sharded level, the fine halo read from the u and f strips and the coarse
// halo from V's coarse strips (stencil.cuh MgStrips), with the boundary,
// the colour and the bilinear edge weights from the global index.
// Bound: HBM bytes, 3.25 arrays (read u, f, V; write u); the strips add
// 4D/nl + 4D/ml of an array for u and f and 4 DV/nl + 4 DV/ml of V.
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
// (cI0, cJ0) is the global coarse index of the coarse tile's first cell.
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

// The leg on the block `blk`; each entry point below instantiates it once.
template <bool kStrips>
static __device__ __forceinline__ void mg_pc_body(
    const float* __restrict__ U, const float* __restrict__ F, const float* __restrict__ V,
    float* __restrict__ Uout, float* __restrict__ partials, const MgBlock& blk,
    const MgStrips& us, const MgStrips& fs, const MgStrips& vs, int H, int nu, int smoother,
    int bc, int kind, float inv_hsq, float inv_adiag, float adiag) {
  extern __shared__ float smem[];
  const MgTile t = mg_tile(blk, H);
  const int S = t.S, n = t.n;
  float* a = smem;
  float* b = a + S * S;
  float* sf = b + S * S;
  float* sv = sf + S * S;
  const int nc = n / 2, CH = mg_coarse_halo(H), SV = mg_coarse_side(H);
  // the fine tile origin is even, so its coarse origin is blockIdx * T/2 in
  // the block's coarse index; the block origin is even too
  const int lI0 = (int)blockIdx.y * (MG_TILE / 2) - CH;
  const int lJ0 = (int)blockIdx.x * (MG_TILE / 2) - CH;
  const int cI0 = blk.r0 / 2 + lI0, cJ0 = blk.c0 / 2 + lJ0;
  for (int k = threadIdx.x; k < SV * SV; k += blockDim.x) {
    const int gI = cI0 + k / SV, gJ = cJ0 + k % SV;
    if constexpr (kStrips)
      sv[k] = mg_in(gI, nc) && mg_in(gJ, nc)
                  ? mg_fetch(V, vs, lI0 + k / SV, lJ0 + k % SV, t.nl / 2, t.ml / 2)
                  : 0.f;
    else
      sv[k] = mg_in(gI, nc) && mg_in(gJ, nc) ? V[(size_t)gI * nc + gJ] : 0.f;
  }
  if constexpr (kStrips)
    mg_load_strips(a, sf, U, F, us, fs, t);
  else
    mg_load(a, sf, U, F, t);
  __syncthreads();
  for (int k = threadIdx.x; k < S * S; k += blockDim.x) {
    const int gi = t.gi0 + k / S, gj = t.gj0 + k % S;
    if (mg_in(gi, n) && mg_in(gj, n)) a[k] = a[k] + mg_prolong(sv, SV, cI0, cJ0, gi, gj, n, kind);
  }
  __syncthreads();
  const float* u = mg_sweeps(a, b, sf, t, nu, smoother, bc, inv_hsq, inv_adiag);
  if constexpr (kStrips)
    mg_store_block(Uout, u, t);
  else
    mg_store(Uout, u, t);
  if (partials == nullptr) return;

  float acc = 0.f;
  for (int k = threadIdx.x; k < MG_TILE * MG_TILE; k += blockDim.x) {
    const int i = H + k / MG_TILE, j = H + k % MG_TILE;
    if (kStrips ? !mg_owned(t, i, j) : !mg_in(t.gi0 + i, n) || !mg_in(t.gj0 + j, n)) continue;
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

// K3: the whole n x n grid.  The block is built here from n, so the
// compiler folds it away and the code is that of the grid-only kernel.
__global__ void __launch_bounds__(MG_THREADS)
mg_pc_kernel(const float* __restrict__ U, const float* __restrict__ F,
             const float* __restrict__ V, float* __restrict__ Uout,
             float* __restrict__ partials, int n, int H, int nu, int smoother, int bc,
             int kind, float inv_hsq, float inv_adiag, float adiag) {
  mg_pc_body<false>(U, F, V, Uout, partials, MgBlock{n, n, n, 0, 0}, MgStrips{}, MgStrips{},
                    MgStrips{}, H, nu, smoother, bc, kind, inv_hsq, inv_adiag, adiag);
}

// K10: one rank's block, its fine halo from the u and f strips and its
// coarse halo from V's.
__global__ void __launch_bounds__(MG_THREADS)
mg_sharded_pc_kernel(const float* __restrict__ U, const float* __restrict__ F,
                     const float* __restrict__ V, float* __restrict__ Uout,
                     float* __restrict__ partials, MgBlock blk, MgStrips us, MgStrips fs,
                     MgStrips vs, int H, int nu, int smoother, int bc, int kind,
                     float inv_hsq, float inv_adiag, float adiag) {
  mg_pc_body<true>(U, F, V, Uout, partials, blk, us, fs, vs, H, nu, smoother, bc, kind,
                   inv_hsq, inv_adiag, adiag);
}

static size_t mg_pc_bytes(int H) {
  const int SV = mg_coarse_side(H);
  return (mg_tile_floats(H) + (size_t)SV * SV + MG_THREADS) * sizeof(float);
}

extern "C" int mg_prolong_correct_smooth(const float* u, const float* f, const float* V,
                                         float* out, float* partials, int n, int nu,
                                         int smoother, int bc, int kind, float inv_hsq,
                                         float inv_adiag, float adiag, int rnorm,
                                         cudaStream_t stream) {
  const int H = mg_steps(nu, smoother) + (rnorm ? 1 : 0);
  const size_t bytes = mg_pc_bytes(H);
  if (bytes > MG_SMEM_LIMIT || n < 2) return (int)cudaErrorInvalidValue;
  const dim3 grid(mg_tiles(n), mg_tiles(n));
  mg_pc_kernel<<<grid, MG_THREADS, bytes, stream>>>(u, f, V, out, rnorm ? partials : nullptr,
                                                     n, H, nu, smoother, bc, kind, inv_hsq,
                                                     inv_adiag, adiag);
  return (int)cudaGetLastError();
}

// One rank's (nl x ml) block at global (r0, c0) of an n x n level; u and f
// strips D >= H deep, V's coarse strips DV >= ceil(H/2) + 1 deep (the
// left/right ones null on a mesh of one column).  With rnorm, one partial
// per block of the (ceil(ml/32), ceil(nl/32)) grid.
extern "C" int mg_sharded_pc(const float* u, const float* f, const float* V, float* out,
                             float* partials, const float* ut, const float* ub,
                             const float* ul, const float* ur, const float* ft,
                             const float* fb, const float* fl, const float* fr,
                             const float* vt, const float* vb, const float* vl,
                             const float* vr, int n, int nl, int ml, int r0, int c0, int D,
                             int DV, int nu, int smoother, int bc, int kind, float inv_hsq,
                             float inv_adiag, float adiag, int rnorm, cudaStream_t stream) {
  const int H = mg_steps(nu, smoother) + (rnorm ? 1 : 0);
  const size_t bytes = mg_pc_bytes(H);
  if (bytes > MG_SMEM_LIMIT || nl < 2 || ml < 2 || (nl | ml | r0 | c0) & 1 || D < H ||
      DV < mg_coarse_halo(H))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(mg_tiles(ml), mg_tiles(nl));
  mg_sharded_pc_kernel<<<grid, MG_THREADS, bytes, stream>>>(
      u, f, V, out, rnorm ? partials : nullptr, MgBlock{n, nl, ml, r0, c0},
      MgStrips{ut, ub, ul, ur, D}, MgStrips{ft, fb, fl, fr, D}, MgStrips{vt, vb, vl, vr, DV},
      H, nu, smoother, bc, kind, inv_hsq, inv_adiag, adiag);
  return (int)cudaGetLastError();
}
