// K2 mg_smooth_rr and K9 mg_sharded_rr: the V-cycle down-leg.  nu smoother
// sweeps, then the residual r = f - A u with the level's bc, then the
// 2x2-mean restriction; writes u and R.  With U == nullptr (the from-zero
// flag) u starts identically zero and is never read.
//
// K2 replaces the Pallas kernels behind smooth_residual_restrict and
// smooth_residual_restrict_zero: _smooth_rr_fused (row stripes), _rr_whole
// (whole array), _rr_fused_wide (two-axis blocks) and _rr_fused_zero (from
// zero), mgpoisson/kernels/pallas.py.  The from-zero form is valid at
// every size here, where the TPU used it only at n >= 4096.
//
// K9 replaces _rr_sharded, mgpoisson/kernels/pallas.py, behind
// smooth_rr_sharded: the same leg on one rank's (nl x ml) block of a
// sharded level, its halo read from the neighbours' strips (stencil.cuh
// MgStrips) and the boundary applied only where the block's edge is the
// grid's.  The TPU kernel assembles its halo by DMA into a VMEM stripe with
// a 128-lane column window; here the tile loader picks each halo cell from
// its strip, and the global index does what the TPU's edge flags did.
// Bound: HBM bytes, 3.25 arrays (read u, f; write u, R), 2.25 from zero;
// the strips add 4D/nl + 4D/ml of an array (both u and f).
#include "stencil.cuh"

// The leg on the block `blk`; each entry point below instantiates it once.
template <bool kStrips>
static __device__ __forceinline__ void mg_smooth_rr_body(
    const float* __restrict__ U, const float* __restrict__ F, float* __restrict__ Uout,
    float* __restrict__ Rout, const MgBlock& blk, const MgStrips& us, const MgStrips& fs,
    int H, int nu, int smoother, int bc, float inv_hsq, float inv_adiag, float adiag) {
  extern __shared__ float smem[];
  const MgTile t = mg_tile(blk, H);
  float* a = smem;
  float* b = a + t.S * t.S;
  float* sf = b + t.S * t.S;
  if constexpr (kStrips)
    mg_load_strips(a, sf, U, F, us, fs, t);
  else
    mg_load(a, sf, U, F, t);
  __syncthreads();
  const float* u = mg_sweeps(a, b, sf, t, nu, smoother, bc, inv_hsq, inv_adiag);
  if constexpr (kStrips)
    mg_store_block(Uout, u, t);
  else
    mg_store(Uout, u, t);

  // the tile origin is even, so each coarse cell's 2x2 fine cells lie in
  // this tile; the halo keeps the ring the residual reads exact
  const int ncl = t.nl / 2, mcl = t.ml / 2, T2 = MG_TILE / 2;
  for (int k = threadIdx.x; k < T2 * T2; k += blockDim.x) {
    const int ci = k / T2, cj = k % T2;
    const int I = (int)blockIdx.y * T2 + ci, J = (int)blockIdx.x * T2 + cj;
    if (!mg_in(I, ncl) || !mg_in(J, mcl)) continue;
    const int i = t.H + 2 * ci, j = t.H + 2 * cj;
    const float r00 = mg_residual(u, sf, t, i, j, bc, inv_hsq, adiag);
    const float r10 = mg_residual(u, sf, t, i + 1, j, bc, inv_hsq, adiag);
    const float r01 = mg_residual(u, sf, t, i, j + 1, bc, inv_hsq, adiag);
    const float r11 = mg_residual(u, sf, t, i + 1, j + 1, bc, inv_hsq, adiag);
    Rout[(size_t)I * mcl + J] = ((r00 + r10) + (r01 + r11)) * 0.25f;
  }
}

// K2: the whole n x n grid.  The block is built here from n, so the
// compiler folds it away and the code is that of the grid-only kernel.
__global__ void __launch_bounds__(MG_THREADS)
mg_smooth_rr_kernel(const float* __restrict__ U, const float* __restrict__ F,
                    float* __restrict__ Uout, float* __restrict__ Rout, int n, int H,
                    int nu, int smoother, int bc, float inv_hsq, float inv_adiag,
                    float adiag) {
  mg_smooth_rr_body<false>(U, F, Uout, Rout, MgBlock{n, n, n, 0, 0}, MgStrips{}, MgStrips{},
                           H, nu, smoother, bc, inv_hsq, inv_adiag, adiag);
}

// K9: one rank's block, its halo from strips.
__global__ void __launch_bounds__(MG_THREADS)
mg_sharded_rr_kernel(const float* __restrict__ U, const float* __restrict__ F,
                     float* __restrict__ Uout, float* __restrict__ Rout, MgBlock blk,
                     MgStrips us, MgStrips fs, int H, int nu, int smoother, int bc,
                     float inv_hsq, float inv_adiag, float adiag) {
  mg_smooth_rr_body<true>(U, F, Uout, Rout, blk, us, fs, H, nu, smoother, bc, inv_hsq,
                          inv_adiag, adiag);
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

// One rank's (nl x ml) block at global (r0, c0) of an n x n level; u and f
// strips D >= H deep (ut..ur unused from zero; ul/ur and fl/fr null on a
// mesh of one column).
extern "C" int mg_sharded_rr(const float* u, const float* f, float* out, float* R,
                             const float* ut, const float* ub, const float* ul,
                             const float* ur, const float* ft, const float* fb,
                             const float* fl, const float* fr, int n, int nl, int ml, int r0,
                             int c0, int D, int nu, int smoother, int bc, float inv_hsq,
                             float inv_adiag, float adiag, int zero, cudaStream_t stream) {
  const int H = mg_steps(nu, smoother) + 1;
  const size_t bytes = mg_tile_floats(H) * sizeof(float);
  if (bytes > MG_SMEM_LIMIT || nl < 2 || ml < 2 || (nl | ml | r0 | c0) & 1 || D < H)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(mg_tiles(ml), mg_tiles(nl));
  const MgStrips us = zero ? MgStrips{nullptr, nullptr, nullptr, nullptr, D}
                           : MgStrips{ut, ub, ul, ur, D};
  mg_sharded_rr_kernel<<<grid, MG_THREADS, bytes, stream>>>(
      zero ? nullptr : u, f, out, R, MgBlock{n, nl, ml, r0, c0}, us,
      MgStrips{ft, fb, fl, fr, D}, H, nu, smoother, bc, inv_hsq, inv_adiag, adiag);
  return (int)cudaGetLastError();
}
