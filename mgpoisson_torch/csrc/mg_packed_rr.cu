// K7 mg_packed_rr and K13 mg_sharded_packed_rr: the fast scheme's fine-level
// down-leg on packed state.  nu red-black sweeps, the ghost0 residual and
// the 2x2 restriction; writes the packed u and the UNPACKED coarse rhs.  A
// coarse cell is one packed lane over a row pair, red plus black (coarse
// column J = lane J), so with the tile's even row origin the restriction is
// tile-local.
//
// K7 replaces the Pallas kernels behind packed_smooth_residual_restrict:
// _packed_rr_fused (row stripes, and its write-through variant) and
// _packed_rr_fused_wide (two-axis blocks), mgpoisson/kernels/pallas.py.
//
// K13 replaces _packed_rr_sharded, mgpoisson/kernels/pallas.py, behind
// packed_rr_sharded: the same leg on one rank's block of nl whole packed
// rows of a row-sharded mesh, its halo rows read from the neighbours'
// strips (packed.cuh MgpStrips).  The TPU kernel DMAs each row stripe with
// its 8-deep strip rows into VMEM and gates its boundary on per-device edge
// flags; here the tile loader picks each halo row from its strip and the
// global row does what the flags did.  Rc is the block's (nl/2, n/2) coarse
// rhs, coarse rows from r0/2.
// Bound: HBM bytes, 3.25 arrays (read up, fp; write up', Rc); K13's strips
// add 4D/nl of an array.
#include "packed.cuh"

// The leg on the block `blk` ({n, 0} for the grid); each entry point below
// instantiates it once.
template <bool kStrips>
static __device__ __forceinline__ void mgp_rr_body(
    const float* __restrict__ U, const float* __restrict__ F, float* __restrict__ Uout,
    float* __restrict__ Rout, const MgpTile& t, const MgpRows& blk, const MgpStrips& us,
    const MgpStrips& fs, int nu, float mhq, float inv_hsq) {
  extern __shared__ float smem[];
  const int SS = t.S * t.S;
  float* xr = smem;
  float* xb = xr + SS;
  float* fr = xb + SS;
  float* fb = fr + SS;
  if constexpr (kStrips) {
    mgp_load_strips(xr, xb, U, us, t, blk);
    mgp_load_strips(fr, fb, F, fs, t, blk);
  } else {
    mgp_load(xr, xb, U, t);
    mgp_load(fr, fb, F, t);
  }
  __syncthreads();
  mgp_sweeps(xr, xb, fr, fb, t, nu, mhq);
  if constexpr (kStrips)
    mgp_store_block(Uout, xr, xb, t, blk);
  else
    mgp_store(Uout, xr, xb, t);

  // ((r_r + r_b) on row 2I + (r_r + r_b) on row 2I+1) / 4, as
  // ops.packed_smooth_residual_restrict; the halo keeps the ring the
  // residual reads exact.  I is the block's coarse row.
  const int T2 = MGP_TILE / 2;
  for (int ci = threadIdx.y; ci < T2; ci += blockDim.y) {
    const int I = (int)blockIdx.y * T2 + ci, li = t.G + 2 * ci;
    if (I >= blk.nl / 2) continue;
    for (int tj = threadIdx.x; tj < MGP_TILE; tj += blockDim.x) {
      const int lj = t.G + tj, gj = t.gj0 + lj;
      if (gj >= t.w) continue;
      const float s0 = mgp_residual(xr, xb, fr, t, li, lj, 0, inv_hsq) +
                       mgp_residual(xb, xr, fb, t, li, lj, 1, inv_hsq);
      const float s1 = mgp_residual(xr, xb, fr, t, li + 1, lj, 0, inv_hsq) +
                       mgp_residual(xb, xr, fb, t, li + 1, lj, 1, inv_hsq);
      Rout[(size_t)I * t.w + gj] = (s0 + s1) * 0.25f;
    }
  }
}

// K7: the whole n x n grid.
__global__ void __launch_bounds__(MGP_TX * MGP_TY)
mg_packed_rr_kernel(const float* __restrict__ U, const float* __restrict__ F,
                    float* __restrict__ Uout, float* __restrict__ Rout, int n, int nu,
                    float mhq, float inv_hsq) {
  mgp_rr_body<false>(U, F, Uout, Rout, mgp_tile(n, 2 * nu + 1), MgpRows{n, 0}, MgpStrips{},
                     MgpStrips{}, nu, mhq, inv_hsq);
}

// K13: one rank's block of whole rows, its halo rows from strips.
__global__ void __launch_bounds__(MGP_TX * MGP_TY)
mg_sharded_packed_rr_kernel(const float* __restrict__ U, const float* __restrict__ F,
                            float* __restrict__ Uout, float* __restrict__ Rout, MgpRows blk,
                            MgpStrips us, MgpStrips fs, int n, int nu, float mhq,
                            float inv_hsq) {
  mgp_rr_body<true>(U, F, Uout, Rout, mgp_tile_block(n, 2 * nu + 1, blk.r0), blk, us, fs, nu,
                    mhq, inv_hsq);
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

// One rank's packed (nl x n) block from global row r0 of an n x n level; u
// and f row strips (D x n) D >= 2 nu + 1 deep.
extern "C" int mg_sharded_packed_rr(const float* up, const float* fp, float* out, float* Rc,
                                    const float* ut, const float* ub, const float* ft,
                                    const float* fb, int n, int nl, int r0, int D, int nu,
                                    float mhq, float inv_hsq, cudaStream_t stream) {
  const int G = 2 * nu + 1, S = mgp_side(G);
  const size_t bytes = 4 * (size_t)S * S * sizeof(float);
  if (n < 2 || n % 2 || nl < 2 || (nl | r0) & 1 || r0 < 0 || r0 + nl > n || nu < 1 ||
      nu > MGP_MAX_NU || D < G || bytes > MGP_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(mgp_tiles(n / 2), mgp_tiles(nl)), block(MGP_TX, MGP_TY);
  mg_sharded_packed_rr_kernel<<<grid, block, bytes, stream>>>(
      up, fp, out, Rc, MgpRows{nl, r0}, MgpStrips{ut, ub, D}, MgpStrips{ft, fb, D}, n, nu, mhq,
      inv_hsq);
  return (int)cudaGetLastError();
}
