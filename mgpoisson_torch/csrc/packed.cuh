// Shared-memory tile of the packed down-leg of the fast scheme's fine level:
// K7 mg_packed_rr on the whole grid and its strip-fed twin K13
// mg_sharded_packed_rr on one rank's block of a row-sharded mesh.  (The
// packed up-leg K8/K14 runs the register tile, stencil_packed.cuh.)
//
// The fine-level state stays checkerboard-packed for the whole solve: an
// (n, n) array whose left half holds the red cells and right half the black,
//
//   up[i][j]     = xr[i][j] = u[i][2j + i%2]        (red, parity 0)
//   up[i][w + j] = xb[i][j] = u[i][2j + 1 - i%2]    (black), w = n/2,
//
// so a colour half-sweep evaluates the stencil on the cells of that colour
// only and every thread does useful work (the where-select form of K1-K3
// computes every cell and keeps half).  The neighbours of red (i, j) are
// black (i-1, j), (i+1, j), (i, j) and (i, j-1) on even rows or (i, j+1) on
// odd rows; black the mirror.  One half-sweep thus reaches one row and one
// packed lane, so a tile of MGP_TILE rows x MGP_TILE packed lanes of both
// colours (MGP_TILE x 2 MGP_TILE fine cells) with a halo of G rows and G
// lanes on every side is exact in its interior after G half-sweeps, each
// updating one colour over a region that shrinks by one on every side:
// G = 2 nu, +1 where a residual follows.  Red, black and the two f planes
// take 4 (MGP_TILE + 2G)^2 floats, 34 KB at G = 7 (nu = 3 with a residual),
// under the 48 KB of a launch without opt-in.
//
// This one tile replaces the TPU's geometries (row stripes with a VMEM
// handoff, their write-through drain, the two-axis blocks at n >= 32768),
// which exist only because of VMEM.  Row parity is the GLOBAL row's.  Cells
// outside the grid load as 0 and are never updated: the ghost0 bc, the
// fine level's by definition.  Bound: HBM bytes, 3.25 arrays per kernel;
// the halo re-reads mostly hit L2.
//
// Arithmetic follows the packed functions of mgpoisson_torch/kernels/ops.py
// (pallas.py _packed_core, _packed_residual) operation for operation.
//
// On a mesh of one column a rank's block is nl whole packed rows from an
// even global row r0 (MgpRows; {n, 0} is the grid), its halo rows the
// neighbours' edge rows, delivered as strips (MgpStrips, the layout of
// kernels/ops.py packed_rr_sharded).  The tile keeps its GLOBAL row gi0,
// which decides the colour pattern, the grid's edges and the bilinear
// weights as on the whole grid; the block row gi - r0 addresses the block's
// arrays, and the strip loader picks each halo row from its strip.
#pragma once

#include <cuda_runtime.h>

#define MGP_TILE 32     // rows and packed lanes per tile; even, so row pairs stay tile-local
#define MGP_TX 32       // threads per block along the lanes
#define MGP_TY 8        // and along the rows
#define MGP_MAX_NU 3    // the JAX package's packed cap (pallas.py packed_plan)
#define MGP_SMEM_LIMIT (48 * 1024)   // dynamic shared memory without opt-in

struct MgpTile {
  int n;    // fine side
  int w;    // packed lanes per colour, n / 2
  int G;    // halo depth, in rows and in lanes
  int S;    // MGP_TILE + 2G
  int gi0;  // global row of local row 0 (tile origin - G; may be negative)
  int gj0;  // global lane of local lane 0
};

static __host__ __device__ inline int mgp_side(int G) { return MGP_TILE + 2 * G; }

static __host__ inline int mgp_tiles(int m) { return (m + MGP_TILE - 1) / MGP_TILE; }

static __device__ __forceinline__ MgpTile mgp_tile(int n, int G) {
  MgpTile t;
  t.n = n;
  t.w = n / 2;
  t.G = G;
  t.S = mgp_side(G);
  t.gi0 = (int)blockIdx.y * MGP_TILE - G;
  t.gj0 = (int)blockIdx.x * MGP_TILE - G;
  return t;
}

static __device__ __forceinline__ bool mgp_in(int g, int n) {
  return (unsigned)g < (unsigned)n;
}

// A block of whole rows: nl rows from global row r0 (even).
struct MgpRows {
  int nl, r0;
};

// A block's halo rows, D deep: top holds block rows -D..-1, bot rows
// nl..nl+D-1, each row as wide as the block's (zeros beyond the grid's edge).
struct MgpStrips {
  const float* top;
  const float* bot;
  int D;
};

// The tile of a launch over a block: mgp_tile with the global row shifted
// by the block's first row.
static __device__ __forceinline__ MgpTile mgp_tile_block(int n, int G, int r0) {
  MgpTile t = mgp_tile(n, G);
  t.gi0 += r0;
  return t;
}

// Block row li of an array of `width` floats per row fed by strips: the
// body's row or the strip's that holds it.  Null beyond the strips: only a
// tile that overhangs the block's last row (nl not a multiple of MGP_TILE;
// the solver's blocks are powers of two >= MGP_TILE) reaches one, and with
// D >= G the shrinking exact region never lets it reach the block or the
// ring a residual reads.
static __device__ __forceinline__ const float* mgp_row(const float* body, const MgpStrips& s,
                                                       int li, int nl, int width) {
  if (li >= 0 && li < nl) return body + (size_t)li * width;
  if (li < 0 && li >= -s.D) return s.top + (size_t)(li + s.D) * width;
  if (li >= nl && li < nl + s.D) return s.bot + (size_t)(li - nl) * width;
  return nullptr;
}

// Lane offset of the horizontal partner: red reads lane j-1 on even rows
// and j+1 on odd rows, black the mirror.
static __device__ __forceinline__ int mgp_dj(int gi, int colour) {
  return ((gi & 1) ^ colour) ? 1 : -1;
}

// Loads the (S x S) tile of both colour planes of a packed array; cells
// outside the grid read 0.
static __device__ void mgp_load(float* r, float* b, const float* __restrict__ A,
                                const MgpTile& t) {
  for (int li = threadIdx.y; li < t.S; li += blockDim.y) {
    const int gi = t.gi0 + li;
    for (int lj = threadIdx.x; lj < t.S; lj += blockDim.x) {
      const int gj = t.gj0 + lj, k = li * t.S + lj;
      float vr = 0.f, vb = 0.f;
      if (mgp_in(gi, t.n) && mgp_in(gj, t.w)) {
        const size_t g = (size_t)gi * t.n + gj;
        vr = A[g];
        vb = A[g + t.w];
      }
      r[k] = vr;
      b[k] = vb;
    }
  }
}

// mgp_load for a block fed by strips: each tile row from the body or a
// strip, by its block row; rows outside the grid read 0.
static __device__ void mgp_load_strips(float* r, float* b, const float* __restrict__ A,
                                       const MgpStrips& s, const MgpTile& t,
                                       const MgpRows& blk) {
  for (int li = threadIdx.y; li < t.S; li += blockDim.y) {
    const int gi = t.gi0 + li;
    const float* row = mgp_in(gi, t.n) ? mgp_row(A, s, gi - blk.r0, blk.nl, t.n) : nullptr;
    for (int lj = threadIdx.x; lj < t.S; lj += blockDim.x) {
      const int gj = t.gj0 + lj, k = li * t.S + lj;
      float vr = 0.f, vb = 0.f;
      if (row != nullptr && mgp_in(gj, t.w)) {
        vr = row[gj];
        vb = row[gj + t.w];
      }
      r[k] = vr;
      b[k] = vb;
    }
  }
}

// nu sweeps in place: half-sweep s updates colour s & 1 (red first) at the
// local cells [s+1, S-2-s] of both axes, X = (V + H) / 4 + f * (-h^2/4).
static __device__ void mgp_sweeps(float* xr, float* xb, const float* fr, const float* fb,
                                  const MgpTile& t, int nu, float mhq) {
  const int S = t.S;
  for (int s = 0; s < 2 * nu; ++s) {
    const int colour = s & 1, lo = s + 1, hi = S - 2 - s;
    float* X = colour ? xb : xr;
    const float* Y = colour ? xr : xb;
    const float* Fc = colour ? fb : fr;
    for (int li = lo + (int)threadIdx.y; li <= hi; li += blockDim.y) {
      const int gi = t.gi0 + li;
      if (!mgp_in(gi, t.n)) continue;
      const int dj = mgp_dj(gi, colour);
      for (int lj = lo + (int)threadIdx.x; lj <= hi; lj += blockDim.x) {
        if (!mgp_in(t.gj0 + lj, t.w)) continue;
        const int k = li * S + lj;
        X[k] = ((Y[k - S] + Y[k + S]) + (Y[k] + Y[k + dj])) * 0.25f + Fc[k] * mhq;
      }
    }
    __syncthreads();
  }
}

// r = f - (nbr - 4x)/h^2 of colour `colour` (X its plane, Y the other) at
// local (li, lj), as ops._packed_residual.
static __device__ __forceinline__ float mgp_residual(const float* X, const float* Y,
                                                     const float* Fc, const MgpTile& t,
                                                     int li, int lj, int colour,
                                                     float inv_hsq) {
  const int S = t.S, k = li * S + lj;
  const float nbr = ((Y[k - S] + Y[k + S]) + Y[k]) + Y[k + mgp_dj(t.gi0 + li, colour)];
  return Fc[k] - (nbr - 4.f * X[k]) * inv_hsq;
}

// Writes the tile's interior of both planes back to the packed array.
static __device__ void mgp_store(float* __restrict__ A, const float* xr, const float* xb,
                                 const MgpTile& t) {
  for (int ti = threadIdx.y; ti < MGP_TILE; ti += blockDim.y) {
    const int li = t.G + ti, gi = t.gi0 + li;
    if (!mgp_in(gi, t.n)) continue;
    for (int tj = threadIdx.x; tj < MGP_TILE; tj += blockDim.x) {
      const int lj = t.G + tj, gj = t.gj0 + lj;
      if (!mgp_in(gj, t.w)) continue;
      const size_t g = (size_t)gi * t.n + gj;
      A[g] = xr[li * t.S + lj];
      A[g + t.w] = xb[li * t.S + lj];
    }
  }
}

// mgp_store for a block: the tile's interior rows that lie in the block,
// back to the block's (nl x n) array by their block row.
static __device__ void mgp_store_block(float* __restrict__ A, const float* xr,
                                       const float* xb, const MgpTile& t,
                                       const MgpRows& blk) {
  for (int ti = threadIdx.y; ti < MGP_TILE; ti += blockDim.y) {
    const int li = t.G + ti, bi = t.gi0 + li - blk.r0;
    if (!mgp_in(bi, blk.nl)) continue;
    for (int tj = threadIdx.x; tj < MGP_TILE; tj += blockDim.x) {
      const int lj = t.G + tj, gj = t.gj0 + lj;
      if (!mgp_in(gj, t.w)) continue;
      const size_t g = (size_t)bi * t.n + gj;
      A[g] = xr[li * t.S + lj];
      A[g + t.w] = xb[li * t.S + lj];
    }
  }
}
