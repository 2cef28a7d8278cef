// Shared tile machinery of the 2D stencil kernels (K1 mg_smooth, K2
// mg_smooth_rr, K3 mg_prolong_correct_smooth, and the strip-fed K9
// mg_sharded_rr and K10 mg_sharded_pc of a sharded level).
//
// One 2D-tiled geometry replaces the Pallas kernels' three (row stripes,
// whole-array VMEM, two-axis blocks), which exist only because of the TPU's
// VMEM.  Each block owns a MG_TILE x MG_TILE interior and loads it with a
// halo of H cells on every side into shared memory, the "deep-halo
// trapezoid" of docs/KERNELS.md: all nu sweeps run there over a region that
// shrinks by the dependency radius each step (1 for a Jacobi sweep, 1 for
// each colour half-sweep of red-black GS), so the interior is exact after
// the last sweep.  H = steps for a smooth, steps + 1 where a residual reads
// one more ring.  Only the interior is written back.
//
// What bounds these kernels on an H100 is HBM bytes: each op passes over
// device memory once (K1 3 arrays, K2 3.25, 2.25 from zero, K3 3.25); the
// halo re-reads mostly hit L2.  This first version keeps one thread per
// cell with __syncthreads() between sweeps; cp.async/TMA staging and
// tuning of MG_TILE come later.
//
// Arithmetic follows mgpoisson_torch/kernels/ops.py operation for
// operation (same neighbour-sum order, same Jacobi form), with the two
// divisions by h^2 and by the diagonal taken as multiplications by their
// reciprocals, which are exact for the power-of-two spacings h = 1/size.
//
// A launch covers one block of the grid (MgBlock): the whole grid for
// K1-K3, a rank's block for K9/K10.  Two index spaces follow from it: the
// GLOBAL index decides everything the grid decides (inside or outside, the
// face and zero-ghost edges, the red/black colour, the bilinear edge
// weights); the BLOCK index addresses the block's arrays and the store.  A
// strip-fed launch reads its halo from the neighbours' pre-exchanged strips
// (MgStrips, the layout of kernels/ops.py) instead of from the array, so
// no extended block is ever assembled in device memory.
#pragma once

#include <cuda_runtime.h>

#define MG_TILE 32      // even: 2x2 restriction cells and bilinear parities stay tile-local
#define MG_THREADS 256
#define MG_SMEM_LIMIT (48 * 1024)   // static-launch shared-memory limit, no opt-in

enum { MG_JACOBI = 0, MG_WJACOBI = 1, MG_RBGS = 2 };
enum { MG_GHOST0 = 0, MG_FACE = 1 };
enum { MG_INJECT = 0, MG_BILINEAR = 1 };

// Shrinking-region steps of nu sweeps: red-black GS updates one colour per
// step, and each colour half-sweep widens the dependency by one cell.
static __host__ __device__ inline int mg_steps(int nu, int smoother) {
  return smoother == MG_RBGS ? 2 * nu : nu;
}

static __host__ inline int mg_tiles(int n) { return (n + MG_TILE - 1) / MG_TILE; }

// Two ping-pong u buffers and f.
static __host__ inline size_t mg_tile_floats(int H) {
  const size_t S = MG_TILE + 2 * H;
  return 3 * S * S;
}

// The grid's side n, the block's extents (nl rows, ml columns) and the
// global index (r0, c0) of its first cell; {n, n, n, 0, 0} is the grid.
struct MgBlock {
  int n, nl, ml, r0, c0;
};

// A block's halo strips, D deep: top and bot (D, ml), the rows above and
// below; left and right (nl + 2D, D), row-extended so they carry the
// corners.  left/right are null on a mesh of one column (only the grid's
// edge lies beside the block); all four are null for u identically zero.
// The neighbours' exchange fills zeros outside the grid.
struct MgStrips {
  const float* top;
  const float* bot;
  const float* left;
  const float* right;
  int D;
};

struct MgTile {
  int n;       // grid side
  int nl, ml;  // block extents
  int H;       // halo depth
  int S;       // MG_TILE + 2H
  int gi0;     // global row of local row 0 (tile origin - H; may be negative)
  int gj0;     // global column of local column 0
  int li0;     // block row of local row 0 (gi0 - r0)
  int lj0;     // block column of local column 0
};

static __device__ __forceinline__ MgTile mg_tile(const MgBlock& b, int H) {
  MgTile t;
  t.n = b.n;
  t.nl = b.nl;
  t.ml = b.ml;
  t.H = H;
  t.S = MG_TILE + 2 * H;
  t.li0 = (int)blockIdx.y * MG_TILE - H;
  t.lj0 = (int)blockIdx.x * MG_TILE - H;
  t.gi0 = b.r0 + t.li0;
  t.gj0 = b.c0 + t.lj0;
  return t;
}

static __device__ __forceinline__ MgTile mg_tile(int n, int H) {
  return mg_tile(MgBlock{n, n, n, 0, 0}, H);
}

static __device__ __forceinline__ bool mg_in(int g, int n) {
  return (unsigned)g < (unsigned)n;
}

// Neighbour sum of local cell (i, j), in ops.neighbor_sum's order.  Cells
// outside the domain are not data: a neighbour across the global edge is 0
// (ghost0) or -u of the cell itself as it is in this sweep (face), decided
// from the global index, never from the tile's.
static __device__ __forceinline__ float mg_nbr(const float* s, const MgTile& t,
                                               int i, int j, int bc) {
  const int S = t.S, gi = t.gi0 + i, gj = t.gj0 + j;
  const float c = s[i * S + j];
  const float up = gi > 0 ? s[(i - 1) * S + j] : 0.f;
  const float dn = gi < t.n - 1 ? s[(i + 1) * S + j] : 0.f;
  float acc = up + dn;
  if (bc == MG_FACE) {
    if (gi == 0) acc -= c;
    if (gi == t.n - 1) acc -= c;
  }
  const float lf = gj > 0 ? s[i * S + j - 1] : 0.f;
  const float rt = gj < t.n - 1 ? s[i * S + j + 1] : 0.f;
  acc = acc + (lf + rt);
  if (bc == MG_FACE) {
    if (gj == 0) acc -= c;
    if (gj == t.n - 1) acc -= c;
  }
  return acc;
}

// r = f - (nbr/h^2 + adiag*u) at local (i, j), as ops.residual.
static __device__ __forceinline__ float mg_residual(const float* su, const float* sf,
                                                    const MgTile& t, int i, int j, int bc,
                                                    float inv_hsq, float adiag) {
  const int k = i * t.S + j;
  return sf[k] - (mg_nbr(su, t, i, j, bc) * inv_hsq + adiag * su[k]);
}

// Loads the (S x S) tile of u and f; cells outside the domain read 0.
// U == nullptr means u is identically zero and is not read.
static __device__ void mg_load(float* su, float* sf, const float* U, const float* F,
                               const MgTile& t) {
  for (int k = threadIdx.x; k < t.S * t.S; k += blockDim.x) {
    const int gi = t.gi0 + k / t.S, gj = t.gj0 + k % t.S;
    float u = 0.f, f = 0.f;
    if (mg_in(gi, t.n) && mg_in(gj, t.n)) {
      const size_t g = (size_t)gi * t.n + gj;
      f = F[g];
      if (U) u = U[g];
    }
    su[k] = u;
    sf[k] = f;
  }
}

// Block cell (li, lj) of an array fed by strips: the body, or the strip
// that holds it.  The caller has checked that the cell lies in the grid.
// A cell beyond the strips gives 0; only the halo of a tile that overhangs
// a block smaller than the tile reads one, and with D >= H the sweeps'
// shrinking exact region never lets it reach the block or the ring a
// residual reads.
static __device__ __forceinline__ float mg_fetch(const float* body, const MgStrips& s,
                                                 int li, int lj, int nl, int ml) {
  const int D = s.D;
  if (lj >= 0 && lj < ml) {
    if (li >= 0 && li < nl) return body[(size_t)li * ml + lj];
    if (li < 0 && li >= -D) return s.top[(size_t)(li + D) * ml + lj];
    if (li >= nl && li < nl + D) return s.bot[(size_t)(li - nl) * ml + lj];
    return 0.f;
  }
  if (li < -D || li >= nl + D || s.left == nullptr) return 0.f;
  if (lj < 0 && lj >= -D) return s.left[(size_t)(li + D) * D + (lj + D)];
  if (lj >= ml && lj < ml + D) return s.right[(size_t)(li + D) * D + (lj - ml)];
  return 0.f;
}

// mg_load for a block fed by strips: each tile cell from the body or a
// strip, by its block index; cells outside the grid read 0.  U == nullptr
// means u is identically zero and is not read.
static __device__ void mg_load_strips(float* su, float* sf, const float* U, const float* F,
                                      const MgStrips& us, const MgStrips& fs,
                                      const MgTile& t) {
  for (int k = threadIdx.x; k < t.S * t.S; k += blockDim.x) {
    const int i = k / t.S, j = k % t.S;
    float u = 0.f, f = 0.f;
    if (mg_in(t.gi0 + i, t.n) && mg_in(t.gj0 + j, t.n)) {
      f = mg_fetch(F, fs, t.li0 + i, t.lj0 + j, t.nl, t.ml);
      if (U) u = mg_fetch(U, us, t.li0 + i, t.lj0 + j, t.nl, t.ml);
    }
    su[k] = u;
    sf[k] = f;
  }
}

// Whether local tile cell (i, j) is in the block (where it is stored and
// counted).
static __device__ __forceinline__ bool mg_owned(const MgTile& t, int i, int j) {
  return mg_in(t.li0 + i, t.nl) && mg_in(t.lj0 + j, t.ml);
}

// nu sweeps on the tile in shared memory; returns the buffer holding the
// result.  Step s updates local cells [s+1, S-2-s] on both axes, so after
// all steps the cells at distance >= steps from the tile edge are exact.
// Jacobi variants ping-pong between a and b; red-black GS updates one
// colour in place per step, the colour being the GLOBAL (i + j) % 2.
static __device__ float* mg_sweeps(float* a, float* b, const float* sf, const MgTile& t,
                                   int nu, int smoother, int bc, float inv_hsq,
                                   float inv_adiag) {
  const int S = t.S, steps = mg_steps(nu, smoother);
  for (int s = 0; s < steps; ++s) {
    const int lo = s + 1, w = S - 2 - 2 * s, colour = s & 1;
    for (int k = threadIdx.x; k < w * w; k += blockDim.x) {
      const int i = lo + k / w, j = lo + k % w;
      const int gi = t.gi0 + i, gj = t.gj0 + j;
      if (!mg_in(gi, t.n) || !mg_in(gj, t.n)) continue;
      const int c = i * S + j;
      if (smoother == MG_RBGS) {
        if (((gi + gj) & 1) != colour) continue;
        a[c] = (sf[c] - mg_nbr(a, t, i, j, bc) * inv_hsq) * inv_adiag;
      } else {
        const float jac = (sf[c] - mg_nbr(a, t, i, j, bc) * inv_hsq) * inv_adiag;
        // omega = 2d/(2d+1) = 0.8 in 2D, as ops.wjacobi_sweep
        b[c] = smoother == MG_WJACOBI ? a[c] + 0.8f * (jac - a[c]) : jac;
      }
    }
    __syncthreads();
    if (smoother != MG_RBGS) {
      float* tmp = a;
      a = b;
      b = tmp;
    }
  }
  return a;
}

// Writes the tile's interior back to the (n x n) array.
static __device__ void mg_store(float* U, const float* su, const MgTile& t) {
  for (int k = threadIdx.x; k < MG_TILE * MG_TILE; k += blockDim.x) {
    const int i = t.H + k / MG_TILE, j = t.H + k % MG_TILE;
    const int gi = t.gi0 + i, gj = t.gj0 + j;
    if (mg_in(gi, t.n) && mg_in(gj, t.n)) U[(size_t)gi * t.n + gj] = su[i * t.S + j];
  }
}

// mg_store for a rank's block: the tile's interior back to the block's
// (nl x ml) array, by the block index.
static __device__ void mg_store_block(float* U, const float* su, const MgTile& t) {
  for (int k = threadIdx.x; k < MG_TILE * MG_TILE; k += blockDim.x) {
    const int i = t.H + k / MG_TILE, j = t.H + k % MG_TILE;
    if (mg_owned(t, i, j)) U[(size_t)(t.li0 + i) * t.ml + (t.lj0 + j)] = su[i * t.S + j];
  }
}
