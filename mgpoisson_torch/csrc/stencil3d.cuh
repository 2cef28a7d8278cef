// The cube tile of the 3D stencil kernels: K4 mg_smooth3d, and the legs
// K5 mg_smooth_rr3d and K6 mg_prolong_correct_smooth3d with their strip
// entries K11 mg_sharded_rr3d and K12 mg_sharded_pc3d at halos above 4
// (MG3Z_MAX_HALO: K5/K11 and K6/K12 with rnorm at jacobi/wjacobi nu >= 4 or
// rbgs nu >= 2, K6/K12 without at nu >= 5 or rbgs nu >= 3).  At halos up
// to 4, the main path's, the legs run the z-marching tile of
// stencil3d_zm.cuh, which takes the enums, MG3_OMEGA, Mg3Block, Mg3Strips,
// mg3_fetch and mg3_sum8 from here.  The 7-point operator on an (n, n, n)
// array, z-major (index (z * n + y) * n + x).
//
// The Pallas 3D kernels block (z, y) with the whole x row in lanes, round
// the y halo up to 8 sublanes and pick the blocks with a VMEM planner
// (_plan3d).  None of that carries over.  Each block owns a T x T x T
// interior and loads it with a halo of H cells on every side into shared
// memory (the deep-halo trapezoid the 2D register tile of stencil.cuh
// also runs, there per warp and in registers); all nu sweeps run
// there over a region that shrinks by the dependency radius each step, so
// the interior is exact after the last sweep and any power-of-two n runs
// the same code.  H = steps for a smooth, steps + 1 where a residual
// follows; steps = nu (Jacobi variants) or 2 nu (red-black GS).
//
// Shared memory: two ping-pong u buffers and f, (T + 2H)^3 floats each.
// T = 16 while H <= 4 (the tuned scheme's wjacobi nu = 3 with a residual:
// 24^3 x 4 B x 3 = 166 KB), T = 8 for deeper halos up to H = 8 (also 24^3);
// the wrapper picks T and the entry points opt in to more than 48 KB of
// dynamic shared memory.  The price of the deep halo is redundant work:
// at T = 16, H = 4 a block loads (24/16)^3 = 3.4 cells per interior cell
// and its three sweeps update 22^3 + 20^3 + 18^3 = 24480 cells for 4096
// interior ones (2.0 per interior cell per sweep).  The z-marching (2.5D)
// tile of stencil3d_zm.cuh cuts both for the legs at halos up to 4.
//
// What bounds these kernels on an H100 is HBM bytes: each op passes over
// device memory once (K4 3 arrays, K5 3.125, 2.125 from zero, K6 3.125);
// the halo re-reads mostly hit L2.  This first version keeps one thread
// per cell with __syncthreads() between steps.
//
// Arithmetic: as the z-marching tile and stencil.cuh, every add and
// multiply rounded on its own (__fadd_rn, __fmul_rn; nvcc would otherwise
// contract pairs of them into FMAs) in the order of
// mgpoisson_torch/kernels/ops.py: neighbour sums in axis order z, y, x
// with face's subtractions after each axis pair, the Jacobi form,
// wjacobi's u + omega (jac - u), the residual f - (nbr/h^2 + adiag u),
// prolong's 2^3 taps and the restriction's 2x2x2 sum in torch's order
// (mg3_sum8), so every output equals the plain ops bit for bit.  The
// divisions by h^2 and by the diagonal are multiplications by their
// reciprocals (exact for 1/h^2 with h = 1/size; 1/adiag = -h^2/6 is the
// rounded reciprocal that torch's CUDA division by a scalar also
// multiplies by).
//
// As in 2D (stencil.cuh), a launch covers one block of the grid
// (Mg3Block): the whole grid for K4 (and K5/K6 at deep halos), a rank's
// (nzl, nyl, n) block for K11/K12, whose mesh cuts axes z and y and keeps x
// whole.  The global index
// decides inside/outside, the edges, the colour and the trilinear weights;
// the block index addresses the arrays, and a strip-fed launch reads its
// halo from the neighbours' strips (Mg3Strips).
//
// The bf16 forms of K4-K6 run both tiles on bf16 arrays, as the 2D
// register tile does (stencil.cuh, Mg2Elem): the element type T of the
// loads, the stores and the arithmetic below, the values in f32 (the
// cube tile's shared memory, the z-marching tile's registers and planes
// stay f32: every value is bf16 already, so no byte budget changes), a
// round to bf16 (Mg3Elem<T>::rd, nothing for f32) after every add and
// multiply as plain torch rounds each op of a bf16 tensor, and the
// damped-Jacobi weight 6/7 rounded to bf16 (0.85546875) as
// ops._omega(3, torch.bfloat16) and the JAX package's weak-typed scalar
// round it.  The up-leg's trilinear blend runs in f32 and is rounded once
// (ops._up_leg_correct; the Pallas blend), the restriction's eight values
// are summed in f32 (mg3_sum8) and rounded once, as torch's sum of a bf16
// tensor, and sum(r^2) squares the bf16 residual in f32.  The strip
// entries K11/K12 are f32 only; the f32 instances are those of the
// f32-only tiles, instruction for instruction.
#pragma once

#include "stencil.cuh"

#define MG3_THREADS 1024
#define MG3_SMEM_MAX 232448   // the most dynamic shared memory a block may opt in to
#define MG3_OMEGA (6.0f / 7.0f)   // wjacobi omega = 2d/(2d+1), d = 3, as ops.wjacobi_sweep

// Per element type, Mg2Elem's loads, `cvt` and `rd` with the 3D
// damped-Jacobi weight: 6/7 in f32, and rounded to bf16 as
// ops._omega(3, torch.bfloat16) rounds it.
template <class T>
struct Mg3Elem;

template <>
struct Mg3Elem<float> : Mg2Elem<float> {
  static constexpr float omega = MG3_OMEGA;
};

template <>
struct Mg3Elem<__nv_bfloat16> : Mg2Elem<__nv_bfloat16> {
  static constexpr float omega = 0.85546875f;   // 6/7 rounded to bf16 (0x3f5b)
};

// The grid's side n, the block's extents in z and y (x is whole: n) and
// the global index (z0, y0) of its first cell; {n, n, n, 0, 0} is the grid.
struct Mg3Block {
  int n, nzl, nyl, z0, y0;
};

// A block's halo strips, D deep: top and bot (D, nyl, n), the z planes
// before and after it; left and right (nzl + 2D, D, n), the y slabs of the
// z-extended block, so they carry the edges.  left/right are null on a
// mesh of one column; all four are null for u identically zero.  The
// neighbours' exchange fills zeros outside the grid.
struct Mg3Strips {
  const float* top;
  const float* bot;
  const float* left;
  const float* right;
  int D;
};

struct Mg3Tile {
  int n;         // grid side
  int nzl, nyl;  // block extents in z and y
  int T;         // interior cells per block side (even)
  int H;         // halo depth
  int S;         // T + 2H
  int gz0;       // global z of local z 0 (tile origin - H; may be negative)
  int gy0;
  int gx0;
  int lz0;       // block z of local z 0 (gz0 - z0)
  int ly0;
};

static __device__ __forceinline__ Mg3Tile mg3_tile(const Mg3Block& b, int T, int H) {
  Mg3Tile t;
  t.n = b.n;
  t.nzl = b.nzl;
  t.nyl = b.nyl;
  t.T = T;
  t.H = H;
  t.S = T + 2 * H;
  t.lz0 = (int)blockIdx.z * T - H;
  t.ly0 = (int)blockIdx.y * T - H;
  t.gz0 = b.z0 + t.lz0;
  t.gy0 = b.y0 + t.ly0;
  t.gx0 = (int)blockIdx.x * T - H;
  return t;
}

static __device__ __forceinline__ Mg3Tile mg3_tile(int n, int T, int H) {
  return mg3_tile(Mg3Block{n, n, n, 0, 0}, T, H);
}

static __device__ __forceinline__ bool mg3_in(const Mg3Tile& t, int i, int j, int l) {
  return mg_in(t.gz0 + i, t.n) && mg_in(t.gy0 + j, t.n) && mg_in(t.gx0 + l, t.n);
}

// Whether local tile cell (i, j, l) is in the block (stored and counted).
static __device__ __forceinline__ bool mg3_owned(const Mg3Tile& t, int i, int j, int l) {
  return mg_in(t.lz0 + i, t.nzl) && mg_in(t.ly0 + j, t.nyl) && mg_in(t.gx0 + l, t.n);
}

// Block cell (lz, ly, x) of an array fed by strips (as mg_fetch in 2D);
// the caller has checked that the cell lies in the grid, and a cell beyond
// the strips gives 0.
static __device__ __forceinline__ float mg3_fetch(const float* body, const Mg3Strips& s,
                                                  int lz, int ly, int x, int nzl, int nyl,
                                                  int nx) {
  const int D = s.D;
  if (ly >= 0 && ly < nyl) {
    if (lz >= 0 && lz < nzl) return body[((size_t)lz * nyl + ly) * nx + x];
    if (lz < 0 && lz >= -D) return s.top[((size_t)(lz + D) * nyl + ly) * nx + x];
    if (lz >= nzl && lz < nzl + D) return s.bot[((size_t)(lz - nzl) * nyl + ly) * nx + x];
    return 0.f;
  }
  if (lz < -D || lz >= nzl + D || s.left == nullptr) return 0.f;
  if (ly < 0 && ly >= -D) return s.left[((size_t)(lz + D) * D + (ly + D)) * nx + x];
  if (ly >= nyl && ly < nyl + D) return s.right[((size_t)(lz + D) * D + (ly - nyl)) * nx + x];
  return 0.f;
}

// Neighbour sum of local cell (i, j, l) = (z, y, x), in ops.neighbor_sum's
// order.  A neighbour across the global edge is 0 (ghost0) or -u of the
// cell itself as it is in this sweep (face), decided from the global
// index, never from the tile's.  Each op's result rounded to T (rd),
// here and below.
template <class T = float>
static __device__ __forceinline__ float mg3_nbr(const float* s, const Mg3Tile& t, int i,
                                                int j, int l, int bc) {
  using E = Mg3Elem<T>;
  const int S = t.S, SS = S * S, k = (i * S + j) * S + l, last = t.n - 1;
  const int gz = t.gz0 + i, gy = t.gy0 + j, gx = t.gx0 + l;
  const float c = s[k];
  float acc = E::rd(__fadd_rn(gz > 0 ? s[k - SS] : 0.f, gz < last ? s[k + SS] : 0.f));
  if (bc == MG_FACE) {
    if (gz == 0) acc = E::rd(__fsub_rn(acc, c));
    if (gz == last) acc = E::rd(__fsub_rn(acc, c));
  }
  acc = E::rd(__fadd_rn(
      acc, E::rd(__fadd_rn(gy > 0 ? s[k - S] : 0.f, gy < last ? s[k + S] : 0.f))));
  if (bc == MG_FACE) {
    if (gy == 0) acc = E::rd(__fsub_rn(acc, c));
    if (gy == last) acc = E::rd(__fsub_rn(acc, c));
  }
  acc = E::rd(__fadd_rn(
      acc, E::rd(__fadd_rn(gx > 0 ? s[k - 1] : 0.f, gx < last ? s[k + 1] : 0.f))));
  if (bc == MG_FACE) {
    if (gx == 0) acc = E::rd(__fsub_rn(acc, c));
    if (gx == last) acc = E::rd(__fsub_rn(acc, c));
  }
  return acc;
}

// r = f - (nbr/h^2 + adiag*u) at local (i, j, l), as ops.residual.
template <class T = float>
static __device__ __forceinline__ float mg3_residual(const float* su, const float* sf,
                                                     const Mg3Tile& t, int i, int j, int l,
                                                     int bc, float inv_hsq, float adiag) {
  using E = Mg3Elem<T>;
  const int k = (i * t.S + j) * t.S + l;
  return E::rd(__fsub_rn(
      sf[k], E::rd(__fadd_rn(E::rd(__fmul_rn(mg3_nbr<T>(su, t, i, j, l, bc), inv_hsq)),
                             E::rd(__fmul_rn(adiag, su[k]))))));
}

// The Jacobi value (f - nbr/h^2) / adiag at local (i, j, l), tile index c,
// as ops.jacobi_sweep.
template <class T = float>
static __device__ __forceinline__ float mg3_jacobi(const float* su, const float* sf,
                                                   const Mg3Tile& t, int i, int j, int l,
                                                   int c, int bc, float inv_hsq,
                                                   float inv_adiag) {
  using E = Mg3Elem<T>;
  return E::rd(__fmul_rn(
      E::rd(__fsub_rn(sf[c], E::rd(__fmul_rn(mg3_nbr<T>(su, t, i, j, l, bc), inv_hsq)))),
      inv_adiag));
}

// The 2x2x2 sum of the restriction, r[(dz << 2) | (dy << 1) | dx], in the
// order torch's reduction of ops.restrict takes on the card: z pairs, then
// y, then x ((r000 + r100) + (r010 + r110)) + ((r001 + r101) + (r011 + r111)).
// In bf16 the caller rounds this f32 sum once, as torch's sum of a bf16
// tensor accumulates in f32.
static __device__ __forceinline__ float mg3_sum8(const float (&r)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[4]), __fadd_rn(r[2], r[6])),
                   __fadd_rn(__fadd_rn(r[1], r[5]), __fadd_rn(r[3], r[7])));
}

// Loads the S^3 tile of u and f; cells outside the domain read 0.
// U == nullptr means u is identically zero and is not read.
template <class T>
static __device__ void mg3_load(float* su, float* sf, const T* U, const T* F,
                                const Mg3Tile& t) {
  const int S = t.S;
  for (int k = threadIdx.x; k < S * S * S; k += blockDim.x) {
    const int l = k % S, r = k / S, j = r % S, i = r / S;
    float u = 0.f, f = 0.f;
    if (mg3_in(t, i, j, l)) {
      const size_t g = ((size_t)(t.gz0 + i) * t.n + (t.gy0 + j)) * t.n + (t.gx0 + l);
      f = Mg3Elem<T>::ld(F + g);
      if (U) u = Mg3Elem<T>::ld(U + g);
    }
    su[k] = u;
    sf[k] = f;
  }
}

// mg3_load for a block fed by strips: each tile cell from the body or a
// strip, by its block index; cells outside the grid read 0.  U == nullptr
// means u is identically zero and is not read.
static __device__ void mg3_load_strips(float* su, float* sf, const float* U, const float* F,
                                       const Mg3Strips& us, const Mg3Strips& fs,
                                       const Mg3Tile& t) {
  const int S = t.S;
  for (int k = threadIdx.x; k < S * S * S; k += blockDim.x) {
    const int l = k % S, r = k / S, j = r % S, i = r / S;
    float u = 0.f, f = 0.f;
    if (mg3_in(t, i, j, l)) {
      const int lz = t.lz0 + i, ly = t.ly0 + j, x = t.gx0 + l;
      f = mg3_fetch(F, fs, lz, ly, x, t.nzl, t.nyl, t.n);
      if (U) u = mg3_fetch(U, us, lz, ly, x, t.nzl, t.nyl, t.n);
    }
    su[k] = u;
    sf[k] = f;
  }
}

// nu sweeps on the tile in shared memory; returns the buffer holding the
// result.  Step s updates local cells [s+1, S-2-s] on all three axes, so
// after all steps the cells at distance >= steps from the tile edge are
// exact.  Jacobi variants ping-pong between a and b; red-black GS updates
// one colour in place per step, the colour being the GLOBAL (z + y + x) % 2,
// colour 0 first.
template <class T = float>
static __device__ float* mg3_sweeps(float* a, float* b, const float* sf, const Mg3Tile& t,
                                    int nu, int smoother, int bc, float inv_hsq,
                                    float inv_adiag) {
  using E = Mg3Elem<T>;
  const int S = t.S, steps = mg_steps(nu, smoother);
  for (int s = 0; s < steps; ++s) {
    const int lo = s + 1, w = S - 2 - 2 * s, colour = s & 1;
    for (int k = threadIdx.x; k < w * w * w; k += blockDim.x) {
      const int l = lo + k % w, r = k / w, j = lo + r % w, i = lo + r / w;
      if (!mg3_in(t, i, j, l)) continue;
      const int c = (i * S + j) * S + l;
      if (smoother == MG_RBGS) {
        if (((t.gz0 + i + t.gy0 + j + t.gx0 + l) & 1) != colour) continue;
        a[c] = mg3_jacobi<T>(a, sf, t, i, j, l, c, bc, inv_hsq, inv_adiag);
      } else {
        const float jac = mg3_jacobi<T>(a, sf, t, i, j, l, c, bc, inv_hsq, inv_adiag);
        b[c] = smoother == MG_WJACOBI
                   ? E::rd(__fadd_rn(a[c], E::rd(__fmul_rn(E::omega,
                                                           E::rd(__fsub_rn(jac, a[c]))))))
                   : jac;
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

// Writes the tile's interior back to the block's (nzl, nyl, n) array.
template <class T>
static __device__ void mg3_store(T* U, const float* su, const Mg3Tile& t) {
  const int side = t.T;
  for (int k = threadIdx.x; k < side * side * side; k += blockDim.x) {
    const int l = t.H + k % side, r = k / side, j = t.H + r % side, i = t.H + r / side;
    if (!mg3_owned(t, i, j, l)) continue;
    U[((size_t)(t.lz0 + i) * t.nyl + (t.ly0 + j)) * t.n + (t.gx0 + l)] =
        Mg3Elem<T>::cvt(su[(i * t.S + j) * t.S + l]);
  }
}

static __host__ inline size_t mg3_tile_floats(int T, int H) {
  const size_t S = T + 2 * H;
  return 3 * S * S * S;
}

static __host__ inline dim3 mg3_grid(const Mg3Block& b, int T) {
  const auto tiles = [T](int m) { return (unsigned)((m + T - 1) / T); };
  return dim3(tiles(b.n), tiles(b.nyl), tiles(b.nzl));
}

// Checks the geometry (even block extents and origin, at least 2 cells)
// and opts the kernel in to `bytes` of dynamic shared memory; returns a
// cudaError_t.
static __host__ inline int mg3_prepare(const void* kernel, const Mg3Block& b, int T,
                                       size_t bytes) {
  if (b.n < 2 || b.nzl < 2 || b.nyl < 2 || (b.nzl | b.nyl | b.z0 | b.y0) & 1 || T < 2 ||
      (T & 1) || bytes > MG3_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}
