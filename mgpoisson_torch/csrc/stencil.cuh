// Shared tile machinery of the 2D stencil kernels (K1 mg_smooth, K2
// mg_smooth_rr, K3 mg_prolong_correct_smooth, and the strip-fed K9
// mg_sharded_rr and K10 mg_sharded_pc of a sharded level).  The 3D tile
// (stencil3d.cuh) takes the enums, mg_steps and mg_in from here; the
// packed legs K7/K8 and K13/K14 run this tile on packed state
// (stencil_packed.cuh).
//
// One 2D-tiled geometry replaces the Pallas kernels' three (row stripes,
// whole-array VMEM, two-axis blocks), which exist only because of the TPU's
// VMEM.  Each WARP owns an interior of TR rows x W columns and loads it
// with a halo of Hr cells on every side, the "deep-halo trapezoid" of
// docs/KERNELS.md: all nu sweeps run there, and a cell at distance >= s
// from the loaded region's edge is exact after s steps (1 per Jacobi
// sweep, 1 per red-black colour half-sweep), so the interior is exact
// after the last step.  H = steps for a smooth, steps + 1 where a residual
// reads one more ring (K2, K3 with or without rnorm); Hr is H rounded up
// to even, so every tile origin is even and 2x2 restriction cells, the
// red/black colour and the bilinear parities are fixed per register.
//
// The warp's region lives in REGISTERS, not in shared memory: lane L holds
// the two columns 2L and 2L + 1 of the 64 loaded ones (one even and one
// odd global column) for all R loaded rows, u and f, as four arrays of R
// floats indexed only by unrolled loop counters.  A sweep walks the rows
// top to bottom keeping the old value of the row above; up and down are
// registers of the same lane, the neighbour across the pair comes from
// the lane beside it (__shfl_up/down_sync), one shuffle per cell.  Every
// step updates rows 1 .. R-2 and every lane; the outermost loaded rows and
// lanes only turn inexact, as the shrinking region of the trapezoid says,
// and no loop tests a bound.  Red-black GS updates one cell of each pair
// per colour step (the colour of (i, 2L) is i % 2), so no lane idles.  No
// shared memory, no __syncthreads() except for the rnorm partial.
//
// Geometry: W = 64 - 2Hr columns, TR = R - 2Hr rows per warp, MG2_WARPS
// warps stacked in row bands per block; R is 24 at Hr <= 4 (the tuned
// scheme, the fast scheme's coarse levels), 16 there on levels too small
// to fill the card, and 40 at the deeper halos (mg2_rows, the tile table,
// mirrored by kernels/cuda.py tile2d, which sizes the rnorm partials).
// The table was tuned on the H100 with bench/ab.py: at Hr = 4, R = 24 beat
// 32 and 40 by 5-45 % (a 24-row tile holds fewer registers, so more warps
// hide each other's latency), though it loads 64 x 24 cells for 56 x 16 it
// owns (1.71x, mostly from L2) and each sweep updates 1.57x the cells.
//
// A warp whose loaded region lies 2 or more cells inside the block (for
// K1-K3 the grid) runs a body with no bound, edge or face test: every load
// comes from the block's array, no cell lies on the grid's edge and every
// bilinear coarse tap exists.  Any other warp runs the checked body: cells
// outside the grid hold 0 and are never updated (zero ghosts), face
// subtracts u on the grid's edge lines, a strip-fed launch picks body or
// strip once per row of a lane's pair.  The choice is uniform per warp.
//
// The least time on an H100 is set by HBM bytes: each op passes over
// device memory once (K1 3 arrays, K2 3.25, 2.25 from zero, K3 3.25).
// What the warps spend beyond it is issue and latency (about ten
// instructions and one shuffle per cell and sweep, with 1.6x the cells of
// the interior), so the legs with the most work per byte, from zero and
// with rnorm, sit furthest below the bound.  Loads and stores are 8-byte
// (one float2 per lane and row, coalesced in 256-byte rows); the operands
// a float2 touches must be 8-byte aligned (the C entries refuse others
// with cudaErrorMisalignedAddress).
//
// Arithmetic follows mgpoisson_torch/kernels/ops.py operation for
// operation (same neighbour-sum order, same Jacobi form, the same blend
// order of the bilinear prolongation), with the two divisions by h^2 and
// by the diagonal taken as multiplications by their reciprocals, which are
// exact for the power-of-two spacings h = 1/size.  Every add and multiply
// is rounded on its own (__fadd_rn, __fmul_rn), as the plain ops round
// them: no instance contracts a product into an FMA another one keeps.
//
// The bf16 forms of K1-K3 (and K9/K10) run the same tile on bf16 arrays
// (the element type T of Mg2ArgsOf; Mg2Regs<T, R> picks the registers): a
// lane's pair of columns of row i is ONE 32-bit register, a bf16x2 word
// (Mg2Word), so u and f take R registers each, and the arithmetic is
// Hopper's bf16x2 (Mg2X2): one instruction adds, subtracts or multiplies
// both cells and rounds each result once to nearest even.  That is what
// plain torch does on a bf16 tensor, which computes each op in f32 and
// rounds it to bf16 (for 8-bit significands the double rounding through
// f32 is harmless), so every output is bit-equal.  A product by a level
// constant is one bf16x2 multiply only where 1/h^2, 1/adiag and adiag are
// bf16 values (h = 1/2^k: every level at the default spacing 1/size); for
// any other h each half is multiplied in f32 by the f32 constant and
// rounded once, as torch multiplies by an f32 scalar (Mg2K).  The
// damped-Jacobi weight is 0.8 rounded to bf16 (ops._omega), a bf16 value.
// No two ops are fused: a product by h^-2 fused into the next add would
// not overflow where torch's product does (tests/test_torch_bf16x2.py).
// The neighbours across the pair come as one shuffle of the word from each
// side and two byte permutes: A = (x1 of lane L - 1, x0), B = (x1, x0 of
// lane L + 1), so lf + rt of both cells is one add.  In f32 stay the
// up-leg's bilinear blend, rounded once to a pair (as the plain op,
// ops._up_leg_correct, and the Pallas kernels blend), the restriction's
// sum of four, rounded once (as torch's sum), and sum(r^2) of the bf16
// residual.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum { MG_JACOBI = 0, MG_WJACOBI = 1, MG_RBGS = 2 };
enum { MG_GHOST0 = 0, MG_FACE = 1 };
enum { MG_INJECT = 0, MG_BILINEAR = 1 };

// Shrinking-region steps of nu sweeps: red-black GS updates one colour per
// step, and each colour half-sweep widens the dependency by one cell.
static __host__ __device__ inline int mg_steps(int nu, int smoother) {
  return smoother == MG_RBGS ? 2 * nu : nu;
}

static __device__ __forceinline__ bool mg_in(int g, int n) {
  return (unsigned)g < (unsigned)n;
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

// The same on bf16 arrays (the bf16 forms of K9/K10): a struct of its own,
// so MgStrips, and every f32 instance's kernel parameter, stay as they were.
struct MgStripsBf16 {
  const __nv_bfloat16* top;
  const __nv_bfloat16* bot;
  const __nv_bfloat16* left;
  const __nv_bfloat16* right;
  int D;
};

// The strips of element type T: MgStripsOf<float> is MgStrips.
template <class T>
struct MgStripsFor {
  using type = MgStrips;
};
template <>
struct MgStripsFor<__nv_bfloat16> {
  using type = MgStripsBf16;
};
template <class T>
using MgStripsOf = typename MgStripsFor<T>::type;

#define MG2_COLS 64             // loaded columns per warp: two per lane
#define MG2_WARPS 2             // warps per block, stacked in row bands
#define MG2_THREADS (32 * MG2_WARPS)
#define MG2_ROWS_SMALL 16       // loaded rows per warp at a shallow halo on a small level
#define MG2_ROWS_SHALLOW 24     // ... at an even halo <= MG2_SHALLOW_HALO
#define MG2_ROWS_DEEP 40        // ... at deeper halos
#define MG2_SHALLOW_HALO 4      // the tuned scheme's H = 4 and the fast scheme's coarse H = 3
#define MG2_FILL_WARPS 528      // 4 warps per SM of an H100 (132 SMs): below, small tiles
// Blocks per SM that a kernel of R loaded rows is compiled for: 6 caps a
// shallow tile at 168 registers (12 warps per SM; without the cap ptxas
// takes up to 208 and fits 8), 8 a small one at 128; the deep tile takes
// what it needs (255).
#define MG2_MIN_BLOCKS(R) ((R) == MG2_ROWS_SMALL ? 8 : (R) == MG2_ROWS_SHALLOW ? 6 : 1)
#define MG2_MAX_HALO 10         // even halo of rbgs nu = 4 and jacobi nu = 8 with a residual

// The halo rounded up to even, and the interior columns of a warp.
static __host__ __device__ inline int mg2_halo(int H) { return H + (H & 1); }
static __host__ __device__ inline int mg2_cols(int H) { return MG2_COLS - 2 * mg2_halo(H); }
static __host__ inline int mg2_ceil(int a, int b) { return (a + b - 1) / b; }

// The tile table: the loaded rows R of a warp at halo H on an (nl x ml)
// block.  A shallow halo takes the small tile where the shallow one would
// give the card fewer than MG2_FILL_WARPS warps: there each warp's chain
// of rows, not the bytes, sets the time, and more, shorter warps shorten it.
static __host__ inline int mg2_rows(int nl, int ml, int H) {
  const int hr = mg2_halo(H);
  if (hr > MG2_SHALLOW_HALO) return MG2_ROWS_DEEP;
  const int warps = mg2_ceil(ml, mg2_cols(H)) * mg2_ceil(nl, MG2_ROWS_SHALLOW - 2 * hr);
  return warps >= MG2_FILL_WARPS ? MG2_ROWS_SHALLOW : MG2_ROWS_SMALL;
}

// The launch's blocks on an (nl x ml) block at halo H, for warps of R
// loaded rows (by default the tile table's).
static __host__ inline dim3 mg2_grid_rows(int nl, int ml, int H, int R) {
  return dim3(mg2_ceil(ml, mg2_cols(H)), mg2_ceil(nl, MG2_WARPS * (R - 2 * mg2_halo(H))));
}

static __host__ inline dim3 mg2_grid(int nl, int ml, int H) {
  return mg2_grid_rows(nl, ml, H, mg2_rows(nl, ml, H));
}

// Whether every pointer is aligned for a lane's pair of T (null is): 8
// bytes for a float2, 4 for a __nv_bfloat162 (the body and the top/bottom
// strips of a strip-fed launch too: their pairs load as one).
template <class T = float, class... P>
static __host__ inline bool mg2_aligned(const P*... p) {
  return ((((uintptr_t)p & (2 * sizeof(T) - 1)) == 0) && ...);
}

// Everything a 2D leg kernel takes, its arrays and strips (K9/K10) of
// element type T.  V/vs and partials only for K3/K10, Rout for K2/K9;
// U == nullptr means u is identically zero (not read).
template <class T>
struct Mg2ArgsOf {
  const T* U;
  const T* F;
  const T* V;
  T* Uout;
  T* Rout;
  float* partials;
  MgBlock blk;
  MgStripsOf<T> us, fs, vs;
  int H, nu, bc, kind;
  float inv_hsq, inv_adiag, adiag;
};
struct Mg2Args : Mg2ArgsOf<float> {};
struct Mg2ArgsBf16 : Mg2ArgsOf<__nv_bfloat16> {};

// Per element type: the loads of one value (ldg through the read-only
// path; a lane's pair is loaded by its registers, Mg2Pair or Mg2Word),
// `cvt`, an f32 value as a T, `rd`, the round of an f32
// result to T that plain torch makes after each op (the packed and 3D
// tiles' bf16 forms), and `omega`, the 2D damped-Jacobi weight 0.8 rounded
// to T as ops.wjacobi_sweep (and the JAX package's weak-typed scalar)
// rounds it.
template <class T>
struct Mg2Elem;

template <>
struct Mg2Elem<float> {
  static constexpr float omega = 0.8f;
  static __device__ __forceinline__ float rd(float x) { return x; }
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float cvt(float v) { return v; }
};

template <>
struct Mg2Elem<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr float omega = 0.80078125f;   // 0.8f rounded to bf16 (0x3f4d)
  static __device__ __forceinline__ float rd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float ld(const T* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ float ldg(const T* p) { return __bfloat162float(__ldg(p)); }
  // the values are bf16 already (rounded by rd): the conversion is exact
  static __device__ __forceinline__ T cvt(float v) { return __float2bfloat16_rn(v); }
};

// One warp's place: the block and global index of its local (0, 0).
struct Mg2Tile {
  int n, nl, ml;  // grid side, block extents
  int hr;         // even halo
  int li0, lj0;   // block index of local (0, 0) (may be negative)
  int gi0, gj0;   // global index of local (0, 0)
  int lane;
};

// A lane's two columns (the even one x0, the odd one x1) of the warp's R
// rows, in registers (u and f).  A row's pair (Row), its loads (ldg
// through the read-only path), its store and a pair of two values (`row`).
template <int R>
struct Mg2Pair {
  using Row = float2;
  float x0[R], x1[R];
  __device__ __forceinline__ float2 at(int i) const { return make_float2(x0[i], x1[i]); }
  __device__ __forceinline__ void put(int i, float2 v) {
    x0[i] = v.x;
    x1[i] = v.y;
  }
  static __device__ __forceinline__ float2 ld(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ float2 ldg(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ void st(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
  static __device__ __forceinline__ float2 row(float lo, float hi) { return make_float2(lo, hi); }
};

// bf16x2 arithmetic on words.  Each op is one instruction with an explicit
// .rn, which keeps ptxas from contracting a multiply and an add into an
// fma (rounded once where torch rounds twice).  The products by the
// level's constants go through K (Mg2K).
struct Mg2X2 {
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  // (lo, hi), each rounded to bf16: one cvt.rn.bf16x2.f32
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
  }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  }
  // lf + rt of both cells of word x: A = (x1 of lane L - 1, x0) plus B =
  // (x1, x0 of lane L + 1)
  static __device__ __forceinline__ uint32_t lr(uint32_t x) {
    const uint32_t l = __shfl_up_sync(0xffffffffu, x, 1), r = __shfl_down_sync(0xffffffffu, x, 1);
    return add(__byte_perm(l, x, 0x5432), __byte_perm(x, r, 0x5432));
  }
  // mg2_nbr's neighbour sum of both cells of word c (up and dn the rows
  // above and below, lr their lf + rt) in ops.neighbor_sum's order; cm
  // the halves on the grid's first or last column (Mg2Cols)
  template <bool kEdge>
  static __device__ __forceinline__ uint32_t nbr(uint32_t c, uint32_t up, uint32_t dn,
                                                 uint32_t lr, bool face, bool row_lo,
                                                 bool row_hi, uint32_t cm) {
    uint32_t acc = add(up, dn);
    if (kEdge && face) {
      if (row_lo) acc = sub(acc, c);
      if (row_hi) acc = sub(acc, c);
    }
    acc = add(acc, lr);
    if (kEdge && face && cm) acc = (sub(acc, c) & cm) | (acc & ~cm);
    return acc;
  }
  // mg2_relax and mg2_resid on both cells
  template <int kSm, class K>
  static __device__ __forceinline__ uint32_t relax(uint32_t c, uint32_t f, uint32_t nbr,
                                                   const K& k) {
    const uint32_t jac = k.by_inv_adiag(sub(f, k.by_inv_hsq(nbr)));
    if (kSm == MG_WJACOBI) return add(c, mul(k.omega, sub(jac, c)));
    return jac;
  }
  template <class K>
  static __device__ __forceinline__ uint32_t resid(uint32_t c, uint32_t f, uint32_t nbr,
                                                   const K& k) {
    return sub(f, add(k.by_inv_hsq(nbr), k.by_adiag(c)));
  }
};

// The level's constants 1/h^2, 1/adiag and adiag (as kernels.cuda passes
// them, f32) for the products of the word arithmetic, and the damped-Jacobi
// weight, a bf16 value.  kExact: the three are bf16 values (h = 1/2^k:
// every level at the default spacing 1/size), so the f32 product of two
// bf16 values is exact and a product is one bf16x2 mul, rounded once as
// torch rounds it.  Otherwise (any other h) a word rounded from them would be
// another constant: each half is multiplied in f32 by the f32 constant
// and the pair rounded once, as torch rounds its f32 product (and as the
// f32 tile multiplies).
template <bool kExact>
struct Mg2K {
  float inv_hsq, inv_adiag, adiag;
  uint32_t w_inv_hsq, w_inv_adiag, w_adiag, omega;
  __device__ __forceinline__ Mg2K(float ih, float ia, float a)
      : inv_hsq(ih), inv_adiag(ia), adiag(a), w_inv_hsq(Mg2X2::pack(ih, ih)),
        w_inv_adiag(Mg2X2::pack(ia, ia)), w_adiag(Mg2X2::pack(a, a)),
        omega(Mg2X2::pack(Mg2Elem<__nv_bfloat16>::omega, Mg2Elem<__nv_bfloat16>::omega)) {}
  __device__ __forceinline__ uint32_t times(uint32_t x, uint32_t w, float k) const {
    if constexpr (kExact) return Mg2X2::mul(x, w);
    const float2 v = Mg2X2::unpack(x);
    return Mg2X2::pack(__fmul_rn(v.x, k), __fmul_rn(v.y, k));
  }
  __device__ __forceinline__ uint32_t by_inv_hsq(uint32_t x) const {
    return times(x, w_inv_hsq, inv_hsq);
  }
  __device__ __forceinline__ uint32_t by_inv_adiag(uint32_t x) const {
    return times(x, w_inv_adiag, inv_adiag);
  }
  __device__ __forceinline__ uint32_t by_adiag(uint32_t x) const {
    return times(x, w_adiag, adiag);
  }
};

// The same constants for the f32 tile's residual (mg2_resid2).
struct Mg2Kf {
  float inv_hsq, inv_adiag, adiag;
};

// The bf16 forms' registers: a lane's pair of row i as one bf16x2 word
// (the even column in the low half, as in memory), its loads, its store
// and a word of two f32 values that are bf16 values (`row`, exact).
template <int R>
struct Mg2Word {
  using Row = uint32_t;
  uint32_t w[R];
  __device__ __forceinline__ uint32_t at(int i) const { return w[i]; }
  __device__ __forceinline__ void put(int i, uint32_t v) { w[i] = v; }
  static __device__ __forceinline__ uint32_t ld(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint32_t ldg(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, uint32_t v) {
    *reinterpret_cast<uint32_t*>(p) = v;
  }
  static __device__ __forceinline__ uint32_t row(float lo, float hi) {
    return Mg2X2::pack(lo, hi);
  }
};

// The registers of a lane for element type T: Mg2Pair in f32, Mg2Word in bf16.
template <class T, int R>
struct Mg2RegsFor {
  using type = Mg2Pair<R>;
};
template <int R>
struct Mg2RegsFor<__nv_bfloat16, R> {
  using type = Mg2Word<R>;
};
template <class T, int R>
using Mg2Regs = typename Mg2RegsFor<T, R>::type;

// Calls fn with the level's constants as the registers' arithmetic takes
// them: Mg2Kf on the f32 tile; on words Mg2K<true> where 1/h^2, 1/adiag
// and adiag are bf16 values (a constant a caller does not use is passed
// as 0), else Mg2K<false>.  The test is uniform, and the word functions
// are instanced once for each answer.
template <int R, class Fn>
static __device__ __forceinline__ void mg2_with_k(const Mg2Pair<R>&, float inv_hsq,
                                                  float inv_adiag, float adiag, Fn fn) {
  fn(Mg2Kf{inv_hsq, inv_adiag, adiag});
}
template <int R, class Fn>
static __device__ __forceinline__ void mg2_with_k(const Mg2Word<R>&, float inv_hsq,
                                                  float inv_adiag, float adiag, Fn fn) {
  const float2 a = Mg2X2::unpack(Mg2X2::pack(inv_hsq, inv_adiag));
  const float b = Mg2X2::unpack(Mg2X2::pack(adiag, adiag)).x;
  if (a.x == inv_hsq && a.y == inv_adiag && b == adiag)
    fn(Mg2K<true>(inv_hsq, inv_adiag, adiag));
  else
    fn(Mg2K<false>(inv_hsq, inv_adiag, adiag));
}

template <int R>
static __device__ __forceinline__ Mg2Tile mg2_tile(const MgBlock& b, int H) {
  Mg2Tile t;
  t.n = b.n;
  t.nl = b.nl;
  t.ml = b.ml;
  t.hr = mg2_halo(H);
  t.li0 = ((int)blockIdx.y * MG2_WARPS + (int)threadIdx.y) * (R - 2 * t.hr) - t.hr;
  t.lj0 = (int)blockIdx.x * (MG2_COLS - 2 * t.hr) - t.hr;
  t.gi0 = b.r0 + t.li0;
  t.gj0 = b.c0 + t.lj0;
  t.lane = (int)threadIdx.x;
  return t;
}

// Whether the warp owns any cell of the block (the last block row may hold
// warps below the block).
static __device__ __forceinline__ bool mg2_owns(const Mg2Tile& t) {
  return t.li0 + t.hr < t.nl && t.lj0 + t.hr < t.ml;
}

// Whether the warp's loaded region lies 2 or more cells inside the block:
// the unchecked body's condition (see the head of this file).
template <int R>
static __device__ __forceinline__ bool mg2_inside(const Mg2Tile& t) {
  return t.li0 >= 2 && t.lj0 >= 2 && t.li0 + R <= t.nl - 2 && t.lj0 + MG2_COLS <= t.ml - 2;
}

static __device__ __forceinline__ float mg2_from_left(float x) {
  return __shfl_up_sync(0xffffffffu, x, 1);
}

static __device__ __forceinline__ float mg2_from_right(float x) {
  return __shfl_down_sync(0xffffffffu, x, 1);
}

// Block cell (li, lj) of an array of T fed by strips: the body, or the
// strip that holds it, as an f32 value.  The caller has checked that the
// cell lies in the grid.  A cell beyond the strips gives 0; only the halo
// of a tile that overhangs the strips reads one, and with D >= the sweeps'
// reach the shrinking exact region never lets it reach the block or the
// ring a residual reads.
template <class T>
static __device__ __forceinline__ float mg_fetch(const T* body, const MgStripsOf<T>& s,
                                                 int li, int lj, int nl, int ml) {
  using E = Mg2Elem<T>;
  const int D = s.D;
  if (lj >= 0 && lj < ml) {
    if (li >= 0 && li < nl) return E::ld(body + (size_t)li * ml + lj);
    if (li < 0 && li >= -D) return E::ld(s.top + (size_t)(li + D) * ml + lj);
    if (li >= nl && li < nl + D) return E::ld(s.bot + (size_t)(li - nl) * ml + lj);
    return 0.f;
  }
  if (li < -D || li >= nl + D || s.left == nullptr) return 0.f;
  if (lj < 0 && lj >= -D) return E::ld(s.left + (size_t)(li + D) * D + (lj + D));
  if (lj >= ml && lj < ml + D) return E::ld(s.right + (size_t)(li + D) * D + (lj - ml));
  return 0.f;
}

// Where a lane's two cells (li, lj), (li, lj + 1) of an array fed by
// strips lie, lj even and in the block's columns: the body or the
// top/bottom strip, picked once for the pair; null beyond the strips.
template <class T>
static __device__ __forceinline__ const T* mg2_pair_at(const T* body, const MgStripsOf<T>& s,
                                                       int li, int lj, int nl, int ml) {
  if (li >= 0 && li < nl) return body + (size_t)li * ml + lj;
  if (li < 0 && li >= -s.D) return s.top + (size_t)(li + s.D) * ml + lj;
  if (li >= nl && li < nl + s.D) return s.bot + (size_t)(li - nl) * ml + lj;
  return nullptr;
}

// The two cells as a row of the registers U (Mg2Pair: f32 values, one
// 8-byte load; Mg2Word: a bf16x2 word, one 4-byte load) in the block's
// columns (mg2_pair_at), cells left or right of the block one by one
// (mg_fetch, packed exactly: they are T values).
template <class U, class T>
static __device__ __forceinline__ typename U::Row mg2_fetch2(const T* body,
                                                             const MgStripsOf<T>& s, int li,
                                                             int lj, int nl, int ml) {
  if (lj >= 0 && lj < ml) {
    const T* p = mg2_pair_at(body, s, li, lj, nl, ml);
    return p ? U::ld(p) : typename U::Row{};
  }
  return U::row(mg_fetch(body, s, li, lj, nl, ml), mg_fetch(body, s, li, lj + 1, nl, ml));
}

// Coarse cell (lI, lJ) of the block's V (global (gI, gJ)) of an up-leg
// (K3/K10, K8/K14), 0 outside the coarse grid: from the array or, fed by
// strips (vs, of V's element type), from the one that holds it.
template <bool kStrips, class T, class S>
static __device__ __forceinline__ float mg2_coarse(const T* __restrict__ V,
                                                   const S& vs, const Mg2Tile& t, int lI,
                                                   int lJ, int gI, int gJ) {
  const int nc = t.n / 2;
  if (!mg_in(gI, nc) || !mg_in(gJ, nc)) return 0.f;
  if constexpr (kStrips) return mg_fetch(V, vs, lI, lJ, t.nl / 2, t.ml / 2);
  return Mg2Elem<T>::ld(V + (size_t)gI * nc + gJ);
}

// Loads the warp's R rows of X into x (Mg2Regs<T, R>), the lane's even and
// odd column; cells outside the grid read 0 (s: X's strips, MgStripsOf<T>).
template <int R, bool kStrips, bool kEdge, class U, class T, class S>
static __device__ __forceinline__ void mg2_load(U& x, const T* __restrict__ X, const S& s,
                                                const Mg2Tile& t) {
  const int lj = t.lj0 + 2 * t.lane;
  if (!kEdge) {
    const T* p = X + (size_t)t.li0 * t.ml + lj;
#pragma unroll
    for (int i = 0; i < R; ++i) x.put(i, U::ldg(p + (size_t)i * t.ml));
    return;
  }
  const int gj = t.gj0 + 2 * t.lane;
  const bool col_in = mg_in(gj, t.n);   // n and gj even: both cells or neither
#pragma unroll
  for (int i = 0; i < R; ++i) {
    typename U::Row v{};
    if (col_in && mg_in(t.gi0 + i, t.n)) {
      if constexpr (kStrips)
        v = mg2_fetch2<U>(X, s, t.li0 + i, lj, t.nl, t.ml);
      else
        v = U::ld(X + (size_t)(t.gi0 + i) * t.n + gj);
    }
    x.put(i, v);
  }
}

// Neighbour sum of a cell c in ops.neighbor_sum's order; on the checked
// body, face subtracts c on the grid's edge lines (row_lo/row_hi: the
// cell's row is the first/last; col_edge: its column is the first or last).
template <bool kEdge>
static __device__ __forceinline__ float mg2_nbr(float c, float up, float dn, float lf, float rt,
                                                bool face, bool row_lo, bool row_hi,
                                                bool col_edge) {
  float acc = __fadd_rn(up, dn);
  if (kEdge && face) {
    if (row_lo) acc = __fsub_rn(acc, c);
    if (row_hi) acc = __fsub_rn(acc, c);
  }
  acc = __fadd_rn(acc, __fadd_rn(lf, rt));
  if (kEdge && face && col_edge) acc = __fsub_rn(acc, c);
  return acc;
}

// One smoother update of cell c from its neighbour sum, as ops'
// jacobi_sweep / wjacobi_sweep (omega = 0.8 in 2D) / rbgs_sweep.
template <int kSm>
static __device__ __forceinline__ float mg2_relax(float c, float f, float nbr, float inv_hsq,
                                                  float inv_adiag) {
  const float jac = __fmul_rn(__fsub_rn(f, __fmul_rn(nbr, inv_hsq)), inv_adiag);
  if (kSm == MG_WJACOBI) return __fadd_rn(c, __fmul_rn(Mg2Elem<float>::omega, __fsub_rn(jac, c)));
  return jac;
}

// r = f - (nbr/h^2 + adiag*u), as ops.residual.
static __device__ __forceinline__ float mg2_resid(float c, float f, float nbr, float inv_hsq,
                                                  float adiag) {
  return __fsub_rn(f, __fadd_rn(__fmul_rn(nbr, inv_hsq), __fmul_rn(adiag, c)));
}

// The lane's edge facts on the checked body.
struct Mg2Cols {
  bool in;       // both columns in the grid
  bool lo0;      // the even column is the grid's first
  bool hi1;      // the odd column is the grid's last
  uint32_t cm;   // on words: the halves of lo0 and hi1 (Mg2X2::nbr)
};

static __device__ __forceinline__ Mg2Cols mg2_cols_of(const Mg2Tile& t) {
  const int gj = t.gj0 + 2 * t.lane;
  const bool lo0 = gj == 0, hi1 = gj + 1 == t.n - 1;
  return Mg2Cols{mg_in(gj, t.n), lo0, hi1,
                 (lo0 ? 0x0000ffffu : 0u) | (hi1 ? 0xffff0000u : 0u)};
}

// One colour step of red-black GS: cells with (global row + column) % 2 ==
// P.  The tile origin is even, so that is the even column on rows with i %
// 2 == P and the odd one on the others; every neighbour has the other
// colour, so the order of the updates does not matter.
template <int P, int R, bool kEdge>
static __device__ __forceinline__ void mg2_colour(Mg2Pair<R>& u, const Mg2Pair<R>& f,
                                                  const Mg2Tile& t, const Mg2Cols& c, bool face,
                                                  float inv_hsq, float inv_adiag) {
#pragma unroll
  for (int i = 1; i < R - 1; ++i) {
    const int gi = t.gi0 + i;
    const bool lo = gi == 0, hi = gi == t.n - 1, in = c.in && mg_in(gi, t.n);
    if ((i & 1) == P) {
      const float x = u.x0[i], lf = mg2_from_left(u.x1[i]);
      const float v = mg2_relax<MG_RBGS>(
          x, f.at(i).x,
          mg2_nbr<kEdge>(x, u.x0[i - 1], u.x0[i + 1], lf, u.x1[i], face, lo, hi, c.lo0),
          inv_hsq, inv_adiag);
      u.x0[i] = (!kEdge || in) ? v : x;
    } else {
      const float x = u.x1[i], rt = mg2_from_right(u.x0[i]);
      const float v = mg2_relax<MG_RBGS>(
          x, f.at(i).y,
          mg2_nbr<kEdge>(x, u.x1[i - 1], u.x1[i + 1], u.x0[i], rt, face, lo, hi, c.hi1),
          inv_hsq, inv_adiag);
      u.x1[i] = (!kEdge || in) ? v : x;
    }
  }
}

// The same on words: the colour's cell of each pair from both halves'
// update, lf + rt of that cell from one shuffle (of the row's x1 from the
// left for the even cell, its x0 from the right for the odd one), the
// other half kept by a byte permute.
template <int P, int R, bool kEdge, class K>
static __device__ __forceinline__ void mg2_colour(Mg2Word<R>& u, const Mg2Word<R>& f,
                                                  const Mg2Tile& t, const Mg2Cols& c, bool face,
                                                  const K& k) {
  using X = Mg2X2;
#pragma unroll
  for (int i = 1; i < R - 1; ++i) {
    const int gi = t.gi0 + i;
    const bool lo = gi == 0, hi = gi == t.n - 1, in = c.in && mg_in(gi, t.n);
    const bool even = (i & 1) == P;
    const uint32_t x = u.w[i];
    const uint32_t lr =
        even ? __byte_perm(X::add(__shfl_up_sync(0xffffffffu, x, 1), x), 0, 0x3232)
             : __byte_perm(X::add(x, __shfl_down_sync(0xffffffffu, x, 1)), 0, 0x1010);
    const uint32_t v = X::relax<MG_RBGS>(
        x, f.w[i], X::nbr<kEdge>(x, u.w[i - 1], u.w[i + 1], lr, face, lo, hi, c.cm), k);
    const uint32_t y = __byte_perm(v, x, even ? 0x7610 : 0x3254);
    u.w[i] = (!kEdge || in) ? y : x;
  }
}

// The first sweep from u identically zero (the from-zero down-leg): every
// neighbour sum is +0 under both bcs, so a Jacobi update is f/adiag and a
// damped one 0 + 0.8 (f/adiag), the same roundings as the full update on
// zeros; red-black GS so updates its first colour.
template <int kSm, int R, bool kEdge>
static __device__ __forceinline__ void mg2_first_from_zero(Mg2Pair<R>& u, const Mg2Pair<R>& f,
                                                           const Mg2Tile& t, const Mg2Cols& c,
                                                           float inv_adiag) {
  constexpr float om = Mg2Elem<float>::omega;
#pragma unroll
  for (int i = 1; i < R - 1; ++i) {
    const bool in = !kEdge || (c.in && mg_in(t.gi0 + i, t.n));
    const float2 fi = f.at(i);
    float v0 = __fmul_rn(fi.x, inv_adiag), v1 = __fmul_rn(fi.y, inv_adiag);
    if (kSm == MG_WJACOBI) {
      v0 = __fadd_rn(0.f, __fmul_rn(om, v0));
      v1 = __fadd_rn(0.f, __fmul_rn(om, v1));
    }
    if (kSm != MG_RBGS || (i & 1) == 0) u.x0[i] = in ? v0 : 0.f;
    if (kSm != MG_RBGS || (i & 1) == 1) u.x1[i] = in ? v1 : 0.f;
  }
}

// The same on words (u all zero words before it).  0 + omega v stays an
// add: it turns -0 into +0, as torch's update does.
template <int kSm, int R, bool kEdge, class K>
static __device__ __forceinline__ void mg2_first_from_zero(Mg2Word<R>& u, const Mg2Word<R>& f,
                                                           const Mg2Tile& t, const Mg2Cols& c,
                                                           const K& k) {
  using X = Mg2X2;
#pragma unroll
  for (int i = 1; i < R - 1; ++i) {
    const bool in = !kEdge || (c.in && mg_in(t.gi0 + i, t.n));
    uint32_t v = k.by_inv_adiag(f.w[i]);
    if (kSm == MG_WJACOBI) v = X::add(0u, X::mul(k.omega, v));
    if (kSm == MG_RBGS) v &= (i & 1) == 0 ? 0x0000ffffu : 0xffff0000u;   // colour 0 only
    u.w[i] = in ? v : 0u;
  }
}

// nu smoother sweeps on the warp's registers (see the head of this file);
// `zero`: u is identically zero before them.  Jacobi variants update out of
// place: each row keeps the old value of the row above it.
template <int kSm, int R, bool kEdge>
static __device__ __forceinline__ void mg2_sweeps(Mg2Pair<R>& u, const Mg2Pair<R>& f,
                                                  const Mg2Tile& t, int nu, int bc,
                                                  float inv_hsq, float inv_adiag,
                                                  bool zero = false) {
  const Mg2Cols c = mg2_cols_of(t);
  const bool face = bc == MG_FACE;
  int s = 0;
  if (zero && nu > 0) {
    mg2_first_from_zero<kSm, R, kEdge>(u, f, t, c, inv_adiag);
    if (kSm == MG_RBGS) mg2_colour<1, R, kEdge>(u, f, t, c, face, inv_hsq, inv_adiag);
    s = 1;
  }
#pragma unroll 1
  for (; s < nu; ++s) {
    // the checked body's row tests, made anew each sweep: hoisted out of
    // the loop they would hold ~3R registers for the whole kernel
    Mg2Tile ts = t;
    if (kEdge) asm volatile("" : "+r"(ts.gi0));
    if (kSm == MG_RBGS) {
      mg2_colour<0, R, kEdge>(u, f, ts, c, face, inv_hsq, inv_adiag);
      mg2_colour<1, R, kEdge>(u, f, ts, c, face, inv_hsq, inv_adiag);
      continue;
    }
    float p0 = u.x0[0], p1 = u.x1[0];
#pragma unroll
    for (int i = 1; i < R - 1; ++i) {
      const int gi = ts.gi0 + i;
      const bool lo = gi == 0, hi = gi == t.n - 1, in = c.in && mg_in(gi, t.n);
      const float x0 = u.x0[i], x1 = u.x1[i];
      const float lf = mg2_from_left(x1), rt = mg2_from_right(x0);
      const float2 fi = f.at(i);
      float v0 = mg2_relax<kSm>(
          x0, fi.x, mg2_nbr<kEdge>(x0, p0, u.x0[i + 1], lf, x1, face, lo, hi, c.lo0),
          inv_hsq, inv_adiag);
      float v1 = mg2_relax<kSm>(
          x1, fi.y, mg2_nbr<kEdge>(x1, p1, u.x1[i + 1], x0, rt, face, lo, hi, c.hi1),
          inv_hsq, inv_adiag);
      if (kEdge && !in) {
        v0 = x0;
        v1 = x1;
      }
      p0 = x0;
      p1 = x1;
      u.x0[i] = v0;
      u.x1[i] = v1;
    }
  }
}

// The same on words: per row two shuffles, two byte permutes and nine
// bf16x2 ops (wjacobi) for the lane's two cells; the constants' products
// as mg2_with_k finds them.
template <int kSm, int R, bool kEdge>
static __device__ __forceinline__ void mg2_sweeps(Mg2Word<R>& u, const Mg2Word<R>& f,
                                                  const Mg2Tile& t, int nu, int bc,
                                                  float inv_hsq, float inv_adiag,
                                                  bool zero = false) {
  using X = Mg2X2;
  const Mg2Cols c = mg2_cols_of(t);
  const bool face = bc == MG_FACE;
  mg2_with_k(u, inv_hsq, inv_adiag, 0.f, [&](const auto& k) {
    int s = 0;
    if (zero && nu > 0) {
      mg2_first_from_zero<kSm, R, kEdge>(u, f, t, c, k);
      if (kSm == MG_RBGS) mg2_colour<1, R, kEdge>(u, f, t, c, face, k);
      s = 1;
    }
#pragma unroll 1
    for (; s < nu; ++s) {
      Mg2Tile ts = t;
      if (kEdge) asm volatile("" : "+r"(ts.gi0));
      if (kSm == MG_RBGS) {
        mg2_colour<0, R, kEdge>(u, f, ts, c, face, k);
        mg2_colour<1, R, kEdge>(u, f, ts, c, face, k);
        continue;
      }
      uint32_t p = u.w[0];
#pragma unroll
      for (int i = 1; i < R - 1; ++i) {
        const int gi = ts.gi0 + i;
        const bool lo = gi == 0, hi = gi == t.n - 1, in = c.in && mg_in(gi, t.n);
        const uint32_t x = u.w[i];
        uint32_t v = X::relax<kSm>(
            x, f.w[i], X::nbr<kEdge>(x, p, u.w[i + 1], X::lr(x), face, lo, hi, c.cm), k);
        if (kEdge && !in) v = x;
        p = x;
        u.w[i] = v;
      }
    }
  });
}

// Whether the lane's pair lies in the warp's interior columns (and, on the
// checked body, in the block).
template <bool kEdge>
static __device__ __forceinline__ bool mg2_lane_owns(const Mg2Tile& t) {
  const int j = 2 * t.lane;
  return j >= t.hr && j < MG2_COLS - t.hr && (!kEdge || mg_in(t.lj0 + j, t.ml));
}

// Writes the warp's interior back to the block's (nl x ml) array, by the
// block index.
template <int R, bool kEdge, class T, class U>
static __device__ __forceinline__ void mg2_store(T* __restrict__ out, const U& u,
                                                 const Mg2Tile& t) {
  if (!mg2_lane_owns<kEdge>(t)) return;
  const int lj = t.lj0 + 2 * t.lane;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int li = t.li0 + i;
    if (i >= t.hr && i < R - t.hr && (!kEdge || mg_in(li, t.nl)))
      U::st(out + (size_t)li * t.ml + lj, u.at(i));
  }
}

// The residual of row i's two cells with the level's bc (face) or the
// zero ghosts.
template <int R, bool kEdge>
static __device__ __forceinline__ float2 mg2_resid2(const Mg2Pair<R>& u, const Mg2Pair<R>& f,
                                                    const Mg2Tile& t, const Mg2Cols& c, int i,
                                                    bool face, const Mg2Kf& k) {
  const int gi = t.gi0 + i;
  const bool lo = gi == 0, hi = gi == t.n - 1;
  const float x0 = u.x0[i], x1 = u.x1[i];
  const float lf = mg2_from_left(x1), rt = mg2_from_right(x0);
  const float2 fi = f.at(i);
  return make_float2(
      mg2_resid(x0, fi.x,
                mg2_nbr<kEdge>(x0, u.x0[i - 1], u.x0[i + 1], lf, x1, face, lo, hi, c.lo0),
                k.inv_hsq, k.adiag),
      mg2_resid(x1, fi.y,
                mg2_nbr<kEdge>(x1, u.x1[i - 1], u.x1[i + 1], x0, rt, face, lo, hi, c.hi1),
                k.inv_hsq, k.adiag));
}

// The same on words, the bf16 residual pair unpacked to f32 (exactly).
template <int R, bool kEdge, class K>
static __device__ __forceinline__ float2 mg2_resid2(const Mg2Word<R>& u, const Mg2Word<R>& f,
                                                    const Mg2Tile& t, const Mg2Cols& c, int i,
                                                    bool face, const K& k) {
  using X = Mg2X2;
  const int gi = t.gi0 + i;
  const bool lo = gi == 0, hi = gi == t.n - 1;
  const uint32_t x = u.w[i];
  const uint32_t nbr = X::nbr<kEdge>(x, u.w[i - 1], u.w[i + 1], X::lr(x), face, lo, hi, c.cm);
  return X::unpack(X::resid(x, f.w[i], nbr, k));
}

// The residual of the warp's interior with the level's bc, restricted by
// 2x2 means ((r00 + r10) + (r01 + r11)) / 4 into the block's coarse
// (nl/2 x ml/2) array: each lane's pair and two rows are one coarse cell.
// In bf16 the f32 sum of the four is rounded once, then the quarter.
template <int R, bool kEdge, class T, class U>
static __device__ __forceinline__ void mg2_restrict(T* __restrict__ Rout, const U& u,
                                                    const U& f, const Mg2Tile& t, int bc,
                                                    float inv_hsq, float adiag) {
  const Mg2Cols c = mg2_cols_of(t);
  const bool face = bc == MG_FACE;
  const int mcl = t.ml / 2, J = (t.lj0 + 2 * t.lane) / 2;
  const bool owns = mg2_lane_owns<kEdge>(t);
  mg2_with_k(u, inv_hsq, 0.f, adiag, [&](const auto& k) {
#pragma unroll
    for (int i = 2; i < R - 2; i += 2) {
      if (i < t.hr || i >= R - t.hr) continue;   // the same for every lane
      const float2 r0 = mg2_resid2<R, kEdge>(u, f, t, c, i, face, k);
      const float2 r1 = mg2_resid2<R, kEdge>(u, f, t, c, i + 1, face, k);
      const int I = (t.li0 + i) / 2;
      using E = Mg2Elem<T>;
      if (owns && (!kEdge || mg_in(I, t.nl / 2)))
        Rout[(size_t)I * mcl + J] = E::cvt(E::rd(
            __fmul_rn(E::rd(__fadd_rn(__fadd_rn(r0.x, r1.x), __fadd_rn(r0.y, r1.y))), 0.25f)));
    }
  });
}

// sum(r^2) over the warp's owned cells of the ZERO-GHOST residual, whatever
// the level's bc (the solver's stopping metric); cells outside the grid
// hold 0, so no test is needed for the ghosts.
template <int R, bool kEdge, class U>
static __device__ __forceinline__ float mg2_rsq(const U& u, const U& f, const Mg2Tile& t,
                                                float inv_hsq, float adiag) {
  const Mg2Cols c = mg2_cols_of(t);
  const bool owns = mg2_lane_owns<kEdge>(t);
  float acc = 0.f;
  mg2_with_k(u, inv_hsq, 0.f, adiag, [&](const auto& k) {
#pragma unroll
    for (int i = 1; i < R - 1; ++i) {
      if (i < t.hr || i >= R - t.hr) continue;   // the same for every lane
      const float2 r = mg2_resid2<R, false>(u, f, t, c, i, false, k);
      if (owns && (!kEdge || mg_in(t.li0 + i, t.nl))) {
        acc = __fmaf_rn(r.x, r.x, acc);
        acc = __fmaf_rn(r.y, r.y, acc);
      }
    }
  });
  return acc;
}

// One f32 partial per block: each warp's sum by a butterfly of shuffles,
// then the warps' in order; the same sum every run.
static __device__ __forceinline__ void mg2_partial(float acc, float* __restrict__ partials) {
  __shared__ float red[MG2_WARPS];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (threadIdx.x == 0) red[threadIdx.y] = acc;
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    float s = red[0];
#pragma unroll
    for (int w = 1; w < MG2_WARPS; ++w) s = __fadd_rn(s, red[w]);
    partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// Launches L::go<smoother, R> (one kernel's instances) for a smoother
// known at run time and the tile table's R; returns the launch's error, or
// cudaErrorInvalidValue for an unknown smoother.
template <class L, int kSm, class A>
static __host__ void mg2_go(int R, dim3 grid, dim3 block, cudaStream_t stream, const A& a) {
  if (R == MG2_ROWS_DEEP)
    L::template go<kSm, MG2_ROWS_DEEP>(grid, block, stream, a);
  else if (R == MG2_ROWS_SHALLOW)
    L::template go<kSm, MG2_ROWS_SHALLOW>(grid, block, stream, a);
  else
    L::template go<kSm, MG2_ROWS_SMALL>(grid, block, stream, a);
}

template <class L, class A>
static __host__ int mg2_launch(int smoother, int R, dim3 grid, cudaStream_t stream,
                               const A& a) {
  const dim3 block(32, MG2_WARPS);
  switch (smoother) {
    case MG_JACOBI:
      mg2_go<L, MG_JACOBI>(R, grid, block, stream, a);
      break;
    case MG_WJACOBI:
      mg2_go<L, MG_WJACOBI>(R, grid, block, stream, a);
      break;
    case MG_RBGS:
      mg2_go<L, MG_RBGS>(R, grid, block, stream, a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
