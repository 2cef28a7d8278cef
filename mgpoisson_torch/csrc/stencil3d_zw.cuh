// The word tile: the z-marching tile of stencil3d_zm.cuh on bf16x2 words,
// which the bf16 forms of K5 mg_smooth_rr3d and K6
// mg_prolong_correct_smooth3d, of their strip entries K11
// mg_sharded_rr3d and K12 mg_sharded_pc3d, and of K4 mg_smooth3d (the
// sweeps alone, kSmooth) run at halos H <= MG3Z_MAX_HALO.  Included only
// by their five instance sources (mg_smooth_rr3d_bf16.cu,
// mg_prolong_correct_smooth3d_bf16.cu, mg_sharded_rr3d_zm_bf16.cu,
// mg_sharded_pc3d_zm_bf16.cu, mg_smooth3d_zw.cu), so every other instance
// keeps its machine code.
//
// The march is the f32 tile's (stage pipeline, windows of three planes
// and the f queue in registers, y neighbours from a shared plane per
// stage double-buffered by march step, K5's ring of four residual planes,
// K6's ring of three coarse planes), but a thread owns a PAIR of adjacent
// x cells of its loaded row as one 32-bit register, a bf16x2 word (the even
// cell in the low half, as in memory), so u, f, the windows, the stage
// planes and the residual ring take one word per pair:
//
// - Geometry: MG3W_LANES = 16 lanes per loaded row of 32 cells, two rows
//   per warp, MG3W_ROWS rows per plane: 512 threads, compiled for
//   MG3W_MIN_BLOCKS = 2 blocks per SM at <= 64 registers, so the chunk
//   table (mg3w_chunk) counts 2 x 132 slots.  The x neighbours come by
//   __shfl with width 16, the y neighbours from a shared plane of words
//   (16 per row: half the f32 tile's bytes per stage plane).  The other
//   geometry, 16 lanes x 64 rows at 1024 threads and one block per SM,
//   timed the same on the H100 (PERF.md, word tile), so the smaller block.
// - Pairs are 4-byte aligned: the tile's xy halo is the halo rounded up
//   to even (mg3w_halo, as stencil.cuh mg2_halo), so the loaded x origin
//   x0 - Hw is even, every pair is (even, odd) in global x, a pair lies
//   wholly inside or outside the grid, and a K5 coarse cell's x pair is one
//   word of the residual ring.  Interior T = 32 - 2 Hw cells per side (24
//   at H = 3 and 4, 28 at H = 1 and 2).  The z halo and the stage masks
//   keep the true step count: stage s updates the words that hold a cell
//   of the lanes and rows [s, 31 - s] (a cell outside that band is
//   garbage either way; the exact band needs only the band of the stage
//   before).
// - Arithmetic: every add, subtract and multiply of the plain op is one
//   add/sub/mul.rn.bf16x2 (stencil.cuh Mg2X2), rounded once to nearest
//   even on both cells: torch computes each op of a bf16 tensor in f32 and
//   rounds it once to bf16 (double rounding through f32 is harmless for
//   8-bit significands), so u, R and the corrected u equal the plain ops
//   bit for bit.  The face subtraction is fma.rn.bf16x2(c, m, acc) with m
//   -1 or 0 per half (x: only the half on the grid's edge, gx = 0 low, gx
//   = n - 1 high), one rounding as the f32 tile's fma(c, -1, acc).  No two
//   ops are fused (tests/test_torch_bf16x2.py).
// - Level constants, per constant (Mg3wK), as kernels/cuda.py _scalars
//   derives them from the plain ops' bf16 h^2 and adiag: adiag is a bf16
//   value at every h, 1/h^2 = f32(1 / bf16(h^2)) at h = 1/2^k (every
//   level at the default spacing), so the products by both are one
//   mul.rn.bf16x2 there; in 3D 1/adiag is a bf16 value at no h, so the
//   product by it is two f32 products and one cvt.rn.bf16x2.f32, as torch
//   multiplies by an f32 scalar; at any other h all three are made so.
//   The launch decides it (mg3w_launch: a.exact, and the words in
//   a.w_inv_hsq, a.w_adiag; K4 by 1/h^2 alone) and the leg is instanced
//   once for each answer.  The f32 products alone would be right at every
//   h (a product of two bf16 values is exact in f32), but timed 1.16-1.23x
//   the word products at 256^3 on the H100 (PERF.md, word tile).  The
//   damped-Jacobi weight is 6/7 rounded to bf16
//   (Mg3Elem<__nv_bfloat16>::omega), a word.
// - Red-black GS: the two cells of a pair have opposite colours; a colour
//   step computes the word and keeps the colour's half (__byte_perm), as
//   stencil.cuh mg2_colour does.
// - In f32, each rounded once into a word: K6's trilinear P(V), per half
//   from the coarse ring (a pair shares its coarse x cell and mirrors the
//   x tap), then added to u as a word (add.rn.bf16x2 of two bf16 values
//   rounds once, as E::rd(__fadd_rn(v0, E::rd(p))) of the rounding tile
//   did); K5's restriction, the eight residuals summed in f32 (mg3_sum8),
//   rounded, x 0.125 and rounded; Sigma r^2 of the bf16 residual, one
//   f32 partial per block.
//
// Shared memory: 2 (steps + 1) word planes of 2 KB (K4: 2 steps), plus
// K5's 8 KB ring or K6's 4.3 KB coarse ring, and for K12 its f queue,
// steps + 2 word planes (mg3w_bytes).  Launch failures surface as errors
// (no fallback): a null instance, a misaligned operand or strip.
#pragma once

#include <string.h>

#include "stencil3d_zm.cuh"

#define MG3W_LANES 16        // words per loaded row: a lane's pair of cells each
#define MG3W_ROWS 32         // loaded rows per plane: two per warp
#define MG3W_THREADS (MG3W_LANES * MG3W_ROWS)
#define MG3W_PLANE MG3W_THREADS   // words per stage plane
#define MG3W_MIN_BLOCKS 2    // blocks per SM the instances are compiled for
#define MG3W_SLOTS (MG3Z_SMS * MG3W_MIN_BLOCKS)   // blocks the card runs at once
#define MG3W_CX (MG3Z_COLS / 2 + 3)   // K6's coarse plane: x side
#define MG3W_CY (MG3W_ROWS / 2 + 3)   // ... and y side

static_assert(2 * MG3W_LANES == MG3Z_COLS, "a row of 32 cells in 16 words");
static_assert(MG3W_CX * MG3W_CY <= MG3W_THREADS, "one thread per coarse ring cell");

// The xy halo rounded up to even, and the interior cells of a block per
// row (x) and per column (y); mirrored by kernels/cuda.py tile3d_zw.
static __host__ __device__ inline int mg3w_halo(int H) { return H + (H & 1); }
static __host__ __device__ inline int mg3w_cols(int H) { return MG3Z_COLS - 2 * mg3w_halo(H); }
static __host__ __device__ inline int mg3w_rows(int H) { return MG3W_ROWS - 2 * mg3w_halo(H); }

// The chunk table of the word tile (mg3z_chunk's rule over MG3W_SLOTS
// slots and this tile's columns; mirrored by kernels/cuda.py zm_chunk in
// bf16).  At 256^3, H = 4: 121 columns, 128 planes (242 blocks in one
// round of 136 plane-steps); at 512^3 the whole column (484 blocks, two
// rounds of 520); on the (128, 128, 256) block of (2, 2): 66 columns, 32
// planes (264 blocks, one round of 40).
static __host__ inline int mg3w_chunk(int n, int nyl, int nzl, int H) {
  const int tx = mg3w_cols(H), ty = mg3w_rows(H);
  const long long cols = (long long)((n + tx - 1) / tx) * ((nyl + ty - 1) / ty);
  int best = nzl;
  long long best_cost = -1;
  for (int c = nzl; c >= 1 && nzl % c == 0 && (c == nzl || c >= MG3Z_MIN_CHUNK); c /= 2) {
    const long long cost = (cols * (nzl / c) + MG3W_SLOTS - 1) / MG3W_SLOTS * (c + 2 * H);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
    if (c & 1) break;
  }
  return best;
}

// The launch grid over a block (x, y, chunk); one Sigma r^2 partial per
// block of it.
static __host__ inline dim3 mg3w_grid(const Mg3Block& b, int H, int chunk) {
  const int tx = mg3w_cols(H), ty = mg3w_rows(H);
  return dim3((b.n + tx - 1) / tx, (b.nyl + ty - 1) / ty, (b.nzl + chunk - 1) / chunk);
}

// Dynamic shared memory of one block: the stages' double-buffered word
// planes (K4's, `smooth`, but for its last stage), K5's ring of residual
// words (rr), K6's f32 coarse ring (pc), and K12's f queue of steps + 2
// word planes (fq: the strip-fed up-leg).
static __host__ inline size_t mg3w_bytes(int steps, bool rr, bool pc, bool fq,
                                         bool smooth = false) {
  size_t words = (size_t)(smooth ? steps : steps + 1) * 2 * MG3W_PLANE;
  if (rr) words += 4 * MG3W_PLANE;
  if (pc) words += 3 * MG3W_CX * MG3W_CY;
  if (fq) words += (size_t)(steps + 2) * MG3W_PLANE;
  return words * 4;
}

// A word of two bf16 values in memory (4-byte aligned), its store, and
// fma.rn.bf16x2 (the face subtraction).
static __device__ __forceinline__ uint32_t mg3w_ldg(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
static __device__ __forceinline__ void mg3w_st(__nv_bfloat16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}
static __device__ __forceinline__ uint32_t mg3w_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The level's constants for the word products (see the head of this
// file), read from the arguments (kernel parameters, no registers held
// through the march): kExact, 1/h^2 and adiag are bf16 values and their
// products words (a.w_inv_hsq, a.w_adiag); the product by 1/adiag is
// always made in f32 and rounded once.
template <bool kExact>
struct Mg3wK {
  // Mg3Elem<__nv_bfloat16>::omega, 0.85546875 (bf16 0x3f5b), in both halves
  static constexpr uint32_t omega = 0x3f5b3f5bu;
  const Mg3zArgsBf16& a;
  static __device__ __forceinline__ uint32_t in_f32(uint32_t x, float k) {
    const float2 v = Mg2X2::unpack(x);
    return Mg2X2::pack(__fmul_rn(v.x, k), __fmul_rn(v.y, k));
  }
  __device__ __forceinline__ uint32_t by_inv_hsq(uint32_t x) const {
    return kExact ? Mg2X2::mul(x, a.w_inv_hsq) : in_f32(x, a.inv_hsq);
  }
  __device__ __forceinline__ uint32_t by_adiag(uint32_t x) const {
    return kExact ? Mg2X2::mul(x, a.w_adiag) : in_f32(x, a.adiag);
  }
  __device__ __forceinline__ uint32_t by_inv_adiag(uint32_t x) const {
    return in_f32(x, a.inv_adiag);
  }
};

// One stage's last three planes of a thread's pair.
struct Mg3wWin {
  uint32_t lo, c, hi;
};

// lf + rt of both cells of word x: A = (x1 of the lane before, x0) plus B
// = (x1, x0 of the lane after), the lanes of the row's 16 (a lane at the
// row's end gets its own word: garbage outside the exact band).
static __device__ __forceinline__ uint32_t mg3w_lr(uint32_t x) {
  const uint32_t l = __shfl_up_sync(0xffffffffu, x, 1, MG3W_LANES),
                 r = __shfl_down_sync(0xffffffffu, x, 1, MG3W_LANES);
  return Mg2X2::add(__byte_perm(l, x, 0x5432), __byte_perm(x, r, 0x5432));
}

// Neighbour sum of both cells in ops.neighbor_sum's order (mg3z_nbr on
// words); with kFace, mz, my, mx hold -1 in the halves on the grid's edge
// plane of that axis, 0 elsewhere.
template <bool kFace>
static __device__ __forceinline__ uint32_t mg3w_nbr(const Mg3wWin& w, uint32_t ylo, uint32_t yhi,
                                                    uint32_t lr, uint32_t mz, uint32_t my,
                                                    uint32_t mx) {
  using X = Mg2X2;
  uint32_t acc = X::add(w.lo, w.hi);
  if (kFace) acc = mg3w_fma(w.c, mz, acc);
  acc = X::add(acc, X::add(ylo, yhi));
  if (kFace) acc = mg3w_fma(w.c, my, acc);
  acc = X::add(acc, lr);
  if (kFace) acc = mg3w_fma(w.c, mx, acc);
  return acc;
}

// P(V) of both cells of a pair in f32 from the coarse ring at cc (their
// coarse cell), each in mg3z_leg's tap order: per (z, y) tap, its weight
// product wzy (every weight a dyadic 0, 1/4, 1/2 or 3/4, so each product
// is exact and (wz wy) wx = wz (wy wx)), then the centre x tap and the
// shifted one: x - 1 for the even cell, x + 1 for the odd one, with the
// cells' x weights (a2l, b2l) and (a2h, b2h).  Three ring reads per (z, y)
// tap serve both cells.
static __device__ __forceinline__ float2 mg3w_tri(const float* cc, int dz, int dy, float a0,
                                                  float b0, float a1, float b1, float a2l,
                                                  float b2l, float a2h, float b2h) {
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float wzy = __fmul_rn(t < 2 ? a0 : b0, (t & 1) ? b1 : a1);
    const float* q = cc + (t < 2 ? 0 : dz) + ((t & 1) ? dy : 0);
    const float c = q[0], l = q[-1], r = q[1];
    const float pl = __fmul_rn(__fmul_rn(wzy, a2l), c), ph = __fmul_rn(__fmul_rn(wzy, a2h), c);
    lo = t == 0 ? pl : __fadd_rn(lo, pl);
    hi = t == 0 ? ph : __fadd_rn(hi, ph);
    lo = __fadd_rn(lo, __fmul_rn(__fmul_rn(wzy, b2l), l));
    hi = __fadd_rn(hi, __fmul_rn(__fmul_rn(wzy, b2h), r));
  }
  return make_float2(lo, hi);
}

// The element offset of row `row` (of n cells) at column x in a strip-fed
// block or its sources: a row index fits 32 bits, the offset only 64 (the
// (1024, 2048, 2048) block of a 2048^3 grid has 2^32 cells).
static __device__ __forceinline__ size_t mg3w_at(int row, int n, int x) {
  return (size_t)(unsigned)row * (unsigned)n + (unsigned)x;
}

// K12: the element offset of block plane zb in column (yb, x) within the
// source it is read from (mg3z_src's address, split), the same for u and
// f, whose strips are alike; and that source's base.
static __device__ __forceinline__ size_t mg3w_src_off(int zb, int yb, int x, int nzl, int nyl,
                                                      int n, int D) {
  if (yb >= 0 && yb < nyl)
    return mg3w_at((zb < 0 ? zb + D : zb < nzl ? zb : zb - nzl) * nyl + yb, n, x);
  return mg3w_at((zb + D) * D + (yb < 0 ? yb + D : yb - nyl), n, x);
}
template <class T, class S>
static __device__ __forceinline__ const T* mg3w_src_base(const T* body, const S& s, int zb,
                                                         int yb, int nzl, int nyl) {
  if (yb >= 0 && yb < nyl) return zb < 0 ? s.top : zb < nzl ? body : s.bot;
  return yb < 0 ? s.left : s.right;
}

// The leg of one block on words: K5 (kRR), K6 or K4 (kSmooth), on the
// whole grid or with kStrips on a rank's block (K11, K12), as mg3z_leg
// (whose comments hold here too), with the level's constants k.  For the registers (64 at two
// blocks per SM) the whole grid's addresses are one unsigned 32-bit WORD
// offset from the arguments' bases, advanced by n^2 / 2 per plane (taken
// modulo 2^32 on the halo planes before plane 0, which it never reads;
// exact where it loads and stores), up to 2^32 words, a 2048^3 grid
// (mg3w_launch refuses larger; 64-bit offsets cost 5-13 %, PERF.md);
// K11 carries its sources' pointers as mg3z_leg does, while K12, the leg
// with the most live values, makes them per plane (mg3w_src_off) and keeps
// its f queue in shared memory.
template <int STEPS, int kSm, bool kFace, bool kRR, bool kStrips, class K, bool kSmooth = false>
static __device__ __forceinline__ void mg3w_leg(const Mg3zArgsBf16& a, const Mg3zStripsBf16& b,
                                                const K& k) {
  using X = Mg2X2;
  using T = __nv_bfloat16;
  using E = Mg3Elem<T>;
  extern __shared__ uint32_t mg3w_smem[];
  constexpr int L = MG3W_LANES, R = MG3W_ROWS, P = MG3W_PLANE, CX = MG3W_CX,
                CC = MG3W_CX * MG3W_CY;
  constexpr bool kPC = !kRR && !kSmooth;    // K6: the coarse ring and the correction
  constexpr bool kFsh = kStrips && !kRR;   // the f queue in shared memory
  constexpr int Q = STEPS + 2;             // its planes
  constexpr uint32_t kM1 = 0xbf80bf80u;    // -1 in both halves
  const int l = (int)threadIdx.x, j = (int)threadIdx.y, me = j * L + l;
  const int n = a.n, H = a.H, Hw = mg3w_halo(H), TX = mg3w_cols(H), TY = mg3w_rows(H);
  const int x0 = (int)blockIdx.x * TX, y0 = (int)blockIdx.y * TY,
            z0 = (int)blockIdx.z * a.chunk;
  const int nzl = kStrips ? b.blk.nzl : n, nyl = kStrips ? b.blk.nyl : n;
  const int oz = kStrips ? b.blk.z0 : 0, oy = kStrips ? b.blk.y0 : 0;
  // the pair's even cell gx, the row yb and the march's first plane zb0 in
  // the block's index
  const int yb = y0 - Hw + j, zb0 = z0 - H;
  const int gx = x0 - Hw + 2 * l, gy = kStrips ? oy + yb : yb, gz0 = kStrips ? oz + zb0 : zb0;
  const int zl = min(a.chunk, nzl - z0);
  const bool in_xy = mg_in(gx, n) && mg_in(gy, n);   // both cells: n and gx are even
  const bool owns_xy = in_xy && 2 * l >= Hw && 2 * l < MG3Z_COLS - Hw && j >= Hw &&
                       j < R - Hw && (!kStrips || yb < nyl);
  const int D = kStrips ? b.fs.D : 0;
  const bool src = !kStrips || (yb >= -D && yb < nyl + D);
  const bool y0e = gy == 0, y1e = gy == n - 1, x0e = gx == 0, x1e = gx + 1 == n - 1;
  uint32_t my = y0e || y1e ? kM1 : 0u,
           mx = (x0e ? 0x0000bf80u : 0u) | (x1e ? 0xbf800000u : 0u);
  asm volatile("" : "+r"(my), "+r"(mx));   // kept, not rebuilt per stage
  const bool res = kRR || (!kSmooth && a.partials != nullptr);
  const T* __restrict__ U = a.U;
  const T* __restrict__ F = a.F;
  const bool has_u = U != nullptr;

  uint32_t* sh = mg3w_smem;                         // [STEPS + 1][2][P]
  uint32_t* rsh = sh + (STEPS + 1) * 2 * P;         // K5: [4][P]
  float* cv = reinterpret_cast<float*>(rsh + (kRR ? 4 * P : 0));   // K6: [3][CC]
  uint32_t* fsh = reinterpret_cast<uint32_t*>(cv + (kRR ? 0 : 3 * CC)) + me;   // [Q][P]

  // K6: the coarse cell this thread loads into the ring; the pair's coarse
  // cell (shared by both halves), its y tap and the trilinear edge weights
  // are made where they are used
  const int nc = n / 2;
  const int cy0 = kStrips ? (oy >> 1) + ((y0 - Hw) >> 1) - 1 : ((y0 - Hw) >> 1) - 1,
            cx0 = ((x0 - Hw) >> 1) - 1;
  const bool loads_c = kPC && me < CC;
  const int ly = me / CX, lx = me - (me / CX) * CX;
  const bool c_in = loads_c && mg_in(cy0 + ly, nc) && mg_in(cx0 + lx, nc);
  const size_t ccol = c_in ? (size_t)(cy0 + ly) * nc + (cx0 + lx) : 0;
  const auto slot = [](int Z) { return (Z + 6) % 3; };
  const auto coarse = [&](int Z) {
    if constexpr (kStrips)
      return mg3z_coarse(a.V, b, c_in, Z, cy0 + ly, cx0 + lx);
    else
      return c_in && mg_in(Z, nc) ? E::ldg(a.V + (size_t)Z * nc * nc + ccol) : 0.f;
  };
  if (loads_c) {
    const int Zf = gz0 >> 1;
    for (int Z = Zf - 1; Z <= Zf + 1; ++Z) cv[slot(Z) * CC + me] = coarse(Z);
  }
  if (kPC) __syncthreads();

  // K5: the coarse cell (cy, cx) of the block's that this thread
  // restricts, its first fine word in the plane and its coarse index
  const int T2 = TX / 2, cyr = me / T2, cxr = me - (me / T2) * T2;
  const int c_at = (Hw + 2 * cyr) * L + Hw / 2 + cxr;
  const int ncy = kStrips ? nyl / 2 : nc;
  const bool owns_c = kRR && me < T2 * (TY / 2) && mg_in(y0 / 2 + cyr, ncy) &&
                      mg_in(x0 / 2 + cxr, nc);
  const size_t c_out = owns_c ? (size_t)(y0 / 2 + cyr) * nc + (x0 / 2 + cxr) : 0;

  // the stage mask (mg3z_leg's), per word: bit s where the pair holds a
  // cell of the stage's band of lanes and rows
  unsigned act = in_xy && src ? 1u : 0u;
#pragma unroll
  for (int s = 1; s <= STEPS; ++s)
    if (in_xy && 2 * l + 1 >= s && 2 * l <= MG3Z_COLS - 1 - s && j >= s && j < R - s)
      act |= 1u << s;
  if (owns_xy) act |= 1u << (STEPS + 1);
  asm volatile("" : "+r"(act));
  const int py = gy & 1;   // red-black colour of the pair's even cell at z = 0

  // the loads' addresses: the whole grid's word offset of the next plane,
  // advanced by n^2 / 2 per plane; K11's pointers into its sources,
  // advanced by a plane and switched at the block's z edges (mg3z_leg's);
  // K12's made per plane
  const unsigned nnw = (unsigned)(n * n) / 2u;
  unsigned off = kStrips ? 0u
                         : (unsigned)gz0 * nnw + (in_xy ? (unsigned)(gy * n + gx) / 2u : 0u);
  const T* pU = nullptr;
  const T* pF = nullptr;
  int pl = 0;
  if constexpr (kStrips && kRR) {
    pl = yb >= 0 && yb < nyl ? nyl * n : D * n;
    pF = mg3z_src(F, b.fs, zb0, yb, gx, nzl, nyl, n);
    pU = has_u ? mg3z_src(U, b.us, zb0, yb, gx, nzl, nyl, n) : pF;
  }
  const auto load = [&](const T* X0, const T* p, const Mg3StripsBf16& s, int zb) -> uint32_t {
    if constexpr (!kStrips)
      return __ldg(reinterpret_cast<const unsigned*>(X0) + off);
    else if constexpr (kRR)
      return mg3w_ldg(p);
    else
      return mg3w_ldg(mg3w_src_base(X0, s, zb, yb, nzl, nyl) +
                      mg3w_src_off(zb, yb, gx, nzl, nyl, n, D));
  };
  uint32_t pu = has_u && in_xy && src && mg_in(gz0, n) ? load(U, pU, b.us, zb0) : 0u;
  uint32_t pf = in_xy && src && mg_in(gz0, n) ? load(F, pF, b.fs, zb0) : 0u;

  Mg3wWin w[STEPS + 1];
  uint32_t fq[kFsh ? 1 : STEPS + 2];   // fq[i]: f at march plane kk - i
#pragma unroll
  for (int s = 0; s <= STEPS; ++s) w[s] = Mg3wWin{0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < (kFsh ? 1 : STEPS + 2); ++i) fq[i] = 0u;
  if constexpr (kFsh) {
#pragma unroll
    for (int i = 0; i < Q; ++i) fsh[i * P] = 0u;
  }
  float acc = 0.f;   // K6 rnorm: sum of r^2 over the owned cells

  const int planes = zl + 2 * H, steps_end = planes + (kRR ? 1 : 0);
#pragma unroll 1
  for (int kk = 0; kk < steps_end; ++kk) {
    const int gz = gz0 + kk, cp = (kk & 1) * P;
    uint32_t* wr = sh + me + cp;              // this step's buffer: stage s at wr[2 s P]
    const uint32_t* rd = sh + me + (P - cp);  // the last step's
    const int fslot = kFsh ? kk % Q : 0;      // the f queue's slot of plane kk
    // f at march plane kk - i
    const auto fat = [&](int i) -> uint32_t {
      if constexpr (kFsh)
        return fsh[(fslot >= i ? fslot - i : fslot - i + Q) * P];
      else
        return fq[i];
    };
    // stage 0: plane kk, loaded one step ahead (K6: corrected by P(V))
    uint32_t v0 = pu;
    const uint32_t fnew = pf;
    const int zb = zb0 + kk + 1;
    if constexpr (!kStrips) off += nnw;
    if constexpr (kStrips && kRR) {   // the rows of the block switch source here
      pU += pl;
      pF += pl;
      if (zb == 0 || zb == nzl) {
        pF = mg3z_src(F, b.fs, zb, yb, gx, nzl, nyl, n);
        pU = has_u ? mg3z_src(U, b.us, zb, yb, gx, nzl, nyl, n) : pF;
      }
    }
    const bool zn = (act & 1u) && mg_in(gz + 1, n) && (!kStrips || zb < nzl + D);
    pu = has_u && zn ? load(U, pU, b.us, zb) : 0u;
    pf = zn ? load(F, pF, b.fs, zb) : 0u;
    const bool c_step = kPC && (gz & 1);   // odd fine plane: the next coarse plane
    const float cnext = c_step && loads_c ? coarse((gz >> 1) + 2) : 0.f;
    if constexpr (kPC) {
      if ((act & 1u) && mg_in(gz, n)) {
        const int Z = gz >> 1;
        const float* cc = cv + slot(Z) * CC + ((gy >> 1) - cy0) * CX + ((gx >> 1) - cx0);
        uint32_t pw;
        if (a.kind != MG_INJECT) {
          const int dz = (slot(Z + ((gz & 1) ? 1 : -1)) - slot(Z)) * CC;
          const bool ez = gz == 0 || gz == n - 1, ey = my != 0u, ex0 = (mx & 0xffffu) != 0u,
                     ex1 = (mx >> 16) != 0u;
          const float2 p = mg3w_tri(cc, dz, (gy & 1) ? CX : -CX, ez ? 0.5f : 0.75f,
                                    ez ? 0.f : 0.25f, ey ? 0.5f : 0.75f, ey ? 0.f : 0.25f,
                                    ex0 ? 0.5f : 0.75f, ex0 ? 0.f : 0.25f, ex1 ? 0.5f : 0.75f,
                                    ex1 ? 0.f : 0.25f);
          pw = X::pack(p.x, p.y);
        } else {
          pw = X::pack(cc[0], cc[0]);
        }
        v0 = X::add(v0, pw);   // P(V) blended in f32, rounded once per half
      } else {
        v0 = 0u;
      }
      // the ring's slot of coarse plane Z - 1 is read by no thread in this
      // step (an odd plane reads Z and Z + 1): refill it now
      if (c_step && loads_c) cv[slot((gz >> 1) + 2) * CC + me] = cnext;
    }
    if constexpr (kFsh) {
      fsh[fslot * P] = fnew;
    } else {
#pragma unroll
      for (int i = STEPS + 1; i > 0; --i) fq[i] = fq[i - 1];
      fq[0] = fnew;
    }
    w[0] = Mg3wWin{w[0].c, w[0].hi, v0};
    if (STEPS > 0 || res) wr[0] = v0;

    // stages 1 .. STEPS: the sweeps, stage s on plane kk - s
#pragma unroll
    for (int s = 1; s <= STEPS; ++s) {
      const int gzs = gz - s;
      const uint32_t c = w[s - 1].c;
      const uint32_t lr = mg3w_lr(c);
      uint32_t v = c;
      if (((act >> s) & 1u) && mg_in(gzs, n)) {
        const uint32_t* prev = rd + (s - 1) * 2 * P;
        const uint32_t mz = gzs == 0 || gzs == n - 1 ? kM1 : 0u;
        const uint32_t nbr = mg3w_nbr<kFace>(w[s - 1], prev[-L], prev[L], lr, mz, my, mx);
        const uint32_t jac = k.by_inv_adiag(X::sub(fat(s), k.by_inv_hsq(nbr)));
        if (kSm == MG_WJACOBI)
          v = X::add(c, X::mul(k.omega, X::sub(jac, c)));
        else if (kSm == MG_RBGS)   // the even cell's colour is this step's: keep its half
          v = __byte_perm(jac, c, ((gzs & 1) ^ py) == ((s - 1) & 1) ? 0x7610 : 0x3254);
        else
          v = jac;
      }
      w[s] = Mg3wWin{w[s].c, w[s].hi, v};
      if (s < STEPS || res) wr[s * 2 * P] = v;
    }

    // the smoothed u of plane kk - STEPS
    {
      const int p = kk - STEPS;
      if (((act >> (STEPS + 1)) & 1u) && p >= H && p < H + zl) {
        if constexpr (kStrips)
          mg3w_st(a.Uout + mg3w_at((zb0 + p) * nyl + yb, n, gx), w[STEPS].hi);
        else
          reinterpret_cast<uint32_t*>(a.Uout)[off - (STEPS + 1) * nnw] = w[STEPS].hi;
      }
    }

    // the residual stage on plane kk - STEPS - 1: K5 with the level's bc
    // into the ring, K6 zero-ghost into sum(r^2)
    if (res) {
      const int p = kk - STEPS - 1, gzr = gz0 + p;
      const uint32_t c = w[STEPS].c;
      const uint32_t lr = mg3w_lr(c);
      uint32_t r = 0u;
      if (((act >> (STEPS + 1)) & 1u) && mg_in(gzr, n)) {
        const uint32_t* prev = rd + STEPS * 2 * P;
        const uint32_t mz = gzr == 0 || gzr == n - 1 ? kM1 : 0u;
        const uint32_t nbr =
            mg3w_nbr<kRR && kFace>(w[STEPS], prev[-L], prev[L], lr, mz, my, mx);
        r = X::sub(fat(STEPS + 1), X::add(k.by_inv_hsq(nbr), k.by_adiag(c)));
        if (!kRR && p >= H && p < H + zl) {
          const float2 rf = X::unpack(r);
          acc = __fmaf_rn(rf.x, rf.x, acc);
          acc = __fmaf_rn(rf.y, rf.y, acc);
        }
      }
      if (kRR) rsh[(p & 3) * P + me] = r;
    }

    // K5: restrict the pair of planes that ends at march plane kk - STEPS
    // - 2, an odd global plane, whose residual the last step wrote
    if constexpr (kRR) {
      const int q = kk - STEPS - 2, gq = gz0 + q;
      if (q >= H && q < H + zl && (gq & 1) && owns_c) {
        const uint32_t* r0 = rsh + ((q - 1) & 3) * P + c_at;
        const uint32_t* r1 = rsh + (q & 3) * P + c_at;
        const float2 p00 = X::unpack(r0[0]), p01 = X::unpack(r0[L]), p10 = X::unpack(r1[0]),
                     p11 = X::unpack(r1[L]);
        const float r8[8] = {p00.x, p00.y, p01.x, p01.y, p10.x, p10.y, p11.x, p11.y};
        a.Rout[(size_t)((kStrips ? gq - oz : gq) >> 1) * ncy * nc + c_out] =
            E::cvt(E::rd(__fmul_rn(E::rd(mg3_sum8(r8)), 0.125f)));
      }
    }
    __syncthreads();
  }

  if (kRR || kSmooth || a.partials == nullptr) return;
  // one f32 partial per block: each warp's sum by a butterfly, then the
  // warps' in order; the same sum every run
  __shared__ float red[MG3W_THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if ((me & 31) == 0) red[me >> 5] = acc;
  __syncthreads();
  if (me == 0) {
    float s = red[0];
    for (int i = 1; i < MG3W_THREADS / 32; ++i) s = __fadd_rn(s, red[i]);
    a.partials[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
  }
}

// The leg with the level's constants as the word products take them
// (a.exact, uniform): instanced once for each answer.
template <int STEPS, int kSm, bool kFace, bool kRR, bool kStrips, bool kSmooth = false>
static __device__ __forceinline__ void mg3w_run(const Mg3zArgsBf16& a, const Mg3zStripsBf16& b) {
  if (a.exact)
    mg3w_leg<STEPS, kSm, kFace, kRR, kStrips, Mg3wK<true>, kSmooth>(a, b, Mg3wK<true>{a});
  else
    mg3w_leg<STEPS, kSm, kFace, kRR, kStrips, Mg3wK<false>, kSmooth>(a, b, Mg3wK<false>{a});
}

static __host__ inline bool mg3w_aligned(const void* p) { return ((uintptr_t)p & 3) == 0; }

static __host__ inline bool mg3w_aligned(const Mg3StripsBf16& s) {
  return mg3w_aligned(s.top) && mg3w_aligned(s.bot) && mg3w_aligned(s.left) &&
         mg3w_aligned(s.right);
}

// An f32 constant's bits; a bf16 value has none in the low half, and its
// word is the high half twice.
static __host__ inline uint32_t mg3w_bits(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  return u;
}

// The leg a word-tile launch runs: K5 or K11 (the down-leg), K6 or K12
// (the up-leg), K4 (the sweeps alone).
enum Mg3wLeg { MG3W_RR, MG3W_PC, MG3W_SMOOTH };

// Opts `kernel` (null: no instance for the step count and smoother) of the
// leg `leg` in to its dynamic shared memory and launches it on the block
// `blk` at halo a.H (checked by the caller with mg3z_takes), with the word
// tile's chunk (mg3w_chunk) and level words, the strips `strips` of a
// strip-fed leg (null for the whole grid) passed on in `args`; returns a
// cudaError_t.
// u, f, the output and the u and f strips are read and written as words:
// a pointer that is not 4-byte aligned is refused, and so is a whole grid
// of more than 2^32 words (above 2048^3, the leg's 32-bit word offsets).
template <class Kernel, class... Args>
static __host__ inline int mg3w_launch(Kernel kernel, const Mg3Block& blk, Mg3zArgsBf16 a,
                                       int steps, Mg3wLeg leg, cudaStream_t stream,
                                       const Mg3zStripsBf16* strips, Args... args) {
  if (kernel == nullptr || blk.n < 2 || (blk.n & 1) || blk.nzl < 2 || blk.nyl < 2 ||
      (blk.nzl | blk.nyl | blk.z0 | blk.y0) & 1 ||
      (strips == nullptr && (unsigned long long)blk.n * blk.n * blk.n / 2 > (1ull << 32)))
    return (int)cudaErrorInvalidValue;
  if (!mg3w_aligned(a.U) || !mg3w_aligned(a.F) || !mg3w_aligned(a.Uout) ||
      (strips != nullptr && (!mg3w_aligned(strips->us) || !mg3w_aligned(strips->fs))))
    return (int)cudaErrorMisalignedAddress;
  a.chunk = mg3w_chunk(blk.n, blk.nyl, blk.nzl, a.H);
  const uint32_t ih = mg3w_bits(a.inv_hsq), ad = mg3w_bits(a.adiag);
  const bool pc = leg == MG3W_PC, smooth = leg == MG3W_SMOOTH;
  a.exact = (ih & 0xffffu) == 0 && (smooth || (ad & 0xffffu) == 0);   // K4 reads no adiag
  a.w_inv_hsq = (ih >> 16) * 0x10001u;
  a.w_adiag = (ad >> 16) * 0x10001u;
  const size_t bytes = mg3w_bytes(steps, leg == MG3W_RR, pc, strips != nullptr && pc, smooth);
  const int rc = (int)cudaFuncSetAttribute((const void*)kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
  if (rc != 0) return rc;
  kernel<<<mg3w_grid(blk, a.H, a.chunk), dim3(MG3W_LANES, MG3W_ROWS), bytes, stream>>>(a,
                                                                                      args...);
  return (int)cudaGetLastError();
}
