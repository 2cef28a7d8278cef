// The packed word tile: the bf16 forms of the fast scheme's packed
// fine-level legs, K7 mg_packed_rr_bf16 and K8 mg_packed_pc_bf16, on
// bf16x2 words.  Included only by their instance sources
// (mg_packed_rr_bf16.cu, mg_packed_pc_bf16.cu), so the f32 packed tile
// (stencil_packed.cuh: K7, K8 and their strip entries K13/K14, which have
// no bf16 form) and every other instance keep their machine code.
//
// The packed ops (kernels/ops.py _packed_core, _packed_residual, after the
// Pallas packed kernels) work on whole red and black planes: a colour step
// updates every cell of one plane.  So does this tile:
//
// - Geometry: lane L of a warp holds packed columns J = j0 + 2L and J + 1
//   of both planes on each of its R loaded rows, the red word (xr[i][J],
//   xr[i][J + 1]) from row[J] and the black word (xb[i][J], xb[i][J + 1])
//   from row[w + J], w = n/2: one 4-byte load each, 128 bytes per warp,
//   plane and row.  A lane covers fine columns 2J ... 2J + 3, a warp
//   MG2W_COLS packed columns of each plane (128 fine ones).  u and f take
//   4R registers.  The column halo is H fine columns rounded up to a
//   multiple of 4 (mg2w_hp: whole lanes), the row halo H rounded up to
//   even (mg2_halo), so every tile origin is even and a row's parity is
//   known per unrolled row.  At rbgs nu = 1 (H = 3) a warp owns 120 of its
//   128 loaded fine columns.  A warp loads 16 rows at a row halo <= 4 and
//   32 beyond (mg2w_rows), MG2_WARPS warps per block in row bands; mirrored
//   by kernels/cuda.py tile_packed_w.  The f32 tile's 24 and 40 rows spill
//   here (u and f take 4R registers) and timed slower on the H100 (PERF.md,
//   packed word tile).
// - A colour step updates one whole word per row and plane: V = other(i -
//   1) + other(i + 1) from the lane's own words, H = other(i) + partner,
//   X = (V + H) * 0.25 + f * (-h^2/4).  The partner word is (the left
//   lane's high half, own low half) or (own high half, the right lane's
//   low half) of the other plane, by the row's parity and the colour: one
//   __shfl and one __byte_perm per word.  Each add, subtract and multiply
//   is one add/sub/mul.rn.bf16x2 (stencil.cuh Mg2X2), rounded once to
//   nearest even as torch rounds each op of a bf16 tensor; nothing is fused.
// - Residual and restriction in words: r = f - ((((up + dn) + same) +
//   partner) - 4 x) * (1/h^2), in the packed ops' order; K7's coarse word
//   (Rc[I][J], Rc[I][J + 1]) = (((r_red + r_black) on row 2I + (the same
//   on row 2I + 1)) + 0) * 0.25.  A bf16 add of two bf16 values rounds
//   once, as torch's bf16 sum over the row pair does (chip_smoke.py
//   probe_restrict_order_packed); the + 0 is that sum's start, which turns
//   a -0 into +0.  K7 writes one 4-byte store per lane and row pair.
// - u's red plane is dead on input: the sweeps' first red step overwrites
//   it from the black plane alone (mg2w_load).  So neither leg loads it,
//   and the up-leg corrects the black plane only.
// - The up-leg's correction: V's coarse word (J, J + 1) is one 4-byte load
//   per coarse row; inject is a word add; bilinear is blended in f32 per
//   cell and rounded once to a pair (cvt.rn.bf16x2.f32), as
//   ops._packed_correction and the Pallas packed up-leg blend, then added
//   as a word.  The lane blend takes the coarse columns J - 1 and J +
//   2 from the words beside (lanes 0 and 31 load theirs).  Sigma r^2
//   squares the bf16 residual in f32, one f32 partial per block.
// - Level constants (Mg2wK): -h^2/4 and 1/h^2 are bf16 values at every h
//   (the plain packed ops round them to bf16 as the Pallas packed kernels
//   do, kernels/ops.py _level), so a product by either is one bf16x2
//   multiply, rounded once as torch rounds its f32 product by a bf16
//   value; the launch refuses other constants.  0.25 and 4 are exact
//   words.
// - Any even n: where w is odd (n % 4 == 2) the black plane, V and Rc put
//   a pair at an odd bf16 offset, and the last word of a plane is half
//   outside the grid.  Such a launch (and one with an operand not 4-byte
//   aligned) runs every warp on the checked body with 2-byte accesses
//   (a.pairs false): no refusal.  Offsets are 64-bit (size_t): every grid
//   the card holds.
//
// Bound: HBM bytes, 2.75 bf16 arrays (u's black plane, f, V or Rc, u'; the
// red plane of u is dead on input).  What the warps spend beyond it is
// issue: per row, plane and colour step 6 bf16x2 ops, a shuffle and a
// permute for two cells (the tile that rounded f32 registers took about 15
// instructions and a shuffle per cell).
#pragma once

#include <string.h>

#include "stencil_packed.cuh"

#define MG2W_COLS 64              // packed columns of each plane a warp loads: two per lane
#define MG2W_ROWS_SHALLOW 16      // loaded rows per warp at an even row halo <= MG2_SHALLOW_HALO
#define MG2W_ROWS_DEEP 32         // ... at deeper halos
// blocks per SM the instances of R loaded rows are compiled for: 8 caps a
// shallow tile at 128 registers; the deep one takes what it needs
#define MG2W_MIN_BLOCKS(R) ((R) == MG2W_ROWS_SHALLOW ? 8 : 1)
#define MG2W_QUARTER 0x3e803e80u  // the word (0.25, 0.25)
#define MG2W_FOUR 0x40804080u     // the word (4, 4)

// The column halo in packed columns: H fine columns rounded up to a
// multiple of 4 (a lane's), halved; the packed columns a warp owns.
static __host__ __device__ inline int mg2w_hp(int H) { return (H + 3) / 4 * 2; }
static __host__ __device__ inline int mg2w_cols(int H) { return MG2W_COLS - 2 * mg2w_hp(H); }

// The loaded rows of a warp at halo H.
static __host__ inline int mg2w_rows(int H) {
  return mg2_halo(H) > MG2_SHALLOW_HALO ? MG2W_ROWS_DEEP : MG2W_ROWS_SHALLOW;
}

// The launch's blocks (one Sigma r^2 partial each).
static __host__ inline dim3 mg2w_grid(int n, int H, int R) {
  return dim3(mg2_ceil(n / 2, mg2w_cols(H)), mg2_ceil(n, MG2_WARPS * (R - 2 * mg2_halo(H))));
}

// Everything a packed word leg takes: V, kind and partials (only with
// rnorm) for the up-leg, Rout for the down-leg; pairs: every word access
// is 4-byte aligned (w even, every operand aligned).
struct Mg2wArgs {
  const __nv_bfloat16* U;
  const __nv_bfloat16* F;
  const __nv_bfloat16* V;
  __nv_bfloat16* Uout;
  __nv_bfloat16* Rout;
  float* partials;
  int n, H, nu, kind;
  bool pairs;
  float mhq, inv_hsq;   // -h^2/4 and 1/h^2, f32, as the plain packed ops take them
};

// The level's constants -h^2/4 and 1/h^2, bf16 values (mg2w_launch checks
// them), as words: a product by either is one bf16x2 multiply.
struct Mg2wK {
  uint32_t w_mhq, w_inv_hsq;
  __device__ __forceinline__ Mg2wK(float m, float ih)
      : w_mhq(Mg2X2::pack(m, m)), w_inv_hsq(Mg2X2::pack(ih, ih)) {}
  __device__ __forceinline__ uint32_t by_mhq(uint32_t x) const { return Mg2X2::mul(x, w_mhq); }
  __device__ __forceinline__ uint32_t by_inv_hsq(uint32_t x) const {
    return Mg2X2::mul(x, w_inv_hsq);
  }
};

// Whether an f32 value is a bf16 value (its low 16 bits are zero).
static __host__ inline bool mg2w_is_bf16(float x) {
  uint32_t b;
  memcpy(&b, &x, sizeof b);
  return (b & 0xffffu) == 0;
}

// One warp's place on the grid.
struct Mg2wTile {
  int n, w;     // grid side, plane width n/2
  int hr, hp;   // row halo (even), column halo in packed columns (even)
  int i0;       // global row of local row 0 (even; may be negative)
  int j0;       // packed column of lane 0's low half (even; may be negative)
  int J;        // the lane's packed columns J, J + 1
  int lane;
};

template <int R>
static __device__ __forceinline__ Mg2wTile mg2w_tile(int n, int H) {
  Mg2wTile t;
  t.n = n;
  t.w = n / 2;
  t.hr = mg2_halo(H);
  t.hp = mg2w_hp(H);
  t.i0 = ((int)blockIdx.y * MG2_WARPS + (int)threadIdx.y) * (R - 2 * t.hr) - t.hr;
  t.j0 = (int)blockIdx.x * (MG2W_COLS - 2 * t.hp) - t.hp;
  t.lane = (int)threadIdx.x;
  t.J = t.j0 + 2 * t.lane;
  return t;
}

// Whether the warp owns any cell (the last block row may hold warps below
// the grid).
static __device__ __forceinline__ bool mg2w_owns(const Mg2wTile& t) {
  return t.i0 + t.hr < t.n && t.j0 + t.hp < t.w;
}

// Whether the unchecked body runs: word accesses aligned and the loaded
// region 2 or more fine cells inside the grid, so every load, every coarse
// tap (lanes 0 and 31 read columns j0 - 1 and j0 + 64) exists and no cell
// lies on the grid's edge.
template <int R>
static __device__ __forceinline__ bool mg2w_inside(const Mg2wTile& t, bool pairs) {
  return pairs && t.i0 >= 2 && t.i0 + R <= t.n - 2 && t.j0 >= 1 && t.j0 + MG2W_COLS <= t.w - 1;
}

// The lane's column facts on the checked body.
struct Mg2wCols {
  bool lo, hi;                // packed columns J and J + 1 lie in the grid
  bool first, last0, last1;   // J is the first, J or J + 1 the last packed column
  uint32_t cm;                // the halves in the grid
};

static __device__ __forceinline__ Mg2wCols mg2w_cols_of(const Mg2wTile& t) {
  const bool lo = mg_in(t.J, t.w), hi = mg_in(t.J + 1, t.w);
  return Mg2wCols{lo, hi, t.J == 0, t.J == t.w - 1, t.J + 1 == t.w - 1,
                  (lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u)};
}

// Whether the lane's word lies in the warp's interior columns (and, on the
// checked body, its low half in the grid).
template <bool kEdge>
static __device__ __forceinline__ bool mg2w_lane_owns(const Mg2wTile& t, const Mg2wCols& c) {
  const int j = 2 * t.lane;
  return j >= t.hp && j + 2 <= MG2W_COLS - t.hp && (!kEdge || c.lo);
}

static __device__ __forceinline__ uint32_t mg2w_ldg(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

static __device__ __forceinline__ uint32_t mg2w_ldg_half(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// The word at p on the checked body: 0 where its low half (lo) lies
// outside the grid, the high half 0 where it does (hi); one 4-byte load
// where the pair is whole and aligned, else two 2-byte ones.
static __device__ __forceinline__ uint32_t mg2w_fetch(const __nv_bfloat16* p, bool lo, bool hi,
                                                      bool pairs) {
  if (!lo) return 0u;
  if (hi && pairs) return mg2w_ldg(p);
  return mg2w_ldg_half(p) | (hi ? mg2w_ldg_half(p + 1) << 16 : 0u);
}

// Stores the word at p: its low half, and its high half where hi.
static __device__ __forceinline__ void mg2w_put(__nv_bfloat16* p, uint32_t v, bool hi,
                                                bool pairs) {
  if (hi && pairs) {
    *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
  reinterpret_cast<unsigned short*>(p)[0] = (unsigned short)v;
  if (hi) reinterpret_cast<unsigned short*>(p)[1] = (unsigned short)(v >> 16);
}

// A lane's red and black words of its R loaded rows (u or f).
template <int R>
struct Mg2wRegs {
  uint32_t r[R], b[R];
};

// Loads the warp's R rows of the packed X; cells outside the grid read 0.
// With kRed false the red words are 0 instead: u's red plane is dead on
// input (the sweeps' first red step overwrites every red cell of rows 1 ..
// R-2 from the black plane alone, and rows 0 and R-1, which it does not
// update, are first read by the black step after it, when they are stale
// either way), so the legs never load it.
template <int R, bool kEdge, bool kRed = true>
static __device__ __forceinline__ void mg2w_load(Mg2wRegs<R>& x, const __nv_bfloat16* __restrict__ X,
                                                 const Mg2wTile& t, const Mg2wCols& c,
                                                 bool pairs) {
  if (!kEdge) {
    const __nv_bfloat16* p = X + (size_t)t.i0 * t.n + t.J;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      x.r[i] = kRed ? mg2w_ldg(p + (size_t)i * t.n) : 0u;
      x.b[i] = mg2w_ldg(p + (size_t)i * t.n + t.w);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    uint32_t r = 0u, b = 0u;
    const int gi = t.i0 + i;
    if (c.lo && mg_in(gi, t.n)) {
      const __nv_bfloat16* p = X + (size_t)gi * t.n + t.J;
      if (kRed) r = mg2w_fetch(p, true, c.hi, pairs);
      b = mg2w_fetch(p + t.w, true, c.hi, pairs);
    }
    x.r[i] = r;
    x.b[i] = b;
  }
}

// Writes the warp's interior back to the packed n x n array.
template <int R, bool kEdge>
static __device__ __forceinline__ void mg2w_store(__nv_bfloat16* __restrict__ out,
                                                  const Mg2wRegs<R>& u, const Mg2wTile& t,
                                                  const Mg2wCols& c, bool pairs) {
  if (!mg2w_lane_owns<kEdge>(t, c)) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int gi = t.i0 + i;
    if (i < t.hr || i >= R - t.hr || (kEdge && !mg_in(gi, t.n))) continue;
    __nv_bfloat16* p = out + (size_t)gi * t.n + t.J;
    if (!kEdge) {
      *reinterpret_cast<uint32_t*>(p) = u.r[i];
      *reinterpret_cast<uint32_t*>(p + t.w) = u.b[i];
    } else {
      mg2w_put(p, u.r[i], c.hi, pairs);
      mg2w_put(p + t.w, u.b[i], c.hi, pairs);
    }
  }
}

// The partner word of word y's cells in y's plane: from the left (the left
// lane's high half, y's low half) or from the right (y's high half, the
// right lane's low half); lanes 0 and 31 get their own value's half, as
// the shuffle returns it (only the loaded region's outermost cells).
static __device__ __forceinline__ uint32_t mg2w_partner(uint32_t y, bool left) {
  if (left) return __byte_perm(__shfl_up_sync(0xffffffffu, y, 1), y, 0x5432);
  return __byte_perm(y, __shfl_down_sync(0xffffffffu, y, 1), 0x5432);
}

// One colour step: every word of plane x (red: kRed) from the other plane
// y, rows 1 .. R-2 of every lane (the trapezoid: the outer rows and lanes
// only turn inexact); red takes its partner from the left on even rows,
// black on odd ones.  On the checked body cells outside the grid keep 0.
template <bool kRed, int R, bool kEdge, class K>
static __device__ __forceinline__ void mg2w_colour(uint32_t (&x)[R], const uint32_t (&y)[R],
                                                   const uint32_t (&fx)[R], const Mg2wTile& t,
                                                   uint32_t cm, const K& k) {
  using X = Mg2X2;
#pragma unroll
  for (int i = 1; i < R - 1; ++i) {
    const uint32_t v = X::add(y[i - 1], y[i + 1]);
    const uint32_t h = X::add(y[i], mg2w_partner(y[i], kRed == ((i & 1) == 0)));
    const uint32_t s = X::add(X::mul(X::add(v, h), MG2W_QUARTER), k.by_mhq(fx[i]));
    x[i] = kEdge ? s & (mg_in(t.i0 + i, t.n) ? cm : 0u) : s;
  }
}

// nu red-black sweeps, red first.
template <int R, bool kEdge, class K>
static __device__ __forceinline__ void mg2w_sweeps(Mg2wRegs<R>& u, const Mg2wRegs<R>& f,
                                                   const Mg2wTile& t, uint32_t cm, int nu,
                                                   const K& k) {
#pragma unroll 1
  for (int s = 0; s < nu; ++s) {
    // the checked body's row tests, made anew each sweep (see mg2_sweeps)
    Mg2wTile ts = t;
    if (kEdge) asm volatile("" : "+r"(ts.i0));
    mg2w_colour<true, R, kEdge>(u.r, u.b, f.r, ts, cm, k);
    mg2w_colour<false, R, kEdge>(u.b, u.r, f.b, ts, cm, k);
  }
}

// The ghost0 residual word of plane x on row i (red: kRed), in
// ops._packed_residual's order.
template <bool kRed, int R, class K>
static __device__ __forceinline__ uint32_t mg2w_resid(const uint32_t (&x)[R],
                                                      const uint32_t (&y)[R],
                                                      const uint32_t (&fx)[R], int i,
                                                      const K& k) {
  using X = Mg2X2;
  const uint32_t nbr = X::add(X::add(X::add(y[i - 1], y[i + 1]), y[i]),
                              mg2w_partner(y[i], kRed == ((i & 1) == 0)));
  return X::sub(fx[i], k.by_inv_hsq(X::sub(nbr, X::mul(MG2W_FOUR, x[i]))));
}

// sum(r^2) of the ghost0 residual over the warp's owned cells, each bf16
// residual squared in f32.
template <int R, bool kEdge, class K>
static __device__ __forceinline__ float mg2w_rsq(const Mg2wRegs<R>& u, const Mg2wRegs<R>& f,
                                                 const Mg2wTile& t, const Mg2wCols& c,
                                                 const K& k) {
  const bool owns = mg2w_lane_owns<kEdge>(t, c);
  float acc = 0.f;
#pragma unroll
  for (int i = 1; i < R - 1; ++i) {
    if (i < t.hr || i >= R - t.hr) continue;   // the same for every lane
    const uint32_t rr = mg2w_resid<true>(u.r, u.b, f.r, i, k);
    const uint32_t rb = mg2w_resid<false>(u.b, u.r, f.b, i, k);
    if (owns && (!kEdge || mg_in(t.i0 + i, t.n))) {
      const uint32_t m = kEdge ? c.cm : 0xffffffffu;
      const float2 a = Mg2X2::unpack(rr & m), b = Mg2X2::unpack(rb & m);
      acc = __fmaf_rn(a.x, a.x, acc);
      acc = __fmaf_rn(a.y, a.y, acc);
      acc = __fmaf_rn(b.x, b.x, acc);
      acc = __fmaf_rn(b.y, b.y, acc);
    }
  }
  return acc;
}

// The ghost0 residual of the warp's interior, restricted into the UNPACKED
// (n/2 x n/2) coarse rhs: a lane's words over a row pair are its coarse
// word (Rc[I][J], Rc[I][J + 1]).
template <int R, bool kEdge, class K>
static __device__ __forceinline__ void mg2w_restrict(__nv_bfloat16* __restrict__ Rout,
                                                     const Mg2wRegs<R>& u, const Mg2wRegs<R>& f,
                                                     const Mg2wTile& t, const Mg2wCols& c,
                                                     bool pairs, const K& k) {
  using X = Mg2X2;
  const bool owns = mg2w_lane_owns<kEdge>(t, c);
#pragma unroll
  for (int i = 2; i < R - 2; i += 2) {
    if (i < t.hr || i >= R - t.hr) continue;   // the same for every lane
    const uint32_t s0 = X::add(mg2w_resid<true>(u.r, u.b, f.r, i, k),
                               mg2w_resid<false>(u.b, u.r, f.b, i, k));
    const uint32_t s1 = X::add(mg2w_resid<true>(u.r, u.b, f.r, i + 1, k),
                               mg2w_resid<false>(u.b, u.r, f.b, i + 1, k));
    const uint32_t rc = X::mul(X::add(X::add(s0, s1), 0u), MG2W_QUARTER);
    const int gi = t.i0 + i;
    if (owns && (!kEdge || mg_in(gi, t.n))) {
      __nv_bfloat16* p = Rout + (size_t)(gi / 2) * t.w + t.J;
      if (kEdge)
        mg2w_put(p, rc, c.hi, pairs);
      else
        *reinterpret_cast<uint32_t*>(p) = rc;
    }
  }
}

// up += P(V) on the warp's in-grid cells of the black plane
// (ops._packed_correction; the red plane is dead on input, mg2w_load).
// vc[k] is the lane's coarse word in coarse row i0/2 - 1 + k; (l, r) the
// coarse columns J - 1 and J + 2 of a coarse row, from the words beside
// (lanes 0 and 31 load their outer one).  Per fine row the row blend B of
// the columns the word needs, then its lane blend: on odd rows cell J with
// J - 1 and J + 1 with J ("left"), on even rows J with J + 1 and J + 1 with
// J + 2 ("right"), in f32, the pair rounded once and added as a word.
template <int R, bool kEdge>
static __device__ __forceinline__ void mg2w_correct(Mg2wRegs<R>& u, const Mg2wArgs& a,
                                                    const Mg2wTile& t, const Mg2wCols& c) {
  using X = Mg2X2;
  constexpr int K = R / 2 + 2;
  const int I0 = t.i0 / 2 - 1;
  uint32_t vc[K];
  if (!kEdge) {
    const __nv_bfloat16* p = a.V + (size_t)I0 * t.w + t.J;
#pragma unroll
    for (int k = 0; k < K; ++k) vc[k] = mg2w_ldg(p + (size_t)k * t.w);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      vc[k] = mg_in(I0 + k, t.w) ? mg2w_fetch(a.V + (size_t)(I0 + k) * t.w + t.J, c.lo, c.hi,
                                               a.pairs)
                                 : 0u;
  }
  if (a.kind == MG_INJECT) {
#pragma unroll
    for (int i = 0; i < R; ++i) u.b[i] = X::add(u.b[i], vc[i / 2 + 1]);
    return;
  }
  const bool outer = t.lane == 0 || t.lane == 31;
  const int oJ = t.J + (t.lane == 0 ? -1 : 2);
  auto sides = [&](int k, float& l, float& r) {
    const uint32_t wl = __shfl_up_sync(0xffffffffu, vc[k], 1);
    const uint32_t wr = __shfl_down_sync(0xffffffffu, vc[k], 1);
    float e = 0.f;
    if (outer && (!kEdge || (mg_in(I0 + k, t.w) && mg_in(oJ, t.w))))
      e = __uint_as_float(mg2w_ldg_half(a.V + (size_t)(I0 + k) * t.w + oJ) << 16);
    l = t.lane == 0 ? e : X::unpack(wl).y;
    r = t.lane == 31 ? e : X::unpack(wr).x;
  };
  // the lane blend's weights: (0.5, 0) where the column beside is off the grid
  const float aL = kEdge && c.first ? 0.5f : 0.75f, bL = kEdge && c.first ? 0.f : 0.25f;
  const float aR0 = kEdge && c.last0 ? 0.5f : 0.75f, bR0 = kEdge && c.last0 ? 0.f : 0.25f;
  const float aR1 = kEdge && c.last1 ? 0.5f : 0.75f, bR1 = kEdge && c.last1 ? 0.f : 0.25f;
  // coarse rows k - 1, k, k + 1 (m, c, p), rolled down the rows: the left
  // blend (odd rows) reads l of rows k and k + 1, the right one r of k and
  // k - 1, so row 0's l goes unused
  float l0, rm, lc, rc;
  sides(0, l0, rm);
  sides(1, lc, rc);
#pragma unroll
  for (int k = 1; k < K - 1; ++k) {
    float lp, rp;
    sides(k + 1, lp, rp);
    const float2 vk = X::unpack(vc[k]);
#pragma unroll
    for (int d = 0; d < 2; ++d) {   // fine row i: even rows blend up, odd rows down
      const int i = 2 * (k - 1) + d, gi = t.i0 + i;
      const bool row_edge = kEdge && (gi == 0 || gi == t.n - 1);
      const float a0 = row_edge ? 0.5f : 0.75f, b0 = row_edge ? 0.f : 0.25f;
      const float2 vo = X::unpack(vc[d ? k + 1 : k - 1]);
      const float B0 = mg2p_mix(a0, vk.x, b0, vo.x), B1 = mg2p_mix(a0, vk.y, b0, vo.y);
      uint32_t p;
      if (d) {   // left
        const float Bl = mg2p_mix(a0, lc, b0, lp);
        p = X::pack(mg2p_mix(aL, B0, bL, Bl), mg2p_mix(0.75f, B1, 0.25f, B0));
      } else {   // right
        const float Br = mg2p_mix(a0, rc, b0, rm);
        p = X::pack(mg2p_mix(aR0, B0, bR0, B1), mg2p_mix(aR1, B1, bR1, Br));
      }
      u.b[i] = X::add(u.b[i], p & (!kEdge ? 0xffffffffu : mg_in(gi, t.n) ? c.cm : 0u));
    }
    rm = rc;
    lc = lp;
    rc = rp;
  }
}

template <int R, bool kEdge>
static __device__ __forceinline__ float mg2w_pc_tile(const Mg2wArgs& a, const Mg2wTile& t) {
  const Mg2wCols c = mg2w_cols_of(t);
  const uint32_t cm = kEdge ? c.cm : 0xffffffffu;
  const Mg2wK k(a.mhq, a.inv_hsq);
  Mg2wRegs<R> u, f;
  mg2w_load<R, kEdge, false>(u, a.U, t, c, a.pairs);
  mg2w_correct<R, kEdge>(u, a, t, c);
  mg2w_load<R, kEdge>(f, a.F, t, c, a.pairs);
  mg2w_sweeps<R, kEdge>(u, f, t, cm, a.nu, k);
  mg2w_store<R, kEdge>(a.Uout, u, t, c, a.pairs);
  if (a.partials == nullptr) return 0.f;
  return mg2w_rsq<R, kEdge>(u, f, t, c, k);
}

// The packed up-leg on the n x n grid; with partials, one per block.
template <int R>
static __device__ __forceinline__ void mg2w_pc_body(const Mg2wArgs& a) {
  const Mg2wTile t = mg2w_tile<R>(a.n, a.H);
  float acc = 0.f;
  if (mg2w_owns(t))
    acc = mg2w_inside<R>(t, a.pairs) ? mg2w_pc_tile<R, false>(a, t)
                                     : mg2w_pc_tile<R, true>(a, t);
  if (a.partials != nullptr) mg2_partial(acc, a.partials);
}

template <int R, bool kEdge>
static __device__ __forceinline__ void mg2w_rr_tile(const Mg2wArgs& a, const Mg2wTile& t) {
  const Mg2wCols c = mg2w_cols_of(t);
  const uint32_t cm = kEdge ? c.cm : 0xffffffffu;
  const Mg2wK k(a.mhq, a.inv_hsq);
  Mg2wRegs<R> u, f;
  mg2w_load<R, kEdge, false>(u, a.U, t, c, a.pairs);
  mg2w_load<R, kEdge>(f, a.F, t, c, a.pairs);
  mg2w_sweeps<R, kEdge>(u, f, t, cm, a.nu, k);
  mg2w_store<R, kEdge>(a.Uout, u, t, c, a.pairs);
  mg2w_restrict<R, kEdge>(a.Rout, u, f, t, c, a.pairs, k);
}

// The packed down-leg on the n x n grid.
template <int R>
static __device__ __forceinline__ void mg2w_rr_body(const Mg2wArgs& a) {
  const Mg2wTile t = mg2w_tile<R>(a.n, a.H);
  if (!mg2w_owns(t)) return;
  if (mg2w_inside<R>(t, a.pairs))
    mg2w_rr_tile<R, false>(a, t);
  else
    mg2w_rr_tile<R, true>(a, t);
}

// Launches L::go<R> for the tile table's R on the n x n level at halo a.H
// (a.pairs set here from the operands and w); returns the launch's error,
// cudaErrorInvalidValue where -h^2/4 or 1/h^2 is no bf16 value.
template <class L>
static __host__ int mg2w_launch(Mg2wArgs a, cudaStream_t stream) {
  if (!mg2w_is_bf16(a.mhq) || !mg2w_is_bf16(a.inv_hsq)) return (int)cudaErrorInvalidValue;
  const int R = mg2w_rows(a.H);
  const dim3 grid = mg2w_grid(a.n, a.H, R), block(32, MG2_WARPS);
  a.pairs = (a.n / 2) % 2 == 0 && mg2_aligned<__nv_bfloat16>(a.U, a.F, a.V, a.Uout, a.Rout);
  if (R == MG2W_ROWS_DEEP)
    L::template go<MG2W_ROWS_DEEP>(grid, block, stream, a);
  else
    L::template go<MG2W_ROWS_SHALLOW>(grid, block, stream, a);
  return (int)cudaGetLastError();
}
