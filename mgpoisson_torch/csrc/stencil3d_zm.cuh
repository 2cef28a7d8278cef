// The z-marching (2.5D) tile of the 3D legs, K5 mg_smooth_rr3d and K6
// mg_prolong_correct_smooth3d and their strip entries K11 mg_sharded_rr3d
// and K12 mg_sharded_pc3d (kStrips, on a rank's block), and K4
// mg_smooth3d (kSmooth: the sweeps alone), at halos H <= MG3Z_MAX_HALO
// (the tuned scheme's K5 at H = 4, K6 at 3 and with rnorm at 4, K4 at 3;
// the fast scheme's rbgs nu = 1 at 2 and 3).  Deeper halos keep the cube
// tile of stencil3d.cuh.
//
// A block owns an xy column of T x T interior cells (T = 32 - 2H) and a
// chunk of its z planes (mg3z_chunk: the whole column at 256^3).  It loads
// the column's plane with a halo of H on both xy axes, one thread per
// loaded cell (a warp per loaded row of 32 cells: lane = x, warp = y), and
// marches z from H planes below its chunk to H planes above it.  The nu
// sweeps run as a pipeline of stages: stage 0 is the loaded (for K6,
// corrected) plane; stage s (sweep s, or red-black colour step s, the
// colour being the GLOBAL (z + y + x) % 2, colour 0 first) computes plane
// k - s of the march from stage s - 1's planes k - s - 1 ... k - s + 1.  A
// residual stage follows where the leg needs one (K5; K6 with rnorm).
// Stage s is exact on rows and lanes [s, 31 - s] and on march planes
// [s, last - s] (the deep-halo trapezoid of stencil.cuh, here in xy and in
// z at the ends of the chunk), so the interior is exact at the last stage;
// warps outside a stage's rows skip it, and no thread tests a tile bound.
//
// Storage: each thread keeps, per stage, its column's last three planes
// (z - 1, z, z + 1) and the f queue (f at planes k ... k - steps - 1) in
// registers.  The x neighbours come from the lanes beside (__shfl), the y
// neighbours from one shared plane per stage, double-buffered by march
// step: stage s writes plane k - s into buffer k % 2 while stage s + 1
// reads plane k - s - 1 from buffer (k + 1) % 2, so one __syncthreads()
// per plane orders them.  K5 keeps its residual planes in a ring of four
// for the 2x2x2 restriction, done one step later on the odd planes; K6
// keeps a ring of three coarse planes of V for the +-1 trilinear tap and
// loads one plane ahead on odd fine planes.  K4 has neither, and its last
// stage (no residual reads it) no shared plane: its halo is the step
// count.  Global loads of the next plane are issued one step ahead.
// Shared memory: 2 (steps + 1) planes of 4 KB (K4: 2 steps), plus K5's
// 16 KB ring or K6's 4.3 KB coarse ring: at most 48 KB.
//
// Redundancy at H = 4: (32 / 24)^2 = 1.78 loaded cells per interior cell
// in xy and (256 + 8) / 256 = 1.03 in z at 256^3 (the cube tile: 3.4 and
// 2.0).
//
// The least time on an H100 is set by HBM bytes (K5 3.125 arrays, 2.125
// from zero, K6 3.125), but what holds these kernels is issue: ~22
// instructions per loaded cell and stage (14 of them the plain ops' own
// rounded adds and multiplies), one 1024-thread block per SM at 40-64
// registers, so ~85 % of the issue slots are taken at 256^3 and the legs
// sit at 18-33 % of the byte bound.  The instances are templates on the
// step count, smoother and bc, and ptxas is kept from rebuilding the
// per-thread stage mask, face multipliers and trilinear weights in every
// stage: left to itself it does, and K5 then takes 1.7x as long.
//
// Arithmetic: as stencil.cuh, every add and multiply rounded on its own
// (__fadd_rn, __fmul_rn) in the order of mgpoisson_torch/kernels/ops.py
// (neighbor_sum's z, y, x with face's subtractions after each axis pair;
// the Jacobi form; wjacobi's u + omega (jac - u); residual f - (nbr/h^2 +
// adiag u); prolong's 2^3 taps, x fastest, weights multiplied in axis
// order), so u, R and the corrected u equal the plain ops bit for bit.
// Only sum(r^2) is summed in another order (one partial per block).
//
// The bf16 forms of K5/K6 and K11/K12 run this march on bf16x2 words, a
// thread's pair of x cells in one register and every op one bf16x2
// instruction: the word tile of stencil3d_zw.cuh, with a geometry, chunk
// table and launch of its own.  Here are only the arguments and strips
// they share with the entries (Mg3zArgsBf16, Mg3zStripsBf16, structs of
// their own so that Mg3zArgs, Mg3zStrips and every f32 kernel parameter
// stay as they were) and their launches' declarations; their instances
// have sources of their own (mg_smooth_rr3d_bf16.cu,
// mg_prolong_correct_smooth3d_bf16.cu, mg_sharded_rr3d_zm_bf16.cu,
// mg_sharded_pc3d_zm_bf16.cu), so nvcc builds them beside the f32 ones.
#pragma once

#include "stencil3d.cuh"

#define MG3Z_COLS 32        // loaded cells per row: one per lane
#define MG3Z_ROWS 32        // loaded rows per plane: one warp each
#define MG3Z_THREADS (MG3Z_COLS * MG3Z_ROWS)
#define MG3Z_PLANE (MG3Z_COLS * MG3Z_ROWS)
#define MG3Z_MAX_HALO 4     // the deepest halo this tile takes
#define MG3Z_SMS 132        // the H100's SMs, for which the chunk table is tuned
#define MG3Z_MIN_CHUNK 32   // the fewest planes per block the table picks
#define MG3Z_CSIDE (MG3Z_ROWS / 2 + 3)   // side of one of K6's coarse planes

// Whether the legs run this tile at halo H (else the cube tile); mirrored
// by kernels/cuda.py zmarch3d.
static __host__ __device__ inline bool mg3z_takes(int H) { return H <= MG3Z_MAX_HALO; }

// Interior cells per block side at halo H (mirrored by kernels/cuda.py
// tile3d_zm).
static __host__ __device__ inline int mg3z_side(int H) { return MG3Z_COLS - 2 * H; }

// The chunk table: planes per block on a block of nzl planes of nyl rows
// of n cells at halo H (mirrored by kernels/cuda.py zm_chunk; the whole
// n^3 grid is nzl = nyl = n).  One 1024-thread block runs per SM, so a
// launch over ceil(n/T) ceil(nyl/T) columns takes ceil(blocks / SMs)
// rounds of a block's march of c + 2H planes; the table picks the chunk c
// (nzl, nzl/2, ... down to MG3Z_MIN_CHUNK) with the fewest plane-steps in
// all, the larger on a tie.  At 256^3 that is the whole column (H = 4: 121
// blocks in one round of 264 planes, not 4 rounds of 72 at 64 planes), at
// 512^3 128 planes; on a (128, 128, 256) block of 256^3 on a (2, 2) mesh
// 64 planes (132 blocks, one round of 72).
static __host__ __device__ inline int mg3z_chunk(int n, int nyl, int nzl, int H) {
  const int T = mg3z_side(H);
  const long long cols = (long long)((n + T - 1) / T) * ((nyl + T - 1) / T);
  int best = nzl;
  long long best_cost = -1;
  for (int c = nzl; c >= 1 && nzl % c == 0 && (c == nzl || c >= MG3Z_MIN_CHUNK); c /= 2) {
    const long long blocks = cols * (nzl / c);
    const long long cost = (blocks + MG3Z_SMS - 1) / MG3Z_SMS * (c + 2 * H);
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
static __host__ inline dim3 mg3z_grid(const Mg3Block& b, int H, int chunk) {
  const int T = mg3z_side(H);
  return dim3((b.n + T - 1) / T, (b.nyl + T - 1) / T, (b.nzl + chunk - 1) / chunk);
}

// Dynamic shared memory of one block: the stages' double-buffered planes
// (K4's, `smooth`, but for its last stage), K5's residual ring (rr), K6's
// coarse ring (pc).
static __host__ inline size_t mg3z_bytes(int steps, bool rr, bool pc, bool smooth = false) {
  size_t floats = (size_t)(smooth ? steps : steps + 1) * 2 * MG3Z_PLANE;
  if (rr) floats += 4 * MG3Z_PLANE;
  if (pc) floats += 3 * MG3Z_CSIDE * MG3Z_CSIDE;
  return floats * sizeof(float);
}

// Everything a z-marching leg takes besides its template arguments (step
// count, smoother, bc), its arrays of element type T (bf16: the word
// tile's legs).  U == nullptr: u identically zero (K5's from-zero flag); V
// and kind only for K6, Rout only for K5; partials (K6's rnorm) null or
// one f32 per block.
template <class T>
struct Mg3zArgsOf {
  const T* U;
  const T* F;
  const T* V;
  T* Uout;
  T* Rout;
  float* partials;
  int n, H, chunk, kind;
  float inv_hsq, inv_adiag, adiag;
  // the word tile's (stencil3d_zw.cuh mg3w_launch sets them): whether
  // 1/h^2 and adiag are bf16 values, and then each as a bf16x2 word
  int exact;
  uint32_t w_inv_hsq, w_adiag;
};
using Mg3zArgsBf16 = Mg3zArgsOf<__nv_bfloat16>;
// The f32 legs' arguments, the same fields in a struct of their own: a
// kernel parameter derived from Mg3zArgsOf<float> reorders the f32
// instances' machine code (bench/sass_diff.py), and this name keeps their
// symbols.
struct Mg3zArgs {
  const float* U;
  const float* F;
  const float* V;
  float* Uout;
  float* Rout;
  float* partials;
  int n, H, chunk, kind;
  float inv_hsq, inv_adiag, adiag;
};

// One stage's last three planes at a thread's column.
struct Mg3zWin {
  float lo, c, hi;
};

// Neighbour sum in ops.neighbor_sum's order.  With kFace, the cell's own
// value is subtracted after each axis pair on the grid's edge planes of
// that axis: mz, my, mx are -1 there and 0 elsewhere (n >= 2, so a cell
// lies on at most one edge per axis), and fma(c, -1, acc) rounds acc - c
// as the plain op's subtraction does.
template <bool kFace>
static __device__ __forceinline__ float mg3z_nbr(const Mg3zWin& w, float ylo, float yhi,
                                                 float xlo, float xhi, float mz, float my,
                                                 float mx) {
  const float c = w.c;
  float acc = __fadd_rn(w.lo, w.hi);
  if (kFace) acc = __fmaf_rn(c, mz, acc);
  acc = __fadd_rn(acc, __fadd_rn(ylo, yhi));
  if (kFace) acc = __fmaf_rn(c, my, acc);
  acc = __fadd_rn(acc, __fadd_rn(xlo, xhi));
  if (kFace) acc = __fmaf_rn(c, mx, acc);
  return acc;
}

// A strip-fed leg's block and strips (K11, K12): the rank's (nzl, nyl, n)
// block at global (z0, y0) (stencil3d.cuh Mg3Block) and its u, f and, for
// K12, V strips (Mg3Strips; V's coarse: (DV, nyl/2, n/2) top and bot,
// (nzl/2 + 2 DV, DV, n/2) left and right).  The whole-grid legs take none.
struct Mg3zStrips {
  Mg3Block blk;
  Mg3Strips us, fs, vs;
};

// The same with bf16 strips (the bf16 forms of K11/K12).
struct Mg3zStripsBf16 {
  Mg3Block blk;
  Mg3StripsBf16 us, fs, vs;
};

// The strip-fed leg's strips of element type T: Mg3zStripsOf<float> is
// Mg3zStrips.
template <class T>
struct Mg3zStripsFor {
  using type = Mg3zStrips;
};
template <>
struct Mg3zStripsFor<__nv_bfloat16> {
  using type = Mg3zStripsBf16;
};
template <class T>
using Mg3zStripsOf = typename Mg3zStripsFor<T>::type;

// kStrips: the address of block plane z (-D <= z < nzl + D) in column
// (yb, x) of an array fed by strips: the body or its top or bot strip for
// a row of the block (0 <= yb < nyl), the left or right strip for a row
// of the y halo.  Computed only at a switch of source; the march adds a
// plane stride, nyl * n or D * n, in between.  T: the element type of the
// body and of the strips S (Mg3StripsOf<T>).
template <class T, class S>
static __device__ __forceinline__ const T* mg3z_src(const T* body, const S& s, int z, int yb,
                                                    int x, int nzl, int nyl, int n) {
  const long long D = s.D, pl = (long long)nyl * n;
  if (yb >= 0 && yb < nyl) {
    const long long c = (long long)yb * n + x;
    if (z < 0) return s.top + (z + D) * pl + c;
    if (z < nzl) return body + z * pl + c;
    return s.bot + (z - nzl) * pl + c;
  }
  const T* side = yb < 0 ? s.left : s.right;
  return side + ((z + D) * D + (yb < 0 ? yb + D : yb - nyl)) * n + x;
}

// kStrips: K12's coarse cell (Z, cy, cx) of V, global index, from V's
// block and coarse strips; 0 outside the grid (c_in: the column is inside)
// and beyond the strips, where the ring's last prefetch may lie (one plane
// past the bottom strip at H = 4).  T: V's element type, B its
// Mg3zStripsOf<T>; the value in f32.
template <class T, class B>
static __device__ __forceinline__ float mg3z_coarse(const T* V, const B& b, bool c_in, int Z,
                                                    int cy, int cx) {
  const Mg3Block& k = b.blk;
  const int nc = k.n / 2;
  return c_in && mg_in(Z, nc) ? mg3_fetch(V, b.vs, Z - k.z0 / 2, cy - k.y0 / 2, cx, k.nzl / 2,
                                          k.nyl / 2, nc)
                              : 0.f;
}

// The leg of one block: K5 (kRR: sweeps, residual with the level's bc,
// restriction), K6 (correction, sweeps, and with partials the zero-ghost
// sum(r^2)) or K4 (kSmooth, with kRR false: the sweeps alone, at the
// halo STEPS; V, kind, partials and Rout unread).  STEPS =
// mg_steps(nu, smoother), kSm the smoother
// (any at STEPS = 0), kFace the level's bc.  With kStrips the leg runs on a
// rank's block (K11, K12; `b`): the launch grid covers the block, the
// GLOBAL index (the block's origin added) decides inside/outside, the
// edges, the colour and the trilinear weights, the BLOCK index addresses
// the arrays, the stores and K11's R, and the halo comes from the strips.
// Without it every block-index term below is the global one, and the code
// is the whole-grid leg's (b unread).
template <int STEPS, int kSm, bool kFace, bool kRR, bool kStrips, bool kSmooth = false>
static __device__ __forceinline__ void mg3z_leg(const Mg3zArgs& a, const Mg3zStrips& b) {
  constexpr bool kPC = !kRR && !kSmooth;   // K6: the coarse ring and the correction
  extern __shared__ float smem[];
  constexpr int W = MG3Z_COLS, R = MG3Z_ROWS, P = MG3Z_PLANE, CS = MG3Z_CSIDE;
  const int l = (int)threadIdx.x, j = (int)threadIdx.y, me = j * W + l;
  const int n = a.n, H = a.H, T = W - 2 * H;
  const int x0 = (int)blockIdx.x * T, y0 = (int)blockIdx.y * T, z0 = (int)blockIdx.z * a.chunk;
  // the block's extents and origin; yb, zb0: this thread's row and the
  // march's first plane in the block's index
  const int nzl = kStrips ? b.blk.nzl : n, nyl = kStrips ? b.blk.nyl : n;
  const int oz = kStrips ? b.blk.z0 : 0, oy = kStrips ? b.blk.y0 : 0;
  const int yb = y0 - H + j, zb0 = z0 - H;
  const int gx = x0 - H + l, gy = kStrips ? oy + yb : yb, gz0 = kStrips ? oz + zb0 : zb0;
  const int zl = min(a.chunk, nzl - z0);   // planes this block owns
  const bool in_xy = mg_in(gx, n) && mg_in(gy, n);
  const bool owns_xy = in_xy && l >= H && l < W - H && j >= H && j < R - H &&
                       (!kStrips || yb < nyl);
  // kStrips: whether the row has a source (the block's rows and the D of
  // the strips on each side); a cell of the grid beyond them reads 0 and
  // is never stored, and no owned cell depends on it (D >= H)
  const int D = kStrips ? b.fs.D : 0;
  const bool src = !kStrips || (yb >= -D && yb < nyl + D);
  const bool y0e = gy == 0, y1e = gy == n - 1, x0e = gx == 0, x1e = gx == n - 1;
  float my = y0e || y1e ? -1.f : 0.f, mx = x0e || x1e ? -1.f : 0.f;
  asm volatile("" : "+f"(my), "+f"(mx));   // kept, not rebuilt per stage
  const bool res = kRR || (!kSmooth && a.partials != nullptr);
  const size_t nn = (size_t)n * n, col = in_xy ? (size_t)gy * n + gx : 0;
  const float* __restrict__ U = a.U;
  const float* __restrict__ F = a.F;

  float* sh = smem;                               // [STEPS + 1][2][P]
  float* rsh = sh + (STEPS + 1) * 2 * P;          // K5: [4][P]
  float* cv = rsh + (kRR ? 4 * P : 0);            // K6: [3][CS * CS]

  // K6: the thread's coarse cell and trilinear weights, and the coarse
  // cell it loads into the ring (the first CS * CS threads)
  const int nc = n / 2;
  const int cy0 = kStrips ? (oy >> 1) + ((y0 - H) >> 1) - 1 : ((y0 - H) >> 1) - 1,
            cx0 = ((x0 - H) >> 1) - 1;
  int cbase = ((gy >> 1) - cy0) * CS + ((gx >> 1) - cx0);
  int dyo = (gy & 1) ? CS : -CS, dxo = (gx & 1) ? 1 : -1;
  // the y and x weight products of the 4 xy taps, (a1 a2, a1 b2, b1 a2,
  // b1 b2): every weight is a dyadic 0, 1/4, 1/2 or 3/4, so each product
  // is exact and ((wz wy) wx) = wz (wy wx) bit for bit
  const float a1 = (y0e || y1e) ? 0.5f : 0.75f, b1 = (y0e || y1e) ? 0.f : 0.25f;
  const float a2 = (x0e || x1e) ? 0.5f : 0.75f, b2 = (x0e || x1e) ? 0.f : 0.25f;
  float qaa = a1 * a2, qab = a1 * b2, qba = b1 * a2, qbb = b1 * b2;
  if (kPC) asm volatile("" : "+r"(cbase), "+r"(dyo), "+r"(dxo), "+f"(qaa), "+f"(qab),
                        "+f"(qba), "+f"(qbb));
  const bool loads_c = kPC && me < CS * CS;
  const int ly = me / CS, lx = me - (me / CS) * CS;
  const bool c_in = loads_c && mg_in(cy0 + ly, nc) && mg_in(cx0 + lx, nc);
  const size_t ccol = c_in ? (size_t)(cy0 + ly) * nc + (cx0 + lx) : 0;
  const auto slot = [](int Z) { return (Z + 6) % 3; };
  const auto coarse = [&](int Z) {
    return c_in && mg_in(Z, nc) ? __ldg(a.V + (size_t)Z * nc * nc + ccol) : 0.f;
  };
  if (loads_c) {
    const int Zf = gz0 >> 1;
    for (int Z = Zf - 1; Z <= Zf + 1; ++Z) {
      if constexpr (kStrips)
        cv[slot(Z) * CS * CS + me] = mg3z_coarse(a.V, b, c_in, Z, cy0 + ly, cx0 + lx);
      else
        cv[slot(Z) * CS * CS + me] = coarse(Z);
    }
  }
  if (kPC) __syncthreads();

  // K5: the coarse cell (cy, cx) of the block's that this thread
  // restricts, its first fine cell in the plane and its coarse index
  const int T2 = T / 2, cyr = me / T2, cxr = me - (me / T2) * T2;
  const int c_at = (H + 2 * cyr) * W + H + 2 * cxr;
  const int ncy = kStrips ? nyl / 2 : nc;   // coarse rows of the block
  const bool owns_c = kRR && me < T2 * T2 && mg_in(y0 / 2 + cyr, ncy) && mg_in(x0 / 2 + cxr, nc);
  const size_t c_out = owns_c ? (size_t)(y0 / 2 + cyr) * nc + (x0 / 2 + cxr) : 0;

  // per-thread stage mask, kept opaque so that ptxas does not rebuild it
  // from the tile origin in every stage: bit 0 where the cell lies in the
  // grid's xy (and has a source), bit s (1 <= s <= STEPS) where stage s updates it (inside
  // the stage's shrinking rows and lanes), bit STEPS + 1 where the cell is
  // owned (the stored u and the residual stage)
  unsigned act = in_xy && src ? 1u : 0u;
#pragma unroll
  for (int s = 1; s <= STEPS; ++s)
    if (in_xy && l >= s && l < W - s && j >= s && j < R - s) act |= 1u << s;
  if (owns_xy) act |= 1u << (STEPS + 1);
  asm volatile("" : "+r"(act));
  const bool has_u = U != nullptr;
  const int pxy = (gy + gx) & 1;   // red-black colour of the column at z = 0

  // running pointers: u and f of the next plane to load, the output
  // plane, and their plane strides (kStrips: the loads' is the source's)
  const long long nnl = (long long)nn;
  const float* pU;
  const float* pF;
  float* pO;
  long long pl, plo;
  if constexpr (kStrips) {
    pl = yb >= 0 && yb < nyl ? (long long)nyl * n : (long long)D * n;
    plo = (long long)nyl * n;
    pF = mg3z_src(F, b.fs, zb0, yb, gx, nzl, nyl, n);
    pU = has_u ? mg3z_src(U, b.us, zb0, yb, gx, nzl, nyl, n) : pF;
    pO = a.Uout + ((long long)(zb0 - STEPS) * nyl + yb) * n + gx;
  } else {
    const long long off0 = (long long)gz0 * nnl + (long long)col;
    pl = plo = nnl;
    pU = (has_u ? U : F) + off0;
    pF = F + off0;
    pO = a.Uout + (off0 - STEPS * nnl);
  }
  float pu = has_u && in_xy && src && mg_in(gz0, n) ? __ldg(pU) : 0.f;
  float pf = in_xy && src && mg_in(gz0, n) ? __ldg(pF) : 0.f;

  Mg3zWin w[STEPS + 1];
  float fq[STEPS + 2];   // fq[i]: f at march plane k - i
#pragma unroll
  for (int s = 0; s <= STEPS; ++s) w[s] = Mg3zWin{0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < STEPS + 2; ++i) fq[i] = 0.f;
  float acc = 0.f;   // K6 rnorm: sum of r^2 over the owned cells

  const int planes = zl + 2 * H, steps_end = planes + (kRR ? 1 : 0);
#pragma unroll 1
  for (int k = 0; k < steps_end; ++k) {
    const int gz = gz0 + k, cp = (k & 1) * P;
    float* wr = sh + me + cp;              // this step's buffer: stage s at wr[2 s P]
    const float* rd = sh + me + (P - cp);  // the last step's
    // stage 0: plane k, loaded one step ahead (K6: corrected by P(V))
    float v0 = pu;
    const float fnew = pf;
    pU += pl;
    pF += pl;
    if constexpr (kStrips) {   // the rows of the block switch source here
      const int zb = zb0 + k + 1;
      if (zb == 0 || zb == nzl) {
        pF = mg3z_src(F, b.fs, zb, yb, gx, nzl, nyl, n);
        pU = has_u ? mg3z_src(U, b.us, zb, yb, gx, nzl, nyl, n) : pF;
      }
    }
    const bool zn = (act & 1u) && mg_in(gz + 1, n) && (!kStrips || zb0 + k + 1 < nzl + D);
    pu = has_u && zn ? __ldg(pU) : 0.f;
    pf = zn ? __ldg(pF) : 0.f;
    float cnext = 0.f;
    const bool c_step = kPC && (gz & 1);   // odd fine plane: the next coarse plane
    if (c_step && loads_c) {
      if constexpr (kStrips)
        cnext = mg3z_coarse(a.V, b, c_in, (gz >> 1) + 2, cy0 + ly, cx0 + lx);
      else
        cnext = coarse((gz >> 1) + 2);
    }
    if constexpr (kPC) {
      if ((act & 1u) && mg_in(gz, n)) {
        const int Z = gz >> 1;
        const float* cc = cv + slot(Z) * CS * CS + cbase;
        float p = cc[0];
        if (a.kind != MG_INJECT) {
          const int dz = (slot(Z + ((gz & 1) ? 1 : -1)) - slot(Z)) * CS * CS;
          const bool ez = gz == 0 || gz == n - 1;
          const float a0 = ez ? 0.5f : 0.75f, b0 = ez ? 0.f : 0.25f;
          const float R0 = p;
          p = __fmul_rn(__fmul_rn(a0, qaa), R0);
          p = __fadd_rn(p, __fmul_rn(__fmul_rn(a0, qab), cc[dxo]));
          p = __fadd_rn(p, __fmul_rn(__fmul_rn(a0, qba), cc[dyo]));
          p = __fadd_rn(p, __fmul_rn(__fmul_rn(a0, qbb), cc[dyo + dxo]));
          p = __fadd_rn(p, __fmul_rn(__fmul_rn(b0, qaa), cc[dz]));
          p = __fadd_rn(p, __fmul_rn(__fmul_rn(b0, qab), cc[dz + dxo]));
          p = __fadd_rn(p, __fmul_rn(__fmul_rn(b0, qba), cc[dz + dyo]));
          p = __fadd_rn(p, __fmul_rn(__fmul_rn(b0, qbb), cc[dz + dyo + dxo]));
        }
        v0 = __fadd_rn(v0, p);
      } else {
        v0 = 0.f;
      }
    }
#pragma unroll
    for (int i = STEPS + 1; i > 0; --i) fq[i] = fq[i - 1];
    fq[0] = fnew;
    w[0] = Mg3zWin{w[0].c, w[0].hi, v0};
    if (STEPS > 0 || res) wr[0] = v0;

    // stages 1 .. STEPS: the sweeps, stage s on plane k - s; the shuffles
    // run in every lane, the update where the stage mask says
#pragma unroll
    for (int s = 1; s <= STEPS; ++s) {
      const int gzs = gz - s;
      const float c = w[s - 1].c;
      const float xlo = __shfl_up_sync(0xffffffffu, c, 1);
      const float xhi = __shfl_down_sync(0xffffffffu, c, 1);
      float v = c;
      if (((act >> s) & 1u) && mg_in(gzs, n)) {
        const float* prev = rd + (s - 1) * 2 * P;
        const float mz = gzs == 0 || gzs == n - 1 ? -1.f : 0.f;
        const float nbr = mg3z_nbr<kFace>(w[s - 1], prev[-W], prev[W], xlo, xhi, mz, my, mx);
        const float jac = __fmul_rn(__fsub_rn(fq[s], __fmul_rn(nbr, a.inv_hsq)), a.inv_adiag);
        if (kSm == MG_WJACOBI)
          v = __fadd_rn(c, __fmul_rn(MG3_OMEGA, __fsub_rn(jac, c)));
        else if (kSm == MG_RBGS)
          v = ((gzs & 1) ^ pxy) == ((s - 1) & 1) ? jac : c;
        else
          v = jac;
      }
      w[s] = Mg3zWin{w[s].c, w[s].hi, v};
      if (s < STEPS || res) wr[s * 2 * P] = v;
    }

    // the smoothed u of plane k - STEPS
    {
      const int p = k - STEPS;
      if (((act >> (STEPS + 1)) & 1u) && p >= H && p < H + zl) *pO = w[STEPS].hi;
      pO += plo;
    }

    // the residual stage on plane k - STEPS - 1: K5 with the level's bc
    // into the ring, K6 zero-ghost into sum(r^2)
    if (res) {
      const int p = k - STEPS - 1, gzr = gz0 + p;
      const float c = w[STEPS].c;
      const float xlo = __shfl_up_sync(0xffffffffu, c, 1);
      const float xhi = __shfl_down_sync(0xffffffffu, c, 1);
      float r = 0.f;
      if (((act >> (STEPS + 1)) & 1u) && mg_in(gzr, n)) {
        const float* prev = rd + STEPS * 2 * P;
        const float mz = gzr == 0 || gzr == n - 1 ? -1.f : 0.f;
        const float nbr =
            mg3z_nbr<kRR && kFace>(w[STEPS], prev[-W], prev[W], xlo, xhi, mz, my, mx);
        r = __fsub_rn(fq[STEPS + 1],
                      __fadd_rn(__fmul_rn(nbr, a.inv_hsq), __fmul_rn(a.adiag, c)));
        if (!kRR && p >= H && p < H + zl) acc = __fmaf_rn(r, r, acc);
      }
      if (kRR) rsh[(p & 3) * P + me] = r;
    }

    // K5: restrict the pair of planes that ends at march plane k - STEPS
    // - 2, an odd global plane, whose residual the last step wrote; the
    // block's (T/2)^2 coarse cells go to its first threads, (cy, cx) each
    if constexpr (kRR) {
      const int q = k - STEPS - 2, gq = gz0 + q;
      if (q >= H && q < H + zl && (gq & 1) && owns_c) {
        const float* r0 = rsh + ((q - 1) & 3) * P + c_at;
        const float* r1 = rsh + (q & 3) * P + c_at;
        float r8[8] = {r0[0], r0[1], r0[W], r0[W + 1], r1[0], r1[1], r1[W], r1[W + 1]};
        a.Rout[(size_t)((kStrips ? gq - oz : gq) >> 1) * ncy * nc + c_out] =
            __fmul_rn(mg3_sum8(r8), 0.125f);
      }
    }
    if (c_step && loads_c) cv[slot((gz >> 1) + 2) * CS * CS + me] = cnext;
    __syncthreads();
  }

  if (kRR || kSmooth || a.partials == nullptr) return;
  // one f32 partial per block: each warp's sum by a butterfly, then the
  // warps' in order; the same sum every run
  __shared__ float red[MG3Z_ROWS];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (l == 0) red[j] = acc;
  __syncthreads();
  if (me == 0) {
    float s = red[0];
    for (int i = 1; i < MG3Z_ROWS; ++i) s = __fadd_rn(s, red[i]);
    a.partials[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
  }
}

using Mg3zKernel = void (*)(Mg3zArgs);                // the whole grid
using Mg3zKernelBf16 = void (*)(Mg3zArgsBf16);        // the whole grid, bf16
using Mg3zStripKernel = void (*)(Mg3zArgs, Mg3zStrips);  // a rank's block
using Mg3zStripKernelBf16 = void (*)(Mg3zArgsBf16, Mg3zStripsBf16);  // a rank's block, bf16

// The instance of a leg's kernel template K<STEPS, kSm, kFace> for a step
// count, smoother and bc known at run time: every step count up to
// kMaxSteps for the Jacobi variants, the even ones for red-black GS (2 nu);
// STEPS = 0 (no sweep) is one instance for every smoother.  Null for any
// other.
template <template <int, int, bool> class K>
using Mg3zFn = decltype(K<0, MG_JACOBI, false>::fn());

template <template <int, int, bool> class K, int S, int kSm>
static __host__ Mg3zFn<K> mg3z_bc(int bc) {
  return bc == MG_FACE ? K<S, kSm, true>::fn() : K<S, kSm, false>::fn();
}

template <template <int, int, bool> class K, int S, int kMaxSteps>
static __host__ Mg3zFn<K> mg3z_pick_from(int steps, int smoother, int bc) {
  if constexpr (S > kMaxSteps) {
    return nullptr;
  } else {
    if (steps != S) return mg3z_pick_from<K, S + 1, kMaxSteps>(steps, smoother, bc);
    if constexpr (S == 0) {
      return mg3z_bc<K, 0, MG_JACOBI>(bc);
    } else {
      if (smoother == MG_JACOBI) return mg3z_bc<K, S, MG_JACOBI>(bc);
      if (smoother == MG_WJACOBI) return mg3z_bc<K, S, MG_WJACOBI>(bc);
      if constexpr (S % 2 == 0) {
        if (smoother == MG_RBGS) return mg3z_bc<K, S, MG_RBGS>(bc);
      }
      return nullptr;
    }
  }
}

// Opts `kernel` (null: no instance for the step count and smoother) in to
// its dynamic shared memory and launches it on the block `blk` (the whole
// grid: {n, n, n, 0, 0}) at halo a.H, which the caller has checked with
// mg3z_takes, with the arguments `args`; returns a cudaError_t.
template <class Kernel, class A, class... Args>
static __host__ inline int mg3z_launch(Kernel kernel, const Mg3Block& blk, const A& a,
                                       size_t bytes, cudaStream_t stream, Args... args) {
  if (kernel == nullptr || blk.n < 2 || (blk.n & 1) || blk.nzl < 2 || blk.nyl < 2 ||
      (blk.nzl | blk.nyl | blk.z0 | blk.y0) & 1 || a.chunk < 1 || blk.nzl % a.chunk)
    return (int)cudaErrorInvalidValue;
  const int rc = (int)cudaFuncSetAttribute((const void*)kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
  if (rc != 0) return rc;
  kernel<<<mg3z_grid(blk, a.H, a.chunk), dim3(MG3Z_COLS, MG3Z_ROWS), bytes, stream>>>(a,
                                                                                      args...);
  return (int)cudaGetLastError();
}

// The strip instances of K11 and K12 (kStrips), each source of its own so
// that nvcc builds them beside the whole-grid legs (mg_sharded_rr3d_zm.cu,
// mg_sharded_pc3d_zm.cu); null where no instance takes the step count and
// smoother.
Mg3zStripKernel mg_sharded_rr3d_zm_pick(int steps, int smoother, int bc);
Mg3zStripKernel mg_sharded_pc3d_zm_pick(int steps, int smoother, int bc);

// The bf16 forms of K5, K6, K11 and K12 on the word tile of
// stencil3d_zw.cuh, each in a source of its own (mg_smooth_rr3d_bf16.cu,
// mg_prolong_correct_smooth3d_bf16.cu, mg_sharded_rr3d_zm_bf16.cu,
// mg_sharded_pc3d_zm_bf16.cu) for the same reason: each launches its
// instance for the step count, smoother and bc on the block `blk` at halo
// a.H (the chunk its own, a.chunk unread) with the strips b (K11, K12);
// returns a cudaError_t, cudaErrorInvalidValue where no instance takes the
// step count and smoother.
int mg_rr3d_zw_launch(const Mg3Block& blk, Mg3zArgsBf16 a, int steps, int smoother, int bc,
                      cudaStream_t stream);
int mg_pc3d_zw_launch(const Mg3Block& blk, Mg3zArgsBf16 a, int steps, int smoother, int bc,
                      cudaStream_t stream);
int mg_sharded_rr3d_zw_launch(const Mg3Block& blk, Mg3zArgsBf16 a, int steps, int smoother,
                              int bc, cudaStream_t stream, const Mg3zStripsBf16& b);
int mg_sharded_pc3d_zw_launch(const Mg3Block& blk, Mg3zArgsBf16 a, int steps, int smoother,
                              int bc, cudaStream_t stream, const Mg3zStripsBf16& b);

// K4's launches on the whole grid, f32 on this tile and bf16 on the word
// tile, each in a source of its own (mg_smooth3d_zm.cu, mg_smooth3d_zw.cu)
// for the same reason: the instance of the sweeps alone for the step count
// (the halo a.H), smoother and bc; a cudaError_t, cudaErrorInvalidValue
// where no instance takes the step count and smoother.
int mg_smooth3d_zm_launch(const Mg3Block& blk, Mg3zArgs a, int steps, int smoother, int bc,
                          cudaStream_t stream);
int mg_smooth3d_zw_launch(const Mg3Block& blk, Mg3zArgsBf16 a, int steps, int smoother, int bc,
                          cudaStream_t stream);
