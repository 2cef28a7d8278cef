// K6 mg_prolong_correct_smooth3d and K12 mg_sharded_pc3d: the 3D V-cycle
// up-leg.  u += P(V), with P the piecewise-constant (inject) or
// face-adapted trilinear prolongation, then nu 7-point smoother sweeps;
// writes u.  With a partials buffer (the rnorm flag) it also writes one f32
// partial of sum(r^2) per block, r being the ZERO-GHOST residual of the
// result whatever the level's bc (the solver's stopping metric), over the
// cells the launch stores; the caller sums the partials, so runs are
// deterministic.
//
// K6 replaces _pc_fused_3d, mgpoisson/kernels/pallas.py, the Pallas kernel
// behind prolong_correct_smooth and prolong_correct_smooth_rnorm for 3D
// arrays.
//
// K12 replaces _pc_sharded_3d, mgpoisson/kernels/pallas.py, behind
// pc_smooth_sharded3: the same leg on one rank's (nzl, nyl, n) block of a
// sharded level, the fine halo read from the u and f strips and the coarse
// halo from V's coarse strips (stencil3d.cuh Mg3Strips), with the boundary,
// the colour and the trilinear edge weights from the global index.
// Bound: HBM bytes, 3.125 arrays (read u, f, V; write u); the strips add
// 4D/nzl + 4D/nyl of an array for u and f and 4 DV/nzl + 4 DV/nyl of V.
//
// Two tiles.  At a halo H = steps (+ 1 with rnorm) <= 4 (the tuned
// scheme's wjacobi nu = 3, the fast scheme's rbgs nu = 1) K6 runs the
// z-marching tile of stencil3d_zm.cuh (mg_pc3d_zm_kernel, one instance per
// step count, smoother and bc) and K12 its strip-fed form
// (mg_sharded_pc3d_zm.cu, the same instances with kStrips, V's coarse ring
// filled from V's block and coarse strips): the correction from a ring of
// three coarse planes, 1.78 loaded cells per interior cell in xy at H = 4,
// one Sigma r^2 partial per block of its (x, y, chunk) grid.  At deeper
// halos both run the cube tile of stencil3d.cuh (mg_pc3d_kernel,
// mg_sharded_pc3d_kernel), which reads each array once per block tile and
// costs (T + 2H)^3 / T^3 = 11.4 cells loaded per interior cell at T = 8,
// H = 5.
//
// The bf16 form of K6 (mg_prolong_correct_smooth3d_bf16, with the rnorm
// flag) runs both tiles on bf16 u, f, V and out, rounding as plain torch
// does in bf16 (stencil3d.cuh, Mg3Elem): P(V) blended in f32 and rounded
// once, sum(r^2) in f32 partials; bound 1.5625 arrays of f32 bytes.  Its
// z-marching instances are in mg_prolong_correct_smooth3d_bf16.cu.  K12
// has no bf16 form.
#include "stencil3d.cuh"
#include "stencil3d_zm.cuh"

// The coarse tile covers the fine tile plus the trilinear +-1 coarse
// shift: ceil(H/2) + 1 coarse halo cells.
static __host__ __device__ inline int mg3_coarse_halo(int H) { return (H + 1) / 2 + 1; }

static __host__ __device__ inline int mg3_coarse_side(int T, int H) {
  return T / 2 + 2 * mg3_coarse_halo(H);
}

// P(V) at in-domain fine cell (gz, gy, gx), in ops.prolong's order: the
// 2^3 taps (z, y, x picks, x fastest), each weighted by the product of its
// per-axis weights taken in axis order.  Per axis the trilinear weights are
// (0.75, 0.25) inside and (0.5, 0) at the GLOBAL fine edges; the shifted
// tap is the coarse neighbour on the side of the cell's parity, zero
// outside the domain (the tile loads those as 0).  (cz0, cy0, cx0) is the
// global coarse index of the coarse tile's first cell.
static __device__ __forceinline__ float mg3_prolong(const float* sv, int SV, int cz0, int cy0,
                                                    int cx0, int gz, int gy, int gx, int n,
                                                    int kind) {
  const int k = (((gz >> 1) - cz0) * SV + ((gy >> 1) - cy0)) * SV + ((gx >> 1) - cx0);
  const float R = sv[k];
  if (kind == MG_INJECT) return R;
  const int dz = (gz & 1) ? SV * SV : -SV * SV, dy = (gy & 1) ? SV : -SV,
            dx = (gx & 1) ? 1 : -1;
  const bool ez = gz == 0 || gz == n - 1, ey = gy == 0 || gy == n - 1,
             ex = gx == 0 || gx == n - 1;
  const float a0 = ez ? 0.5f : 0.75f, b0 = ez ? 0.f : 0.25f;
  const float a1 = ey ? 0.5f : 0.75f, b1 = ey ? 0.f : 0.25f;
  const float a2 = ex ? 0.5f : 0.75f, b2 = ex ? 0.f : 0.25f;
  float out = __fmul_rn(__fmul_rn(__fmul_rn(a0, a1), a2), R);
  out = __fadd_rn(out, __fmul_rn(__fmul_rn(__fmul_rn(a0, a1), b2), sv[k + dx]));
  out = __fadd_rn(out, __fmul_rn(__fmul_rn(__fmul_rn(a0, b1), a2), sv[k + dy]));
  out = __fadd_rn(out, __fmul_rn(__fmul_rn(__fmul_rn(a0, b1), b2), sv[k + dy + dx]));
  out = __fadd_rn(out, __fmul_rn(__fmul_rn(__fmul_rn(b0, a1), a2), sv[k + dz]));
  out = __fadd_rn(out, __fmul_rn(__fmul_rn(__fmul_rn(b0, a1), b2), sv[k + dz + dx]));
  out = __fadd_rn(out, __fmul_rn(__fmul_rn(__fmul_rn(b0, b1), a2), sv[k + dz + dy]));
  out = __fadd_rn(out, __fmul_rn(__fmul_rn(__fmul_rn(b0, b1), b2), sv[k + dz + dy + dx]));
  return out;
}

// The leg on the block `blk`, its arrays of element type T (bf16 only
// without kStrips); each entry point below instantiates it once.
template <bool kStrips, class T>
static __device__ __forceinline__ void mg_pc3d_body(
    const T* __restrict__ U, const T* __restrict__ F, const T* __restrict__ V,
    T* __restrict__ Uout, float* __restrict__ partials, const Mg3Block& blk,
    const Mg3Strips& us, const Mg3Strips& fs, const Mg3Strips& vs, int side, int H, int nu,
    int smoother, int bc, int kind, float inv_hsq, float inv_adiag, float adiag) {
  using E = Mg3Elem<T>;
  extern __shared__ float smem[];
  const Mg3Tile t = mg3_tile(blk, side, H);
  const int S = t.S, S3 = S * S * S, n = t.n;
  float* a = smem;
  float* b = a + S3;
  float* sf = b + S3;
  float* sv = sf + S3;
  const int nc = n / 2, CH = mg3_coarse_halo(H), SV = mg3_coarse_side(side, H);
  // the fine tile origin is even, so its coarse origin is blockIdx * T/2 in
  // the block's coarse index; the block origin is even too
  const int lz0 = (int)blockIdx.z * (side / 2) - CH, ly0 = (int)blockIdx.y * (side / 2) - CH;
  const int cz0 = blk.z0 / 2 + lz0, cy0 = blk.y0 / 2 + ly0,
            cx0 = (int)blockIdx.x * (side / 2) - CH;
  for (int k = threadIdx.x; k < SV * SV * SV; k += blockDim.x) {
    const int gK = cx0 + k % SV, q = k / SV, gJ = cy0 + q % SV, gI = cz0 + q / SV;
    if constexpr (kStrips)
      sv[k] = mg_in(gI, nc) && mg_in(gJ, nc) && mg_in(gK, nc)
                  ? mg3_fetch(V, vs, lz0 + q / SV, ly0 + q % SV, gK, t.nzl / 2, t.nyl / 2, nc)
                  : 0.f;
    else
      sv[k] = mg_in(gI, nc) && mg_in(gJ, nc) && mg_in(gK, nc)
                  ? E::ld(V + ((size_t)gI * nc + gJ) * nc + gK)
                  : 0.f;
  }
  if constexpr (kStrips)
    mg3_load_strips(a, sf, U, F, us, fs, t);
  else
    mg3_load(a, sf, U, F, t);
  __syncthreads();
  for (int k = threadIdx.x; k < S3; k += blockDim.x) {
    const int l = k % S, q = k / S, j = q % S, i = q / S;
    if (mg3_in(t, i, j, l))   // P(V) blended in f32, rounded once
      a[k] = E::rd(__fadd_rn(a[k], E::rd(mg3_prolong(sv, SV, cz0, cy0, cx0, t.gz0 + i,
                                                     t.gy0 + j, t.gx0 + l, n, kind))));
  }
  __syncthreads();
  const float* u = mg3_sweeps<T>(a, b, sf, t, nu, smoother, bc, inv_hsq, inv_adiag);
  mg3_store(Uout, u, t);
  if (partials == nullptr) return;

  float acc = 0.f;
  for (int k = threadIdx.x; k < side * side * side; k += blockDim.x) {
    const int l = H + k % side, q = k / side, j = H + q % side, i = H + q / side;
    if (kStrips ? !mg3_owned(t, i, j, l) : !mg3_in(t, i, j, l)) continue;
    const float r = mg3_residual<T>(u, sf, t, i, j, l, MG_GHOST0, inv_hsq, adiag);
    acc += r * r;
  }
  float* red = sv + SV * SV * SV;   // fixed-order tree: the same sum every run
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    partials[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = red[0];
}

// K6 at halos above MG3Z_MAX_HALO: the whole n^3 grid.  The block is built here from n, so the compiler
// folds it away and the code is that of the grid-only kernel.
__global__ void __launch_bounds__(MG3_THREADS)
mg_pc3d_kernel(const float* __restrict__ U, const float* __restrict__ F,
               const float* __restrict__ V, float* __restrict__ Uout,
               float* __restrict__ partials, int n, int T, int H, int nu, int smoother,
               int bc, int kind, float inv_hsq, float inv_adiag, float adiag) {
  mg_pc3d_body<false>(U, F, V, Uout, partials, Mg3Block{n, n, n, 0, 0}, Mg3Strips{},
                      Mg3Strips{}, Mg3Strips{}, T, H, nu, smoother, bc, kind, inv_hsq,
                      inv_adiag, adiag);
}

// The bf16 form of the above.
__global__ void __launch_bounds__(MG3_THREADS)
mg_pc3d_bf16_kernel(const __nv_bfloat16* __restrict__ U, const __nv_bfloat16* __restrict__ F,
                    const __nv_bfloat16* __restrict__ V, __nv_bfloat16* __restrict__ Uout,
                    float* __restrict__ partials, int n, int T, int H, int nu, int smoother,
                    int bc, int kind, float inv_hsq, float inv_adiag, float adiag) {
  mg_pc3d_body<false>(U, F, V, Uout, partials, Mg3Block{n, n, n, 0, 0}, Mg3Strips{},
                      Mg3Strips{}, Mg3Strips{}, T, H, nu, smoother, bc, kind, inv_hsq,
                      inv_adiag, adiag);
}

// K12 at halos above MG3Z_MAX_HALO: one rank's block, its fine halo from
// the u and f strips and its coarse halo from V's.
__global__ void __launch_bounds__(MG3_THREADS)
mg_sharded_pc3d_kernel(const float* __restrict__ U, const float* __restrict__ F,
                       const float* __restrict__ V, float* __restrict__ Uout,
                       float* __restrict__ partials, Mg3Block blk, Mg3Strips us,
                       Mg3Strips fs, Mg3Strips vs, int T, int H, int nu, int smoother, int bc,
                       int kind, float inv_hsq, float inv_adiag, float adiag) {
  mg_pc3d_body<true>(U, F, V, Uout, partials, blk, us, fs, vs, T, H, nu, smoother, bc, kind,
                     inv_hsq, inv_adiag, adiag);
}

static size_t mg_pc3d_bytes(int tile, int H) {
  const size_t SV = (size_t)mg3_coarse_side(tile, H);
  return (mg3_tile_floats(tile, H) + SV * SV * SV + MG3_THREADS) * sizeof(float);
}

// K6 at halos up to MG3Z_MAX_HALO: the z-marching tile, one instance per
// step count, smoother and bc (mg3z_pick_from).
template <int STEPS, int kSm, bool kFace>
__global__ void __launch_bounds__(MG3Z_THREADS, 1) mg_pc3d_zm_kernel(Mg3zArgs a) {
  mg3z_leg<STEPS, kSm, kFace, false, false>(a, Mg3zStrips{});
}

template <int STEPS, int kSm, bool kFace>
struct MgPc3dZm {
  static __host__ Mg3zKernel fn() { return mg_pc3d_zm_kernel<STEPS, kSm, kFace>; }
};

// The whole n^3 grid in element type T (A its z-marching arguments): the
// z-marching instance `zm` (null: none for the step count and smoother)
// where the tile takes the halo (with rnorm one partial per block of
// mg3z_grid), else the cube kernel `cube` of side `tile` (kernels/cuda.py
// tile3d; one partial per T^3 block).
template <class A, class T, class Zm>
static int mg_pc3d_grid(Zm zm,
                        void (*cube)(const T*, const T*, const T*, T*, float*, int, int, int,
                                     int, int, int, int, float, float, float),
                        const T* u, const T* f, const T* V, T* out, float* partials, int n,
                        int tile, int nu, int smoother, int bc, int kind, float inv_hsq,
                        float inv_adiag, float adiag, int rnorm, cudaStream_t stream) {
  const int steps = mg_steps(nu, smoother), H = steps + (rnorm ? 1 : 0);
  if (mg3z_takes(H)) {
    const A a{u, f, V, out, nullptr, rnorm ? partials : nullptr, n, H, mg3z_chunk(n, n, n, H),
              kind, inv_hsq, inv_adiag, adiag};
    return mg3z_launch(zm, Mg3Block{n, n, n, 0, 0}, a, mg3z_bytes(steps, false, true),
                       stream);
  }
  const size_t bytes = mg_pc3d_bytes(tile, H);
  const Mg3Block grid{n, n, n, 0, 0};
  const int rc = mg3_prepare((const void*)cube, grid, tile, bytes);
  if (rc != 0) return rc;
  cube<<<mg3_grid(grid, tile), MG3_THREADS, bytes, stream>>>(
      u, f, V, out, rnorm ? partials : nullptr, n, tile, H, nu, smoother, bc, kind, inv_hsq,
      inv_adiag, adiag);
  return (int)cudaGetLastError();
}

extern "C" int mg_prolong_correct_smooth3d(const float* u, const float* f, const float* V,
                                           float* out, float* partials, int n, int tile,
                                           int nu, int smoother, int bc, int kind,
                                           float inv_hsq, float inv_adiag, float adiag,
                                           int rnorm, cudaStream_t stream) {
  return mg_pc3d_grid<Mg3zArgs>(
      mg3z_pick_from<MgPc3dZm, 0, MG3Z_MAX_HALO>(mg_steps(nu, smoother), smoother, bc),
      mg_pc3d_kernel, u, f, V, out, partials, n, tile, nu, smoother, bc, kind, inv_hsq,
      inv_adiag, adiag, rnorm, stream);
}

extern "C" int mg_prolong_correct_smooth3d_bf16(
    const __nv_bfloat16* u, const __nv_bfloat16* f, const __nv_bfloat16* V, __nv_bfloat16* out,
    float* partials, int n, int tile, int nu, int smoother, int bc, int kind, float inv_hsq,
    float inv_adiag, float adiag, int rnorm, cudaStream_t stream) {
  return mg_pc3d_grid<Mg3zArgsBf16>(mg_pc3d_zm_bf16_pick(mg_steps(nu, smoother), smoother, bc),
                                    mg_pc3d_bf16_kernel, u, f, V, out, partials, n, tile, nu,
                                    smoother, bc, kind, inv_hsq, inv_adiag, adiag, rnorm,
                                    stream);
}

// One rank's (nzl, nyl, n) block at global (z0, y0) of an n^3 level; u and
// f strips D >= H deep, V's coarse strips DV >= ceil(H/2) + 1 deep (the
// left/right ones null on a mesh of one column).  The z-marching tile
// where it takes the halo (with rnorm one partial per block of mg3z_grid
// over the block), else the cube tile of side `tile` (one partial per
// block of the (ceil(n/T), ceil(nyl/T), ceil(nzl/T)) grid).
extern "C" int mg_sharded_pc3d(const float* u, const float* f, const float* V, float* out,
                               float* partials, const float* ut, const float* ub,
                               const float* ul, const float* ur, const float* ft,
                               const float* fb, const float* fl, const float* fr,
                               const float* vt, const float* vb, const float* vl,
                               const float* vr, int n, int nzl, int nyl, int z0, int y0,
                               int D, int DV, int tile, int nu, int smoother, int bc,
                               int kind, float inv_hsq, float inv_adiag, float adiag,
                               int rnorm, cudaStream_t stream) {
  const int steps = mg_steps(nu, smoother), H = steps + (rnorm ? 1 : 0);
  const Mg3Block blk{n, nzl, nyl, z0, y0};
  if (D < H || DV < mg3_coarse_halo(H)) return (int)cudaErrorInvalidValue;
  if (mg3z_takes(H)) {
    const Mg3zArgs a{u, f, V, out, nullptr, rnorm ? partials : nullptr, n, H,
                     mg3z_chunk(n, nyl, nzl, H), kind, inv_hsq, inv_adiag, adiag};
    return mg3z_launch(mg_sharded_pc3d_zm_pick(steps, smoother, bc), blk, a,
                       mg3z_bytes(steps, false, true), stream,
                       Mg3zStrips{blk, Mg3Strips{ut, ub, ul, ur, D},
                                  Mg3Strips{ft, fb, fl, fr, D}, Mg3Strips{vt, vb, vl, vr, DV}});
  }
  const size_t bytes = mg_pc3d_bytes(tile, H);
  const int rc = mg3_prepare((const void*)mg_sharded_pc3d_kernel, blk, tile, bytes);
  if (rc != 0) return rc;
  mg_sharded_pc3d_kernel<<<mg3_grid(blk, tile), MG3_THREADS, bytes, stream>>>(
      u, f, V, out, rnorm ? partials : nullptr, blk, Mg3Strips{ut, ub, ul, ur, D},
      Mg3Strips{ft, fb, fl, fr, D}, Mg3Strips{vt, vb, vl, vr, DV}, tile, H, nu, smoother, bc,
      kind, inv_hsq, inv_adiag, adiag);
  return (int)cudaGetLastError();
}
