// K5 mg_smooth_rr3d and K11 mg_sharded_rr3d: the 3D V-cycle down-leg.  nu
// 7-point smoother sweeps, then the residual r = f - A u with the level's
// bc, then the 2x2x2-mean restriction (x 0.125); writes u and R.  With
// U == nullptr (the from-zero flag) u starts identically zero and is never
// read.
//
// K5 replaces _rr_fused_3d, mgpoisson/kernels/pallas.py, the Pallas kernel
// behind smooth_residual_restrict for 3D arrays and, through the explicit
// zeros array of smooth_residual_restrict_zero, its from-zero form.  The
// flag reads f only: the same values with one array pass fewer in and
// none out for the zeros.
//
// K11 replaces _rr_sharded_3d, mgpoisson/kernels/pallas.py, behind
// smooth_rr_sharded3: the same leg on one rank's (nzl, nyl, n) block of a
// sharded level (z and y cut over the mesh, x whole), the halo read from
// the neighbours' strips (stencil3d.cuh Mg3Strips), the boundary applied
// only where the block's edge is the grid's.  The TPU kernel's 8-sublane y
// window and block planner (sharded_plan3) exist for VMEM and are not
// carried over.
// Bound: HBM bytes, 3.125 arrays (read u, f; write u, R), 2.125 from zero;
// the strips add 4D/nzl + 4D/nyl of an array (both u and f).
//
// Two tiles.  At a halo H = steps + 1 <= 4 (the tuned scheme's wjacobi nu
// = 3, the fast scheme's rbgs nu = 1) K5 runs the z-marching tile of
// stencil3d_zm.cuh (mg_rr3d_zm_kernel, one instance per step count,
// smoother and bc) and K11 its strip-fed form (mg_sharded_rr3d_zm.cu, the
// same instances with kStrips): 1.78 loaded cells per interior cell in xy
// at H = 4, the restriction from a ring of residual planes.  At deeper
// halos both run the cube tile of stencil3d.cuh (mg_smooth_rr3d_kernel,
// mg_sharded_rr3d_kernel), which reads each array once per block tile and
// costs (T + 2H)^3 / T^3 = 11.4 cells loaded per interior cell at T = 8,
// H = 5.
//
// The bf16 forms of K5 (mg_smooth_rr3d_bf16) and K11
// (mg_sharded_rr3d_bf16), with the from-zero flag, take bf16 u, f, R and
// strips (Mg3StripsBf16), every output bit-equal to plain torch in bf16:
// bound 1.5625 arrays of f32 bytes, 1.0625 from zero (K11.bf16 replaces
// _rr_sharded_3d in bf16: the JAX package's sharded_plan3 admits bf16).
// At halos <= 4 they run the word tile of stencil3d_zw.cuh, the
// z-marching march on bf16x2 words, its instances and launches in
// mg_smooth_rr3d_bf16.cu and mg_sharded_rr3d_zm_bf16.cu; deeper, the cube
// tile rounding every op (stencil3d.cuh, Mg3Elem).
#include "stencil3d.cuh"
#include "stencil3d_zm.cuh"

// The leg on the block `blk`, its arrays of element type T and its
// strips of type Strips (Mg3StripsOf<T>, unread without kStrips); each
// entry point below instantiates it once.
template <bool kStrips, class T, class Strips>
static __device__ __forceinline__ void mg_smooth_rr3d_body(
    const T* __restrict__ U, const T* __restrict__ F, T* __restrict__ Uout,
    T* __restrict__ Rout, const Mg3Block& blk, const Strips& us, const Strips& fs,
    int side, int H, int nu, int smoother, int bc, float inv_hsq, float inv_adiag, float adiag) {
  using E = Mg3Elem<T>;
  extern __shared__ float smem[];
  const Mg3Tile t = mg3_tile(blk, side, H);
  const int S3 = t.S * t.S * t.S;
  float* a = smem;
  float* b = a + S3;
  float* sf = b + S3;
  if constexpr (kStrips)
    mg3_load_strips(a, sf, U, F, us, fs, t);
  else
    mg3_load(a, sf, U, F, t);
  __syncthreads();
  const float* u = mg3_sweeps<T>(a, b, sf, t, nu, smoother, bc, inv_hsq, inv_adiag);
  mg3_store(Uout, u, t);

  // the tile origin is even on all three axes, so each coarse cell's
  // 2x2x2 fine cells lie in this tile; the halo keeps the ring the
  // residual reads exact
  const int ncz = t.nzl / 2, ncy = t.nyl / 2, ncx = t.n / 2, T2 = side / 2;
  for (int k = threadIdx.x; k < T2 * T2 * T2; k += blockDim.x) {
    const int cl = k % T2, q = k / T2, cj = q % T2, ci = q / T2;
    const int gI = (int)blockIdx.z * T2 + ci, gJ = (int)blockIdx.y * T2 + cj,
              gK = (int)blockIdx.x * T2 + cl;
    if (!mg_in(gI, ncz) || !mg_in(gJ, ncy) || !mg_in(gK, ncx)) continue;
    const int i = H + 2 * ci, j = H + 2 * cj, l = H + 2 * cl;
    float r[8];
#pragma unroll
    for (int d = 0; d < 8; ++d)
      r[d] = mg3_residual<T>(u, sf, t, i + (d >> 2), j + ((d >> 1) & 1), l + (d & 1), bc,
                             inv_hsq, adiag);
    Rout[((size_t)gI * ncy + gJ) * ncx + gK] =
        E::cvt(E::rd(__fmul_rn(E::rd(mg3_sum8(r)), 0.125f)));
  }
}

// K5 at halos above MG3Z_MAX_HALO: the whole n^3 grid.  The block is built here from n, so the compiler
// folds it away and the code is that of the grid-only kernel.
__global__ void __launch_bounds__(MG3_THREADS)
mg_smooth_rr3d_kernel(const float* __restrict__ U, const float* __restrict__ F,
                      float* __restrict__ Uout, float* __restrict__ Rout, int n, int T,
                      int H, int nu, int smoother, int bc, float inv_hsq,
                      float inv_adiag, float adiag) {
  mg_smooth_rr3d_body<false>(U, F, Uout, Rout, Mg3Block{n, n, n, 0, 0}, Mg3Strips{},
                             Mg3Strips{}, T, H, nu, smoother, bc, inv_hsq, inv_adiag, adiag);
}

// The bf16 form of the above.
__global__ void __launch_bounds__(MG3_THREADS)
mg_smooth_rr3d_bf16_kernel(const __nv_bfloat16* __restrict__ U,
                           const __nv_bfloat16* __restrict__ F, __nv_bfloat16* __restrict__ Uout,
                           __nv_bfloat16* __restrict__ Rout, int n, int T, int H, int nu,
                           int smoother, int bc, float inv_hsq, float inv_adiag, float adiag) {
  mg_smooth_rr3d_body<false>(U, F, Uout, Rout, Mg3Block{n, n, n, 0, 0}, Mg3Strips{},
                             Mg3Strips{}, T, H, nu, smoother, bc, inv_hsq, inv_adiag, adiag);
}

// K11 at halos above MG3Z_MAX_HALO: one rank's block, its halo from strips.
__global__ void __launch_bounds__(MG3_THREADS)
mg_sharded_rr3d_kernel(const float* __restrict__ U, const float* __restrict__ F,
                       float* __restrict__ Uout, float* __restrict__ Rout, Mg3Block blk,
                       Mg3Strips us, Mg3Strips fs, int T, int H, int nu, int smoother,
                       int bc, float inv_hsq, float inv_adiag, float adiag) {
  mg_smooth_rr3d_body<true>(U, F, Uout, Rout, blk, us, fs, T, H, nu, smoother, bc, inv_hsq,
                            inv_adiag, adiag);
}

// The bf16 form of the above: bf16 arrays and strips.
__global__ void __launch_bounds__(MG3_THREADS)
mg_sharded_rr3d_bf16_kernel(const __nv_bfloat16* __restrict__ U,
                            const __nv_bfloat16* __restrict__ F,
                            __nv_bfloat16* __restrict__ Uout, __nv_bfloat16* __restrict__ Rout,
                            Mg3Block blk, Mg3StripsBf16 us, Mg3StripsBf16 fs, int T, int H,
                            int nu, int smoother, int bc, float inv_hsq, float inv_adiag,
                            float adiag) {
  mg_smooth_rr3d_body<true>(U, F, Uout, Rout, blk, us, fs, T, H, nu, smoother, bc, inv_hsq,
                            inv_adiag, adiag);
}

// K5 at halos up to MG3Z_MAX_HALO: the z-marching tile, one instance per
// step count, smoother and bc (mg3z_pick_from).
template <int STEPS, int kSm, bool kFace>
__global__ void __launch_bounds__(MG3Z_THREADS, 1) mg_rr3d_zm_kernel(Mg3zArgs a) {
  mg3z_leg<STEPS, kSm, kFace, true, false>(a, Mg3zStrips{});
}

template <int STEPS, int kSm, bool kFace>
struct MgRr3dZm {
  static __host__ Mg3zKernel fn() { return mg_rr3d_zm_kernel<STEPS, kSm, kFace>; }
};

// K5's and K11's z-marching launches in f32 (those of the bf16 forms,
// on the word tile, are mg_rr3d_zw_launch and mg_sharded_rr3d_zw_launch):
// the instance for the step count, smoother and bc, the chunk from the
// chunk table over the block.
static int mg_rr3d_zm_launch(const Mg3Block& blk, Mg3zArgs a, int steps, int smoother, int bc,
                             cudaStream_t stream) {
  a.chunk = mg3z_chunk(blk.n, blk.nyl, blk.nzl, a.H);
  return mg3z_launch(mg3z_pick_from<MgRr3dZm, 0, MG3Z_MAX_HALO - 1>(steps, smoother, bc), blk,
                     a, mg3z_bytes(steps, true, false), stream);
}

static int mg_sharded_rr3d_zm_launch(const Mg3Block& blk, Mg3zArgs a, int steps, int smoother,
                                     int bc, cudaStream_t stream, const Mg3zStrips& b) {
  a.chunk = mg3z_chunk(blk.n, blk.nyl, blk.nzl, a.H);
  return mg3z_launch(mg_sharded_rr3d_zm_pick(steps, smoother, bc), blk, a,
                     mg3z_bytes(steps, true, false), stream, b);
}

// The whole n^3 grid in element type T (A its z-marching arguments): the
// z-marching launch `zm` (mg_rr3d_zm_launch or, in bf16, the word tile's)
// where the tile takes the halo, else the cube kernel `cube` of side
// `tile` (kernels/cuda.py tile3d).
template <class A, class T, class Zm>
static int mg_smooth_rr3d_grid(Zm zm,
                               void (*cube)(const T*, const T*, T*, T*, int, int, int, int, int,
                                            int, float, float, float),
                               const T* u, const T* f, T* out, T* R, int n, int tile, int nu,
                               int smoother, int bc, float inv_hsq, float inv_adiag,
                               float adiag, int zero, cudaStream_t stream) {
  const int steps = mg_steps(nu, smoother), H = steps + 1;
  if (mg3z_takes(H)) {
    const A a{zero ? nullptr : u, f, nullptr, out, R, nullptr, n, H, 0, 0, inv_hsq, inv_adiag,
              adiag};
    return zm(Mg3Block{n, n, n, 0, 0}, a, steps, smoother, bc, stream);
  }
  const size_t bytes = mg3_tile_floats(tile, H) * sizeof(float);
  const Mg3Block grid{n, n, n, 0, 0};
  const int rc = mg3_prepare((const void*)cube, grid, tile, bytes);
  if (rc != 0) return rc;
  cube<<<mg3_grid(grid, tile), MG3_THREADS, bytes, stream>>>(
      zero ? nullptr : u, f, out, R, n, tile, H, nu, smoother, bc, inv_hsq, inv_adiag,
      adiag);
  return (int)cudaGetLastError();
}

extern "C" int mg_smooth_rr3d(const float* u, const float* f, float* out, float* R, int n,
                              int tile, int nu, int smoother, int bc, float inv_hsq,
                              float inv_adiag, float adiag, int zero, cudaStream_t stream) {
  return mg_smooth_rr3d_grid<Mg3zArgs>(
      mg_rr3d_zm_launch, mg_smooth_rr3d_kernel, u, f, out, R, n, tile, nu, smoother, bc,
      inv_hsq, inv_adiag, adiag, zero, stream);
}

extern "C" int mg_smooth_rr3d_bf16(const __nv_bfloat16* u, const __nv_bfloat16* f,
                                   __nv_bfloat16* out, __nv_bfloat16* R, int n, int tile,
                                   int nu, int smoother, int bc, float inv_hsq,
                                   float inv_adiag, float adiag, int zero,
                                   cudaStream_t stream) {
  return mg_smooth_rr3d_grid<Mg3zArgsBf16>(
      mg_rr3d_zw_launch, mg_smooth_rr3d_bf16_kernel, u, f, out, R, n, tile, nu, smoother, bc,
      inv_hsq, inv_adiag, adiag, zero, stream);
}

// One rank's (nzl, nyl, n) block at global (z0, y0) of an n^3 level in
// element type T (A its z-marching arguments); u and f strips D >= H deep
// (ut..ur unused from zero; ul/ur and fl/fr null on a mesh of one column).
// The z-marching launch `zm` (mg_sharded_rr3d_zm_launch or, in bf16, the
// word tile's) where the tile takes the halo, else the cube kernel `cube`
// of side `tile`.
template <class A, class T, class Zm, class Cube>
static int mg_sharded_rr3d_block(Zm zm, Cube cube, const T* u, const T* f, T* out, T* R,
                                 const T* ut, const T* ub, const T* ul, const T* ur,
                                 const T* ft, const T* fb, const T* fl, const T* fr, int n,
                                 int nzl, int nyl, int z0, int y0, int D, int tile, int nu,
                                 int smoother, int bc, float inv_hsq, float inv_adiag,
                                 float adiag, int zero, cudaStream_t stream) {
  using S = Mg3StripsOf<T>;
  const int steps = mg_steps(nu, smoother), H = steps + 1;
  const Mg3Block blk{n, nzl, nyl, z0, y0};
  if (D < H) return (int)cudaErrorInvalidValue;
  const S us = zero ? S{nullptr, nullptr, nullptr, nullptr, D} : S{ut, ub, ul, ur, D};
  if (mg3z_takes(H)) {
    const A a{zero ? nullptr : u, f, nullptr, out, R, nullptr, n, H, 0, 0, inv_hsq, inv_adiag,
              adiag};
    return zm(blk, a, steps, smoother, bc, stream,
              Mg3zStripsOf<T>{blk, us, S{ft, fb, fl, fr, D}, S{}});
  }
  const size_t bytes = mg3_tile_floats(tile, H) * sizeof(float);
  const int rc = mg3_prepare((const void*)cube, blk, tile, bytes);
  if (rc != 0) return rc;
  cube<<<mg3_grid(blk, tile), MG3_THREADS, bytes, stream>>>(
      zero ? nullptr : u, f, out, R, blk, us, S{ft, fb, fl, fr, D}, tile, H, nu, smoother, bc,
      inv_hsq, inv_adiag, adiag);
  return (int)cudaGetLastError();
}

extern "C" int mg_sharded_rr3d(const float* u, const float* f, float* out, float* R,
                               const float* ut, const float* ub, const float* ul,
                               const float* ur, const float* ft, const float* fb,
                               const float* fl, const float* fr, int n, int nzl, int nyl,
                               int z0, int y0, int D, int tile, int nu, int smoother, int bc,
                               float inv_hsq, float inv_adiag, float adiag, int zero,
                               cudaStream_t stream) {
  return mg_sharded_rr3d_block<Mg3zArgs>(
      mg_sharded_rr3d_zm_launch, mg_sharded_rr3d_kernel, u, f, out, R, ut, ub, ul, ur, ft, fb,
      fl, fr, n, nzl, nyl, z0, y0, D, tile, nu, smoother, bc, inv_hsq, inv_adiag, adiag, zero,
      stream);
}

extern "C" int mg_sharded_rr3d_bf16(const __nv_bfloat16* u, const __nv_bfloat16* f,
                                    __nv_bfloat16* out, __nv_bfloat16* R,
                                    const __nv_bfloat16* ut, const __nv_bfloat16* ub,
                                    const __nv_bfloat16* ul, const __nv_bfloat16* ur,
                                    const __nv_bfloat16* ft, const __nv_bfloat16* fb,
                                    const __nv_bfloat16* fl, const __nv_bfloat16* fr, int n,
                                    int nzl, int nyl, int z0, int y0, int D, int tile, int nu,
                                    int smoother, int bc, float inv_hsq, float inv_adiag,
                                    float adiag, int zero, cudaStream_t stream) {
  return mg_sharded_rr3d_block<Mg3zArgsBf16>(
      mg_sharded_rr3d_zw_launch, mg_sharded_rr3d_bf16_kernel, u, f, out, R, ut, ub, ul, ur, ft,
      fb, fl, fr, n, nzl, nyl, z0, y0, D, tile, nu, smoother, bc, inv_hsq, inv_adiag, adiag,
      zero, stream);
}
