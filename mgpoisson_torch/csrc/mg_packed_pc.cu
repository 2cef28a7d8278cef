// K8 mg_packed_pc and K14 mg_sharded_packed_pc: the fast scheme's fine-level
// up-leg on packed state.  up += P(V), V the UNPACKED coarse correction,
// then nu red-black sweeps; writes the packed u.  With a partials buffer
// (the rnorm flag) it also writes one f32 partial of sum(r^2) per block, r
// the ghost0 residual of the result (the solver's stopping metric) over the
// cells the launch owns; the caller sums the partials in a fixed order, so
// runs are deterministic.
//
// K8 replaces the Pallas kernels behind packed_prolong_correct_smooth and
// packed_prolong_correct_smooth_rnorm: _packed_pc_fused (row stripes, and
// its write-through variant) and _packed_pc_fused_wide (two-axis blocks),
// mgpoisson/kernels/pallas.py.
//
// K14 replaces _packed_pc_sharded, mgpoisson/kernels/pallas.py, behind
// packed_pc_sharded: the same leg on one rank's block of nl whole packed
// rows of a row-sharded mesh, the fine halo rows from the u and f strips
// and the coarse halo rows of V from V's coarse strips (stencil.cuh
// MgStrips, left/right null: a mesh of one column).  The TPU kernel writes
// a row of column partials accumulated over its sequential stripes; here
// each block writes one partial.
//
// Bound: HBM bytes, 2.75 arrays (read up's black plane, fp, V; write up':
// u's red plane is dead on input, though this tile loads it); K14's strips
// add (4D + Dv)/nl of an array.  Design: the 2D register tile of K3
// (stencil.cuh) on packed state (stencil_packed.cuh): a warp per 64 fine
// columns, R rows of the tile table in registers, one shuffle per cell and
// colour step, no shared memory but the partial's.  Halo H = 2 nu (+1 with
// rnorm), so the instance without rnorm keeps a shallower halo than K3's.
//
// The bf16 form of K8 (mg_packed_pc_bf16, with the rnorm flag) runs the
// packed word tile, in mg_packed_pc_bf16.cu; K14 has no bf16 form.
#include "stencil_packed.cuh"

// K8: the whole n x n grid.
template <int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_packed_pc_kernel(const Mg2pArgs a) {
  mg2p_pc_body<R, false>(a);
}

// K14: one rank's block of whole rows, its halo rows from strips.
template <int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_sharded_packed_pc_kernel(const Mg2pArgs a) {
  mg2p_pc_body<R, true>(a);
}

struct MgPackedPcLaunch {
  template <int R, bool kStrips>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2pArgs& a) {
    if constexpr (kStrips)
      mg_sharded_packed_pc_kernel<R><<<grid, block, 0, stream>>>(a);
    else
      mg_packed_pc_kernel<R><<<grid, block, 0, stream>>>(a);
  }
};

static Mg2pArgs mg2p_args(const float* up, const float* fp, const float* V, float* out,
                          float* partials, int nu, int kind, float mhq, float inv_hsq,
                          int rnorm) {
  Mg2pArgs a{};
  a.U = up;
  a.F = fp;
  a.V = V;
  a.Uout = out;
  a.partials = rnorm ? partials : nullptr;
  a.H = 2 * nu + (rnorm ? 1 : 0);
  a.nu = nu;
  a.kind = kind;
  a.mhq = mhq;
  a.inv_hsq = inv_hsq;
  return a;
}

// With rnorm, one partial per block of mg2_grid(n, n, 2 nu + 1)
// (kernels/cuda.py packed_rnorm_partials).
extern "C" int mg_packed_pc(const float* up, const float* fp, const float* V, float* out,
                            float* partials, int n, int nu, int kind, float mhq,
                            float inv_hsq, int rnorm, cudaStream_t stream) {
  if (n < 2 || n & 1 || nu < 1 || nu > MG2P_MAX_NU || (kind != MG_INJECT && kind != MG_BILINEAR))
    return (int)cudaErrorInvalidValue;
  Mg2pArgs a = mg2p_args(up, fp, V, out, partials, nu, kind, mhq, inv_hsq, rnorm);
  a.blk = MgBlock{n, n, n, 0, 0};
  return mg2p_launch<MgPackedPcLaunch, false>(a, stream);
}

// One rank's packed (nl x n) block from global row r0 of an n x n level, V
// its (nl/2 x n/2) coarse block; u and f row strips (D x n) D >= H deep,
// V's (Dv x n/2) Dv >= ceil(H/2) + 1 deep, H = 2 nu (+1 with rnorm).  The
// tile's even halo may reach one row beyond the strips (H odd, D = H): that
// row reads 0 and stays outside the exact region.  With rnorm, one partial
// per block of mg2_grid(nl, n, H).
extern "C" int mg_sharded_packed_pc(const float* up, const float* fp, const float* V,
                                    float* out, float* partials, const float* ut,
                                    const float* ub, const float* ft, const float* fb,
                                    const float* vt, const float* vb, int n, int nl, int r0,
                                    int D, int Dv, int nu, int kind, float mhq, float inv_hsq,
                                    int rnorm, cudaStream_t stream) {
  const int H = 2 * nu + (rnorm ? 1 : 0);
  if (n < 2 || n & 1 || nl < 2 || (nl | r0) & 1 || r0 < 0 || r0 + nl > n || nu < 1 ||
      nu > MG2P_MAX_NU || D < H || Dv < (H + 1) / 2 + 1 ||
      (kind != MG_INJECT && kind != MG_BILINEAR))
    return (int)cudaErrorInvalidValue;
  Mg2pArgs a = mg2p_args(up, fp, V, out, partials, nu, kind, mhq, inv_hsq, rnorm);
  a.blk = MgBlock{n, nl, n, r0, 0};
  a.us = MgStrips{ut, ub, nullptr, nullptr, D};
  a.fs = MgStrips{ft, fb, nullptr, nullptr, D};
  a.vs = MgStrips{vt, vb, nullptr, nullptr, Dv};
  return mg2p_launch<MgPackedPcLaunch, true>(a, stream);
}
