// K7 mg_packed_rr and K13 mg_sharded_packed_rr: the fast scheme's fine-level
// down-leg on packed state.  nu red-black sweeps, the ghost0 residual and
// the 2x2 restriction; writes the packed u and the UNPACKED coarse rhs.  A
// coarse cell is one packed lane over a row pair, red plus black (coarse
// column J = lane J), so with the tile's even row origin the restriction is
// tile-local.
//
// K7 replaces the Pallas kernels behind packed_smooth_residual_restrict:
// _packed_rr_fused (row stripes, and its write-through variant) and
// _packed_rr_fused_wide (two-axis blocks), mgpoisson/kernels/pallas.py.
//
// K13 replaces _packed_rr_sharded, mgpoisson/kernels/pallas.py, behind
// packed_rr_sharded: the same leg on one rank's block of nl whole packed
// rows of a row-sharded mesh, its halo rows read from the neighbours' u and
// f strips (stencil.cuh MgStrips, left/right null: a mesh of one column).
// The TPU kernel DMAs each row stripe with its 8-deep strip rows into VMEM
// and gates its boundary on per-device edge flags; here the tile loader
// picks each halo row from its strip and the global row does what the flags
// did.  Rc is the block's (nl/2, n/2) coarse rhs, coarse rows from r0/2.
//
// Bound: HBM bytes, 2.75 arrays (read up's black plane, fp; write up', Rc:
// u's red plane is dead on input, though this tile loads it); K13's strips
// add 4D/nl of an array.  Design: the 2D register tile of K2 (stencil.cuh)
// on packed state (stencil_packed.cuh): a warp per 64 fine columns, R rows
// of the tile table in registers, one shuffle per cell and colour step, no
// shared memory; the residual and the restriction run on the registers.
// Halo H = 2 nu + 1, K2's at rbgs, so at nu = 1 the tile loads what K2's
// loads.
//
// The bf16 form of K7 (mg_packed_rr_bf16) runs the packed word tile, in
// mg_packed_rr_bf16.cu; K13 has no bf16 form.
#include "stencil_packed.cuh"

// K7: the whole n x n grid.
template <int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_packed_rr_kernel(const Mg2pArgs a) {
  mg2p_rr_body<R, false>(a);
}

// K13: one rank's block of whole rows, its halo rows from strips.
template <int R>
__global__ void __launch_bounds__(MG2_THREADS, MG2_MIN_BLOCKS(R))
mg_sharded_packed_rr_kernel(const Mg2pArgs a) {
  mg2p_rr_body<R, true>(a);
}

struct MgPackedRrLaunch {
  template <int R, bool kStrips>
  static void go(dim3 grid, dim3 block, cudaStream_t stream, const Mg2pArgs& a) {
    if constexpr (kStrips)
      mg_sharded_packed_rr_kernel<R><<<grid, block, 0, stream>>>(a);
    else
      mg_packed_rr_kernel<R><<<grid, block, 0, stream>>>(a);
  }
};

static Mg2pArgs mg2p_rr_args(const float* up, const float* fp, float* out, float* Rc, int nu,
                             float mhq, float inv_hsq) {
  Mg2pArgs a{};
  a.U = up;
  a.F = fp;
  a.Uout = out;
  a.Rout = Rc;
  a.H = 2 * nu + 1;
  a.nu = nu;
  a.mhq = mhq;
  a.inv_hsq = inv_hsq;
  return a;
}

extern "C" int mg_packed_rr(const float* up, const float* fp, float* out, float* Rc, int n,
                            int nu, float mhq, float inv_hsq, cudaStream_t stream) {
  if (n < 2 || n % 2 || nu < 1 || nu > MG2P_MAX_NU) return (int)cudaErrorInvalidValue;
  Mg2pArgs a = mg2p_rr_args(up, fp, out, Rc, nu, mhq, inv_hsq);
  a.blk = MgBlock{n, n, n, 0, 0};
  return mg2p_launch<MgPackedRrLaunch, false>(a, stream);
}

// One rank's packed (nl x n) block from global row r0 of an n x n level; u
// and f row strips (D x n) D >= 2 nu + 1 deep.  The tile's even halo, 2 nu
// + 2, reaches one row beyond strips of D = 2 nu + 1: that row reads 0 and
// stays outside the exact region.
extern "C" int mg_sharded_packed_rr(const float* up, const float* fp, float* out, float* Rc,
                                    const float* ut, const float* ub, const float* ft,
                                    const float* fb, int n, int nl, int r0, int D, int nu,
                                    float mhq, float inv_hsq, cudaStream_t stream) {
  if (n < 2 || n % 2 || nl < 2 || (nl | r0) & 1 || r0 < 0 || r0 + nl > n || nu < 1 ||
      nu > MG2P_MAX_NU || D < 2 * nu + 1)
    return (int)cudaErrorInvalidValue;
  Mg2pArgs a = mg2p_rr_args(up, fp, out, Rc, nu, mhq, inv_hsq);
  a.blk = MgBlock{n, nl, n, r0, 0};
  a.us = MgStrips{ut, ub, nullptr, nullptr, D};
  a.fs = MgStrips{ft, fb, nullptr, nullptr, D};
  return mg2p_launch<MgPackedRrLaunch, true>(a, stream);
}
