// K12 mg_sharded_pc3d on the z-marching tile: the strip-fed instances of
// the up-leg of stencil3d_zm.cuh (mg3z_leg with kStrips), one per step
// count, smoother and bc, at halos H = steps (+ 1 with rnorm) <=
// MG3Z_MAX_HALO.  The entry point, its checks and the cube tile of deeper
// halos are in mg_prolong_correct_smooth3d.cu beside K6; these instances
// have a source of their own so that nvcc builds them in parallel with
// K6's.
#include "stencil3d_zm.cuh"

template <int STEPS, int kSm, bool kFace>
__global__ void __launch_bounds__(MG3Z_THREADS, 1)
    mg_sharded_pc3d_zm_kernel(Mg3zArgs a, Mg3zStrips b) {
  mg3z_leg<STEPS, kSm, kFace, false, true>(a, b);
}

template <int STEPS, int kSm, bool kFace>
struct MgShardedPc3dZm {
  static __host__ Mg3zStripKernel fn() { return mg_sharded_pc3d_zm_kernel<STEPS, kSm, kFace>; }
};

Mg3zStripKernel mg_sharded_pc3d_zm_pick(int steps, int smoother, int bc) {
  return mg3z_pick_from<MgShardedPc3dZm, 0, MG3Z_MAX_HALO>(steps, smoother, bc);
}
