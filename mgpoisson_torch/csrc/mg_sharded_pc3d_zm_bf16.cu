// K12.bf16 mg_sharded_pc3d_bf16 on the z-marching tile: the bf16
// strip-fed instances of the up-leg of stencil3d_zm.cuh (mg3z_leg with
// kStrips on bf16 arrays and strips, Mg3zStripsBf16), one per step count,
// smoother and bc, at halos H = steps (+ 1 with rnorm) <= MG3Z_MAX_HALO.
// The entry point, its checks and the cube tile of deeper halos are in
// mg_prolong_correct_smooth3d.cu beside K6; these instances have a source
// of their own so that nvcc builds them in parallel with the f32 ones
// (mg_sharded_pc3d_zm.cu).
#include "stencil3d_zm.cuh"

template <int STEPS, int kSm, bool kFace>
__global__ void __launch_bounds__(MG3Z_THREADS, 1)
    mg_sharded_pc3d_zm_bf16_kernel(Mg3zArgsBf16 a, Mg3zStripsBf16 b) {
  mg3z_leg<STEPS, kSm, kFace, false, true>(a, b);
}

template <int STEPS, int kSm, bool kFace>
struct MgShardedPc3dZmBf16 {
  static __host__ Mg3zStripKernelBf16 fn() {
    return mg_sharded_pc3d_zm_bf16_kernel<STEPS, kSm, kFace>;
  }
};

Mg3zStripKernelBf16 mg_sharded_pc3d_zm_bf16_pick(int steps, int smoother, int bc) {
  return mg3z_pick_from<MgShardedPc3dZmBf16, 0, MG3Z_MAX_HALO>(steps, smoother, bc);
}
