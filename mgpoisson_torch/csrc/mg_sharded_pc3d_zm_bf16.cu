// K12.bf16 mg_sharded_pc3d_bf16 on the word tile: the bf16 strip-fed
// instances of the up-leg of stencil3d_zw.cuh (mg3w_leg with kStrips on
// bf16 arrays and strips, Mg3zStripsBf16), one per step count, smoother
// and bc, at halos H = steps (+ 1 with rnorm) <= MG3Z_MAX_HALO, and their
// launch.  The entry point, its checks and the cube tile of deeper halos
// are in mg_prolong_correct_smooth3d.cu beside K6; these instances have a
// source of their own so that nvcc builds them in parallel with the f32
// ones (mg_sharded_pc3d_zm.cu).
#include "stencil3d_zw.cuh"

template <int STEPS, int kSm, bool kFace>
__global__ void __launch_bounds__(MG3W_THREADS, MG3W_MIN_BLOCKS)
    mg_sharded_pc3d_zm_bf16_kernel(Mg3zArgsBf16 a, Mg3zStripsBf16 b) {
  mg3w_run<STEPS, kSm, kFace, false, true>(a, b);
}

template <int STEPS, int kSm, bool kFace>
struct MgShardedPc3dZmBf16 {
  static __host__ Mg3zStripKernelBf16 fn() {
    return mg_sharded_pc3d_zm_bf16_kernel<STEPS, kSm, kFace>;
  }
};

int mg_sharded_pc3d_zw_launch(const Mg3Block& blk, Mg3zArgsBf16 a, int steps, int smoother,
                              int bc, cudaStream_t stream, const Mg3zStripsBf16& b) {
  return mg3w_launch(mg3z_pick_from<MgShardedPc3dZmBf16, 0, MG3Z_MAX_HALO>(steps, smoother, bc),
                     blk, a, steps, MG3W_PC, stream, &b, b);
}
