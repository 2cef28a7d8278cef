// K6.bf16 mg_prolong_correct_smooth3d_bf16 on the z-marching tile: the
// bf16 instances of the up-leg of stencil3d_zm.cuh (mg3z_leg on bf16
// arrays), one per step count, smoother and bc, at halos H = steps (+ 1
// with rnorm) <= MG3Z_MAX_HALO.  The entry point, its checks and the cube
// tile of deeper halos are in mg_prolong_correct_smooth3d.cu beside K6;
// these instances have a source of their own so that nvcc builds them in
// parallel with K6's.
#include "stencil3d_zm.cuh"

template <int STEPS, int kSm, bool kFace>
__global__ void __launch_bounds__(MG3Z_THREADS, 1) mg_pc3d_zm_bf16_kernel(Mg3zArgsBf16 a) {
  mg3z_leg<STEPS, kSm, kFace, false, false>(a, Mg3zStrips{});
}

template <int STEPS, int kSm, bool kFace>
struct MgPc3dZmBf16 {
  static __host__ Mg3zKernelBf16 fn() { return mg_pc3d_zm_bf16_kernel<STEPS, kSm, kFace>; }
};

Mg3zKernelBf16 mg_pc3d_zm_bf16_pick(int steps, int smoother, int bc) {
  return mg3z_pick_from<MgPc3dZmBf16, 0, MG3Z_MAX_HALO>(steps, smoother, bc);
}
