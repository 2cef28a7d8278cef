// K5.bf16 mg_smooth_rr3d_bf16 on the z-marching tile: the bf16 instances
// of the down-leg of stencil3d_zm.cuh (mg3z_leg on bf16 arrays), one per
// step count, smoother and bc, at halos H = steps + 1 <= MG3Z_MAX_HALO.
// The entry point, its checks and the cube tile of deeper halos are in
// mg_smooth_rr3d.cu beside K5; these instances have a source of their own
// so that nvcc builds them in parallel with K5's.
#include "stencil3d_zm.cuh"

template <int STEPS, int kSm, bool kFace>
__global__ void __launch_bounds__(MG3Z_THREADS, 1) mg_rr3d_zm_bf16_kernel(Mg3zArgsBf16 a) {
  mg3z_leg<STEPS, kSm, kFace, true, false>(a, Mg3zStrips{});
}

template <int STEPS, int kSm, bool kFace>
struct MgRr3dZmBf16 {
  static __host__ Mg3zKernelBf16 fn() { return mg_rr3d_zm_bf16_kernel<STEPS, kSm, kFace>; }
};

Mg3zKernelBf16 mg_rr3d_zm_bf16_pick(int steps, int smoother, int bc) {
  return mg3z_pick_from<MgRr3dZmBf16, 0, MG3Z_MAX_HALO - 1>(steps, smoother, bc);
}
