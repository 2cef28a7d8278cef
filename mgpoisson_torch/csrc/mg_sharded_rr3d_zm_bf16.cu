// K11.bf16 mg_sharded_rr3d_bf16 on the z-marching tile: the bf16
// strip-fed instances of the down-leg of stencil3d_zm.cuh (mg3z_leg with
// kStrips on bf16 arrays and strips, Mg3zStripsBf16), one per step count,
// smoother and bc, at halos H = steps + 1 <= MG3Z_MAX_HALO.  The entry
// point, its checks and the cube tile of deeper halos are in
// mg_smooth_rr3d.cu beside K5; these instances have a source of their own
// so that nvcc builds them in parallel with the f32 ones
// (mg_sharded_rr3d_zm.cu).
#include "stencil3d_zm.cuh"

template <int STEPS, int kSm, bool kFace>
__global__ void __launch_bounds__(MG3Z_THREADS, 1)
    mg_sharded_rr3d_zm_bf16_kernel(Mg3zArgsBf16 a, Mg3zStripsBf16 b) {
  mg3z_leg<STEPS, kSm, kFace, true, true>(a, b);
}

template <int STEPS, int kSm, bool kFace>
struct MgShardedRr3dZmBf16 {
  static __host__ Mg3zStripKernelBf16 fn() {
    return mg_sharded_rr3d_zm_bf16_kernel<STEPS, kSm, kFace>;
  }
};

Mg3zStripKernelBf16 mg_sharded_rr3d_zm_bf16_pick(int steps, int smoother, int bc) {
  return mg3z_pick_from<MgShardedRr3dZmBf16, 0, MG3Z_MAX_HALO - 1>(steps, smoother, bc);
}
