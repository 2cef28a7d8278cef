// K5.bf16 mg_smooth_rr3d_bf16 on the word tile: the bf16 instances of the
// down-leg of stencil3d_zw.cuh (mg3w_leg, the z-marching tile on bf16x2
// words), one per step count, smoother and bc, at halos H = steps + 1 <=
// MG3Z_MAX_HALO, and their launch.  The entry point, its checks and the
// cube tile of deeper halos are in mg_smooth_rr3d.cu beside K5; these
// instances have a source of their own so that nvcc builds them in
// parallel with K5's.
#include "stencil3d_zw.cuh"

template <int STEPS, int kSm, bool kFace>
__global__ void __launch_bounds__(MG3W_THREADS, MG3W_MIN_BLOCKS)
    mg_rr3d_zm_bf16_kernel(Mg3zArgsBf16 a) {
  mg3w_run<STEPS, kSm, kFace, true, false>(a, Mg3zStripsBf16{});
}

template <int STEPS, int kSm, bool kFace>
struct MgRr3dZmBf16 {
  static __host__ Mg3zKernelBf16 fn() { return mg_rr3d_zm_bf16_kernel<STEPS, kSm, kFace>; }
};

int mg_rr3d_zw_launch(const Mg3Block& blk, Mg3zArgsBf16 a, int steps, int smoother, int bc,
                      cudaStream_t stream) {
  return mg3w_launch(mg3z_pick_from<MgRr3dZmBf16, 0, MG3Z_MAX_HALO - 1>(steps, smoother, bc),
                     blk, a, steps, MG3W_RR, stream, nullptr);
}
