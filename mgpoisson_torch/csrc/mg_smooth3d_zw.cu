// K4.bf16 mg_smooth3d_bf16 on the word tile: the bf16 instances of the
// sweeps alone (stencil3d_zw.cuh mg3w_leg with kSmooth, the z-marching
// tile on bf16x2 words), one per step count, smoother and bc, at halos H =
// steps <= MG3Z_MAX_HALO, and their launch.  The entry point, its checks
// and the cube tile of deeper halos are in mg_smooth3d.cu; these instances
// have a source of their own so that nvcc builds them in parallel with the
// other legs'.
#include "stencil3d_zw.cuh"

template <int STEPS, int kSm, bool kFace>
__global__ void __launch_bounds__(MG3W_THREADS, MG3W_MIN_BLOCKS)
    mg_smooth3d_zm_bf16_kernel(Mg3zArgsBf16 a) {
  mg3w_run<STEPS, kSm, kFace, false, false, true>(a, Mg3zStripsBf16{});
}

template <int STEPS, int kSm, bool kFace>
struct MgSmooth3dZmBf16 {
  static __host__ Mg3zKernelBf16 fn() { return mg_smooth3d_zm_bf16_kernel<STEPS, kSm, kFace>; }
};

int mg_smooth3d_zw_launch(const Mg3Block& blk, Mg3zArgsBf16 a, int steps, int smoother, int bc,
                          cudaStream_t stream) {
  return mg3w_launch(mg3z_pick_from<MgSmooth3dZmBf16, 1, MG3Z_MAX_HALO>(steps, smoother, bc),
                     blk, a, steps, MG3W_SMOOTH, stream, nullptr);
}
