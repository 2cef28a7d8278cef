// K4 mg_smooth3d on the z-marching tile: the f32 instances of the sweeps
// alone (stencil3d_zm.cuh mg3z_leg with kSmooth), one per step count,
// smoother and bc, at halos H = steps <= MG3Z_MAX_HALO, and their launch.
// The entry point, its checks and the cube tile of deeper halos are in
// mg_smooth3d.cu; these instances have a source of their own so that nvcc
// builds them in parallel with the other legs'.
#include "stencil3d_zm.cuh"

template <int STEPS, int kSm, bool kFace>
__global__ void __launch_bounds__(MG3Z_THREADS, 1) mg_smooth3d_zm_kernel(Mg3zArgs a) {
  mg3z_leg<STEPS, kSm, kFace, false, false, true>(a, Mg3zStrips{});
}

template <int STEPS, int kSm, bool kFace>
struct MgSmooth3dZm {
  static __host__ Mg3zKernel fn() { return mg_smooth3d_zm_kernel<STEPS, kSm, kFace>; }
};

int mg_smooth3d_zm_launch(const Mg3Block& blk, Mg3zArgs a, int steps, int smoother, int bc,
                          cudaStream_t stream) {
  a.chunk = mg3z_chunk(blk.n, blk.nyl, blk.nzl, a.H);
  return mg3z_launch(mg3z_pick_from<MgSmooth3dZm, 1, MG3Z_MAX_HALO>(steps, smoother, bc), blk,
                     a, mg3z_bytes(steps, false, false, true), stream);
}
