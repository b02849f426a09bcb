// K4: the dual-MIS estimator pair from a G-buffer (the pass pipeline's
// shade kernel, shade_backend="pallas").
//
// Replaces kylespathtracer_tpu/ops/shade_kernel.py:dual_mis_pallas (its body
// `_shade_kernel`). Per pixel: the shading point hl = cam + rd·depth from
// the G-buffer's ray direction and depth, then one sample of the direct
// light and the four plane-strategy roulettes for both estimators
// (frame_body.cuh:shade_sample) on the G-buffer normal and object ID with
// the pixel's seed, ONE sample, as the TPU kernel takes whatever the smp
// counts; zero where the pixel is a miss or the light. In: normal
// [H][W][3], obj_id, depth, ray_dir [H][W][3], seed [H][W]; out: est_d,
// est_s [H][W][3].
//
// What bounds it on an H100: arithmetic and branches, as K1's shade part
// (~9 visibility traces per shaded pixel); its device-memory traffic is 36
// bytes in and 24 out per pixel. The design is K1's frame body: one thread
// per pixel in 16×8 tiles, the tables gathered into shared memory from the
// scene's tensors (no packing launch), the plane strategies in the thread's
// shared-memory slots, the rounded box culled before its candidates; misses
// and the light skip the shade (the tensor code computes and masks them).
// Six resident blocks of 128 threads per SM (72 registers) hide more latency
// than K1's five (PERF.md). Built with -fmad=false (ops/_build.py), so
// it rounds like its plain version; K1 compiles the same body with nvcc's
// default contraction.
#include "frame_body.cuh"

namespace kpt {

// The G-buffer in and the estimator pair out.
struct ShadeIO {
  const float *normal, *depth, *ray_dir;
  const int *obj_id, *seed;
  float *est_d, *est_s;
};

__global__ void __launch_bounds__(BLOCK, 6) shade_kernel(TableParts tp, FrameParams P, ShadeIO io) {
  extern __shared__ float smem[];
  const Tables T = load_table_parts(smem, tp, P);
  const Slot slot = thread_slot(smem, P);

  const int x = blockIdx.x * TILE_W + threadIdx.x % TILE_W;
  const int y = blockIdx.y * TILE_H + threadIdx.x / TILE_W;
  if (x >= P.width || y >= P.height) return;
  const size_t p = (size_t)y * P.width + x;

  const int ho = io.obj_id[p];
  float ed[3] = {0.0f, 0.0f, 0.0f}, es[3] = {0.0f, 0.0f, 0.0f};
  if (ho != T.light_id && ho > 0) {
    const V3 hn = mk(io.normal[3 * p], io.normal[3 * p + 1], io.normal[3 * p + 2]);
    const V3 rd = mk(io.ray_dir[3 * p], io.ray_dir[3 * p + 1], io.ray_dir[3 * p + 2]);
    const float t = io.depth[p];
    const V3 hl = mk(T.f[T.cam] + rd.x * t, T.f[T.cam + 1] + rd.y * t, T.f[T.cam + 2] + rd.z * t);
    shade_sample(T, slot, hn, rd, ho, hl, io.seed[p], P.soft_beta, P.gloss, ed, es);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    io.est_d[3 * p + c] = ed[c];
    io.est_s[3 * p + c] = es[c];
  }
}

}  // namespace kpt

extern "C" int kpt_dual_mis(const kpt::TableParts* tp, int nP, int nS, int nB, int nK, int width, int height,
                            float soft_beta, int gloss, const kpt::ShadeIO* io, void* stream) {
  if (nP > kpt::MAX_PLANES) return (int)cudaErrorInvalidValue;
  kpt::FrameParams P{nP, nS, nB, nK, width, height, 0.0f, 0, 0, height, 1, 0, 1, soft_beta, gloss};
  const size_t shmem = kpt::body_smem(nP, nS, nB, nK);
  if (shmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kpt::shade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((width + kpt::TILE_W - 1) / kpt::TILE_W, (height + kpt::TILE_H - 1) / kpt::TILE_H);
  kpt::shade_kernel<<<grid, kpt::BLOCK, shmem, (cudaStream_t)stream>>>(*tp, P, *io);
  return (int)cudaGetLastError();
}
