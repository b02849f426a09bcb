// K4: the dual-MIS estimator pair from a G-buffer (the pass pipeline's
// shade kernel, shade_backend="pallas").
//
// Replaces kylespathtracer_tpu/ops/shade_kernel.py:dual_mis_pallas (its body
// `_shade_kernel`). Per pixel: the shading point hl = cam + rd·depth from
// the G-buffer's ray direction and depth, then the shared shade core
// (shade_core.cuh: direct light + the four plane-strategy roulettes for both
// estimators) on the G-buffer normal and object ID with the pixel's seed,
// ONE sample, as the TPU kernel takes whatever the smp counts; zero where the
// pixel is a miss or the light. In: normal [H][W][3], obj_id, depth,
// ray_dir [H][W][3], seed [H][W]; out: est_d, est_s [H][W][3].
//
// What bounds it on an H100: arithmetic and branches, as K1's shade part
// (~9 visibility traces per shaded pixel); its device-memory traffic is 36
// bytes in and 24 out per pixel. The design is K1's: the scene tables in
// shared memory, one thread per pixel in 16×8 blocks, misses and the light
// skip the shade core (the tensor code computes and masks them). Built with
// -fmad=false (ops/_build.py), so it rounds like its plain version.
#include "frame_core.cuh"

namespace kpt {

__global__ void __launch_bounds__(128, 5) shade_kernel(const float* __restrict__ ftab, const int* __restrict__ itab,
                                                       FrameParams P, const float* __restrict__ normal,
                                                       const int* __restrict__ obj_id, const float* __restrict__ depth,
                                                       const float* __restrict__ ray_dir, const int* __restrict__ seed,
                                                       float* __restrict__ est_d, float* __restrict__ est_s) {
  extern __shared__ float smem[];
  const Tables T = load_tables(smem, ftab, itab, P);

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= P.width || y >= P.height) return;
  const size_t p = (size_t)y * P.width + x;

  const int ho = obj_id[p];
  float ed[3] = {0.0f, 0.0f, 0.0f}, es[3] = {0.0f, 0.0f, 0.0f};
  if (ho != T.light_id && ho > 0) {
    const V3 hn = mk(normal[3 * p], normal[3 * p + 1], normal[3 * p + 2]);
    const V3 rd = mk(ray_dir[3 * p], ray_dir[3 * p + 1], ray_dir[3 * p + 2]);
    const float t = depth[p];
    const V3 hl = mk(T.f[T.cam] + rd.x * t, T.f[T.cam + 1] + rd.y * t, T.f[T.cam + 2] + rd.z * t);
    shade_core<float>(T, hn, rd, ho, hl, seed[p], P.soft_beta, P.gloss, ed, es);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    est_d[3 * p + c] = ed[c];
    est_s[3 * p + c] = es[c];
  }
}

}  // namespace kpt

extern "C" int kpt_dual_mis(const float* ftab, const int* itab, int nP, int nS, int nB, int nK, int width,
                            int height, float soft_beta, int gloss, const float* normal, const int* obj_id,
                            const float* depth, const float* ray_dir, const int* seed, float* est_d, float* est_s,
                            void* stream) {
  if (nP > kpt::MAX_PLANES) return (int)cudaErrorInvalidValue;
  kpt::FrameParams P{nP, nS, nB, nK, width, height, 0.0f, 0, 0, height, 1, 0, 1, soft_beta, gloss};
  const size_t shmem = kpt::table_smem(nP, nS, nB, nK, false);
  const dim3 block(16, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  kpt::shade_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(ftab, itab, P, normal, obj_id, depth, ray_dir,
                                                                  seed, est_d, est_s);
  return (int)cudaGetLastError();
}
