// K5: the fused frame's backward kernel (its vector-Jacobian product).
//
// Replaces kylespathtracer_tpu/ops/frame_grad.py:frame_backward_pallas
// (its body `_frame_bwd_kernel`: re-run frame_block per block, apply
// jax.vjp of it to the cotangent planes, accumulate the scene-table
// gradients). Given cotangent planes g_k for the frame's float outputs,
// it returns Σ_pixels Σ_k g_k · ∂out_k/∂θ for every seeded entry θ of the
// flat f32 scene table (ops/frame_kernel.py:pack_tables order).
//
// What bounds it on an H100: arithmetic. The only device-memory traffic is
// the cotangent planes, read once (≤ 13 f32 per pixel), and a few hundred
// gradient floats; the work is the frame's own per-pixel math plus its
// derivative, which reverse mode would do in at most about three times the
// forward's operations.
//
// Design: forward mode, not a reverse sweep written by hand. The frame body
// (frame_core.cuh) is a template on its scalar type; here it runs on
// Dual<NT>, so each pixel carries NT tangents, one per seeded table entry
// of this chunk, through the same code K1 runs, and the derivative follows
// the branch each pixel took. The seeded entries are cut into chunks of NT,
// and the chunk is the grid's z dimension, so a call is one launch. Per
// pixel the tangents of the 13 outputs are dotted with the cotangents; the
// warp sums each lane with shuffles and lane 0 adds it to the gradient with
// one atomicAdd. The cost is one forward per chunk at about NT+1 times the
// float work on the differentiable path; the occlusion tests and the
// roulette's choice stay float (shade_core.cuh), as they carry no
// derivative. Float atomics make the sum's order vary from run to run.
#include "frame_core.cuh"

namespace kpt {

__global__ void __launch_bounds__(128) frame_grad_kernel(const float* __restrict__ ftab,
                                                         const int* __restrict__ itab,
                                                         const int* __restrict__ seeds, int n_seeds,
                                                         FrameParams P, const float* __restrict__ g, int present,
                                                         float* __restrict__ out_g) {
  extern __shared__ float smem[];
  const Tables T = load_tables(smem, ftab, itab, P, seeds, n_seeds, blockIdx.z, NT);

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  float acc[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i] = 0.0f;
  // Threads off the image stay for the warp sums below.
  if (x < P.width && r < P.rows) {
    DualNT vals[13];
    int oid;
    frame_pixel<DualNT>(T, P, x, P.row_base + r, vals, oid);
    const size_t plane = (size_t)P.rows * (size_t)P.width;
    const size_t o = (size_t)r * (size_t)P.width + (size_t)x;
    int j = 0;  // the cotangent planes hold the present outputs only
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      if (present & (1 << k)) {
        const float gk = g[(size_t)j * plane + o];
        ++j;
#pragma unroll
        for (int i = 0; i < NT; ++i) acc[i] += gk * vals[k].d[i];
      }
    }
  }
  add_tangents(acc, out_g, n_seeds);
}

}  // namespace kpt

// g: the present cotangent planes [popcount(present)][height][width] in
// output order (bit k of `present`: plane k). out_g[n_seeds] must be zeroed.
extern "C" int kpt_frame_backward(const float* ftab, const int* itab, const int* seeds, int n_seeds, int nP,
                                  int nS, int nB, int nK, int width, int height, float fov, int frame, int smp,
                                  int decorrelate, int biased, float soft_beta, int gloss, const float* g,
                                  int present, float* out_g, void* stream) {
  if (nP > kpt::MAX_PLANES) return (int)cudaErrorInvalidValue;
  if (n_seeds <= 0 || present == 0) return 0;
  kpt::FrameParams P{nP, nS, nB, nK, width, height, fov, frame, 0, height,
                     smp, decorrelate, biased, soft_beta, gloss};
  const size_t shmem = kpt::table_smem(nP, nS, nB, nK, true);
  kpt::frame_grad_kernel<<<kpt::grad_grid(width, height, n_seeds), dim3(16, 8), shmem, (cudaStream_t)stream>>>(
      ftab, itab, seeds, n_seeds, P, g, present, out_g);
  return (int)cudaGetLastError();
}
