// K5: the fused frame's backward kernel (its vector-Jacobian product).
//
// Replaces kylespathtracer_tpu/ops/frame_grad.py:frame_backward_pallas
// (its body `_frame_bwd_kernel`: re-run frame_block per block, apply
// jax.vjp of it to the cotangent planes, accumulate the scene-table
// gradients). Given cotangent planes g_k for the frame's float outputs,
// it returns Σ_pixels Σ_k g_k · ∂out_k/∂θ for every requested entry θ of
// the flat f32 scene table (ops/frame_kernel.py:table_parts order).
//
// What bounds it on an H100: arithmetic. The only device-memory traffic is
// the cotangent planes, read once (≤ 13 f32 per pixel), and a few hundred
// gradient floats; the work is the frame's own per-pixel math and its
// reverse sweep, about three times the forward's operations.
//
// Row mode (frame_backward_pallas's `row_base`/`rows`, run by the sharded
// trainer, parallel/shard.py): the cotangent planes cover image rows
// [row_base, row_base+rows) of the height-row image, the grid covers those
// rows only, NDC and seeds stay the full image's, and the result is the
// tile's partial gradient, which the trainer sums over the ranks.
//
// Design: one reverse-mode pass over the pixels, as the JAX kernel's
// jax.vjp. Each thread reads its pixel's present cotangents and runs
// frame_adjoint.cuh:frame_pixel_adjoint (the forward recomputed in float,
// then the hand-written reverse sweep), which adds the gradient into the
// block's shared copy of the table; at the end of the block each requested
// entry is added to out_g with one global atomicAdd. The grid covers the
// pixels only, so the cost does not grow with the number of entries asked
// for. Float atomics make the sum's order vary from run to run. 5 blocks
// of 128 threads per SM (96 registers, about 1 KB spilled) was the fastest
// cap at 1920×1080 (ops/adjoint_variants.py).
#include "frame_adjoint.cuh"

namespace kpt {

__global__ void __launch_bounds__(128, 5) frame_grad_kernel(TableParts tp, const int* __restrict__ seeds, int n_seeds,
                                                            FrameParams P, const float* __restrict__ g, int present,
                                                            float* __restrict__ out_g) {
  extern __shared__ float smem[];
  float* sg;
  const Tables T = load_table_parts(smem, tp, P, &sg);
  Grad G(sg);
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  // Threads off the image stay for the block's sums below.
  if (x < P.width && r < P.rows) {
    const size_t plane = (size_t)P.rows * (size_t)P.width;
    const size_t o = (size_t)r * (size_t)P.width + (size_t)x;
    float gbar[13];
    int j = 0;  // the cotangent planes hold the present outputs only
#pragma unroll
    for (int k = 0; k < 13; ++k) gbar[k] = (present & (1 << k)) ? g[(size_t)(j++) * plane + o] : 0.0f;
    frame_pixel_adjoint(T, P, x, P.row_base + r, gbar, G);
  }
  flush_grad(T, G, seeds, n_seeds, out_g);
}

}  // namespace kpt

// g: the present cotangent planes [popcount(present)][rows][width] of image
// rows [row_base, row_base+rows), in output order (bit k of `present`: plane
// k). out_g[n_seeds] must be zeroed; seeds[i] is the flat-table entry whose
// gradient lands in out_g[i].
extern "C" int kpt_frame_backward(const kpt::TableParts* tp, const int* seeds, int n_seeds, int nP, int nS,
                                  int nB, int nK, int width, int height, float fov, int frame, int row_base,
                                  int rows, int smp, int decorrelate, int biased, float soft_beta, int gloss,
                                  const float* g, int present, float* out_g, void* stream) {
  if (nP > kpt::MAX_PLANES) return (int)cudaErrorInvalidValue;
  if (n_seeds <= 0 || present == 0) return 0;
  kpt::FrameParams P{nP, nS, nB, nK, width, height, fov, frame, row_base, rows,
                     smp, decorrelate, biased, soft_beta, gloss};
  const size_t shmem = kpt::table_smem(nP, nS, nB, nK, true);
  const dim3 grid((width + 15) / 16, (rows + 7) / 8);
  kpt::frame_grad_kernel<<<grid, dim3(16, 8), shmem, (cudaStream_t)stream>>>(*tp, seeds, n_seeds, P, g, present,
                                                                              out_g);
  return (int)cudaGetLastError();
}
