// K6: the fused loss-and-gradient kernel, the inverse-rendering hot loop.
//
// Replaces kylespathtracer_tpu/ops/loss_kernel.py:render_loss_and_grad
// (its body `_loss_grad_kernel`: frame_block, the fresh-history composite,
// ACES and sRGB, then MSE against a target or the plain sum, and jax.vjp of
// that scalar with cotangent 1). One launch returns the summed per-pixel
// loss and its gradient for every requested entry of the flat f32 scene
// table (ops/frame_kernel.py:table_parts order); the wrapper divides both
// by H·W·3.
//
// What bounds it on an H100: arithmetic, as for K5 (frame_grad.cu). Device
// memory sees the target (3 f32 per pixel) and a few hundred gradient
// floats; no image plane is written.
//
// Design: K5's reverse-mode pass (frame_adjoint.cuh) with another source of
// the cotangents. Each thread runs its pixel's frame forward in float, then
// the composite and the loss on Dual<11> over the 11 planes they read (a
// leaf Jacobian: its tangents are the planes' cotangents), sums the loss
// per warp, and hands the cotangents to frame_pixel_adjoint. The grid
// covers the pixels only.
#include "frame_adjoint.cuh"

namespace kpt {

// composite_from + aces_fitted + linear_srgb for the fresh-history frame
// (both counts 1; passthrough.frag:29-47, common.glsl:111-139), on the 13
// planes of one pixel.
template <typename S>
__device__ void composite_pixel(const S v[13], float brightness, S img[3]) {
  const float aces_in[3][3] = {
      {0.59719f, 0.35458f, 0.04823f}, {0.07600f, 0.90834f, 0.01566f}, {0.02840f, 0.13383f, 0.83777f}};
  const float aces_out[3][3] = {
      {1.60475f, -0.53108f, -0.07367f}, {-0.10208f, 1.10813f, -0.00605f}, {-0.00327f, -0.07276f, 1.07602f}};
  S o[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const S alb = v[6 + c];
    const S alb_sqrt = alb > 0.0f ? sqrtf(alb) : S(0.0f);
    o[c] = (v[c] * alb * v[9] + v[3 + c] * alb_sqrt * v[10]) * brightness;
  }
  S cpl[3], rat[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) cpl[r] = o[0] * aces_in[r][0] + o[1] * aces_in[r][1] + o[2] * aces_in[r][2];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const S a = cpl[c] * (cpl[c] + 0.0245786f) - 0.000090537f;
    const S b = cpl[c] * (0.983729f * cpl[c] + 0.4329510f) + 0.238081f;
    rat[c] = a / b;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) cpl[r] = rat[0] * aces_out[r][0] + rat[1] * aces_out[r][1] + rat[2] * aces_out[r][2];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const S x = clip(cpl[c], 0.0f, 1.0f);
    const S lo = 12.92f * x;
    const S hi = 1.055f * powf(fmaxf(x, 1e-10f), (float)(1.0 / 2.4)) - 0.055f;
    img[c] = x <= 0.0031308f ? lo : hi;
  }
}

__global__ void __launch_bounds__(128, 5) loss_grad_kernel(TableParts tp, const int* __restrict__ seeds, int n_seeds,
                                                           FrameParams P, float brightness, int mse,
                                                           const float* __restrict__ target,
                                                           float* __restrict__ out_loss, float* __restrict__ out_g) {
  extern __shared__ float smem[];
  float* sg;
  const Tables T = load_table_parts(smem, tp, P, &sg);
  Grad G(sg);
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  float lsum = 0.0f;
  // Threads off the image stay for the sums below.
  if (x < P.width && r < P.rows) {
    float vals[13];
    int oid;
    frame_pixel<float>(T, P, x, P.row_base + r, vals, oid);
    using D = Dual<11>;  // the composite reads planes 0-10
    D v[13];
#pragma unroll
    for (int k = 0; k < 13; ++k) v[k] = seeded<11>(vals[k], k < 11 ? k : -1);
    D img[3];
    composite_pixel(v, brightness, img);
    const size_t plane = (size_t)P.rows * (size_t)P.width;
    const size_t o = (size_t)r * (size_t)P.width + (size_t)x;
    D l = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (mse) {
        const D res = img[c] - target[c * plane + o];
        l = l + res * res;
      } else {
        l = l + img[c];
      }
    }
    lsum = l.v;
    float gbar[13];
#pragma unroll
    for (int k = 0; k < 13; ++k) gbar[k] = k < 11 ? l.d[k] : 0.0f;
    frame_pixel_adjoint(T, P, x, P.row_base + r, gbar, G);
  }
  warp_add(lsum, out_loss);
  flush_grad(T, G, seeds, n_seeds, out_g);
}

}  // namespace kpt

// target: [3][height][width] planes (read when mse != 0). out_loss[1] and
// out_g[n_seeds] must be zeroed; both hold sums over the pixels, out_g[i]
// the gradient of flat-table entry seeds[i].
extern "C" int kpt_loss_grad(const kpt::TableParts* tp, const int* seeds, int n_seeds, int nP, int nS, int nB,
                             int nK, int width, int height, float fov, int frame, int smp, int decorrelate,
                             int biased, float soft_beta, int gloss, float brightness, int mse, const float* target,
                             float* out_loss, float* out_g, void* stream) {
  if (nP > kpt::MAX_PLANES) return (int)cudaErrorInvalidValue;
  kpt::FrameParams P{nP, nS, nB, nK, width, height, fov, frame, 0, height,
                     smp, decorrelate, biased, soft_beta, gloss};
  const size_t shmem = kpt::table_smem(nP, nS, nB, nK, true);
  const dim3 grid((width + 15) / 16, (height + 7) / 8);
  kpt::loss_grad_kernel<<<grid, dim3(16, 8), shmem, (cudaStream_t)stream>>>(*tp, seeds, n_seeds, P, brightness, mse,
                                                                             target, out_loss, out_g);
  return (int)cudaGetLastError();
}
