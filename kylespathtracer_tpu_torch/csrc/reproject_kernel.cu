// K2: the windowed temporal reprojection of one channel set.
//
// Replaces kylespathtracer_tpu/ops/reproject_kernel.py:reproject_pallas
// (its body `_reproject_kernel` → `_set_kernel_dyn`), full-frame mode. One
// launch per channel set (diffuse, then specular), as on the TPU.
//
// Per pixel: the 2×2 bilinear history taps inside ±K whose object ID
// matches, summed by `tap_sum` (reproject_core.cuh, shared with K8).
//
// What bounds it on an H100: device-memory bytes. Per pixel it reads 7
// query planes (28 B) and, for each live tap, 5 history floats, and writes
// 16 B; the arithmetic is a few dozen instructions. The TPU kernel needed
// row-block halos and lane rolls to avoid a gather; here the gather is
// direct and bounded: neighbouring threads read neighbouring history
// texels, so the taps of a warp fall in a few cache lines served by L1/L2.
#include "reproject_core.cuh"

namespace kpt {

__global__ void __launch_bounds__(256) reproject_kernel(
    const int* __restrict__ ho, const int* __restrict__ dyrel, const int* __restrict__ dxrel,
    const float* __restrict__ wy0, const float* __restrict__ wy1, const float* __restrict__ wx0,
    const float* __restrict__ wx1, const float* __restrict__ hist_rgb, const float* __restrict__ hist_cnt,
    const int* __restrict__ hist_oid, float* __restrict__ out_rgb, float* __restrict__ out_cnt, int H, int W,
    int K) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W || y >= H) return;
  const size_t p = (size_t)y * W + x;
  const int id = ho[p];
  const int dy = dyrel[p], dx = dxrel[p];
  const float wy[2] = {wy0[p], wy1[p]};
  const float wx[2] = {wx0[p], wx1[p]};

  float acc[4];
  tap_sum(hist_rgb, hist_cnt, hist_oid, id, y, x, dy, dx, wy, wx, K, H, W, acc);
  out_rgb[3 * p] = acc[0];
  out_rgb[3 * p + 1] = acc[1];
  out_rgb[3 * p + 2] = acc[2];
  out_cnt[p] = acc[3];
}

}  // namespace kpt

extern "C" int kpt_reproject_window(const int* ho, const int* dyrel, const int* dxrel, const float* wy0,
                                    const float* wy1, const float* wx0, const float* wx1,
                                    const float* hist_rgb, const float* hist_cnt, const int* hist_oid,
                                    float* out_rgb, float* out_cnt, int H, int W, int K, void* stream) {
  const dim3 block(256, 1);
  const dim3 grid((W + block.x - 1) / block.x, H);
  kpt::reproject_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      ho, dyrel, dxrel, wy0, wy1, wx0, wx1, hist_rgb, hist_cnt, hist_oid, out_rgb, out_cnt, H, W, K);
  return (int)cudaGetLastError();
}
