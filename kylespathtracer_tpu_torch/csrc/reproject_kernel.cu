// K2: the windowed temporal reprojection of one channel set.
//
// Replaces kylespathtracer_tpu/ops/reproject_kernel.py:reproject_pallas
// (its body `_reproject_kernel` → `_set_kernel_dyn`), in full-frame and in
// tile mode. One launch per channel set (diffuse, then specular), as on the
// TPU.
//
// Per pixel: the 2×2 bilinear history taps inside ±K whose object ID
// matches, summed by `tap_sum` (reproject_core.cuh, shared with K8).
//
// Tile mode (the tile branch of reproject_pallas, run by the sharded
// renderer, parallel/shard.py): the queries cover image rows
// [row_base, row_base+rows) of an H-row image, and the history is the
// window of rows + 2·halo rows around them that the halo exchange
// assembles, its first row image row hist_row0 = row_base − halo. The TPU
// kernel reads that window through BlockSpecs shifted by the halo's
// blocks; here a tap's window row is its image row less hist_row0. Taps
// reach at most K ≤ halo rows (the wrapper checks), so they stay inside
// the window; rows beyond the image carry zero weight from the query head.
//
// What bounds it on an H100: device-memory bytes. Per pixel it reads 7
// query planes (28 B) and, for each live tap, 5 history floats, and writes
// 16 B; the arithmetic is a few dozen instructions. The TPU kernel needed
// row-block halos and lane rolls to avoid a gather; here the gather is
// direct and bounded: neighbouring threads read neighbouring history
// texels, so the taps of a warp fall in a few cache lines served by L1/L2.
#include "reproject_core.cuh"

namespace kpt {

// Query row r is image row row_base + r; the full frame has row_base =
// hist_row0 = 0 and rows = H.
__global__ void __launch_bounds__(256) reproject_kernel(
    const int* __restrict__ ho, const int* __restrict__ dyrel, const int* __restrict__ dxrel,
    const float* __restrict__ wy0, const float* __restrict__ wy1, const float* __restrict__ wx0,
    const float* __restrict__ wx1, const float* __restrict__ hist_rgb, const float* __restrict__ hist_cnt,
    const int* __restrict__ hist_oid, float* __restrict__ out_rgb, float* __restrict__ out_cnt, int rows, int H,
    int W, int K, int row_base, int hist_row0) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (x >= W || r >= rows) return;
  const size_t p = (size_t)r * W + x;
  const int id = ho[p];
  const int dy = dyrel[p], dx = dxrel[p];
  const float wy[2] = {wy0[p], wy1[p]};
  const float wx[2] = {wx0[p], wx1[p]};

  float acc[4];
  tap_sum(hist_rgb, hist_cnt, hist_oid, id, row_base + r, x, dy, dx, wy, wx, K, H, W, hist_row0, acc);
  out_rgb[3 * p] = acc[0];
  out_rgb[3 * p + 1] = acc[1];
  out_rgb[3 * p + 2] = acc[2];
  out_cnt[p] = acc[3];
}

}  // namespace kpt

// The queries and outputs are [rows][W] for image rows [row_base,
// row_base+rows) of an H-row image; the history's first row is image row
// hist_row0 (the full frame: rows = H, row_base = hist_row0 = 0).
extern "C" int kpt_reproject_window(const int* ho, const int* dyrel, const int* dxrel, const float* wy0,
                                    const float* wy1, const float* wx0, const float* wx1,
                                    const float* hist_rgb, const float* hist_cnt, const int* hist_oid,
                                    float* out_rgb, float* out_cnt, int rows, int H, int W, int K, int row_base,
                                    int hist_row0, void* stream) {
  const dim3 block(256, 1);
  const dim3 grid((W + block.x - 1) / block.x, rows);
  kpt::reproject_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      ho, dyrel, dxrel, wy0, wy1, wx0, wx1, hist_rgb, hist_cnt, hist_oid, out_rgb, out_cnt, rows, H, W, K,
      row_base, hist_row0);
  return (int)cudaGetLastError();
}
