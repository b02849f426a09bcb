// The windowed 2×2 history tap sum of one pixel, shared by the reprojection
// kernel K2 (reproject_kernel.cu) and the mono temporal frame K8
// (frame_hist.cu): the port of kylespathtracer_tpu/ops/reproject_kernel.py:
// _set_kernel_dyn.
//
// The taps (ty, tx) at (y + dy + ty, x + dx + tx), each weighted wy_ty·wx_tx,
// count only when both tap offsets lie inside ±K and the tap's history
// object ID equals the current one `id`; taps beyond K restart the history.
// Out-of-image taps carry zero weight from the query head, so they are
// skipped (adding exactly zero). The four taps are summed from zero in the
// TPU kernel's order (column offset outer, row offset inner) with no fused
// multiply-add, so the sum matches the plain version bit for bit. History is
// rgb [.][W][3], cnt [.][W], oid [.][W]: the whole image, or (tile mode) a
// window of image rows whose first row is image row `hist_row0`; y, dy and
// H are image rows either way, and the window must hold rows y-K..y+K.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace kpt {

__device__ __forceinline__ void tap_sum(const float* __restrict__ hist_rgb, const float* __restrict__ hist_cnt,
                                        const int* __restrict__ hist_oid, int id, int y, int x, int dy, int dx,
                                        const float (&wy)[2], const float (&wx)[2], int K, int H, int W,
                                        int hist_row0, float (&acc)[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
#pragma unroll
  for (int tx = 0; tx < 2; ++tx) {
    // -K <= dx + tx <= K, written without overflowing on far-off queries.
    if (dx < -K - tx || dx > K - tx) continue;
#pragma unroll
    for (int ty = 0; ty < 2; ++ty) {
      if (dy < -K - ty || dy > K - ty) continue;
      const int sy = y + dy + ty, sx = x + dx + tx;
      if (sy < 0 || sy >= H || sx < 0 || sx >= W) continue;  // zero weight
      const size_t q = (size_t)(sy - hist_row0) * W + sx;
      if (hist_oid[q] != id) continue;
      const float w = __fmul_rn(wy[ty], wx[tx]);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(w, hist_rgb[3 * q]));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(w, hist_rgb[3 * q + 1]));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(w, hist_rgb[3 * q + 2]));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(w, hist_cnt[q]));
    }
  }
}

}  // namespace kpt
