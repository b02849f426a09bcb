// The display transform of one pixel, shared by the split frame's tail in
// K2 (reproject_kernel.cu:composite) and K7's tonemapped epilogue
// (path_kernel.cu): core/color.py:aces_fitted, then linear_srgb, each
// operation rounded on its own (both files build with -fmad=false,
// ops/_build.py) in the plain code's order, so that on the card the result
// is that of the plain chain bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace kpt {

// torch.clamp's bounds, which keep a NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp01(float v) { return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f); }

// A row of core/color.py:_mat3, left to right.
__device__ __forceinline__ float mat_row(const float (&v)[3], float m0, float m1, float m2) {
  return (v[0] * m0 + v[1] * m1) + v[2] * m2;
}

// core/color.py:aces_fitted, then linear_srgb, on one pixel's rgb in place.
__device__ __forceinline__ void aces_srgb(float (&v)[3]) {
  const float c[3] = {mat_row(v, 0.59719f, 0.35458f, 0.04823f), mat_row(v, 0.07600f, 0.90834f, 0.01566f),
                      mat_row(v, 0.02840f, 0.13383f, 0.83777f)};
  float q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = c[k] * (c[k] + 0.0245786f) - 0.000090537f;
    const float b = c[k] * (0.983729f * c[k] + 0.4329510f) + 0.238081f;
    q[k] = a / b;
  }
  const float o[3] = {mat_row(q, 1.60475f, -0.53108f, -0.07367f), mat_row(q, -0.10208f, 1.10813f, -0.00605f),
                      mat_row(q, -0.00327f, -0.07276f, 1.07602f)};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float x = clamp01(o[k]);
    const float lo = 12.92f * x;
    const float hi = 1.055f * powf(clamp_min(x, 1e-10f), (float)(1.0 / 2.4)) - 0.055f;
    v[k] = x <= 0.0031308f ? lo : hi;
  }
}

}  // namespace kpt
