// Forward-mode dual numbers with N tangent lanes, for the leaf Jacobians of
// the gradient kernels' reverse sweep (frame_adjoint.cuh).
//
// The reverse sweep is written by hand, except for two leaves run once per
// pixel, whose inputs are few and bodies long: the primary hit
// (frame_adjoint.cuh) and K6's composite (loss_kernel.cu). There the code,
// a template on its scalar type S, runs once on Dual<N> with one lane
// seeded per input, and its outputs' tangents are its Jacobian. Values are
// computed by the same float operations, in the same order.
//
// Derivative conventions, matching reverse-mode autodiff of the masked
// tensor code (kylespathtracer_tpu_torch/ops/shade_kernel.py); the
// hand-written adjoints keep the same ones:
// - comparisons read the value only, so a selection `c ? a : b` carries the
//   derivative of the branch taken and hard tests contribute zero;
// - fminf/fmaxf return the selected operand, derivative included (the
//   first on a tie: the clamp's side, as torch.clamp);
// - fabsf differentiates to sign(x)·dx, with sign(0) = 0;
// - floorf and the seed arithmetic stay float: they carry no derivative.
#pragma once

#include <cuda_runtime.h>

namespace kpt {

// The float functions stay visible beside the dual overloads below.
using ::fabsf;
using ::fmaxf;
using ::fminf;
using ::powf;
using ::rsqrtf;
using ::sqrtf;

template <int N>
struct Dual {
  float v;
  float d[N];

  Dual() = default;
  __device__ __forceinline__ Dual(float x) : v(x) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = 0.0f;
  }
};

__device__ __forceinline__ float val(float x) { return x; }

// Input `lane` of a leaf Jacobian: the value v with tangent 1 on `lane`
// (none if lane < 0).
template <int N>
__device__ __forceinline__ Dual<N> seeded(float v, int lane) {
  Dual<N> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = i == lane ? 1.0f : 0.0f;
  return r;
}

// ----------------------------------------------------------- arithmetic

template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a) {
  Dual<N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v + b;
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v - b;
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, float b) {
  Dual<N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(float a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a * b.d[i];
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v / b.v;
  const float inv = 1.0f / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
  return r;
}

// ----------------------------------------------------------- comparisons

#define KPT_DUAL_CMP(op)                                                                 \
  template <int N>                                                                       \
  __device__ __forceinline__ bool operator op(const Dual<N>& a, const Dual<N>& b) {      \
    return a.v op b.v;                                                                   \
  }                                                                                      \
  template <int N>                                                                       \
  __device__ __forceinline__ bool operator op(const Dual<N>& a, float b) { return a.v op b; } \
  template <int N>                                                                       \
  __device__ __forceinline__ bool operator op(float a, const Dual<N>& b) { return a op b.v; }
KPT_DUAL_CMP(<)
KPT_DUAL_CMP(<=)
KPT_DUAL_CMP(>)
KPT_DUAL_CMP(>=)
#undef KPT_DUAL_CMP

// ------------------------------------------------------------ functions

// f(a) with f'(a) = fp: the chain rule on every lane.
template <int N>
__device__ __forceinline__ Dual<N> chain(const Dual<N>& a, float fv, float fp) {
  Dual<N> r;
  r.v = fv;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = fp * a.d[i];
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> sqrtf(const Dual<N>& a) {
  const float s = ::sqrtf(a.v);
  return chain(a, s, 0.5f / s);
}
template <int N>
__device__ __forceinline__ Dual<N> rsqrtf(const Dual<N>& a) {
  const float s = ::rsqrtf(a.v);
  return chain(a, s, -0.5f * s * s * s);
}
// x**p for a constant exponent: p·x**(p-1).
template <int N>
__device__ __forceinline__ Dual<N> powf(const Dual<N>& a, float p) {
  return chain(a, ::powf(a.v, p), p * ::powf(a.v, p - 1.0f));
}
template <int N>
__device__ __forceinline__ Dual<N> fabsf(const Dual<N>& a) {
  const float s = a.v > 0.0f ? 1.0f : (a.v < 0.0f ? -1.0f : 0.0f);
  return chain(a, ::fabsf(a.v), s);
}

template <int N>
__device__ __forceinline__ Dual<N> fmaxf(const Dual<N>& a, float b) {
  return a.v >= b ? a : Dual<N>(b);
}
template <int N>
__device__ __forceinline__ Dual<N> fminf(const Dual<N>& a, float b) {
  return a.v <= b ? a : Dual<N>(b);
}

}  // namespace kpt
