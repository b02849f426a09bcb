// Forward-mode dual numbers with N tangent lanes, for the gradient kernels.
//
// The shade core (shade_core.cuh) and the frame body (frame_core.cuh) are
// templates on their scalar type S. The frame kernel (K1) instantiates
// S = float; the backward kernel (K5, frame_grad.cu) and the fused
// loss-and-gradient kernel (K6, loss_kernel.cu) instantiate S = Dual<N>,
// which carries the value and its derivative along N seeded table entries.
//
// Derivative conventions, matching reverse-mode autodiff of the masked
// tensor code (kylespathtracer_tpu_torch/ops/shade_kernel.py):
// - comparisons read the value only, so a selection `c ? a : b` carries the
//   derivative of the branch taken and hard tests contribute zero;
// - fminf/fmaxf return the selected operand, derivative included (the
//   clamp's side on a tie, as torch.clamp);
// - fabsf differentiates to sign(x)·dx, with sign(0) = 0;
// - floorf and the seed arithmetic stay float: they carry no derivative.
#pragma once

#include <cuda_runtime.h>

namespace kpt {

// The float functions stay visible beside the dual overloads below.
using ::cosf;
using ::expf;
using ::fabsf;
using ::fmaxf;
using ::fminf;
using ::logf;
using ::powf;
using ::rsqrtf;
using ::sinf;
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
template <int N>
__device__ __forceinline__ float val(const Dual<N>& x) { return x.v; }

// Loading a scene-table entry: the plain value for float; for a dual, the
// value with tangent 1 on `lane` (its lane in this chunk, or -1).
template <typename S>
struct Scalar;
template <>
struct Scalar<float> {
  static __device__ __forceinline__ float load(float v, int) { return v; }
};
template <int N>
struct Scalar<Dual<N>> {
  static __device__ __forceinline__ Dual<N> load(float v, int lane) {
    Dual<N> r;
    r.v = v;
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = i == lane ? 1.0f : 0.0f;
    return r;
  }
};

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
__device__ __forceinline__ Dual<N> operator+(float a, const Dual<N>& b) {
  Dual<N> r = b;
  r.v = a + b.v;
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
__device__ __forceinline__ Dual<N> operator-(float a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -b.d[i];
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
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, float b) {
  Dual<N> r;
  r.v = a.v / b;
  const float inv = 1.0f / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * inv;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(float a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a / b.v;
  const float s = -r.v / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = s * b.d[i];
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
template <int N>
__device__ __forceinline__ Dual<N> cosf(const Dual<N>& a) {
  return chain(a, ::cosf(a.v), -::sinf(a.v));
}
template <int N>
__device__ __forceinline__ Dual<N> sinf(const Dual<N>& a) {
  return chain(a, ::sinf(a.v), ::cosf(a.v));
}
template <int N>
__device__ __forceinline__ Dual<N> expf(const Dual<N>& a) {
  const float e = ::expf(a.v);
  return chain(a, e, e);
}
template <int N>
__device__ __forceinline__ Dual<N> logf(const Dual<N>& a) {
  return chain(a, ::logf(a.v), 1.0f / a.v);
}
// The logistic function 1/(1+e^-x), differentiated as s·(1-s): the
// quotient form's derivative, e^-x/(1+e^-x)², is inf/inf = NaN once e^-x
// overflows (as torch.sigmoid's and jax.nn.sigmoid's derivatives are not).
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + ::expf(-x)); }
template <int N>
__device__ __forceinline__ Dual<N> sigmoid(const Dual<N>& a) {
  const float s = sigmoid(a.v);
  return chain(a, s, s * (1.0f - s));
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
__device__ __forceinline__ Dual<N> fmaxf(const Dual<N>& a, const Dual<N>& b) {
  return a.v >= b.v ? a : b;
}
template <int N>
__device__ __forceinline__ Dual<N> fmaxf(const Dual<N>& a, float b) {
  return a.v >= b ? a : Dual<N>(b);
}
template <int N>
__device__ __forceinline__ Dual<N> fmaxf(float a, const Dual<N>& b) {
  return b.v >= a ? b : Dual<N>(a);
}
template <int N>
__device__ __forceinline__ Dual<N> fminf(const Dual<N>& a, const Dual<N>& b) {
  return a.v <= b.v ? a : b;
}
template <int N>
__device__ __forceinline__ Dual<N> fminf(const Dual<N>& a, float b) {
  return a.v <= b ? a : Dual<N>(b);
}
template <int N>
__device__ __forceinline__ Dual<N> fminf(float a, const Dual<N>& b) {
  return b.v <= a ? b : Dual<N>(a);
}

}  // namespace kpt
