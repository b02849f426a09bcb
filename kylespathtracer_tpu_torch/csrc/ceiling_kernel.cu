// K9: the op-mix ceiling probe.
//
// Replaces bench_ceiling.py:_mix_kernel (its pallas_call in run_variant):
// per element of two f32 planes x and y, `chains` pairs
// (x·f32(1 + c/16), y + f32(c/32)) each take `iters` rounds of a template
// of elementwise operations, round k = (i·chains + c) % 7; after each sweep
// i, live plane i % live gains xs[0]·1e-6; the output sums the chains, the
// ys·0.001 and the planes·1e-6 in that order. Templates (the JAX file's):
// frame_mix (72 operations: the frame kernel's primitive mix, one division
// and one square root), fma (64 multiplies and adds) and fma_bf16 (the
// same in bfloat16).
//
// What bounds it on an H100: the operations, by construction (~2.6-2.9k per
// element against 12 bytes moved). The probe measures the rate at which the
// SMs retire this mix; the other kernels' operation counts are divided by
// it (chip_smoke.py: bound_measured_ms).
//
// Design: one thread per element, loads and stores coalesced. The template,
// iters, chains and live are template parameters, one instantiation per
// variant of the sweep (ops/ceiling_kernel.py: KERNEL_VARIANTS); every
// round is unrolled at compile time, as Python unrolls the Pallas body, so
// the code is the template's operations with no loop around them, and the
// chains and live planes are register values. On the TPU the live planes
// stood for the shade kernel's VMEM planes; here they stand for register
// pressure.
//
// Rounding: this file compiles with -fmad=false (ops/_build.py), so no
// multiply and add contract; division and sqrt are the correctly rounded
// div.rn and sqrt.rn. Every Python constant is rounded once from its double
// to f32 (f32() below), and the round constant 0.6 + 0.05k is computed in
// double, as in Python. max/min pass NaN on (max.NaN, min.NaN), as
// jnp.maximum and torch.maximum do; fmaxf would not. bfloat16 operations
// are mul.rn.bf16 and add.rn.bf16: one rounding of the exact result, which
// is what f32 arithmetic rounded to bfloat16 (torch, XLA) gives for
// bfloat16 operands; the bfloat16 constants are rounded from the double
// directly (nearest, ties to even), which for the eight constants used is
// also what the double → f32 → bfloat16 route gives.
#include <cuda_runtime.h>

namespace kpt {
namespace {

constexpr int BLOCK = 128;
// Template ids, as ops/ceiling_kernel.py: TEMPLATE_IDS.
constexpr int FMA = 0, FMA_BF16 = 1, FRAME_MIX = 2;

__host__ __device__ constexpr float f32(double v) { return static_cast<float>(v); }

// The bfloat16 bits of v in [0.5, 1): 8 significant bits, to nearest, ties
// to even.
__host__ __device__ constexpr unsigned short bf16_bits(double v) {
  const double s = v * 256.0;  // [128, 256): the significand, 7 fraction bits
  long long f = static_cast<long long>(s);
  const double r = s - static_cast<double>(f);
  if (r > 0.5 || (r == 0.5 && (f & 1))) ++f;
  return f == 256 ? 0x3F80 : static_cast<unsigned short>((126 << 7) | (f - 128));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ unsigned short to_bf16(float a) {
  unsigned short d;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(d) : "f"(a));
  return d;
}

__device__ __forceinline__ float from_bf16(unsigned short a) { return __uint_as_float(static_cast<unsigned>(a) << 16); }

__device__ __forceinline__ unsigned short mul_bf16(unsigned short a, unsigned short b) {
  unsigned short d;
  asm("mul.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

__device__ __forceinline__ unsigned short add_bf16(unsigned short a, unsigned short b) {
  unsigned short d;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

// One 72-operation round of the frame kernel's mix
// (bench_ceiling.py:_template_mix), operation for operation.
template <int K>
__device__ __forceinline__ void round_mix(float& x_, float& y_) {
  constexpr float c1 = f32(0.6 + 0.05 * K);
  float x = x_, y = y_;
  // 17 mul, 12 add, 5 sub
  x = x * y + c1;
  y = y * f32(0.75) + x * f32(0.125);
  x = x - y * f32(0.25);
  y = y * x + f32(0.3);
  x = x * f32(0.5) - y;
  y = y + x * f32(0.0625);
  x = x * y + f32(0.2);
  y = y * f32(0.8) + x;
  x = x - y * f32(0.5);
  y = y * x + c1;
  x = x * f32(0.25) + y;
  y = y - x * f32(0.125);
  x = x * y + f32(0.15);
  y = y * f32(0.7) + x;
  x = x - y;
  y = y + f32(0.4);
  x = x * c1 + y * f32(0.3);
  // 7 compares, 4 and, 7 selects, 3 max, 3 min
  const bool m1 = x > y, m2 = x < c1, m3 = y >= 0.0f, m4 = x <= 2.0f, m5 = y != x, m6 = x > 0.5f, m7 = y < 1.5f;
  const bool a1 = m1 & m2, a2 = m3 & m4, a3 = m5 & m6, a4 = a1 & m7;
  x = a1 ? x : y;
  y = a2 ? y : x * 0.5f;
  x = a3 ? x + 0.125f : x;
  y = a4 ? y : 0.0f;
  x = m5 ? x : 1.0f;
  y = m6 ? y : x;
  x = m7 ? x : y;
  x = max_nan(x, -4.0f);
  y = max_nan(y, x * 0.25f);
  x = max_nan(x, f32(0.001));
  x = min_nan(x, 4.0f);
  y = min_nan(y, 3.0f);
  x = min_nan(x, y + 2.0f);
  // abs, neg, floor, div, sqrt
  y = fabsf(y);
  x = -x;
  y = y - floorf(y * 0.125f);
  x = x / (y + 1.5f);
  x = sqrtf(fabsf(x) + 0.0625f);
  x_ = x;
  y_ = y;
}

// 64 multiplies and adds in 16 nonlinear steps (bench_ceiling.py:_template_fma).
template <int K>
__device__ __forceinline__ void round_fma(float& x, float& y) {
  constexpr float c1 = f32(0.6 + 0.05 * K);
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    x = x * y + c1;
    y = y * f32(0.65) + x;
  }
}

// The fma round in bfloat16 (bench_ceiling.py:_template_fma_bf16): the
// chain values round to bfloat16 on entry and return as f32.
template <int K>
__device__ __forceinline__ void round_fma_bf16(float& x_, float& y_) {
  constexpr unsigned short c1 = bf16_bits(0.6 + 0.05 * K), c2 = bf16_bits(0.65);
  unsigned short x = to_bf16(x_), y = to_bf16(y_);
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    x = add_bf16(mul_bf16(x, y), c1);
    y = add_bf16(mul_bf16(y, c2), x);
  }
  x_ = from_bf16(x);
  y_ = from_bf16(y);
}

template <int TPL, int K>
__device__ __forceinline__ void one_round(float& x, float& y) {
  if constexpr (TPL == FRAME_MIX) {
    round_mix<K>(x, y);
  } else if constexpr (TPL == FMA) {
    round_fma<K>(x, y);
  } else {
    round_fma_bf16<K>(x, y);
  }
}

// Rounds STEP.. of the sweep, STEP = i·CHAINS + c, each round k = STEP % 7;
// after chain CHAINS-1 of sweep i, the live plane i % LIVE.
template <int TPL, int ITERS, int CHAINS, int LIVE, int STEP, int NP>
__device__ __forceinline__ void sweep(float (&xs)[CHAINS], float (&ys)[CHAINS], float (&planes)[NP]) {
  if constexpr (STEP < ITERS * CHAINS) {
    constexpr int c = STEP % CHAINS, i = STEP / CHAINS;
    one_round<TPL, STEP % 7>(xs[c], ys[c]);
    if constexpr (LIVE > 0 && c == CHAINS - 1) planes[i % LIVE] = planes[i % LIVE] + xs[0] * f32(1e-6);
    sweep<TPL, ITERS, CHAINS, LIVE, STEP + 1>(xs, ys, planes);
  }
}

template <int TPL, int ITERS, int CHAINS, int LIVE>
__global__ void __launch_bounds__(BLOCK) mix_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                                    float* __restrict__ out, int n) {
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p >= n) return;
  const float x0 = x[p], y0 = y[p];
  float xs[CHAINS], ys[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    xs[c] = x0 * f32(1.0 + 0.0625 * c);
    ys[c] = y0 + f32(0.03125 * c);
  }
  float planes[LIVE > 0 ? LIVE : 1];
#pragma unroll
  for (int j = 0; j < LIVE; ++j) planes[j] = x0 * f32(0.5 + 0.01 * j) + y0 * 0.125f;
  sweep<TPL, ITERS, CHAINS, LIVE, 0>(xs, ys, planes);
  float acc = xs[0];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) acc = acc + xs[c];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc = acc + ys[c] * f32(0.001);
#pragma unroll
  for (int j = 0; j < LIVE; ++j) acc = acc + planes[j] * f32(1e-6);
  out[p] = acc;
}

struct Variant {
  int tpl, iters, chains, live;
  void (*fn)(const float*, const float*, float*, int);
};

// ops/ceiling_kernel.py: KERNEL_VARIANTS (the sweep, then the fma probe
// that runs half its steps on finite values).
const Variant VARIANTS[] = {
    {FMA, 40, 1, 0, mix_kernel<FMA, 40, 1, 0>},
    {FMA, 20, 2, 0, mix_kernel<FMA, 20, 2, 0>},
    {FMA, 10, 4, 0, mix_kernel<FMA, 10, 4, 0>},
    {FMA, 5, 8, 0, mix_kernel<FMA, 5, 8, 0>},
    {FMA_BF16, 40, 1, 0, mix_kernel<FMA_BF16, 40, 1, 0>},
    {FMA_BF16, 10, 4, 0, mix_kernel<FMA_BF16, 10, 4, 0>},
    {FRAME_MIX, 40, 1, 0, mix_kernel<FRAME_MIX, 40, 1, 0>},
    {FRAME_MIX, 20, 2, 0, mix_kernel<FRAME_MIX, 20, 2, 0>},
    {FRAME_MIX, 10, 4, 0, mix_kernel<FRAME_MIX, 10, 4, 0>},
    {FRAME_MIX, 5, 8, 0, mix_kernel<FRAME_MIX, 5, 8, 0>},
    {FRAME_MIX, 20, 2, 16, mix_kernel<FRAME_MIX, 20, 2, 16>},
    {FRAME_MIX, 20, 2, 32, mix_kernel<FRAME_MIX, 20, 2, 32>},
    {FRAME_MIX, 20, 2, 64, mix_kernel<FRAME_MIX, 20, 2, 64>},
    {FRAME_MIX, 20, 2, 96, mix_kernel<FRAME_MIX, 20, 2, 96>},
    {FMA, 1, 8, 0, mix_kernel<FMA, 1, 8, 0>},
};

static_assert(bf16_bits(0.6) == 0x3F1A && bf16_bits(0.65) == 0x3F26 && bf16_bits(0.75) == 0x3F40,
              "bfloat16 constants");

}  // namespace
}  // namespace kpt

// out[p] for p < n from x[p], y[p]; the variant (template id, iters, chains,
// live) must be one of VARIANTS, else cudaErrorInvalidValue.
extern "C" int kpt_mix_ceiling(const float* x, const float* y, float* out, int n, int tpl, int iters, int chains,
                               int live, void* stream) {
  for (const kpt::Variant& v : kpt::VARIANTS) {
    if (v.tpl == tpl && v.iters == iters && v.chains == chains && v.live == live) {
      void* args[] = {&x, &y, &out, &n};
      return (int)cudaLaunchKernel((const void*)v.fn, dim3((n + kpt::BLOCK - 1) / kpt::BLOCK), dim3(kpt::BLOCK),
                                   args, 0, (cudaStream_t)stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}
