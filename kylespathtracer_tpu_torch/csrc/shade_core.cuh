// The shared per-pixel shade core, as scalar __device__ code.
//
// A line-by-line mirror of kylespathtracer_tpu_torch/ops/shade_kernel.py
// (itself the port of kylespathtracer_tpu/ops/shade_kernel.py): the analytic
// nearest-hit trace, the occlusion-only visibility tests, the material
// table, and the dual-MIS / unbiased estimator pairs. Where the tensor code
// computes every branch for every pixel and selects with `where`, this code
// returns early or indexes the selected table row: the same result, since
// the unselected lanes never reach the output.
//
// Generic over the scalar type S: the kernels run it on float; the reverse
// sweep of the gradient kernels (frame_adjoint.cuh) also runs its vector
// helpers and powi on dual.cuh's Dual<N>, in the same operation order, for
// the leaf Jacobians it takes in forward mode. What only decides (the
// occlusion tests, the soft-shadow trace's object ID, the roulette's
// choice, the contribution march's hit point) runs on the values alone: it
// carries no derivative, as in the tensor code.
//
// Integer hashing runs in uint32 (wraparound is defined there) and is cast
// back to int32, matching the int32 wraparound of the tensor code.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dual.cuh"

namespace kpt {

constexpr float EPS = 1e-3f;
constexpr float IEPS = 0.999f;
constexpr float ZFAR = 50.0f;
constexpr float PI = 3.1415926f;
constexpr float TWOPI = 6.2831853f;
constexpr float INF_T = 1e9f;
// Local-array bound on planes (the roulette keeps one direction per plane).
constexpr int MAX_PLANES = 8;

template <typename S>
struct V3T {
  S x, y, z;
};
using V3 = V3T<float>;

template <typename S>
__device__ __forceinline__ V3T<S> mk(S x, S y, S z) { return {x, y, z}; }
__device__ __forceinline__ V3 mk(float x, float y, float z) { return {x, y, z}; }
template <typename S>
__device__ __forceinline__ S dot(V3T<S> a, V3T<S> b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
template <typename S>
__device__ __forceinline__ V3T<S> sub(V3T<S> a, V3T<S> b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
template <typename S>
__device__ __forceinline__ V3T<S> scale(V3T<S> a, S s) { return {a.x * s, a.y * s, a.z * s}; }
template <typename S, typename A, typename B>
__device__ __forceinline__ S clip(S x, A lo, B hi) { return fminf(fmaxf(x, lo), hi); }
// The values of a vector, for the tests that only decide.
template <typename S>
__device__ __forceinline__ V3 vval(V3T<S> a) { return {val(a.x), val(a.y), val(a.z)}; }

template <typename S>
__device__ __forceinline__ V3T<S> normalize(V3T<S> a, float eps = 1e-20f) {
  return scale(a, rsqrtf(fmaxf(dot(a, a), eps)));
}

template <typename S>
__device__ __forceinline__ V3T<S> reflect(V3T<S> i, V3T<S> n) {
  S d = 2.0f * dot(n, i);
  return {i.x - d * n.x, i.y - d * n.y, i.z - d * n.z};
}

// The scene tables: offsets into the flat f32 table `f`, in the order of
// ops/frame_kernel.py:_table_tensors, and the i32 ID tables.
struct Tables {
  int nP, nS, nB, nK;
  const float* f;
  int planes, spheres, boxes, light_color, light;
  int s0, s1, freq, alb_const, alb_scale, emission, en_const, en_scale;
  int cam, orient;
  const int *plane_ids, *sphere_ids, *box_ids;
  int light_id;
};

__host__ __device__ inline int table_floats(int nP, int nS, int nB, int nK) {
  return nP * 4 + nS * 4 + nB * 7 + 3 + 4 + nK * 16 + 5;
}
__host__ __device__ inline int table_ints(int nP, int nS, int nB) { return nP + nS + nB + 1; }

__device__ inline Tables make_tables(const float* f, const int* i, int nP, int nS, int nB, int nK) {
  Tables t;
  t.nP = nP; t.nS = nS; t.nB = nB; t.nK = nK;
  t.f = f;
  int o = 0;
  t.planes = o; o += nP * 4;
  t.spheres = o; o += nS * 4;
  t.boxes = o; o += nB * 7;
  t.light_color = o; o += 3;
  t.light = o; o += 4;
  t.s0 = o; o += nK;
  t.s1 = o; o += nK;
  t.freq = o; o += nK;
  t.alb_const = o; o += nK * 3;
  t.alb_scale = o; o += nK * 3;
  t.emission = o; o += nK * 3;
  t.en_const = o; o += nK * 2;
  t.en_scale = o; o += nK * 2;
  t.cam = o; o += 3;
  t.orient = o;
  t.plane_ids = i; i += nP;
  t.sphere_ids = i; i += nS;
  t.box_ids = i; i += nB;
  t.light_id = i[0];
  return t;
}

// Entry k of the flat f32 table as an S.
template <typename S>
__device__ __forceinline__ S tab(const Tables& T, int k) { return T.f[k]; }

// ------------------------------------------------------------- sampling

__device__ __forceinline__ void weyl3(int seed, float u[3]) {
  const uint32_t K[3] = {13743434u, 11258243u, 9222443u};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int prod = (int)((uint32_t)seed * K[k]);
    float p = (float)prod / 16777216.0f;
    u[k] = p - floorf(p);
  }
}

// core/sampler.pcg_hash: PCG-RXS-M-XS over a 32-bit LCG state.
__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t shift = (state >> 28) + 4u;
  uint32_t word = ((state >> shift) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

// core/sampler.fold_seed: seed + i, or the PCG hash of (seed, i).
__device__ __forceinline__ int fold_seed(int seed, int i, bool decorrelate) {
  if (!decorrelate || i == 0) return (int)((uint32_t)seed + (uint32_t)i);
  return (int)pcg_hash((uint32_t)seed ^ ((uint32_t)i * 0x9E3779B9u));
}

struct Pre {
  float su1, ct, st, u3;
};

__device__ __forceinline__ Pre cone_pre(int seed) {
  float u[3];
  weyl3(seed, u);
  float tha = u[1] * TWOPI;
  return {sqrtf(u[0]), cosf(tha), sinf(tha), u[2]};
}

template <typename S>
__device__ __forceinline__ void basis(V3T<S> n, V3T<S>& f, V3T<S>& r) {
  float s = n.z >= 0.0f ? 1.0f : -1.0f;
  S a = 1.0f / (s + n.z);
  S b = -n.x * n.y * a;
  f = mk(1.0f - n.x * n.x * a * s, b * s, -n.x * s);
  r = mk(b, s - n.y * n.y * a, -n.y);
}

template <typename S>
__device__ __forceinline__ V3T<S> cone_dir(V3T<S> lv, S lr, const Pre& pre) {
  S d = sqrtf(fmaxf(dot(lv, lv), 1e-20f));
  S x = clip(lr / fmaxf(d, 1e-12f), EPS, IEPS);
  S rad = pre.su1 * x * rsqrtf(1.0f - x * x);
  V3T<S> nlv = normalize(lv);
  V3T<S> f, r;
  basis(nlv, f, r);
  V3T<S> o = mk(nlv.x + rad * (f.x * pre.ct + r.x * pre.st),
                nlv.y + rad * (f.y * pre.ct + r.y * pre.st),
                nlv.z + rad * (f.z * pre.ct + r.z * pre.st));
  return normalize(o);
}

template <typename S>
__device__ __forceinline__ S solid_angle(S d2, S r2) {
  S inner = 1.0f - clip(r2 / fmaxf(d2, 1e-24f), 0.0f, 1.0f);
  return (1.0f - sqrtf(fmaxf(inner, 1e-12f))) * TWOPI;
}

template <typename S>
__device__ __forceinline__ S schlick(float r1, float r2, S vn) {
  float r0 = (r1 - r2) / (r1 + r2);
  r0 = r0 * r0;
  S u = 1.0f - vn;
  S u2 = u * u;
  return r0 + (1.0f - r0) * u2 * u2 * u;
}

// x**n by repeated squaring, in the tensor code's multiplication order.
template <typename S>
__device__ __forceinline__ S powi(S x, int n) {
  S acc = 1.0f, base = x;
  bool have = false;
  while (n) {
    if (n & 1) {
      acc = have ? acc * base : base;
      have = true;
    }
    n >>= 1;
    if (n) base = base * base;
  }
  return acc;
}

// --------------------------------------------------------- intersection

template <typename S>
__device__ __forceinline__ S plane_t(const Tables& T, int p, V3T<S> o, V3T<S> d, bool& front) {
  const int q = T.planes + p * 4;
  const S n0 = tab<S>(T, q), n1 = tab<S>(T, q + 1), n2 = tab<S>(T, q + 2), w = tab<S>(T, q + 3);
  S denom = d.x * n0 + d.y * n1 + d.z * n2;
  S sd0 = o.x * n0 + o.y * n1 + o.z * n2 + w;
  front = denom < -1e-7f;
  return -sd0 / (fabsf(denom) < 1e-12f ? S(1e-12f) : denom);
}

template <typename S>
__device__ __forceinline__ S sphere_t(const Tables& T, int s, V3T<S> o, V3T<S> d, float& disc) {
  const int q = T.spheres + s * 4;
  V3T<S> oc = mk(o.x - tab<S>(T, q), o.y - tab<S>(T, q + 1), o.z - tab<S>(T, q + 2));
  const S r = tab<S>(T, q + 3);
  S b = dot(oc, d);
  S c2 = dot(oc, oc) - r * r;
  S ds = b * b - c2;
  disc = val(ds);
  return -b - sqrtf(fmaxf(ds, 1e-12f));
}

// sphere_t with the far root where the near one is not ahead of the ray:
// a ray starting inside the sphere exits through its far surface.
__device__ __forceinline__ float sphere_t_far(const Tables& T, int s, V3 o, V3 d, float& disc) {
  const float* C = T.f + T.spheres + s * 4;
  V3 oc = mk(o.x - C[0], o.y - C[1], o.z - C[2]);
  float b = dot(oc, d);
  float c2 = dot(oc, oc) - C[3] * C[3];
  disc = b * b - c2;
  float sq = sqrtf(fmaxf(disc, 1e-12f));
  float t = -b - sq;
  return t > 0.0f ? t : -b + sq;
}

// The box cull of K1, K4, K7 and K8 (CULL below): can the ray
// o + t·d, 0 <= t <= tmax, meet rounded box B (center B[0..2], half extents
// B[3..5], rounding radius B[6])? A slab test against the box's bounds grown
// by the rounding radius and by a margin far above the rounding of this test
// and of the candidates: false only where no candidate of `trace` and no
// `box_occludes` finds the box, so skipping them leaves t and oid bit for
// bit. ops/frame_kernel.py:box_cull_plain mirrors it for the tests.
__device__ __forceinline__ bool box_may_hit(const float* B, V3 o, V3 d, float tmax) {
  const float oc[3] = {o.x - B[0], o.y - B[1], o.z - B[2]};
  const float dv[3] = {d.x, d.y, d.z};
  float t0 = 0.0f, t1 = tmax;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float h = B[3 + k] + B[6];
    const float m = 1e-3f * h + 1e-5f * fabsf(oc[k]) + 1e-4f;
    const float lo = -h - m - oc[k], hi = h + m - oc[k];  // the grown slab, from o
    if (dv[k] == 0.0f) {
      if (lo > 0.0f || hi < 0.0f) return false;
      continue;
    }
    const float inv = 1.0f / dv[k];
    const float ta = lo * inv, tb = hi * inv;
    t0 = fmaxf(t0, fminf(ta, tb));
    t1 = fminf(t1, fmaxf(ta, tb));
  }
  return t0 <= t1;
}

// Nearest hit → (t, oid) over planes, spheres and rounded boxes. With
// INSIDE_HITS (float only: the path kernel's dielectric continuation rays)
// a sphere is hit at its far root from inside; the default instantiation is
// the trace of K3-K6. With RECORD, *win names the winning candidate
// (frame_adjoint.cuh reverses its t alone): plane p → p, sphere s → 256 + s,
// rounded box bx → 512 + 32·bx + part, part 0-5 a face (2k + si), 6-17 an
// edge cylinder (6 + 4k + 2ii + jj), 18-25 a corner sphere (18 + c). With
// CULL (K1, K4, K7 and K8), a box that `box_may_hit` rules out is skipped.
// Without BOXES (K7's census) the boxes are skipped and the nearest plane or
// sphere hit is returned unpulled (no eps, no ZFAR clamp): the tmax of the
// box cull.
template <typename S, bool INSIDE_HITS = false, bool RECORD = false, bool CULL = false, bool BOXES = true>
__device__ void trace(const Tables& T, V3T<S> ro, V3T<S> rd, int excl, S& t_out, int& id_out,
                      int* win = nullptr) {
  S best_t = INF_T;
  int best_id = 0;
  int best_win = -1;
  auto consider = [&](const S& t, int oid, bool valid, int code) {
    if (valid && t > 0.0f && oid != excl && t < best_t) {
      best_t = t;
      best_id = oid;
      if constexpr (RECORD) best_win = code;
    }
  };
  for (int p = 0; p < T.nP; ++p) {
    bool front;
    S t = plane_t(T, p, ro, rd, front);
    consider(t, T.plane_ids[p], front, p);
  }
  for (int s = 0; s < T.nS; ++s) {
    float disc;
    S t;
    if constexpr (INSIDE_HITS) {
      t = sphere_t_far(T, s, ro, rd, disc);
    } else {
      t = sphere_t(T, s, ro, rd, disc);
    }
    consider(t, T.sphere_ids[s], disc > 0.0f, 256 + s);
  }
  for (int bx = 0; bx < (BOXES ? T.nB : 0); ++bx) {
    const int q = T.boxes + bx * 7;
    if constexpr (CULL) {
      if (!box_may_hit(T.f + q, vval(ro), vval(rd), val(best_t))) continue;
    }
    const S hext[3] = {tab<S>(T, q + 3), tab<S>(T, q + 4), tab<S>(T, q + 5)};
    const S rnd = tab<S>(T, q + 6);
    const int oid = T.box_ids[bx];
    const S o[3] = {ro.x - tab<S>(T, q), ro.y - tab<S>(T, q + 1), ro.z - tab<S>(T, q + 2)};
    const S d[3] = {rd.x, rd.y, rd.z};
#pragma unroll
    for (int k = 0; k < 3; ++k) {  // 6 faces
      const int j1 = (k + 1) % 3, j2 = (k + 2) % 3;
      S dk = fabsf(d[k]) < 1e-12f ? S(1e-12f) : d[k];
#pragma unroll
      for (int si = 0; si < 2; ++si) {
        float sgn = si == 0 ? 1.0f : -1.0f;
        S t = (sgn * (hext[k] + rnd) - o[k]) / dk;
        S p1 = o[j1] + d[j1] * t;
        S p2 = o[j2] + d[j2] * t;
        consider(t, oid, fabsf(p1) <= hext[j1] && fabsf(p2) <= hext[j2], 512 + 32 * bx + 2 * k + si);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {  // 12 edge cylinders
      const int i = (k + 1) % 3, j = (k + 2) % 3;
      S a = fmaxf(d[i] * d[i] + d[j] * d[j], 1e-12f);
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        float si = ii == 0 ? 1.0f : -1.0f;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float sj = jj == 0 ? 1.0f : -1.0f;
          S oi = o[i] - si * hext[i];
          S oj = o[j] - sj * hext[j];
          S b = oi * d[i] + oj * d[j];
          S cq = oi * oi + oj * oj - rnd * rnd;
          S disc = b * b - a * cq;
          S t = (-b - sqrtf(fmaxf(disc, 1e-12f))) / a;
          S pk = o[k] + d[k] * t;
          consider(t, oid,
                   disc > 0.0f && fabsf(pk) <= hext[k] && (oi + d[i] * t) * si > 0.0f &&
                       (oj + d[j] * t) * sj > 0.0f,
                   512 + 32 * bx + 6 + 4 * k + 2 * ii + jj);
        }
      }
    }
    for (int c = 0; c < 8; ++c) {  // 8 corner spheres, (sx, sy, sz) from +,+,+
      float sx = (c & 4) ? -1.0f : 1.0f;
      float sy = (c & 2) ? -1.0f : 1.0f;
      float sz = (c & 1) ? -1.0f : 1.0f;
      V3T<S> oc = mk(o[0] - sx * hext[0], o[1] - sy * hext[1], o[2] - sz * hext[2]);
      V3T<S> dv = mk(d[0], d[1], d[2]);
      S b = dot(oc, dv);
      S cq = dot(oc, oc) - rnd * rnd;
      S disc = b * b - cq;
      S t = -b - sqrtf(fmaxf(disc, 1e-12f));
      consider(t, oid,
               disc > 0.0f && (oc.x + d[0] * t) * sx > 0.0f && (oc.y + d[1] * t) * sy > 0.0f &&
                   (oc.z + d[2] * t) * sz > 0.0f,
               512 + 32 * bx + 18 + c);
    }
  }
  if constexpr (!BOXES) {
    t_out = best_t;
    id_out = best_id;
    return;
  }
  // Pull back by eps; clamp misses (common.glsl:289-294).
  S t = best_t - EPS;
  bool miss = t > ZFAR || best_id == 0;
  t_out = miss ? S(ZFAR) : t;
  id_out = miss ? 0 : best_id;
  if constexpr (RECORD) *win = best_win;
}

// ------------------------------------------------ occlusion-only tests
// These decide only, so they run on float values in every kernel.

// Does rounded box bx intersect the open segment (0, tmax)?
__device__ inline bool box_occludes(const Tables& T, int bx, V3 o, V3 dv, float tmax) {
  const float* B = T.f + T.boxes + bx * 7;
  const float hext[3] = {B[3], B[4], B[5]};
  const float rnd = B[6];
  const float op[3] = {o.x - B[0], o.y - B[1], o.z - B[2]};
  const float d[3] = {dv.x, dv.y, dv.z};
  float inv_d[3];
  for (int k = 0; k < 3; ++k) inv_d[k] = 1.0f / (fabsf(d[k]) < 1e-12f ? 1e-12f : d[k]);

  auto gprime = [&](float t) {
    float acc = 0.0f;
    for (int k = 0; k < 3; ++k) {
      float x = op[k] + d[k] * t;
      acc = acc + d[k] * (x - clip(x, -hext[k], hext[k]));
    }
    return acc;
  };

  float t_lo = 0.0f, t_hi = tmax;
  float gp_lo = gprime(0.0f), gp_hi = gprime(tmax);
  for (int c = 0; c < 8; ++c) {
    float t_c;
    if (c == 0) {
      t_c = 0.0f;
    } else if (c == 1) {
      t_c = tmax;
    } else {
      int k = (c - 2) >> 1;
      float sgn = ((c - 2) & 1) ? -1.0f : 1.0f;
      t_c = clip((sgn * hext[k] - op[k]) * inv_d[k], 0.0f, tmax);
    }
    float gp = gprime(t_c);
    if (gp <= 0.0f && t_c >= t_lo) {
      t_lo = t_c;
      gp_lo = gp;
    }
    if (gp >= 0.0f && t_c <= t_hi) {
      t_hi = t_c;
      gp_hi = gp;
    }
  }
  float den = gp_hi - gp_lo;
  float frac = fabsf(den) < 1e-20f ? 0.0f : gp_lo / den;
  float t_star = clip(t_lo - frac * (t_hi - t_lo), 0.0f, tmax);
  float g = 0.0f;
  for (int k = 0; k < 3; ++k) {
    float x = op[k] + d[k] * t_star;
    float e = x - clip(x, -hext[k], hext[k]);
    g = g + e * e;
  }
  return g <= rnd * rnd;
}

// True where the analytic target hit is the nearest scene hit from o along d.
// skip_sphere: a sphere id that is the target itself (or any value no sphere
// has). With CULL, a box that `box_may_hit` rules out is not tested; without
// BOXES (K7's census) no box is.
template <bool CULL = false, bool BOXES = true>
__device__ inline bool nearest_is_target(const Tables& T, V3 o, V3 d, int excl, float t_target,
                                  bool target_valid, bool use_skip, int skip_sphere) {
  if (!target_valid) return false;
  for (int p = 0; p < T.nP; ++p) {
    bool front;
    float t = plane_t(T, p, o, d, front);
    if (front && t > 0.0f && T.plane_ids[p] != excl && t < t_target) return false;
  }
  for (int s = 0; s < T.nS; ++s) {
    int sid = T.sphere_ids[s];
    float disc;
    float t = sphere_t(T, s, o, d, disc);
    if (disc > 0.0f && t > 0.0f && sid != excl && t < t_target && !(use_skip && sid == skip_sphere))
      return false;
  }
  for (int bx = 0; bx < (BOXES ? T.nB : 0); ++bx) {
    if constexpr (CULL) {
      if (!box_may_hit(T.f + T.boxes + bx * 7, o, d, t_target)) continue;
    }
    if (T.box_ids[bx] != excl && box_occludes(T, bx, o, d, t_target)) return false;
  }
  return t_target - EPS <= ZFAR;
}

// Occlusion-style `nearest hit == light` (common.glsl:348-353). Without
// BOXES (K7's census) no box is tested, and *t_light gets the light's
// distance, the tmax of the box cull.
template <bool CULL = false, bool BOXES = true>
__device__ inline bool light_visible(const Tables& T, V3 o, V3 d, int excl, float* t_light = nullptr) {
  const float* L = T.f + T.light;
  V3 oc = mk(o.x - L[0], o.y - L[1], o.z - L[2]);
  float b = dot(oc, d);
  float c2 = dot(oc, oc) - L[3] * L[3];
  float disc = b * b - c2;
  float t_l = -b - sqrtf(fmaxf(disc, 1e-12f));
  bool valid = disc > 0.0f && t_l > 0.0f && T.light_id != excl;
  if constexpr (!BOXES) *t_light = t_l;
  return nearest_is_target<CULL, BOXES>(T, o, d, excl, t_l, valid, true, T.light_id);
}

// ------------------------------------------------------------ materials

// The material row of ho at the point hl. The checker reads hl through
// floor only, so hl is a value.
template <typename S>
__device__ void surface(const Tables& T, int ho, V3 hl, S alb[3], S emi[3], S ene[2]) {
  for (int c = 0; c < 3; ++c) alb[c] = emi[c] = 0.0f;
  ene[0] = ene[1] = 0.0f;
  if (ho < 0 || ho >= T.nK) return;
  int k = ho;
  float freq = T.f[T.freq + k];
  float s = floorf(hl.x * freq) + floorf(hl.y * freq) + floorf(hl.z * freq);
  // s is integer-valued, so |fmod| equals |floor-mod| here.
  float checker = fabsf(fmodf(s, 2.0f));
  S sval = tab<S>(T, T.s0 + k) + tab<S>(T, T.s1 + k) * checker;
  for (int c = 0; c < 3; ++c) {
    alb[c] = tab<S>(T, T.alb_const + k * 3 + c) + tab<S>(T, T.alb_scale + k * 3 + c) * sval;
    emi[c] = tab<S>(T, T.emission + k * 3 + c);
  }
  for (int c = 0; c < 2; ++c)
    ene[c] = tab<S>(T, T.en_const + k * 2 + c) + tab<S>(T, T.en_scale + k * 2 + c) * sval;
}

// ----------------------------------------------------------- MIS pieces

template <typename S>
__device__ __forceinline__ V3T<S> light_pos(const Tables& T) {
  return mk(tab<S>(T, T.light), tab<S>(T, T.light + 1), tab<S>(T, T.light + 2));
}

// lambert_plane_pdf for plane p (common.glsl:308-322).
template <typename S>
__device__ void plane_pdf_lambert(const Tables& T, int p, V3T<S> hl, const Pre& pre, V3T<S>& dir, S& w_out) {
  V3T<S> L = light_pos<S>(T);
  const int q = T.planes + p * 4;
  V3T<S> n = mk(tab<S>(T, q), tab<S>(T, q + 1), tab<S>(T, q + 2));
  S w = tab<S>(T, q + 3);
  S ldn = L.x * n.x + L.y * n.y + L.z * n.z + w;
  V3T<S> d = mk(L.x - n.x * ldn, L.y - n.y * ldn, L.z - n.z * ldn);
  V3T<S> dv = sub(d, hl);
  V3T<S> ld = sub(L, d);
  S dv2 = dot(dv, dv);
  S frad = fminf(sqrtf(fmaxf(dv2, 1e-20f)), sqrtf(fmaxf(dot(ld, ld), 1e-20f))) * 0.9f;
  dir = cone_dir(dv, frad, pre);
  S lpdf = solid_angle(dv2, frad * frad) / PI;
  S g2 = fmaxf(EPS, -(dir.x * n.x + dir.y * n.y + dir.z * n.z));
  w_out = dv2 > 1e-12f ? lpdf * g2 : S(0.0f);
}

// phong_plane_pdf for plane p (common.glsl:325-343).
template <typename S>
__device__ void plane_pdf_phong(const Tables& T, int p, V3T<S> hl, const Pre& pre, V3T<S>& dir, S& w_out) {
  V3T<S> L = light_pos<S>(T);
  S lr = tab<S>(T, T.light + 3);
  const int q = T.planes + p * 4;
  V3T<S> n = mk(tab<S>(T, q), tab<S>(T, q + 1), tab<S>(T, q + 2));
  S w = tab<S>(T, q + 3);
  S a = dot(hl, n) + w;
  S b = L.x * n.x + L.y * n.y + L.z * n.z + w;
  S ab = a + b;
  ab = fabsf(ab) < 1e-6f ? S(1e-6f) : ab;
  S fac = a / ab;
  V3T<S> s = mk((hl.x - a * n.x) + ((L.x - b * n.x) - (hl.x - a * n.x)) * fac,
                (hl.y - a * n.y) + ((L.y - b * n.y) - (hl.y - a * n.y)) * fac,
                (hl.z - a * n.z) + ((L.z - b * n.z) - (hl.z - a * n.z)) * fac);
  V3T<S> sv = sub(s, hl);
  S sv2 = dot(sv, sv);
  S lsv = sqrtf(fmaxf(sv2, 1e-20f)) * lr;
  V3T<S> ls = sub(L, s);
  S lsn = sqrtf(fmaxf(dot(ls, ls), 1e-20f));
  V3T<S> ts = scale(sv, lsn);
  dir = cone_dir(ts, lsv, pre);
  S lpdf = solid_angle(dot(ts, ts), lsv * lsv) / PI;
  S spdf = schlick(1.0f, 3.0f, dot(normalize(sv), n));
  w_out = sv2 > 1e-12f ? lpdf * spdf : S(0.0f);
}

// CDF roulette over the plane strategies + contribution march
// (common.glsl:453-519), occlusion-style. Adds into est[3]. The choice and
// the march decide only; the contribution is differentiable through the
// strategy weights and the tables.
template <typename S>
__device__ void roulette(const Tables& T, const V3T<S>* dirs, const S* ws, V3T<S> hl, int ho,
                         const Pre& pre, int energy_channel, S est[3]) {
  const int nP = T.nP;
  float cdf[MAX_PLANES];
  S acc = 0.0f;
  for (int p = 0; p < nP; ++p) {
    acc = acc + ws[p];
    cdf[p] = val(acc);
  }
  S total = acc;
  float rnd = pre.u3 * val(total);
  // The first p with rnd <= cdf_p (last plane unconditional).
  int idx = 0;
  for (int p = 0; p < nP - 1; ++p) idx += rnd > cdf[p] ? 1 : 0;

  V3 dir_sel = vval(dirs[idx]);
  S w_sel = ws[idx];
  const float* pl = T.f + T.planes + idx * 4;
  V3 n_sel = mk(pl[0], pl[1], pl[2]);
  float pw_sel = pl[3];
  int po_sel = T.plane_ids[idx];
  V3 hlv = vval(hl);

  // Analytic hit on the selected plane + occlusion verify (common.glsl:356-371).
  float denom = dot(dir_sel, n_sel);
  float sd0 = dot(hlv, n_sel) + pw_sel;
  float tp = -sd0 / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
  bool valid_p = denom < -1e-7f && tp > 0.0f && po_sel != ho;
  if (!nearest_is_target(T, hlv, dir_sel, ho, tp, valid_p, false, 0)) return;

  float t = tp - EPS;
  V3 hl2 = mk(hlv.x + dir_sel.x * t + n_sel.x * EPS, hlv.y + dir_sel.y * t + n_sel.y * EPS,
              hlv.z + dir_sel.z * t + n_sel.z * EPS);
  V3 lv2 = sub(light_pos<float>(T), hl2);
  V3 sample_dir = cone_dir(lv2, T.f[T.light + 3], pre);
  bool lhit = light_visible(T, hl2, sample_dir, po_sel);
  S alb[3], emi[3], ene[2];
  surface<S>(T, po_sel, hl2, alb, emi, ene);
  S e = ene[energy_channel];
  S boost = total / fmaxf(EPS, w_sel);
  for (int c = 0; c < 3; ++c) {
    S lc = lhit ? tab<S>(T, T.light_color + c) * w_sel : S(0.0f);
    est[c] = est[c] + (emi[c] + e * alb[c] * lc) * boost;
  }
}

// ------------------------------------------------ unbiased ground truth

__device__ __forceinline__ V3 cos_hemi_dir(V3 hn, int seed) {
  float u[3], g[3];
  weyl3(seed, u);
  for (int k = 0; k < 3; ++k) {
    float t = 0.988f * (u[k] + 0.006f);
    g[k] = logf(t / (1.0f - t)) * 0.221f + 0.5f;
  }
  V3 d = normalize(mk(g[0] * 2.0f - 1.0f, g[1] * 2.0f - 1.0f, g[2] * 2.0f - 1.0f));
  return normalize(mk(hn.x + d.x * IEPS, hn.y + d.y * IEPS, hn.z + d.z * IEPS));
}

// UnbiasedLambertian / UnbiasedPhong (common.glsl:394-415). The directions
// only decide visibility; the derivative reaches the light color alone.
template <typename S, bool CULL = false>
__device__ void shade_core_unbiased(const Tables& T, V3 hn, V3 rd, int ho, V3 hl, int seed, int smp,
                                    bool decorrelate, S est_d[3], S est_s[3]) {
  for (int c = 0; c < 3; ++c) est_d[c] = 0.0f;
  for (int i = 0; i < smp; ++i) {
    V3 d = cos_hemi_dir(hn, fold_seed(seed, i, decorrelate));
    bool vis = light_visible<CULL>(T, hl, d, ho);
    for (int c = 0; c < 3; ++c) est_d[c] = est_d[c] + (vis ? tab<S>(T, T.light_color + c) * PI : S(0.0f));
  }
  if (smp > 1) {
    float inv = 1.0f / (float)smp;
    for (int c = 0; c < 3; ++c) est_d[c] = est_d[c] * inv;
  }
  // Plain reflect, not re-normalized.
  bool vis_s = light_visible<CULL>(T, hl, reflect(rd, hn), ho);
  for (int c = 0; c < 3; ++c) est_s[c] = vis_s ? tab<S>(T, T.light_color + c) : S(0.0f);
}

// ----------------------------------------------------------- shade core

// The logistic function 1/(1+e^-x). Its derivative is s·(1-s)
// (frame_adjoint.cuh): the quotient form's, e^-x/(1+e^-x)², is inf/inf =
// NaN once e^-x overflows, as torch.sigmoid's and jax.nn.sigmoid's
// derivatives are not.
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Sphere s's smooth visibility factor along the shadow ray from hl in
// direction dl_dir, up to t_surf.
template <typename S>
__device__ __forceinline__ S sphere_transmittance(const Tables& T, int s, V3T<S> hl, V3T<S> dl_dir, S t_surf,
                                                  float beta) {
  const int q = T.spheres + s * 4;
  V3T<S> c = mk(tab<S>(T, q), tab<S>(T, q + 1), tab<S>(T, q + 2));
  S tc = clip(dot(sub(c, hl), dl_dir), EPS, t_surf);
  V3T<S> closest = mk(hl.x + dl_dir.x * tc - c.x, hl.y + dl_dir.y * tc - c.y, hl.z + dl_dir.z * tc - c.z);
  S sd = sqrtf(fmaxf(dot(closest, closest), 1e-20f)) - tab<S>(T, q + 3);
  return sigmoid(sd / (beta * tc));
}

// Smooth shadow-ray visibility over the spheres, skipping the light and ho.
template <typename S>
__device__ S soft_transmittance(const Tables& T, V3T<S> hl, V3T<S> dl_dir, S t_surf, int ho, float beta) {
  S trans = 1.0f;
  for (int s = 0; s < T.nS; ++s) {
    S v = sphere_transmittance(T, s, hl, dl_dir, t_surf, beta);
    int sid = T.sphere_ids[s];
    bool skip = sid == T.light_id || sid == ho;
    trans = trans * (skip ? S(1.0f) : v);
  }
  return trans;
}

// Direct light + the four plane-strategy roulettes for both estimators
// (common.glsl:430-616) → est_d / est_s of one sample.
template <typename S>
__device__ void shade_core(const Tables& T, V3T<S> hn, V3T<S> rd, int ho, V3T<S> hl, int seed, float soft_beta,
                           int gloss, S est_d[3], S est_s[3]) {
  V3T<S> L = light_pos<S>(T);
  S lr = tab<S>(T, T.light + 3);
  Pre pre = cone_pre(seed);
  V3T<S> lv = sub(L, hl);
  V3T<S> dl_dir = cone_dir(lv, lr, pre);
  S dl_pdf = solid_angle(dot(lv, lv), lr * lr);
  S lam_w = fmaxf(EPS, dot(dl_dir, hn));
  V3T<S> refl = reflect(rd, hn);
  S pho_w = powi(fmaxf(EPS, dot(dl_dir, refl)), gloss);

  S vis;
  if (soft_beta > 0.0f) {
    float t_unused;
    int vis_id;
    trace(T, vval(hl), vval(dl_dir), ho, t_unused, vis_id);
    S dist = sqrtf(fmaxf(dot(lv, lv), 1e-20f));
    S t_surf = fmaxf(dist - lr, EPS);
    S trans = soft_transmittance(T, hl, dl_dir, t_surf, ho, soft_beta);
    bool sol = false;
    for (int s = 0; s < T.nS; ++s) sol = sol || vis_id == T.sphere_ids[s];
    vis = sol ? trans : S(0.0f);
  } else {
    vis = light_visible(T, vval(hl), vval(dl_dir), ho) ? 1.0f : 0.0f;
  }
  for (int c = 0; c < 3; ++c) {
    est_d[c] = tab<S>(T, T.light_color + c) * (vis * dl_pdf * lam_w);
    est_s[c] = tab<S>(T, T.light_color + c) * (vis * dl_pdf * pho_w);
  }

  const int nP = T.nP;
  V3T<S> dirs_l[MAX_PLANES], dirs_p[MAX_PLANES];
  S wl_lam[MAX_PLANES], wp_lam[MAX_PLANES], wl_pho[MAX_PLANES], wp_pho[MAX_PLANES];
  for (int p = 0; p < nP; ++p) {
    S pl_, pp_;
    plane_pdf_lambert(T, p, hl, pre, dirs_l[p], pl_);
    plane_pdf_phong(T, p, hl, pre, dirs_p[p], pp_);
    wl_lam[p] = pl_ * fmaxf(EPS, dot(dirs_l[p], hn));
    wp_lam[p] = pp_ * fmaxf(EPS, dot(dirs_p[p], hn));
    wl_pho[p] = pl_ * powi(fmaxf(EPS, dot(dirs_l[p], refl)), gloss);
    wp_pho[p] = pp_ * powi(fmaxf(EPS, dot(dirs_p[p], refl)), gloss);
  }
  // Each roulette's contribution is summed before it is added, as in the
  // tensor code (est + r).
  S r[3];
  r[0] = r[1] = r[2] = 0.0f;
  roulette(T, dirs_l, wl_lam, hl, ho, pre, 0, r);
  for (int c = 0; c < 3; ++c) { est_d[c] = est_d[c] + r[c]; r[c] = 0.0f; }
  roulette(T, dirs_p, wp_lam, hl, ho, pre, 1, r);
  for (int c = 0; c < 3; ++c) { est_d[c] = est_d[c] + r[c]; r[c] = 0.0f; }
  roulette(T, dirs_l, wl_pho, hl, ho, pre, 0, r);
  for (int c = 0; c < 3; ++c) { est_s[c] = est_s[c] + r[c]; r[c] = 0.0f; }
  roulette(T, dirs_p, wp_pho, hl, ho, pre, 1, r);
  for (int c = 0; c < 3; ++c) est_s[c] = est_s[c] + r[c];
}

}  // namespace kpt
