// The reverse-mode adjoint of the fused frame's per-pixel body
// (frame_core.cuh:frame_pixel), shared by the backward kernel K5
// (frame_grad.cu) and the fused loss-and-gradient kernel K6
// (loss_kernel.cu). The two differ only in where the cotangents of the 13
// float planes come from.
//
// frame_pixel_adjoint(T, P, px, py, gbar, G) adds ∂(Σ_k gbar_k·out_k)/∂θ,
// for every entry θ of the flat f32 scene table, into G. It recomputes the
// pixel's forward in float, keeping only what the reverse sweep needs (the
// trace's winning candidate; per sample, the plane strategies' directions,
// pdfs and weights), and sweeps back:
//   outputs → the primary material (linear in its row)
//   → per sample, run forward and reversed at once, so that nothing is kept
//     across samples: the four roulettes (the picked plane's material, the
//     light color, every strategy weight through the total and the picked
//     one) → each plane's two strategies → the direct light (and the soft
//     shadow's product over the spheres)
//   → the primary hit (the winning candidate's closed-form t, the normal and
//     the curvature) → the raygen (cam, orient).
// The sweep is written by hand, down to the plane strategies and the cone
// sample run once per plane and sample. Only the primary hit, once per
// pixel, takes its Jacobian in forward mode over its 13 inputs (the ray and
// one object's row) on dual.cuh's Dual<N>. Both keep dual.cuh's derivative
// conventions, which are those of autograd through the plain tensor code.
// The cost does not depend on how many table entries are asked for.
#pragma once

#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>

#include "frame_core.cuh"

namespace kpt {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ void axpy(V3& a, float s, V3 b) {
  a.x += s * b.x;
  a.y += s * b.y;
  a.z += s * b.z;
}

template <int N>
__device__ __forceinline__ V3T<Dual<N>> seeded3(V3 v, int lane) {
  return {seeded<N>(v.x, lane), seeded<N>(v.y, lane + 1), seeded<N>(v.z, lane + 2)};
}

// g[j] += bar·∂y/∂(input j), over the lanes of a leaf Jacobian.
template <int N>
__device__ __forceinline__ void vjp(float (&g)[N], const Dual<N>& y, float bar) {
#pragma unroll
  for (int j = 0; j < N; ++j) g[j] += bar * y.d[j];
}
template <int N>
__device__ __forceinline__ void vjp3(float (&g)[N], const V3T<Dual<N>>& y, V3 bar) {
  vjp(g, y.x, bar.x);
  vjp(g, y.y, bar.y);
  vjp(g, y.z, bar.z);
}

// x**n and its derivative, by powi's own multiplications.
__device__ __forceinline__ float powi_d(float x, int n, float& dx) {
  const Dual<1> y = powi(seeded<1>(x, 0), n);
  dx = y.d[0];
  return y.v;
}

// Add the sum of v over the warp to *dst: shuffles, then one atomicAdd from
// lane 0. Every lane of the warp must call it.
__device__ __forceinline__ void warp_add(float v, float* dst) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (((threadIdx.y * blockDim.x + threadIdx.x) & 31) == 0) atomicAdd(dst, v);
}

// ------------------------------------------------------------ accumulator

// One thread's gradient. The entries every pixel touches (camera, light,
// light color) stay in registers and are summed per warp at the end; the
// rows a pixel selects (planes, spheres, boxes, materials) are added into
// the block's shared copy of the flat table. Neighbouring pixels mostly
// select the same rows, and 32 lanes adding to one shared address
// serialize, so the lanes adding to the same entry are summed first and
// each such group takes one shared-memory atomic.
struct Grad {
  float* sg;
  float cam[3], orient[2], light[4], lc[3];
  __device__ explicit Grad(float* s) : sg(s), cam{}, orient{}, light{}, lc{} {}
  __device__ __forceinline__ void add(int k, float v) {
    if (v == 0.0f) return;
    const cg::coalesced_group same = cg::labeled_partition(cg::coalesced_threads(), k);
    const float sum = cg::reduce(same, v, cg::plus<float>());
    if (same.thread_rank() == 0) atomicAdd(sg + k, sum);
  }
};

// The block's epilogue: the register entries' warp sums into the shared
// table, then one global atomicAdd per non-zero entry asked for (out_g[i]
// is the gradient of flat entry seeds[i]). Every thread of the block calls
// it.
__device__ inline void flush_grad(const Tables& T, Grad& G, const int* seeds, int n_seeds, float* out_g) {
#pragma unroll
  for (int i = 0; i < 3; ++i) warp_add(G.cam[i], G.sg + T.cam + i);
#pragma unroll
  for (int i = 0; i < 2; ++i) warp_add(G.orient[i], G.sg + T.orient + i);
#pragma unroll
  for (int i = 0; i < 4; ++i) warp_add(G.light[i], G.sg + T.light + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) warp_add(G.lc[i], G.sg + T.light_color + i);
  __syncthreads();
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n_seeds; i += blockDim.x * blockDim.y) {
    const float v = G.sg[seeds[i]];
    if (v != 0.0f) atomicAdd(out_g + i, v);
  }
}

// ------------------------------------------------------ the shade leaves
// Each takes its inputs' values and its outputs' cotangents, recomputes its
// forward (shade_core.cuh) in float, and adds its inputs' cotangents.

// normalize: y = a·rsqrt(max(a·a, eps)).
__device__ __forceinline__ void normalize_adjoint(V3 a, float eps, V3 y_bar, V3& a_bar) {
  const float q = dot(a, a);
  const float s = rsqrtf(fmaxf(q, eps));
  axpy(a_bar, s, y_bar);
  if (q >= eps) axpy(a_bar, 2.0f * dot(y_bar, a) * (-0.5f * s * s * s), a);
}

// basis(n) → (f, r).
__device__ __forceinline__ void basis_adjoint(V3 n, V3 f_bar, V3 r_bar, V3& n_bar) {
  const float s = n.z >= 0.0f ? 1.0f : -1.0f;
  const float den = s + n.z;
  const float a = 1.0f / den;
  const float nxy = -n.x * n.y;  // b = nxy·a
  // f = (1 - n.x²·a·s, b·s, -n.x·s), r = (b, s - n.y²·a, -n.y).
  const float b_bar = f_bar.y * s + r_bar.x;
  const float a_bar = -f_bar.x * (n.x * n.x) * s - r_bar.y * (n.y * n.y) + b_bar * nxy;
  const float nxy_bar = b_bar * a;
  n_bar.x += 2.0f * n.x * (-f_bar.x * a * s) - nxy_bar * n.y - f_bar.z * s;
  n_bar.y += 2.0f * n.y * (-r_bar.y * a) - nxy_bar * n.x - r_bar.z;
  n_bar.z += a_bar * (-a / den);
}

// cone_dir(lv, lr, pre) → y.
__device__ inline void cone_dir_adjoint(V3 lv, float lr, const Pre& pre, V3 y_bar, V3& lv_bar, float& lr_bar) {
  const float q = dot(lv, lv);
  const float d = sqrtf(fmaxf(q, 1e-20f));
  const float dm = fmaxf(d, 1e-12f);
  const float u = lr / dm;
  const float x = clip(u, EPS, IEPS);
  const float rs = rsqrtf(1.0f - x * x);
  const float px = pre.su1 * x;
  const float rad = px * rs;
  const V3 nlv = normalize(lv);
  V3 f, r;
  basis(nlv, f, r);
  const V3 g = mk(f.x * pre.ct + r.x * pre.st, f.y * pre.ct + r.y * pre.st, f.z * pre.ct + r.z * pre.st);
  const V3 o = mk(nlv.x + rad * g.x, nlv.y + rad * g.y, nlv.z + rad * g.z);

  V3 o_bar = mk(0.0f, 0.0f, 0.0f);
  normalize_adjoint(o, 1e-20f, y_bar, o_bar);
  const float rad_bar = dot(o_bar, g);
  V3 nlv_bar = o_bar;
  basis_adjoint(nlv, scale(o_bar, rad * pre.ct), scale(o_bar, rad * pre.st), nlv_bar);
  normalize_adjoint(lv, 1e-20f, nlv_bar, lv_bar);
  // rad = (su1·x)·rsqrt(1 - x²), x = clip(lr / max(d, 1e-12), EPS, IEPS).
  const float rs_bar = rad_bar * px;
  const float x_bar = rad_bar * rs * pre.su1 + rs_bar * (-0.5f * rs * rs * rs) * (-2.0f * x);
  const float u_bar = (u >= EPS && fmaxf(u, EPS) <= IEPS) ? x_bar : 0.0f;
  lr_bar += u_bar / dm;
  if (d >= 1e-12f && q >= 1e-20f) axpy(lv_bar, -u_bar * u / dm * (0.5f / d) * 2.0f, lv);
}

// solid_angle(d2, r2) → y.
__device__ __forceinline__ void solid_angle_adjoint(float d2, float r2, float y_bar, float& d2_bar, float& r2_bar) {
  const float m = fmaxf(d2, 1e-24f);
  const float ratio = r2 / m;
  const float inner = 1.0f - clip(ratio, 0.0f, 1.0f);
  const float sq = sqrtf(fmaxf(inner, 1e-12f));
  const float inner_bar = inner >= 1e-12f ? -y_bar * TWOPI * (0.5f / sq) : 0.0f;
  const float ratio_bar = (ratio >= 0.0f && ratio <= 1.0f) ? -inner_bar : 0.0f;
  r2_bar += ratio_bar / m;
  if (d2 >= 1e-24f) d2_bar += -ratio_bar * ratio / m;
}

// lambert_pdf(L, n, w, hl) → (dir, w_out).
__device__ inline void lambert_pdf_adjoint(V3 L, V3 n, float w, V3 hl, const Pre& pre, V3 dir_bar, float out_bar,
                                           V3& L_bar, V3& n_bar, float& w_bar, V3& hl_bar) {
  const float ldn = L.x * n.x + L.y * n.y + L.z * n.z + w;
  const V3 d = mk(L.x - n.x * ldn, L.y - n.y * ldn, L.z - n.z * ldn);
  const V3 dv = sub(d, hl);
  const V3 ld = sub(L, d);
  const float dv2 = dot(dv, dv), ld2 = dot(ld, ld);
  const float s1 = sqrtf(fmaxf(dv2, 1e-20f)), s2 = sqrtf(fmaxf(ld2, 1e-20f));
  const float frad = fminf(s1, s2) * 0.9f;
  const V3 dir = cone_dir(dv, frad, pre);
  const float lpdf = solid_angle(dv2, frad * frad) / PI;
  const float gd = -(dir.x * n.x + dir.y * n.y + dir.z * n.z);

  float lpdf_bar = 0.0f, g2_bar = 0.0f;
  if (dv2 > 1e-12f) {
    lpdf_bar = out_bar * fmaxf(EPS, gd);
    g2_bar = out_bar * lpdf;
  }
  if (gd >= EPS) {
    axpy(dir_bar, -g2_bar, n);
    axpy(n_bar, -g2_bar, dir);
  }
  float dv2_bar = 0.0f, r2_bar = 0.0f;
  solid_angle_adjoint(dv2, frad * frad, lpdf_bar * (1.0f / PI), dv2_bar, r2_bar);
  V3 dv_bar = mk(0.0f, 0.0f, 0.0f);
  float frad_bar = r2_bar * 2.0f * frad;
  cone_dir_adjoint(dv, frad, pre, dir_bar, dv_bar, frad_bar);
  const float fm_bar = frad_bar * 0.9f;  // frad = min(s1, s2)·0.9
  V3 ld_bar = mk(0.0f, 0.0f, 0.0f);
  if (s1 <= s2) {
    if (dv2 >= 1e-20f) dv2_bar += fm_bar * (0.5f / s1);
  } else if (ld2 >= 1e-20f) {
    ld_bar = scale(ld, 2.0f * fm_bar * (0.5f / s2));
  }
  axpy(dv_bar, 2.0f * dv2_bar, dv);
  // dv = d - hl, ld = L - d, d = L - n·ldn, ldn = L·n + w.
  const V3 d_bar = sub(dv_bar, ld_bar);
  axpy(hl_bar, -1.0f, dv_bar);
  axpy(L_bar, 1.0f, ld_bar);
  axpy(L_bar, 1.0f, d_bar);
  axpy(n_bar, -ldn, d_bar);
  const float ldn_bar = -dot(d_bar, n);
  axpy(L_bar, ldn_bar, n);
  axpy(n_bar, ldn_bar, L);
  w_bar += ldn_bar;
}

// phong_pdf(L, lr, n, w, hl) → (dir, w_out).
__device__ inline void phong_pdf_adjoint(V3 L, float lr, V3 n, float w, V3 hl, const Pre& pre, V3 dir_bar,
                                         float out_bar, V3& L_bar, float& lr_bar, V3& n_bar, float& w_bar,
                                         V3& hl_bar) {
  const float a = dot(hl, n) + w;
  const float b = L.x * n.x + L.y * n.y + L.z * n.z + w;
  const float ab0 = a + b;
  const bool clamped = fabsf(ab0) < 1e-6f;
  const float ab = clamped ? 1e-6f : ab0;
  const float fac = a / ab;
  const V3 P = mk(hl.x - a * n.x, hl.y - a * n.y, hl.z - a * n.z);
  const V3 Q = mk(L.x - b * n.x, L.y - b * n.y, L.z - b * n.z);
  const V3 D = sub(Q, P);
  const V3 s = mk(P.x + D.x * fac, P.y + D.y * fac, P.z + D.z * fac);
  const V3 sv = sub(s, hl);
  const float sv2 = dot(sv, sv);
  const float s3 = sqrtf(fmaxf(sv2, 1e-20f));
  const float lsv = s3 * lr;
  const V3 ls = sub(L, s);
  const float q4 = dot(ls, ls);
  const float lsn = sqrtf(fmaxf(q4, 1e-20f));
  const V3 ts = scale(sv, lsn);
  const float tt = dot(ts, ts);
  const float lpdf = solid_angle(tt, lsv * lsv) / PI;
  const V3 nsv = normalize(sv);
  const float vn = dot(nsv, n);

  float lpdf_bar = 0.0f, spdf_bar = 0.0f;
  if (sv2 > 1e-12f) {
    lpdf_bar = out_bar * schlick(1.0f, 3.0f, vn);
    spdf_bar = out_bar * lpdf;
  }
  // schlick = r0 + ((k·u²)·u²)·u, k = 1 - r0, u = 1 - vn.
  float r0 = (1.0f - 3.0f) / (1.0f + 3.0f);
  r0 = r0 * r0;
  const float k = 1.0f - r0;
  const float u = 1.0f - vn, u2 = u * u, t1 = k * u2;
  const float t2_bar = spdf_bar * u;
  const float u2_bar = t2_bar * t1 + t2_bar * u2 * k;
  const float vn_bar = -(spdf_bar * (t1 * u2) + 2.0f * u * u2_bar);
  axpy(n_bar, vn_bar, nsv);
  V3 sv_bar = mk(0.0f, 0.0f, 0.0f);
  normalize_adjoint(sv, 1e-20f, scale(n, vn_bar), sv_bar);
  float tt_bar = 0.0f, r2_bar = 0.0f;
  solid_angle_adjoint(tt, lsv * lsv, lpdf_bar * (1.0f / PI), tt_bar, r2_bar);
  V3 ts_bar = scale(ts, 2.0f * tt_bar);
  float lsv_bar = r2_bar * 2.0f * lsv;
  cone_dir_adjoint(ts, lsv, pre, dir_bar, ts_bar, lsv_bar);
  // ts = sv·lsn, lsn = |L - s|, lsv = |sv|·lr.
  axpy(sv_bar, lsn, ts_bar);
  const float lsn_bar = dot(ts_bar, sv);
  V3 s_bar = mk(0.0f, 0.0f, 0.0f);
  if (q4 >= 1e-20f) {
    const float c = 2.0f * lsn_bar * (0.5f / lsn);
    axpy(L_bar, c, ls);
    axpy(s_bar, -c, ls);
  }
  lr_bar += lsv_bar * s3;
  if (sv2 >= 1e-20f) axpy(sv_bar, 2.0f * lsv_bar * lr * (0.5f / s3), sv);
  // sv = s - hl, s = P + (Q - P)·fac, P = hl - a·n, Q = L - b·n.
  axpy(s_bar, 1.0f, sv_bar);
  axpy(hl_bar, -1.0f, sv_bar);
  const V3 q_bar = scale(s_bar, fac);
  const V3 p_bar = sub(s_bar, q_bar);
  const float fac_bar = dot(s_bar, D);
  axpy(hl_bar, 1.0f, p_bar);
  axpy(L_bar, 1.0f, q_bar);
  float a_bar = -dot(p_bar, n), b_bar = -dot(q_bar, n);
  axpy(n_bar, -a, p_bar);
  axpy(n_bar, -b, q_bar);
  // fac = a / ab, ab = a + b unless clamped; a = hl·n + w, b = L·n + w.
  a_bar += fac_bar / ab;
  if (!clamped) {
    const float ab_bar = -fac_bar * fac / ab;
    a_bar += ab_bar;
    b_bar += ab_bar;
  }
  axpy(hl_bar, a_bar, n);
  axpy(n_bar, a_bar, hl);
  axpy(L_bar, b_bar, n);
  axpy(n_bar, b_bar, L);
  w_bar += a_bar + b_bar;
}

// -------------------------------------------------------------- materials

// surface's adjoint: the material row of ho at hl (a value: the checker
// reads it through floor only) receives the cotangents of alb, emi, ene.
__device__ inline void surface_adjoint(const Tables& T, int ho, V3 hl, const float alb_bar[3], const float emi_bar[3],
                                const float ene_bar[2], Grad& G) {
  if (ho < 0 || ho >= T.nK) return;
  const int k = ho;
  const float freq = T.f[T.freq + k];
  const float s = floorf(hl.x * freq) + floorf(hl.y * freq) + floorf(hl.z * freq);
  const float checker = fabsf(fmodf(s, 2.0f));
  const float sval = T.f[T.s0 + k] + T.f[T.s1 + k] * checker;
  float sval_bar = 0.0f;
  for (int c = 0; c < 3; ++c) {
    G.add(T.alb_const + k * 3 + c, alb_bar[c]);
    G.add(T.alb_scale + k * 3 + c, alb_bar[c] * sval);
    sval_bar += alb_bar[c] * T.f[T.alb_scale + k * 3 + c];
    G.add(T.emission + k * 3 + c, emi_bar[c]);
  }
  for (int c = 0; c < 2; ++c) {
    G.add(T.en_const + k * 2 + c, ene_bar[c]);
    G.add(T.en_scale + k * 2 + c, ene_bar[c] * sval);
    sval_bar += ene_bar[c] * T.f[T.en_scale + k * 2 + c];
  }
  G.add(T.s0 + k, sval_bar);
  G.add(T.s1 + k, sval_bar * checker);
}

// ------------------------------------------------------------ the shade

// One roulette (shade_core.cuh:roulette) forward in float, then reversed:
// bar is the cotangent of its contribution; the picked plane's material row
// and the light color go to G, the strategy weights' cotangents into wbar.
// The choice, the march and the visibility tests carry no derivative; the
// contribution (emi + e·alb·lc·w_sel)·total/max(EPS, w_sel) reaches every
// weight through the total and the picked one once more.
__device__ inline void roulette_adjoint(const Tables& T, const V3* dirs, const float* ws, V3 hl, int ho, const Pre& pre,
                                 int energy_channel, const float bar[3], float* wbar, Grad& G) {
  if (bar[0] == 0.0f && bar[1] == 0.0f && bar[2] == 0.0f) return;
  const int nP = T.nP;
  float cdf[MAX_PLANES];
  float acc = 0.0f;
  for (int p = 0; p < nP; ++p) {
    acc = acc + ws[p];
    cdf[p] = acc;
  }
  const float total = acc;
  const float rnd = pre.u3 * total;
  int idx = 0;
  for (int p = 0; p < nP - 1; ++p) idx += rnd > cdf[p] ? 1 : 0;

  const V3 dir_sel = dirs[idx];
  const float* pl = T.f + T.planes + idx * 4;
  const V3 n_sel = mk(pl[0], pl[1], pl[2]);
  const int po_sel = T.plane_ids[idx];
  const float denom = dot(dir_sel, n_sel);
  const float sd0 = dot(hl, n_sel) + pl[3];
  const float tp = -sd0 / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
  const bool valid_p = denom < -1e-7f && tp > 0.0f && po_sel != ho;
  if (!nearest_is_target(T, hl, dir_sel, ho, tp, valid_p, false, 0)) return;
  if (po_sel < 0 || po_sel >= T.nK) return;  // no material row: the contribution is 0

  const float t = tp - EPS;
  const V3 hl2 = mk(hl.x + dir_sel.x * t + n_sel.x * EPS, hl.y + dir_sel.y * t + n_sel.y * EPS,
                    hl.z + dir_sel.z * t + n_sel.z * EPS);
  const V3 lv2 = sub(light_pos<float>(T), hl2);
  const V3 sample_dir = cone_dir(lv2, T.f[T.light + 3], pre);
  const bool lhit = light_visible(T, hl2, sample_dir, po_sel);
  float alb[3], emi[3], ene[2];
  surface<float>(T, po_sel, hl2, alb, emi, ene);
  const float e = ene[energy_channel];
  const float w_sel = ws[idx];
  const float m = fmaxf(EPS, w_sel);
  const float boost = total / m;

  float boost_bar = 0.0f, w_sel_bar = 0.0f, e_bar = 0.0f;
  float alb_bar[3], emi_bar[3];
  for (int c = 0; c < 3; ++c) {
    const float lcc = T.f[T.light_color + c];
    const float lc = lhit ? lcc * w_sel : 0.0f;
    boost_bar += bar[c] * (emi[c] + e * alb[c] * lc);
    const float in_bar = bar[c] * boost;
    emi_bar[c] = in_bar;
    const float ea_bar = in_bar * lc;  // (e·alb)·lc
    e_bar += ea_bar * alb[c];
    alb_bar[c] = ea_bar * e;
    if (lhit) {
      const float lc_bar = in_bar * (e * alb[c]);
      G.lc[c] += lc_bar * w_sel;
      w_sel_bar += lc_bar * lcc;
    }
  }
  const float ene_bar[2] = {energy_channel == 0 ? e_bar : 0.0f, energy_channel == 1 ? e_bar : 0.0f};
  surface_adjoint(T, po_sel, hl2, alb_bar, emi_bar, ene_bar, G);

  // boost = total / m, m = max(EPS, w_sel).
  const float inv = 1.0f / m;
  const float total_bar = boost_bar * inv;
  if (w_sel >= EPS) w_sel_bar += -boost_bar * boost * inv;
  for (int p = 0; p < nP; ++p) wbar[p] += total_bar;
  wbar[idx] += w_sel_bar;
}

// One strategy of plane p (PHONG: phong_pdf, else lambert_pdf), reversed
// from the cotangents of its two weights, pdf·max(EPS, dir·hn) (the
// Lambert estimator's) and pdf·max(EPS, dir·refl)^gloss (the Phong one's);
// (dir, pdf) are its forward values. The plane's row cotangent goes to
// n_bar and w_bar.
template <bool PHONG>
__device__ inline void strategy_adjoint(const Tables& T, int p, V3 hl, V3 hn, V3 refl, const Pre& pre, int gloss,
                                        V3 dir, float pdf, float w_lam_bar, float w_pho_bar, V3& hl_bar,
                                        V3& hn_bar, V3& refl_bar, V3& L_bar, float& lr_bar, V3& n_bar,
                                        float& w_bar) {
  if (w_lam_bar == 0.0f && w_pho_bar == 0.0f) return;
  const float m_hn = dot(dir, hn), m_rf = dot(dir, refl);
  float dpow;
  const float pw = powi_d(fmaxf(EPS, m_rf), gloss, dpow);
  const float pdf_bar = w_lam_bar * fmaxf(EPS, m_hn) + w_pho_bar * pw;
  V3 dir_bar = mk(0.0f, 0.0f, 0.0f);
  if (m_hn >= EPS) {
    axpy(dir_bar, w_lam_bar * pdf, hn);
    axpy(hn_bar, w_lam_bar * pdf, dir);
  }
  if (m_rf >= EPS) {
    const float s = w_pho_bar * pdf * dpow;
    axpy(dir_bar, s, refl);
    axpy(refl_bar, s, dir);
  }
  const int q = T.planes + p * 4;
  const V3 n = mk(T.f[q], T.f[q + 1], T.f[q + 2]);
  if constexpr (PHONG) {
    phong_pdf_adjoint(light_pos<float>(T), T.f[T.light + 3], n, T.f[q + 3], hl, pre, dir_bar, pdf_bar, L_bar,
                      lr_bar, n_bar, w_bar, hl_bar);
  } else {
    lambert_pdf_adjoint(light_pos<float>(T), n, T.f[q + 3], hl, pre, dir_bar, pdf_bar, L_bar, n_bar, w_bar,
                        hl_bar);
  }
}

// Sphere s's factor of soft_transmittance (sphere_transmittance), reversed
// from its cotangent v_bar into hl, the shadow ray's direction dl, t_surf
// and the sphere's row.
__device__ inline void sphere_transmittance_adjoint(const Tables& T, int s, V3 hl, V3 dl, float t_surf, float beta,
                                             float v_bar, V3& hl_bar, V3& dl_bar, float& t_surf_bar, Grad& G) {
  const int q = T.spheres + s * 4;
  const V3 c = mk(T.f[q], T.f[q + 1], T.f[q + 2]);
  const V3 ch = sub(c, hl);
  const float u = dot(ch, dl);
  const float mu = fmaxf(u, EPS);
  const float tc = fminf(mu, t_surf);  // clip(u, EPS, t_surf)
  const V3 cl = mk(hl.x + dl.x * tc - c.x, hl.y + dl.y * tc - c.y, hl.z + dl.z * tc - c.z);
  const float qq = dot(cl, cl);
  const float sq = sqrtf(fmaxf(qq, 1e-20f));
  const float sd = sq - T.f[q + 3];
  const float den = beta * tc;
  const float x = sd / den;
  const float v = sigmoid(x);

  const float x_bar = v_bar * (v * (1.0f - v));
  const float inv = 1.0f / den;
  const float sd_bar = x_bar * inv;
  float tc_bar = -x_bar * x * inv * beta;
  G.add(q + 3, -sd_bar);
  const float q_bar = qq >= 1e-20f ? sd_bar * (0.5f / sq) : 0.0f;
  V3 cl_bar = scale(cl, 2.0f * q_bar);
  hl_bar = mk(hl_bar.x + cl_bar.x, hl_bar.y + cl_bar.y, hl_bar.z + cl_bar.z);
  axpy(dl_bar, tc, cl_bar);
  tc_bar += dot(cl_bar, dl);
  V3 c_bar = scale(cl_bar, -1.0f);
  float u_bar = 0.0f;
  if (mu <= t_surf) {
    if (u >= EPS) u_bar = tc_bar;
  } else {
    t_surf_bar += tc_bar;
  }
  axpy(c_bar, u_bar, dl);
  axpy(hl_bar, -u_bar, dl);
  axpy(dl_bar, u_bar, ch);
  G.add(q, c_bar.x);
  G.add(q + 1, c_bar.y);
  G.add(q + 2, c_bar.z);
}

// soft_transmittance's adjoint: trans = Π_s v_s over the spheres other
// than the light and ho, so ∂trans/∂v_s is the product of the other
// factors. Taken as prefix · suffix products, never as trans / v_s (a
// sigmoid can underflow to 0), sixteen spheres at a time from the last.
__device__ inline void soft_transmittance_adjoint(const Tables& T, V3 hl, V3 dl, float t_surf, int ho, float beta,
                                           float trans_bar, V3& hl_bar, V3& dl_bar, float& t_surf_bar, Grad& G) {
  constexpr int GROUP = 16;
  auto skip = [&](int s) {
    const int sid = T.sphere_ids[s];
    return sid == T.light_id || sid == ho;
  };
  auto factor = [&](int s) { return skip(s) ? 1.0f : sphere_transmittance(T, s, hl, dl, t_surf, beta); };
  float suffix = 1.0f;  // the product over the spheres after this group
  for (int g0 = (T.nS - 1) / GROUP * GROUP; g0 >= 0; g0 -= GROUP) {
    float prefix = 1.0f;  // and over the spheres before it
    for (int s = 0; s < g0; ++s) prefix *= factor(s);
    const int n = min(GROUP, T.nS - g0);
    float v[GROUP], left[GROUP];
    for (int j = 0; j < n; ++j) {
      v[j] = factor(g0 + j);
      left[j] = prefix;
      prefix *= v[j];
    }
    for (int j = n - 1; j >= 0; --j) {
      if (!skip(g0 + j))
        sphere_transmittance_adjoint(T, g0 + j, hl, dl, t_surf, beta, trans_bar * left[j] * suffix, hl_bar,
                                     dl_bar, t_surf_bar, G);
      suffix *= v[j];
    }
  }
}

// One biased sample (shade_core) forward in float, then its reverse: adds
// ∂(ed_bar·est_d + es_bar·est_s)/∂· into hn_bar, rd_bar, hl_bar and G.
__device__ inline void shade_sample_adjoint(const Tables& T, V3 hn, V3 rd, int ho, V3 hl, int seed, float soft_beta,
                                     int gloss, const float ed_bar[3], const float es_bar[3], V3& hn_bar,
                                     V3& rd_bar, V3& hl_bar, Grad& G) {
  // Forward.
  const V3 L = light_pos<float>(T);
  const float lr = T.f[T.light + 3];
  const Pre pre = cone_pre(seed);
  const V3 lv = sub(L, hl);
  const V3 dl_dir = cone_dir(lv, lr, pre);
  const float dl_pdf = solid_angle(dot(lv, lv), lr * lr);
  const float lam_d = dot(dl_dir, hn);
  const float lam_w = fmaxf(EPS, lam_d);
  const V3 refl = reflect(rd, hn);
  const float pho_d = dot(dl_dir, refl);
  float pho_dp;
  const float pho_w = powi_d(fmaxf(EPS, pho_d), gloss, pho_dp);
  float vis, t_surf = 0.0f;
  bool soft = false;  // vis is the soft-shadow product
  if (soft_beta > 0.0f) {
    float t_unused;
    int vis_id;
    trace(T, hl, dl_dir, ho, t_unused, vis_id);
    const float dist = sqrtf(fmaxf(dot(lv, lv), 1e-20f));
    t_surf = fmaxf(dist - lr, EPS);
    for (int s = 0; s < T.nS; ++s) soft = soft || vis_id == T.sphere_ids[s];
    vis = soft ? soft_transmittance(T, hl, dl_dir, t_surf, ho, soft_beta) : 0.0f;
  } else {
    vis = light_visible(T, hl, dl_dir, ho) ? 1.0f : 0.0f;
  }
  const int nP = T.nP;
  V3 dirs_l[MAX_PLANES], dirs_p[MAX_PLANES];
  float pdf_l[MAX_PLANES], pdf_p[MAX_PLANES];
  float w_ll[MAX_PLANES], w_pl[MAX_PLANES], w_lp[MAX_PLANES], w_pp[MAX_PLANES];
  for (int p = 0; p < nP; ++p) {
    plane_pdf_lambert(T, p, hl, pre, dirs_l[p], pdf_l[p]);
    plane_pdf_phong(T, p, hl, pre, dirs_p[p], pdf_p[p]);
    w_ll[p] = pdf_l[p] * fmaxf(EPS, dot(dirs_l[p], hn));
    w_pl[p] = pdf_p[p] * fmaxf(EPS, dot(dirs_p[p], hn));
    w_lp[p] = pdf_l[p] * powi(fmaxf(EPS, dot(dirs_l[p], refl)), gloss);
    w_pp[p] = pdf_p[p] * powi(fmaxf(EPS, dot(dirs_p[p], refl)), gloss);
  }

  // Reverse: the roulettes, then each plane's strategies.
  float b_ll[MAX_PLANES], b_pl[MAX_PLANES], b_lp[MAX_PLANES], b_pp[MAX_PLANES];
  for (int p = 0; p < nP; ++p) b_ll[p] = b_pl[p] = b_lp[p] = b_pp[p] = 0.0f;
  roulette_adjoint(T, dirs_l, w_ll, hl, ho, pre, 0, ed_bar, b_ll, G);
  roulette_adjoint(T, dirs_p, w_pl, hl, ho, pre, 1, ed_bar, b_pl, G);
  roulette_adjoint(T, dirs_l, w_lp, hl, ho, pre, 0, es_bar, b_lp, G);
  roulette_adjoint(T, dirs_p, w_pp, hl, ho, pre, 1, es_bar, b_pp, G);
  V3 refl_bar = mk(0.0f, 0.0f, 0.0f), L_bar = mk(0.0f, 0.0f, 0.0f);
  float lr_bar = 0.0f;
  for (int p = 0; p < nP; ++p) {
    V3 n_bar = mk(0.0f, 0.0f, 0.0f);
    float w_bar = 0.0f;
    strategy_adjoint<false>(T, p, hl, hn, refl, pre, gloss, dirs_l[p], pdf_l[p], b_ll[p], b_lp[p], hl_bar, hn_bar,
                            refl_bar, L_bar, lr_bar, n_bar, w_bar);
    strategy_adjoint<true>(T, p, hl, hn, refl, pre, gloss, dirs_p[p], pdf_p[p], b_pl[p], b_pp[p], hl_bar, hn_bar,
                           refl_bar, L_bar, lr_bar, n_bar, w_bar);
    const int q = T.planes + p * 4;
    G.add(q, n_bar.x);
    G.add(q + 1, n_bar.y);
    G.add(q + 2, n_bar.z);
    G.add(q + 3, w_bar);
  }

  // The direct light: est_d = lc·((vis·dl_pdf)·lam_w), est_s = lc·((vis·dl_pdf)·pho_w).
  const float vd = vis * dl_pdf;
  float a_bar = 0.0f, b_bar = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float lc = T.f[T.light_color + c];
    G.lc[c] += ed_bar[c] * (vd * lam_w) + es_bar[c] * (vd * pho_w);
    a_bar += ed_bar[c] * lc;
    b_bar += es_bar[c] * lc;
  }
  const float vd_bar = a_bar * lam_w + b_bar * pho_w;
  V3 dl_bar = mk(0.0f, 0.0f, 0.0f);
  if (lam_d >= EPS) {
    axpy(dl_bar, a_bar * vd, hn);
    axpy(hn_bar, a_bar * vd, dl_dir);
  }
  if (pho_d >= EPS) {
    const float s = b_bar * vd * pho_dp;
    axpy(dl_bar, s, refl);
    axpy(refl_bar, s, dl_dir);
  }
  float t_surf_bar = 0.0f;
  if (soft) soft_transmittance_adjoint(T, hl, dl_dir, t_surf, ho, soft_beta, vd_bar * dl_pdf, hl_bar, dl_bar,
                                       t_surf_bar, G);
  // The light cone: dl_dir = cone_dir(lv, lr), dl_pdf = solid_angle(lv·lv,
  // lr²), t_surf = max(|lv| - lr, EPS), lv = L - hl.
  V3 lv_bar = mk(0.0f, 0.0f, 0.0f);
  cone_dir_adjoint(lv, lr, pre, dl_bar, lv_bar, lr_bar);
  const float q = dot(lv, lv);
  float q_bar = 0.0f, r2_bar = 0.0f;
  solid_angle_adjoint(q, lr * lr, vd_bar * vis, q_bar, r2_bar);
  lr_bar += 2.0f * lr * r2_bar;
  if (soft) {
    const float dist = sqrtf(fmaxf(q, 1e-20f));
    if (dist - lr >= EPS) {
      lr_bar -= t_surf_bar;
      if (q >= 1e-20f) q_bar += t_surf_bar * (0.5f / dist);
    }
  }
  axpy(lv_bar, 2.0f * q_bar, lv);
  axpy(L_bar, 1.0f, lv_bar);
  axpy(hl_bar, -1.0f, lv_bar);
  // refl = rd - (2·hn·rd)·hn.
  const float dd = 2.0f * dot(hn, rd);
  const float dd_bar = -dot(refl_bar, hn);
  rd_bar = mk(rd_bar.x + refl_bar.x, rd_bar.y + refl_bar.y, rd_bar.z + refl_bar.z);
  axpy(hn_bar, -dd, refl_bar);
  axpy(hn_bar, 2.0f * dd_bar, rd);
  axpy(rd_bar, 2.0f * dd_bar, hn);
  G.light[0] += L_bar.x;
  G.light[1] += L_bar.y;
  G.light[2] += L_bar.z;
  G.light[3] += lr_bar;
}

// The unbiased estimators (shade_core_unbiased): only the light color
// carries a derivative.
__device__ inline void shade_unbiased_adjoint(const Tables& T, V3 hn, V3 rd, int ho, V3 hl, int seed, int smp,
                                       bool decorrelate, const float gbar[13], Grad& G) {
  int nvis = 0;
  for (int i = 0; i < smp; ++i)
    nvis += light_visible(T, hl, cos_hemi_dir(hn, fold_seed(seed, i, decorrelate)), ho) ? 1 : 0;
  const float d_scale = PI * (float)nvis * (smp > 1 ? 1.0f / (float)smp : 1.0f);
  const float vis_s = light_visible(T, hl, reflect(rd, hn), ho) ? 1.0f : 0.0f;
  for (int c = 0; c < 3; ++c) G.lc[c] += gbar[c] * d_scale + gbar[3 + c] * vis_s;
}

// ------------------------------------------------------- the primary hit

using DP = Dual<13>;  // the primary hit's leaf: ro (lanes 0-2), rd (3-5), one object's row (6-12)

// The t of trace's winning candidate `win` (shade_core.cuh:trace's code)
// from o along d, by trace's own arithmetic; row entry i on lane 6 + i when
// `seed`. The nearest-hit selection passes the derivative to the winner
// alone.
__device__ inline DP winner_t(const Tables& T, int win, const V3T<DP>& o, const V3T<DP>& d, bool seed) {
  auto row = [&](int q, int i) { return seeded<13>(T.f[q + i], seed ? 6 + i : -1); };
  if (win < 256) {
    const int q = T.planes + win * 4;
    const DP n0 = row(q, 0), n1 = row(q, 1), n2 = row(q, 2), w = row(q, 3);
    const DP denom = d.x * n0 + d.y * n1 + d.z * n2;
    const DP sd0 = o.x * n0 + o.y * n1 + o.z * n2 + w;
    return -sd0 / (fabsf(denom) < 1e-12f ? DP(1e-12f) : denom);
  }
  if (win < 512) {
    const int q = T.spheres + (win - 256) * 4;
    const V3T<DP> oc = mk(o.x - row(q, 0), o.y - row(q, 1), o.z - row(q, 2));
    const DP r = row(q, 3);
    const DP b = dot(oc, d);
    const DP c2 = dot(oc, oc) - r * r;
    const DP ds = b * b - c2;
    return -b - sqrtf(fmaxf(ds, 1e-12f));
  }
  const int q = T.boxes + ((win - 512) >> 5) * 7, part = (win - 512) & 31;
  const V3T<DP> he = mk(row(q, 3), row(q, 4), row(q, 5));
  const DP rnd = row(q, 6);
  const V3T<DP> ob = mk(o.x - row(q, 0), o.y - row(q, 1), o.z - row(q, 2));
  // Component k of a vector, selected by value (no local array).
  auto at = [](const V3T<DP>& v, int k) { return k == 0 ? v.x : (k == 1 ? v.y : v.z); };
  if (part < 6) {  // face (k, si)
    const int k = part >> 1;
    const float sgn = (part & 1) ? -1.0f : 1.0f;
    const DP dk = fabsf(at(d, k)) < 1e-12f ? DP(1e-12f) : at(d, k);
    return (sgn * (at(he, k) + rnd) - at(ob, k)) / dk;
  }
  if (part < 18) {  // edge cylinder (k, ii, jj)
    const int e = part - 6, k = e >> 2;
    const int i = (k + 1) % 3, j = (k + 2) % 3;
    const float si = (e & 2) ? -1.0f : 1.0f, sj = (e & 1) ? -1.0f : 1.0f;
    const DP di = at(d, i), dj = at(d, j);
    const DP a = fmaxf(di * di + dj * dj, 1e-12f);
    const DP oi = at(ob, i) - si * at(he, i);
    const DP oj = at(ob, j) - sj * at(he, j);
    const DP b = oi * di + oj * dj;
    const DP cq = oi * oi + oj * oj - rnd * rnd;
    const DP disc = b * b - a * cq;
    return (-b - sqrtf(fmaxf(disc, 1e-12f))) / a;
  }
  const int c = part - 18;  // corner sphere
  const float sx = (c & 4) ? -1.0f : 1.0f, sy = (c & 2) ? -1.0f : 1.0f, sz = (c & 1) ? -1.0f : 1.0f;
  const V3T<DP> oc = mk(ob.x - sx * he.x, ob.y - sy * he.y, ob.z - sz * he.z);
  const DP b = dot(oc, d);
  const DP cq = dot(oc, oc) - rnd * rnd;
  const DP disc = b * b - cq;
  return -b - sqrtf(fmaxf(disc, 1e-12f));
}

// normal_curv's normal and curvature for one table object (kind 0 plane,
// 1 sphere, 2 rounded box; -1 none) at hp; row entry i on lane 6 + i when
// `seed`.
__device__ inline void normal_leaf(const Tables& T, int kind, int i, const V3T<DP>& hp, bool seed, V3T<DP>& n, DP& c) {
  auto row = [&](int q, int k) { return seeded<13>(T.f[q + k], seed ? 6 + k : -1); };
  n = mk(DP(0.0f), DP(0.0f), DP(0.0f));
  c = 0.0f;
  if (kind == 0) {
    const int q = T.planes + i * 4;
    n = mk(row(q, 0), row(q, 1), row(q, 2));
  } else if (kind == 1) {
    const int q = T.spheres + i * 4;
    const V3T<DP> d = mk(hp.x - row(q, 0), hp.y - row(q, 1), hp.z - row(q, 2));
    const DP inv = rsqrtf(fmaxf(dot(d, d), 1e-12f));
    n = scale(d, inv);
    c = EPS * inv;
  } else if (kind == 2) {
    const int q = T.boxes + i * 7;
    const DP qv[3] = {hp.x - row(q, 0), hp.y - row(q, 1), hp.z - row(q, 2)};
    DP m[3];
    float kpos = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const DP dk = fabsf(qv[k]) - row(q, 3 + k);
      m[k] = fmaxf(dk, 0.0f);
      kpos = kpos + (dk > 0.0f ? 1.0f : 0.0f);
    }
    const DP inv = rsqrtf(fmaxf(m[0] * m[0] + m[1] * m[1] + m[2] * m[2], 1e-12f));
    n = mk(m[0] * sign3(qv[0].v) * inv, m[1] * sign3(qv[1].v) * inv, m[2] * sign3(qv[2].v) * inv);
    c = 0.0005f * fmaxf(kpos - 1.0f, 0.0f) * inv;
  }
}

// Add g's row lanes (6 + i) to the row of table object (kind, i).
__device__ inline void add_row(const Tables& T, int kind, int i, const float (&g)[13], Grad& G) {
  const int q = kind == 0 ? T.planes + i * 4 : (kind == 1 ? T.spheres + i * 4 : T.boxes + i * 7);
  const int len = kind == 2 ? 7 : 4;
  for (int e = 0; e < len; ++e) G.add(q + e, g[6 + e]);
}

// The primary hit reversed: depth = t - EPS, curv and the normal hn of the
// object normal_curv reads (the last table entry with this id), and the
// shading point hl = ro + rd·depth, with t the winner's t less EPS. Adds to
// ro_bar, rd_bar and the rows. When the normal's object is not the winner
// (ids shared across tables), a second pass seeds its row.
__device__ inline void primary_adjoint(const Tables& T, V3 ro, V3 rd, int win, int oid, float depth_bar, float curv_bar,
                                V3 hn_bar, V3 hl_bar, V3& ro_bar, V3& rd_bar, Grad& G) {
  if (depth_bar == 0.0f && curv_bar == 0.0f && hn_bar.x == 0.0f && hn_bar.y == 0.0f && hn_bar.z == 0.0f &&
      hl_bar.x == 0.0f && hl_bar.y == 0.0f && hl_bar.z == 0.0f)
    return;
  int nk = -1, ni = 0;
  for (int i = 0; i < T.nP; ++i)
    if (T.plane_ids[i] == oid) nk = 0, ni = i;
  for (int i = 0; i < T.nS; ++i)
    if (T.sphere_ids[i] == oid) nk = 1, ni = i;
  for (int i = 0; i < T.nB; ++i)
    if (T.box_ids[i] == oid) nk = 2, ni = i;
  const int wk = win < 256 ? 0 : (win < 512 ? 1 : 2);
  const int wi = wk == 0 ? win : (wk == 1 ? win - 256 : (win - 512) >> 5);
  const bool same = nk == wk && ni == wi;
  const int passes = same || nk < 0 ? 1 : 2;
  for (int pass = 0; pass < passes; ++pass) {
    const bool first = pass == 0;
    const V3T<DP> o = first ? seeded3<13>(ro, 0) : mk(DP(ro.x), DP(ro.y), DP(ro.z));
    const V3T<DP> d = first ? seeded3<13>(rd, 3) : mk(DP(rd.x), DP(rd.y), DP(rd.z));
    const DP t = winner_t(T, win, o, d, first) - EPS;  // trace pulls the hit back by EPS
    const V3T<DP> hp = mk(o.x + d.x * t, o.y + d.y * t, o.z + d.z * t);
    V3T<DP> n;
    DP c;
    normal_leaf(T, nk, ni, hp, !first || same, n, c);
    const DP depth = t - EPS;
    const V3T<DP> hl = mk(o.x + d.x * depth, o.y + d.y * depth, o.z + d.z * depth);
    float g[13] = {};
    vjp(g, depth, depth_bar);
    vjp(g, c, curv_bar);
    vjp3(g, n, hn_bar);
    vjp3(g, hl, hl_bar);
    if (first) {
      ro_bar = mk(ro_bar.x + g[0], ro_bar.y + g[1], ro_bar.z + g[2]);
      rd_bar = mk(rd_bar.x + g[3], rd_bar.y + g[4], rd_bar.z + g[5]);
      add_row(T, wk, wi, g, G);
    } else {
      add_row(T, nk, ni, g, G);
    }
  }
}

// primary_ray reversed: ro is the camera; rd turns the pixel's fixed
// direction by the pitch and yaw in orient.
__device__ inline void primary_ray_adjoint(const Tables& T, const FrameParams& P, int px, int py, V3 ro_bar, V3 rd_bar,
                                    Grad& G) {
  const float asp = (float)((double)P.width / (double)P.height);
  const float xf = (2.0f * ((float)px + 0.5f) / (float)P.width - 1.0f) * asp;
  const float yf = 2.0f * ((float)py + 0.5f) / (float)P.height - 1.0f;
  const float zf = P.fov;
  const float inv = rsqrtf(xf * xf + yf * yf + zf * zf);
  const float dx = xf * inv, dy = yf * inv, dz = zf * inv;
  const float o0 = T.f[T.orient], o1 = T.f[T.orient + 1];
  const float cx = cosf(o0), sx = sinf(o0);
  const float cy = cosf(o1), sy = sinf(o1);
  const float z1 = -dy * sx + dz * cx;
  // rd = (dx·cy + z1·sy, dy·cx + dz·sx, -dx·sy + z1·cy), z1 = -dy·sx + dz·cx.
  const float cy_bar = rd_bar.x * dx + rd_bar.z * z1;
  const float sy_bar = rd_bar.x * z1 - rd_bar.z * dx;
  const float z1_bar = rd_bar.x * sy + rd_bar.z * cy;
  const float cx_bar = rd_bar.y * dy + z1_bar * dz;
  const float sx_bar = rd_bar.y * dz - z1_bar * dy;
  G.orient[0] += cx * sx_bar - sx * cx_bar;
  G.orient[1] += cy * sy_bar - sy * cy_bar;
  G.cam[0] += ro_bar.x;
  G.cam[1] += ro_bar.y;
  G.cam[2] += ro_bar.z;
}

// ------------------------------------------------------------- the pixel

// Add ∂(Σ_k gbar_k·out_k)/∂θ of image pixel (px, py) (py from the image
// bottom) to G, out being frame_pixel's 13 float planes.
__device__ inline void frame_pixel_adjoint(const Tables& T, const FrameParams& P, int px, int py, const float gbar[13],
                                    Grad& G) {
  // Forward, as frame_pixel, recording the primary trace's winner.
  V3 ro, rd;
  primary_ray(T, P, px, py, ro, rd);
  const uint32_t upx = (uint32_t)px, upy = (uint32_t)py;
  const int seed = (int)((((uint32_t)P.frame << 12) + upx + (upy << 1)) ^ (upx * (uint32_t)P.height) ^
                         (upy * (uint32_t)P.width));
  float t;
  int oid, win;
  trace<float, false, true>(T, ro, rd, -1, t, oid, &win);
  const bool hit = oid > 0;
  V3 hn;
  float curv;
  normal_curv(T, mk(ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t), oid, hn, curv);
  if (!hit) hn = mk(0.0f, 0.0f, 0.0f);
  const float depth = t - EPS;
  const V3 hl = mk(ro.x + rd.x * depth, ro.y + rd.y * depth, ro.z + rd.z * depth);

  // The primary material: add_d = emi + est_d, add_s = emi + est_s, alb, ene.
  const float emi_bar[3] = {gbar[0] + gbar[3], gbar[1] + gbar[4], gbar[2] + gbar[5]};
  surface_adjoint(T, oid, hl, gbar + 6, emi_bar, gbar + 9, G);
  if (!hit) return;  // a miss's depth and curvature are constants and it is not shaded

  V3 hn_bar = mk(0.0f, 0.0f, 0.0f), rd_bar = mk(0.0f, 0.0f, 0.0f), hl_bar = mk(0.0f, 0.0f, 0.0f);
  bool est = false;
  for (int k = 0; k < 6; ++k) est = est || gbar[k] != 0.0f;
  if (est && oid != T.light_id) {
    if (P.biased) {
      const float inv_smp = P.smp > 1 ? 1.0f / (float)P.smp : 1.0f;
      const float ed_bar[3] = {gbar[0] * inv_smp, gbar[1] * inv_smp, gbar[2] * inv_smp};
      const float es_bar[3] = {gbar[3] * inv_smp, gbar[4] * inv_smp, gbar[5] * inv_smp};
      for (int i = 0; i < P.smp; ++i)
        shade_sample_adjoint(T, hn, rd, oid, hl, fold_seed(seed, i, P.decorrelate != 0), P.soft_beta, P.gloss,
                             ed_bar, es_bar, hn_bar, rd_bar, hl_bar, G);
    } else {
      shade_unbiased_adjoint(T, hn, rd, oid, hl, seed, P.smp, P.decorrelate != 0, gbar, G);
    }
  }

  V3 ro_bar = mk(0.0f, 0.0f, 0.0f);
  primary_adjoint(T, ro, rd, win, oid, gbar[11], gbar[12], hn_bar, hl_bar, ro_bar, rd_bar, G);
  primary_ray_adjoint(T, P, px, py, ro_bar, rd_bar, G);
}

}  // namespace kpt
