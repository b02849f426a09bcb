// The frame body of K1 (frame_kernel.cu) and K8 (frame_hist.cu): the
// per-pixel math of frame_core.cuh:frame_pixel, one pixel per thread, with
// three changes that the card's measurements called for (PERF.md, PR 6):
//
// - every trace culls the rounded box by a slab test (CULL,
//   shade_core.cuh:box_may_hit) before its 26 candidates, which leaves t
//   and oid bit for bit: with the box switched off, frame_pixel took 39%
//   less time;
// - the plane strategies' directions and weights, which the roulettes
//   index at run time, live in the thread's own slots of shared memory
//   (`Slot`) instead of in arrays on its stack (352 bytes a thread);
// - the tables are gathered into shared memory straight from the scene's
//   tensors (`TableParts`), so the wrapper packs nothing, and what is the
//   same for every pixel (the camera's rotation; K8's previous-camera
//   basis and clamp limit) is computed once per block (`Block`).
//
// A design that compacted the block's shaded pixels and ran each pixel's
// four roulettes on four threads, with the block synchronized between the
// phases, took longer than frame_pixel on the card at 1080p and at the
// 192×128 recovery view, and was dropped.
#pragma once

#include "frame_core.cuh"

namespace kpt {

// The block: 128 threads on a 16×8 tile of pixels.
constexpr int BLOCK = 128, TILE_W = 16, TILE_H = 8;

// A thread's slots in shared memory, field-major across the block's
// threads (field a at f[a·BLOCK]): the weight of roulette k's strategy on
// plane p at 4p + k, the lambert and the phong direction of plane p at
// 4nP + 3p and 7nP + 3p.
struct Slot {
  float* f;
  int nP;
  __device__ float& w(int k, int p) const { return f[(4 * p + k) * BLOCK]; }
  __device__ float* dir(int strategy, int p) const { return f + ((4 + 3 * strategy) * nP + 3 * p) * BLOCK; }
  __device__ V3 get(int strategy, int p) const {
    const float* d = dir(strategy, p);
    return mk(d[0], d[BLOCK], d[2 * BLOCK]);
  }
  __device__ void put(int strategy, int p, V3 v) const {
    float* d = dir(strategy, p);
    d[0] = v.x;
    d[BLOCK] = v.y;
    d[2 * BLOCK] = v.z;
  }
};

// Values the same for every pixel of the frame, computed by one thread of
// the block: cos/sin of the camera's pitch and yaw, and K8's previous-camera
// basis (lf, r, u) and velocity clamp limit.
struct Block {
  float cx, sx, cy, sy;
  V3 lf, r, u;
  float limit;
};

// Bytes of shared memory of a frame-body block: the tables, `Block` and
// the slots.
__host__ __device__ inline size_t body_smem(int nP, int nS, int nB, int nK) {
  return table_smem(nP, nS, nB, nK, false) + sizeof(Block) + sizeof(float) * (size_t)(10 * nP) * BLOCK;
}

__device__ inline Block* block_values(float* smem, const FrameParams& P) {
  return reinterpret_cast<Block*>(smem + table_smem(P.nP, P.nS, P.nB, P.nK, false) / sizeof(float));
}

__device__ inline Slot thread_slot(float* smem, const FrameParams& P) {
  return {reinterpret_cast<float*>(block_values(smem, P) + 1) + threadIdx.x, P.nP};
}

// The camera's rotation of `Block`, as frame_core.cuh:primary_ray computes it.
__device__ inline void camera_trig(const Tables& T, Block& B) {
  B.cx = cosf(T.f[T.orient]);
  B.sx = sinf(T.f[T.orient]);
  B.cy = cosf(T.f[T.orient + 1]);
  B.sy = sinf(T.f[T.orient + 1]);
}

// frame_core.cuh:primary_ray with the camera's rotation from `Block`.
__device__ __forceinline__ void primary_ray_block(const Tables& T, const FrameParams& P, const Block& B, int px,
                                                  int py, V3& ro, V3& rd) {
  const float asp = (float)((double)P.width / (double)P.height);
  const float xf = (2.0f * ((float)px + 0.5f) / (float)P.width - 1.0f) * asp;
  const float yf = 2.0f * ((float)py + 0.5f) / (float)P.height - 1.0f;
  const float zf = P.fov;
  const float inv = rsqrtf(xf * xf + yf * yf + zf * zf);
  const float dx = xf * inv, dy = yf * inv, dz = zf * inv;
  const float y2 = dy * B.cx + dz * B.sx;
  const float z1 = -dy * B.sx + dz * B.cx;
  rd = mk(dx * B.cy + z1 * B.sy, y2, -dx * B.sy + z1 * B.cy);
  ro = mk(T.f[T.cam], T.f[T.cam + 1], T.f[T.cam + 2]);
}

// Roulette k (shade_core.cuh:roulette on the lambert (k even) or phong (k
// odd) strategy, energy channel k & 1) over the slot's strategies: adds
// its contribution into est[3].
__device__ inline void roulette_slot(const Tables& T, const Slot& sl, int k, V3 hl, int ho, const Pre& pre,
                                     float est[3]) {
  const int nP = T.nP;
  float acc = 0.0f;
  for (int p = 0; p < nP; ++p) acc = acc + sl.w(k, p);
  const float total = acc;
  const float rnd = pre.u3 * total;
  // The first p with rnd <= cdf_p (last plane unconditional).
  int idx = 0;
  acc = 0.0f;
  for (int p = 0; p < nP - 1; ++p) {
    acc = acc + sl.w(k, p);
    idx += rnd > acc ? 1 : 0;
  }
  const V3 dir_sel = sl.get(k & 1, idx);
  const float w_sel = sl.w(k, idx);
  const float* pl = T.f + T.planes + idx * 4;
  const V3 n_sel = mk(pl[0], pl[1], pl[2]);
  const int po_sel = T.plane_ids[idx];

  // Analytic hit on the selected plane + occlusion verify (common.glsl:356-371).
  const float denom = dot(dir_sel, n_sel);
  const float sd0 = dot(hl, n_sel) + pl[3];
  const float tp = -sd0 / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
  const bool valid_p = denom < -1e-7f && tp > 0.0f && po_sel != ho;
  if (!nearest_is_target<true>(T, hl, dir_sel, ho, tp, valid_p, false, 0)) return;

  const float t = tp - EPS;
  const V3 hl2 = mk(hl.x + dir_sel.x * t + n_sel.x * EPS, hl.y + dir_sel.y * t + n_sel.y * EPS,
                    hl.z + dir_sel.z * t + n_sel.z * EPS);
  const V3 lv2 = sub(light_pos<float>(T), hl2);
  const V3 sample_dir = cone_dir(lv2, T.f[T.light + 3], pre);
  const bool lhit = light_visible<true>(T, hl2, sample_dir, po_sel);
  float alb[3], emi[3], ene[2];
  surface<float>(T, po_sel, hl2, alb, emi, ene);
  const float e = ene[k & 1];
  const float boost = total / fmaxf(EPS, w_sel);
  for (int c = 0; c < 3; ++c) {
    const float lc = lhit ? T.f[T.light_color + c] * w_sel : 0.0f;
    est[c] = est[c] + (emi[c] + e * alb[c] * lc) * boost;
  }
}

// One sample of the direct light and the four plane-strategy roulettes
// (shade_core.cuh:shade_core) → est_d / est_s, the strategies kept in the
// thread's slot.
__device__ inline void shade_sample(const Tables& T, const Slot& sl, V3 hn, V3 rd, int ho, V3 hl, int seed,
                                    float soft_beta, int gloss, float est_d[3], float est_s[3]) {
  const V3 L = light_pos<float>(T);
  const float lr = T.f[T.light + 3];
  const Pre pre = cone_pre(seed);
  const V3 lv = sub(L, hl);
  const V3 dl_dir = cone_dir(lv, lr, pre);
  const float dl_pdf = solid_angle(dot(lv, lv), lr * lr);
  const float lam_w = fmaxf(EPS, dot(dl_dir, hn));
  const V3 refl = reflect(rd, hn);
  const float pho_w = powi(fmaxf(EPS, dot(dl_dir, refl)), gloss);

  float vis;
  if (soft_beta > 0.0f) {
    float t_unused;
    int vis_id;
    trace<float, false, false, true>(T, hl, dl_dir, ho, t_unused, vis_id);
    const float dist = sqrtf(fmaxf(dot(lv, lv), 1e-20f));
    const float t_surf = fmaxf(dist - lr, EPS);
    const float trans = soft_transmittance(T, hl, dl_dir, t_surf, ho, soft_beta);
    bool sol = false;
    for (int j = 0; j < T.nS; ++j) sol = sol || vis_id == T.sphere_ids[j];
    vis = sol ? trans : 0.0f;
  } else {
    vis = light_visible<true>(T, hl, dl_dir, ho) ? 1.0f : 0.0f;
  }
  for (int c = 0; c < 3; ++c) {
    est_d[c] = T.f[T.light_color + c] * (vis * dl_pdf * lam_w);
    est_s[c] = T.f[T.light_color + c] * (vis * dl_pdf * pho_w);
  }

  for (int p = 0; p < T.nP; ++p) {
    V3 dl, dp;
    float pl_, pp_;
    plane_pdf_lambert(T, p, hl, pre, dl, pl_);
    plane_pdf_phong(T, p, hl, pre, dp, pp_);
    sl.put(0, p, dl);
    sl.put(1, p, dp);
    sl.w(0, p) = pl_ * fmaxf(EPS, dot(dl, hn));
    sl.w(1, p) = pp_ * fmaxf(EPS, dot(dp, hn));
    sl.w(2, p) = pl_ * powi(fmaxf(EPS, dot(dl, refl)), gloss);
    sl.w(3, p) = pp_ * powi(fmaxf(EPS, dot(dp, refl)), gloss);
  }
  // Each roulette's contribution is summed before it is added, as in the
  // tensor code (est + r).
  for (int k = 0; k < 4; ++k) {
    float r[3] = {0.0f, 0.0f, 0.0f};
    roulette_slot(T, sl, k, hl, ho, pre, r);
    float* est = k < 2 ? est_d : est_s;
    for (int c = 0; c < 3; ++c) est[c] = est[c] + r[c];
  }
}

// The 13 float planes and the object ID of pixel (px, py), py counting
// from the image bottom, and its primary ray (ro, rd): frame_core.cuh:
// frame_pixel with the box cull and the strategies in the thread's slot.
__device__ inline void frame_body(const Tables& T, const FrameParams& P, const Block& B, const Slot& sl, int px,
                                  int py, float out[13], int& oid_out, V3& ro, V3& rd) {
  primary_ray_block(T, P, B, px, py, ro, rd);

  // Per-pixel Weyl seed (common.glsl:39-41), int32 wraparound via uint32.
  const uint32_t upx = (uint32_t)px, upy = (uint32_t)py;
  const int seed = (int)((((uint32_t)P.frame << 12) + upx + (upy << 1)) ^ (upx * (uint32_t)P.height) ^
                         (upy * (uint32_t)P.width));

  // Primary intersect + analytic normal/curvature.
  float t, curv;
  int oid;
  trace<float, false, false, true>(T, ro, rd, -1, t, oid);
  const bool hit = oid > 0;
  V3 hn;
  normal_curv(T, mk(ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t), oid, hn, curv);
  if (!hit) hn = mk(0.0f, 0.0f, 0.0f);

  // Shading point: one more eps back along the ray (geometry.frag:71).
  const float depth = t - EPS;
  const V3 hl = mk(ro.x + rd.x * depth, ro.y + rd.y * depth, ro.z + rd.z * depth);

  float est_d[3] = {0.0f, 0.0f, 0.0f}, est_s[3] = {0.0f, 0.0f, 0.0f};
  if (oid != T.light_id && hit) {
    if (P.biased) {
      for (int i = 0; i < P.smp; ++i) {
        float ed[3], es[3];
        shade_sample(T, sl, hn, rd, oid, hl, fold_seed(seed, i, P.decorrelate != 0), P.soft_beta, P.gloss, ed, es);
        for (int c = 0; c < 3; ++c) {
          est_d[c] = est_d[c] + ed[c];
          est_s[c] = est_s[c] + es[c];
        }
      }
      if (P.smp > 1) {
        const float inv_smp = 1.0f / (float)P.smp;
        for (int c = 0; c < 3; ++c) {
          est_d[c] = est_d[c] * inv_smp;
          est_s[c] = est_s[c] * inv_smp;
        }
      }
    } else {
      shade_core_unbiased<float, true>(T, hn, rd, oid, hl, seed, P.smp, P.decorrelate != 0, est_d, est_s);
    }
  }

  // Emission + primary material (diffuse.frag:54-56; passthrough.frag:39-41).
  float alb[3], emi[3], ene[2];
  surface<float>(T, oid, hl, alb, emi, ene);
  for (int c = 0; c < 3; ++c) {
    out[c] = emi[c] + est_d[c];
    out[3 + c] = emi[c] + est_s[c];
    out[6 + c] = alb[c];
  }
  out[9] = ene[0];
  out[10] = ene[1];
  out[11] = depth;
  out[12] = curv;
  oid_out = oid;
}

}  // namespace kpt
