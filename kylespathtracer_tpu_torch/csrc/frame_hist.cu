// K8: the mono temporal frame: the whole history-path frame in one kernel.
//
// Replaces kylespathtracer_tpu/ops/frame_hist.py:frame_hist_pallas (its body
// `_frame_hist_kernel`), in full-frame and in tile mode. Per pixel:
//
//   K1's frame (frame_body.cuh: frame_body)        → 13 planes and the oid
//   → hit point + curvature-pushed specular anchor  (specular.frag:45-49)
//   → previous-camera projection of each anchor     (frame_hist.py:_queries_block)
//   → windowed 2×2 tap sum (reproject_core.cuh: tap_sum, K2's, with the loads gathered)
//   → floor(count + 1e-4) + velocity clamp           (diffuse.frag:46-51)
//   → accumulate (rgb + this frame's estimate, count + 1)
//
// In: the scene tables, the previous camera (ptab: loc 3, orient 2) and both
// history channels (rgb [H][W][3], cnt, oid); out: d_rgb, s_rgb, alb
// [H][W][3], d_cnt, s_cnt, ene [H][W][2] and oid, so the new history is
// written in place of the next frame's input layout, with no stacking pass.
//
// The TPU kernel clamps the window K to its row-block height (its history
// halo is one block); here the taps are a direct, bounded gather, so any K
// works, and the wrapper computes K as the JAX code does.
//
// Tile mode (the sharded renderer's, parallel/shard.py): the kernel renders
// image rows [row_base, row_base+rows) of the height-row image (NDC, seeds
// and the previous-camera projection stay the full image's) into [rows][W]
// outputs, and reads the history from the window of rows + 2·halo rows that
// the halo exchange assembles, whose first row is image row hist_row0 =
// row_base − halo. A tap's window row is its image row less hist_row0; taps
// reach at most K ≤ halo rows (the wrapper checks). The full frame is the
// same launch with row_base = 0, rows = height and no halo.
//
// Rounding: built with -fmad=false (ops/_build.py), so the frame part and
// the head round as the plain version's per-operation tensor code does
// (the head and the tail also spell their rounding out with explicit
// intrinsics). With K1's default contraction the frame part's ray
// directions and depths part from the plain version's by an ulp, and the
// projection into the previous camera turns that into ~4e-5 pixel of tap
// position at 1080p: more than the 1e-5 median bar on a random history.
// So K8's frame planes are not bitwise K1's (chip_smoke.py phase 17 logs
// how far).
//
// What bounds it on an H100: K1's arithmetic (~9 visibility traces per
// shaded pixel). Its device-memory traffic is 10 history planes in and 14
// planes out, 96 bytes per pixel, and the tap gathers of a warp fall in a few
// cache lines. The frame part is K1's body (frame_body.cuh: one thread per
// pixel, the strategies in shared memory, the rounded box culled; tables and
// both cameras read from the scene's own tensors); the head and the tail
// add a few hundred operations per pixel after the shade, when the shade's
// registers are free again, under __launch_bounds__(128, 5).
#include "frame_body.cuh"

namespace kpt {

struct HistParams {
  int K;          // reprojection window (taps beyond ±K restart the history)
  float inv_asp;  // 1/aspect, rounded from double as the JAX code's Python float
  float temporal, two_t, t_m1;  // T, T·2 and T−1 (TEMPORALSMOOTHING)
};

namespace {

__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
// a.x·b.x + a.y·b.y + a.z·b.z, left to right, each operation rounded.
__device__ __forceinline__ float rn_dot(V3 a, V3 b) {
  return rn_add(rn_add(rn_mul(a.x, b.x), rn_mul(a.y, b.y)), rn_mul(a.z, b.z));
}
__device__ __forceinline__ V3 rn_scale(V3 a, float s) { return mk(rn_mul(a.x, s), rn_mul(a.y, s), rn_mul(a.z, s)); }
// a + d·t per component.
__device__ __forceinline__ V3 rn_along(V3 a, V3 d, float t) {
  return mk(rn_add(a.x, rn_mul(d.x, t)), rn_add(a.y, rn_mul(d.y, t)), rn_add(a.z, rn_mul(d.z, t)));
}

// The previous camera's basis (frame_hist.py:_prev_basis): lf = the rotated
// forward axis, r = normalize(cross(lf, up)), u = normalize(cross(lf, r)).
__device__ __forceinline__ void prev_basis(const float* __restrict__ ptab, V3& lf, V3& r, V3& u) {
  const float cx = cosf(ptab[3]), sx = sinf(ptab[3]);
  const float cy = cosf(ptab[4]), sy = sinf(ptab[4]);
  lf = mk(rn_mul(cx, sy), sx, rn_mul(cx, cy));
  const float rlen = rsqrtf(fmaxf(rn_add(rn_mul(lf.x, lf.x), rn_mul(lf.z, lf.z)), 1e-20f));
  r = mk(rn_mul(-lf.z, rlen), 0.0f, rn_mul(lf.x, rlen));
  const V3 c = mk(rn_sub(rn_mul(lf.y, r.z), rn_mul(lf.z, r.y)), rn_sub(rn_mul(lf.z, r.x), rn_mul(lf.x, r.z)),
                  rn_sub(rn_mul(lf.x, r.y), rn_mul(lf.y, r.x)));
  u = rn_scale(c, rsqrtf(fmaxf(rn_dot(c, c), 1e-20f)));
}

// Project an anchor into the previous camera (frame_hist.py:_queries_block)
// → the tap window's offset from pixel (px, py) and its separable bilinear
// weights; border fractions can be negative (trunc), and so can the weights.
__device__ __forceinline__ void query(V3 anchor, const float* __restrict__ ptab, const V3& lf, const V3& r,
                                      const V3& u, int px, int py, int W, int H, float fov, float inv_asp, int& dy,
                                      int& dx, float (&wy)[2], float (&wx)[2]) {
  V3 nhl = mk(rn_sub(ptab[0], anchor.x), rn_sub(ptab[1], anchor.y), rn_sub(ptab[2], anchor.z));
  nhl = rn_scale(nhl, rsqrtf(fmaxf(rn_dot(nhl, nhl), 1e-20f)));
  float denom = rn_dot(nhl, lf);
  if (fabsf(denom) < 1e-6f) denom = 1e-6f;
  const float inv_den = __fdiv_rn(fov, denom);
  const float luv_x = rn_mul(rn_mul(rn_dot(nhl, r), inv_den), inv_asp);
  const float luv_y = rn_mul(rn_dot(nhl, u), inv_den);
  const bool inside = luv_x <= 1.0f && luv_x >= -1.0f && luv_y <= 1.0f && luv_y >= -1.0f;
  const float fu = rn_sub(rn_mul(rn_add(rn_mul(luv_x, -0.5f), 0.5f), (float)W), 0.5f);
  const float fv = rn_sub(rn_mul(rn_add(rn_mul(luv_y, -0.5f), 0.5f), (float)H), 0.5f);
  const int iu = (int)truncf(fu), iv = (int)truncf(fv);
  const float du = rn_sub(fu, (float)iu), dv = rn_sub(fv, (float)iv);
  dy = iv - py;
  dx = iu - px;
  wy[0] = (iv >= 0 && iv < H) ? rn_sub(1.0f, dv) : 0.0f;
  wy[1] = (iv >= -1 && iv < H - 1) ? dv : 0.0f;
  wx[0] = (iu >= 0 && iu < W && inside) ? rn_sub(1.0f, du) : 0.0f;
  wx[1] = (iu >= -1 && iu < W - 1 && inside) ? du : 0.0f;
}

// Reprojected history → floor(count + 1e-4), velocity clamp to `limit`,
// plus this frame's estimate `add` (frame_hist.py:_temporal_clamp_block).
__device__ __forceinline__ void accumulate(const float (&acc)[4], const float* add, float limit, float* rgb_out,
                                           float& cnt_out) {
  const float cnt = floorf(rn_add(acc[3], 1e-4f));
  const bool over = cnt > limit;
  const float scale = over ? __fdiv_rn(limit, fmaxf(cnt, 1e-6f)) : 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb_out[c] = rn_add(rn_mul(acc[c], scale), add[c]);
  cnt_out = rn_add(over ? limit : cnt, 1.0f);
}

// reproject_core.cuh:tap_sum with the four taps' loads issued together:
// every live tap's object ID, rgb and count are read before any is
// compared, so the gathers of a pixel wait on memory once, not once per
// tap. The sum is tap_sum's, term for term; the history's first row is
// image row hist_row0, as there.
__device__ __forceinline__ void tap_sum_gathered(const float* __restrict__ hist_rgb,
                                                 const float* __restrict__ hist_cnt,
                                                 const int* __restrict__ hist_oid, int id, int y, int x, int dy,
                                                 int dx, const float (&wy)[2], const float (&wx)[2], int K, int H,
                                                 int W, int hist_row0, float (&acc)[4]) {
  bool live[4];
  int tid[4];
  float v[4][4];
#pragma unroll
  for (int tx = 0; tx < 2; ++tx) {
#pragma unroll
    for (int ty = 0; ty < 2; ++ty) {
      const int j = 2 * tx + ty;
      const int sy = y + dy + ty, sx = x + dx + tx;
      // -K <= dx + tx, dy + ty <= K, written without overflowing on far-off
      // queries; out-of-image taps carry zero weight and are skipped.
      live[j] = !(dx < -K - tx || dx > K - tx || dy < -K - ty || dy > K - ty) && sy >= 0 && sy < H && sx >= 0 &&
                sx < W;
      const size_t q = live[j] ? (size_t)(sy - hist_row0) * W + sx : 0;
      tid[j] = live[j] ? hist_oid[q] : 0;
      v[j][0] = live[j] ? hist_rgb[3 * q] : 0.0f;
      v[j][1] = live[j] ? hist_rgb[3 * q + 1] : 0.0f;
      v[j][2] = live[j] ? hist_rgb[3 * q + 2] : 0.0f;
      v[j][3] = live[j] ? hist_cnt[q] : 0.0f;
    }
  }
  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
#pragma unroll
  for (int tx = 0; tx < 2; ++tx) {
#pragma unroll
    for (int ty = 0; ty < 2; ++ty) {
      const int j = 2 * tx + ty;
      if (!live[j] || tid[j] != id) continue;
      const float w = __fmul_rn(wy[ty], wx[tx]);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, v[j][c]));
    }
  }
}

}  // namespace

// The previous camera: loc [3] and orient [2].
struct PrevCamera {
  const float *loc, *orient;
};

// Output row r is image row P.row_base + r of P.rows; the history's first
// row is image row hist_row0 (the full frame: row_base = hist_row0 = 0).
__global__ void __launch_bounds__(BLOCK, 5)
    frame_hist_kernel(TableParts tp, FrameParams P, HistParams Q, PrevCamera prev,
                      const float* __restrict__ hd_rgb, const float* __restrict__ hd_cnt,
                      const int* __restrict__ hd_oid, const float* __restrict__ hs_rgb,
                      const float* __restrict__ hs_cnt, const int* __restrict__ hs_oid, float* __restrict__ out_drgb,
                      float* __restrict__ out_dcnt, float* __restrict__ out_srgb, float* __restrict__ out_scnt,
                      float* __restrict__ out_alb, float* __restrict__ out_ene, int* __restrict__ out_oid,
                      int hist_row0) {
  extern __shared__ float smem[];
  const Tables T = load_table_parts(smem, tp, P);
  const Slot slot = thread_slot(smem, P);
  const float ptab[5] = {prev.loc[0], prev.loc[1], prev.loc[2], prev.orient[0], prev.orient[1]};
  Block& B = *block_values(smem, P);
  if (threadIdx.x == 0) {
    camera_trig(T, B);
    prev_basis(ptab, B.lf, B.r, B.u);
    // Camera speed and the velocity clamp's limit.
    const float dvx = rn_sub(T.f[T.cam], ptab[0]), dvy = rn_sub(T.f[T.cam + 1], ptab[1]);
    const float dvz = rn_sub(T.f[T.cam + 2], ptab[2]);
    const float vv = sqrtf(fmaxf(rn_add(rn_add(rn_mul(dvx, dvx), rn_mul(dvy, dvy)), rn_mul(dvz, dvz)), 0.0f));
    B.limit = rn_sub(Q.temporal, fminf(Q.t_m1, floorf(rn_mul(Q.two_t, sqrtf(vv)))));
  }
  __syncthreads();

  const int x = blockIdx.x * TILE_W + threadIdx.x % TILE_W;
  const int r = blockIdx.y * TILE_H + threadIdx.x / TILE_W;  // output row
  const int W = P.width, H = P.height;

  float vals[13];
  int oid;
  if (x >= W || r >= P.rows) return;
  const int y = P.row_base + r;  // image row
  V3 ro, rd;
  frame_body(T, P, B, slot, x, y, vals, oid, ro, rd);

  // Anchors: the hit point for diffuse, the curvature-pushed virtual-image
  // point for specular, on the primary ray of this pixel.
  const V3 hl = rn_along(ro, rd, vals[11]);
  const V3 lv = mk(rn_sub(hl.x, T.f[T.light]), rn_sub(hl.y, T.f[T.light + 1]), rn_sub(hl.z, T.f[T.light + 2]));
  const float light_dist = sqrtf(fmaxf(rn_dot(lv, lv), 1e-20f));
  const float fac = __fdiv_rn(EPS, sqrtf(fmaxf(EPS, vals[12])));
  const V3 sl = rn_along(hl, rd, rn_mul(light_dist, fac));

  const size_t p = (size_t)r * W + x;

  int dy, dx;
  float wy[2], wx[2], acc[4];
  query(hl, ptab, B.lf, B.r, B.u, x, y, W, H, P.fov, Q.inv_asp, dy, dx, wy, wx);
  tap_sum_gathered(hd_rgb, hd_cnt, hd_oid, oid, y, x, dy, dx, wy, wx, Q.K, H, W, hist_row0, acc);
  accumulate(acc, vals + 0, B.limit, out_drgb + 3 * p, out_dcnt[p]);
  query(sl, ptab, B.lf, B.r, B.u, x, y, W, H, P.fov, Q.inv_asp, dy, dx, wy, wx);
  tap_sum_gathered(hs_rgb, hs_cnt, hs_oid, oid, y, x, dy, dx, wy, wx, Q.K, H, W, hist_row0, acc);
  accumulate(acc, vals + 3, B.limit, out_srgb + 3 * p, out_scnt[p]);

#pragma unroll
  for (int c = 0; c < 3; ++c) out_alb[3 * p + c] = vals[6 + c];
  out_ene[2 * p] = vals[9];
  out_ene[2 * p + 1] = vals[10];
  out_oid[p] = oid;
}

}  // namespace kpt

extern "C" int kpt_frame_hist(const kpt::TableParts* tp, const float* prev_loc, const float* prev_orient, int nP,
                              int nS, int nB, int nK, int width, int height, float fov, int frame, int smp,
                              int decorrelate, int biased, float soft_beta, int gloss, int K, float inv_asp,
                              float temporal, float two_t, float t_m1, int row_base, int rows, int hist_row0,
                              const float* hd_rgb, const float* hd_cnt, const int* hd_oid, const float* hs_rgb,
                              const float* hs_cnt, const int* hs_oid,
                              float* out_drgb, float* out_dcnt, float* out_srgb, float* out_scnt, float* out_alb,
                              float* out_ene, int* out_oid, void* stream) {
  if (nP > kpt::MAX_PLANES) return (int)cudaErrorInvalidValue;
  kpt::FrameParams P{nP, nS, nB, nK, width, height, fov, frame, row_base, rows, smp, decorrelate, biased,
                     soft_beta, gloss};
  kpt::HistParams Q{K, inv_asp, temporal, two_t, t_m1};
  const size_t shmem = kpt::body_smem(nP, nS, nB, nK);
  if (shmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kpt::frame_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((width + kpt::TILE_W - 1) / kpt::TILE_W, (rows + kpt::TILE_H - 1) / kpt::TILE_H);
  kpt::frame_hist_kernel<<<grid, kpt::BLOCK, shmem, (cudaStream_t)stream>>>(
      *tp, P, Q, kpt::PrevCamera{prev_loc, prev_orient}, hd_rgb, hd_cnt, hd_oid, hs_rgb, hs_cnt, hs_oid,
      out_drgb, out_dcnt, out_srgb, out_scnt, out_alb, out_ene, out_oid, hist_row0);
  return (int)cudaGetLastError();
}
