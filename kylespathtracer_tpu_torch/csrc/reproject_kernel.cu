// K2: the split temporal frame's windowed reprojection, both channel sets
// and their query heads in one launch, and, when the tail's operands are
// given, the rest of the frame: the primary rays and both reprojection
// anchors in its head, then count floor, velocity clamp, accumulate and the
// ACES composite, so that one launch goes from K1's planes and the previous
// history to the new history and the image.
//
// Replaces kylespathtracer_tpu/ops/reproject_kernel.py:reproject_pallas
// (its query head `_queries` and its body `_reproject_kernel` →
// `_set_kernel_dyn`), in full-frame and in tile mode, and the tensor ops
// around it in the split frame (render/camera.py:ray_dirs_window and the
// anchors before it; render/passes.py:accumulate, render/composite.py:
// composite_from after it). The TPU version runs the rays, the anchors and
// the head as XLA, the tap sum as one kernel per channel set and the tail as
// XLA; here one launch does all of it.
//
// Per pixel, for the diffuse anchor hl and then the specular anchor sl: the
// anchor projected into the previous camera (render/reproject.py:
// reproject_query), the tap window's offset from the pixel and its separable
// bilinear weights (ops/reproject_kernel.py:_queries), then the 2×2 bilinear
// history taps inside ±K whose object ID matches, summed by `tap_sum`
// (reproject_core.cuh, shared with K8). Without the tail the anchors are
// read from memory and the two sums are the outputs. With it
// (`SplitTail::image` set), the kernel builds the anchors itself from K1's
// depth and curvature: the pixel's primary ray as ray_dirs_window computes
// it, rotated by the current camera's orientation (its sine and cosine once
// a block), hl = loc + rd·depth, and sl = hl pushed along rd by the light's
// distance and the curvature (render/passes.py:specular_anchor). Each sum
// then goes through `accumulate` (reproject_core.cuh, K8's too) against the
// clamp limit of the camera's speed, which one thread a block computes from
// both cameras' positions on the device; the results are the new history,
// and their composite with K1's albedo and energies, tonemapped by
// tonemap.cuh:aces_srgb (K7's too), is the sRGB image.
//
// Rounding: the rays, the anchors, the head and the tail repeat the split
// frame's plain code operation for operation, each rounded on its own (this
// file builds with -fmad=false, ops/_build.py), in the order torch's CUDA
// code takes them: a sum over a trailing axis of three adds the third
// product to the first, then the second (the reduction splits the axis over
// two lanes), torch.linalg.cross contracts each component's first product
// into a fused multiply-add, and a Python scalar over a tensor is the
// tensor's reciprocal times the scalar. Scalars are the Python constants
// rounded to float, as torch passes them to its kernels; pow, sqrt, sin,
// cos and division are CUDA's, as torch's. So the kernel's rays, anchors,
// taps, weights, history and image are those of the plain route on the
// card. Its head is not K8's (rsqrt basis, fov-first division), and its ray
// is not K1's `primary_ray` (rsqrt): both part from this one by ulps.
//
// Tile mode (the tile branch of reproject_pallas, run by the sharded
// renderer, parallel/shard.py): the anchors, or K1's planes, cover image
// rows [row_base, row_base+rows) of an H-row image, whose H also sets the
// NDC mapping of the rays and of the query and the bounds, and the history
// is the window of rows + 2·halo rows around them that the halo exchange
// assembles, its first row image row hist_row0 = row_base − halo. A tap's
// window row is its image row less hist_row0. Taps reach at most K ≤ halo
// rows (the wrapper checks), so they stay inside the window; rows beyond the
// image carry zero weight from the query head. The rays, the anchors and the
// tail are per pixel and read and write the tile's rows.
//
// What bounds it on an H100: device-memory bytes. Per pixel it reads the
// object ID, for each live tap 5 history floats, and writes 32 B of history;
// without the tail it reads the two anchors (24 B); with it, K1's depth and
// curvature (8 B), estimates, albedo and energies (44 B), and it writes the
// image (12 B): ~140 B a pixel in all, 290 MB a 1920×1080 frame, 0.087 ms at
// 3.35 TB/s. The rays and anchors are ~40 operations, the head a few
// hundred, the tail ~100 more; the two cameras' sines and cosines, the
// previous camera's basis and the clamp limit are computed once per block.
// Neighbouring threads read neighbouring history texels, so the taps of a
// warp fall in a few cache lines served by L1/L2.
#include "reproject_core.cuh"
#include "tonemap.cuh"

namespace kpt {

// The split frame's tail: the current camera's loc [3] and orient [2]
// (pitch, yaw); the scene's light sphere [4] (its centre and radius); K1's
// depth and curvature [rows][W], estimates add_d, add_s and albedo alb
// [rows][W][3] and energies ene [rows][W][2]; the sRGB image out
// [rows][W][3]; TEMPORALSMOOTHING T, T·2, T−1 and the exposure. A null
// image: no tail, the anchors are read and the outputs are the tap sums.
struct SplitTail {
  const float *loc, *orient, *light, *depth, *curv, *add_d, *add_s, *alb, *ene;
  float* image;
  float temporal, two_t, t_m1, brightness;
};

namespace {

struct Vec3 {
  float x, y, z;
};

// torch's CUDA sum of a trailing axis of three.
__device__ __forceinline__ float sum3(float a, float b, float c) { return (a + c) + b; }
__device__ __forceinline__ float dot3(Vec3 a, Vec3 b) { return sum3(a.x * b.x, a.y * b.y, a.z * b.z); }
// torch.linalg.cross on the card.
__device__ __forceinline__ Vec3 cross3(Vec3 a, Vec3 b) {
  return {__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)), __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}
// gmath.normalize: v · 1/sqrt(max(v·v, 1e-20)), a NaN kept as torch.clamp keeps it.
__device__ __forceinline__ Vec3 normalize3(Vec3 v) {
  float n2 = dot3(v, v);
  n2 = n2 < 1e-20f ? 1e-20f : n2;
  const float inv = 1.0f / sqrtf(n2);
  return {v.x * inv, v.y * inv, v.z * inv};
}

// The previous camera's basis (render/reproject.py:reproject_query):
// lf = rotate_xy((0, 0, 1), orient) as gmath.rotate_xy computes it,
// r = normalize(cross(lf, (0, 1, 0))), u = normalize(cross(lf, r)).
__device__ __forceinline__ void prev_camera_basis(const float* __restrict__ orient, Vec3& lf, Vec3& r, Vec3& u) {
  const float cx = cosf(orient[0]), cy = cosf(orient[1]);
  const float sx = sinf(orient[0]), sy = sinf(orient[1]);
  const float x = 0.0f, y = 0.0f, z = 1.0f;
  const float y2 = y * cx + z * sx;
  const float z1 = -y * sx + z * cx;
  const float x2 = x * cy + z1 * sy;
  const float z2 = -x * sy + z1 * cy;
  lf = {x2, y2, z2};
  r = normalize3(cross3(lf, {0.0f, 1.0f, 0.0f}));
  u = normalize3(cross3(lf, r));
}

// One anchor's query (reproject_query, then _queries) → the tap window's
// offset from image pixel (px, py) and its separable bilinear weights.
// Border fractions can be negative (trunc), and so can the weights.
__device__ __forceinline__ void split_query(Vec3 anchor, const float* __restrict__ loc, const Vec3& lf, const Vec3& r,
                                            const Vec3& u, int px, int py, int W, int H, float fov, float asp,
                                            int& dy, int& dx, float (&wy)[2], float (&wx)[2]) {
  const Vec3 nhl = normalize3({loc[0] - anchor.x, loc[1] - anchor.y, loc[2] - anchor.z});
  float denom = dot3(nhl, lf);
  denom = fabsf(denom) < 1e-6f ? 1e-6f : denom;
  const float lu = dot3(nhl, r) / denom * fov / asp;
  const float lv = dot3(nhl, u) / denom * fov / 1.0f;
  const bool inside = lu <= 1.0f && lu >= -1.0f && lv <= 1.0f && lv >= -1.0f;
  // NDC → pixel coordinates less the half-pixel centre offset.
  const float fu = (lu * -0.5f + 0.5f) * (float)W - 0.5f;
  const float fv = (lv * -0.5f + 0.5f) * (float)H - 0.5f;
  const int iu = (int)truncf(fu), iv = (int)truncf(fv);
  const float du = fu - (float)iu, dv = fv - (float)iv;
  dy = iv - py;
  dx = iu - px;
  wy[0] = (iv >= 0 && iv < H) ? 1.0f - dv : 0.0f;
  wy[1] = (iv >= -1 && iv < H - 1) ? dv : 0.0f;
  wx[0] = (iu >= 0 && iu < W && inside) ? 1.0f - du : 0.0f;
  wx[1] = (iu >= -1 && iu < W - 1 && inside) ? du : 0.0f;
}

// One channel set of one pixel: the anchor's query, then the tap sum → acc
// (rgb, count).
__device__ __forceinline__ void one_set(Vec3 a, const float* __restrict__ loc, const Vec3& lf, const Vec3& r,
                                        const Vec3& u, const float* __restrict__ hist_rgb,
                                        const float* __restrict__ hist_cnt, const int* __restrict__ hist_oid, int id,
                                        int x, int y, int W, int H, int K, float fov, float asp, int hist_row0,
                                        float (&acc)[4]) {
  int dy, dx;
  float wy[2], wx[2];
  split_query(a, loc, lf, r, u, x, y, W, H, fov, asp, dy, dx, wy, wx);
  tap_sum(hist_rgb, hist_cnt, hist_oid, id, y, x, dy, dx, wy, wx, K, H, W, hist_row0, acc);
}

__device__ __forceinline__ Vec3 load3(const float* __restrict__ v, size_t p) {
  return {v[3 * p], v[3 * p + 1], v[3 * p + 2]};
}

// The primary ray of image pixel (x, y) as render/camera.py:ray_dirs_window
// computes it: ndc_grid's centre (a true division by W and H, the aspect
// asp = W/H rounded to float), the focal z fov, gmath.normalize_fast, then
// gmath.rotate_xy by the current orientation, trig = (cos pitch, cos yaw,
// sin pitch, sin yaw).
__device__ __forceinline__ Vec3 primary_dir(int x, int y, int W, int H, float asp, float fov,
                                            const float (&trig)[4]) {
  const float nx = (2.0f * ((float)x + 0.5f) / (float)W - 1.0f) * asp;
  const float ny = 2.0f * ((float)y + 0.5f) / (float)H - 1.0f;
  const float inv = 1.0f / sqrtf(sum3(nx * nx, ny * ny, fov * fov));
  const float px = nx * inv, py = ny * inv, pz = fov * inv;
  const float cx = trig[0], cy = trig[1], sx = trig[2], sy = trig[3];
  const float y2 = py * cx + pz * sx;
  const float z1 = -py * sx + pz * cx;
  const float x2 = px * cy + z1 * sy;
  const float z2 = -px * sy + z1 * cy;
  return {x2, y2, z2};
}

// The reprojection anchors of pixel p on ray rd (render/passes.py:
// reprojection_anchors): the hit point hl = loc + rd·depth, and sl = hl +
// rd·(|hl − light| · EPS/sqrt(max(curv, EPS))), the quotient taken as torch
// takes a scalar over a tensor: the reciprocal times EPS.
__device__ __forceinline__ void anchors(const SplitTail& t, Vec3 rd, size_t p, Vec3& hl, Vec3& sl) {
  const float depth = t.depth[p];
  hl = {t.loc[0] + rd.x * depth, t.loc[1] + rd.y * depth, t.loc[2] + rd.z * depth};
  const float ex = hl.x - t.light[0], ey = hl.y - t.light[1], ez = hl.z - t.light[2];
  const float light_dist = sqrtf(sum3(ex * ex, ey * ey, ez * ez));
  const float eps = (float)1e-3;  // gmath.EPS
  const float fac = 1.0f / sqrtf(clamp_min(t.curv[p], eps)) * eps;
  const float push = light_dist * fac;
  sl = {hl.x + rd.x * push, hl.y + rd.y * push, hl.z + rd.z * push};
}

__device__ __forceinline__ void store(const float* rgb, float cnt, size_t p, float* __restrict__ out_rgb,
                                      float* __restrict__ out_cnt) {
  out_rgb[3 * p] = rgb[0];
  out_rgb[3 * p + 1] = rgb[1];
  out_rgb[3 * p + 2] = rgb[2];
  out_cnt[p] = cnt;
}

// render/composite.py:composite_from on one pixel: the new history of both
// sets modulated by the primary surface, averaged by sample count, exposed,
// tonemapped → sRGB out[3].
__device__ __forceinline__ void composite(const float (&d)[3], float dcnt, const float (&s)[3], float scnt,
                                          const float* __restrict__ alb, const float* __restrict__ ene,
                                          float brightness, float* __restrict__ out) {
  const float dn = clamp_min(floorf(dcnt), 1.0f), sn = clamp_min(floorf(scnt), 1.0f);
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float asq = alb[c] > 0.0f ? sqrtf(alb[c]) : 0.0f;
    v[c] = (d[c] * alb[c] * ene[0] / dn + s[c] * asq * ene[1] / sn) * brightness;
  }
  aces_srgb(v);
  out[0] = v[0];
  out[1] = v[1];
  out[2] = v[2];
}

}  // namespace

// Row r of the anchors (or K1's planes) and outputs is image row row_base +
// r; the full frame has row_base = hist_row0 = 0 and rows = H. prev_loc [3]
// and prev_orient [2] are the previous camera's, read on the device. Without
// the tail the anchors hl, sl are read and the outputs are the tap sums;
// with it the anchors are built here and the outputs are the new history.
__global__ void __launch_bounds__(256) reproject_kernel(
    const float* __restrict__ hl, const float* __restrict__ sl, const int* __restrict__ ho,
    const float* __restrict__ prev_loc, const float* __restrict__ prev_orient, const float* __restrict__ hd_rgb,
    const float* __restrict__ hd_cnt, const int* __restrict__ hd_oid, const float* __restrict__ hs_rgb,
    const float* __restrict__ hs_cnt, const int* __restrict__ hs_oid, float* __restrict__ out_drgb,
    float* __restrict__ out_dcnt, float* __restrict__ out_srgb, float* __restrict__ out_scnt, float fov, float asp,
    int rows, int H, int W, int K, int row_base, int hist_row0, SplitTail tail) {
  __shared__ Vec3 basis[3];
  __shared__ float trig[4];
  __shared__ float limit;
  if (threadIdx.x == 0) {
    prev_camera_basis(prev_orient, basis[0], basis[1], basis[2]);
    if (tail.image) {
      // gmath.rotate_xy's cos and sin of the current orientation.
      trig[0] = cosf(tail.orient[0]);
      trig[1] = cosf(tail.orient[1]);
      trig[2] = sinf(tail.orient[0]);
      trig[3] = sinf(tail.orient[1]);
      // The camera's speed, gmath.length(loc − prev loc), and the clamp's limit.
      const float vx = tail.loc[0] - prev_loc[0], vy = tail.loc[1] - prev_loc[1], vz = tail.loc[2] - prev_loc[2];
      limit = clamp_limit(sqrtf(sum3(vx * vx, vy * vy, vz * vz)), tail.temporal, tail.two_t, tail.t_m1);
    }
  }
  __syncthreads();
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (x >= W || r >= rows) return;
  const Vec3 lf = basis[0], rt = basis[1], up = basis[2];
  const size_t p = (size_t)r * W + x;
  const int id = ho[p];
  const int y = row_base + r;
  Vec3 anc_d, anc_s;
  if (tail.image) {
    anchors(tail, primary_dir(x, y, W, H, asp, fov, trig), p, anc_d, anc_s);
  } else {
    anc_d = load3(hl, p);
    anc_s = load3(sl, p);
  }
  float accd[4], accs[4];
  one_set(anc_d, prev_loc, lf, rt, up, hd_rgb, hd_cnt, hd_oid, id, x, y, W, H, K, fov, asp, hist_row0, accd);
  one_set(anc_s, prev_loc, lf, rt, up, hs_rgb, hs_cnt, hs_oid, id, x, y, W, H, K, fov, asp, hist_row0, accs);
  if (!tail.image) {
    store(accd, accd[3], p, out_drgb, out_dcnt);
    store(accs, accs[3], p, out_srgb, out_scnt);
    return;
  }
  float drgb[3], dcnt, srgb[3], scnt;
  accumulate(accd, tail.add_d + 3 * p, limit, drgb, dcnt);
  accumulate(accs, tail.add_s + 3 * p, limit, srgb, scnt);
  store(drgb, dcnt, p, out_drgb, out_dcnt);
  store(srgb, scnt, p, out_srgb, out_scnt);
  composite(drgb, dcnt, srgb, scnt, tail.alb + 3 * p, tail.ene + 2 * p, tail.brightness, tail.image + 3 * p);
}

}  // namespace kpt

// The anchors (or K1's planes), object IDs and outputs are [rows][W] for
// image rows [row_base, row_base+rows) of an H-row image; each history's
// first row is image row hist_row0 (the full frame: rows = H, row_base =
// hist_row0 = 0). asp is W/H rounded to float. `tail` null: the anchors hl
// and sl are read and the outputs are the tap sums; else hl and sl are
// ignored (null), the anchors are built from the tail's operands, the
// outputs are the new history, and the image goes to tail->image.
extern "C" int kpt_reproject_frame(const float* hl, const float* sl, const int* ho, const float* prev_loc,
                                   const float* prev_orient, const float* hd_rgb, const float* hd_cnt,
                                   const int* hd_oid, const float* hs_rgb, const float* hs_cnt, const int* hs_oid,
                                   float* out_drgb, float* out_dcnt, float* out_srgb, float* out_scnt, float fov,
                                   float asp, int rows, int H, int W, int K, int row_base, int hist_row0,
                                   const kpt::SplitTail* tail, void* stream) {
  if (tail ? !tail->image : !hl || !sl) return (int)cudaErrorInvalidValue;
  const kpt::SplitTail none{};
  const dim3 block(256, 1);
  const dim3 grid((W + block.x - 1) / block.x, rows);
  kpt::reproject_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      hl, sl, ho, prev_loc, prev_orient, hd_rgb, hd_cnt, hd_oid, hs_rgb, hs_cnt, hs_oid, out_drgb, out_dcnt,
      out_srgb, out_scnt, fov, asp, rows, H, W, K, row_base, hist_row0, tail ? *tail : none);
  return (int)cudaGetLastError();
}
