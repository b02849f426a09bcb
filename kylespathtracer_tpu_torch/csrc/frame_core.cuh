// The fused frame's per-pixel body of the gradient kernels K5
// (frame_grad.cu) and K6 (loss_kernel.cu), whose reverse sweep is
// frame_adjoint.cuh; K1 and K8 run frame_body.cuh's form of it. Also the
// scene-table loader of every frame-table kernel (`load_table_parts`).
//
// Per pixel: raygen, nearest analytic hit, closed-form normal and
// curvature, dual-MIS shade (or the unbiased estimators), emission and
// primary material → the 13 float planes and the object ID, in the order
// of ops/frame_kernel.py:frame_block.
#pragma once

#include "shade_core.cuh"

namespace kpt {

struct FrameParams {
  int nP, nS, nB, nK;
  int width, height;
  float fov;
  int frame, row_base, rows;
  int smp, decorrelate, biased;
  float soft_beta;
  int gloss;
};

// Bytes of shared memory `load_table_parts` uses: the two tables and, for
// the gradient kernels, the block's gradient sum of every f32 entry.
__host__ __device__ inline size_t table_smem(int nP, int nS, int nB, int nK, bool grad) {
  const int nf = table_floats(nP, nS, nB, nK);
  return sizeof(float) * nf * (grad ? 2 : 1) + sizeof(int) * table_ints(nP, nS, nB);
}

// The scene tables and the camera as the tensors hold them, in the order
// of the flat tables `make_tables` reads (ops/frame_kernel.py:table_parts).
constexpr int F_PARTS = 15, I_PARTS = 4;
struct TableParts {
  const float* f[F_PARTS];
  const int* i[I_PARTS];
  int nf[F_PARTS], ni[I_PARTS];
};

// The address of entry j of the flat table that parts p[0..N) of sizes
// n[0..N) make end to end: the last part that starts at or before j (an
// empty part gives way to the next). A select chain, not a loop per part,
// so the loader's loads do not wait on each other.
template <int N, typename T>
__device__ __forceinline__ const T* part_entry(const T* const (&p)[N], const int (&n)[N], int j) {
  const T* at = p[0] + j;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    j -= n[k - 1];
    if (j >= 0) at = p[k] + j;
  }
  return at;
}

// Gather the parts into the flat tables in shared memory; with `grad`, also
// zero the block's gradient sums and point *grad at them. Every thread of
// the block calls it; 1-D and 2-D blocks stride by the flat thread id. The
// loads take the read-only cache (`__ldg`): with a loop per part and plain
// loads, K6 took 0.8% longer a step on the H100 (PERF.md §6).
__device__ inline Tables load_table_parts(float* smem, const TableParts& tp, const FrameParams& P,
                                          float** grad = nullptr) {
  const int nf = table_floats(P.nP, P.nS, P.nB, P.nK);
  const int ni = table_ints(P.nP, P.nS, P.nB);
  float* sf = smem;
  int* si = reinterpret_cast<int*>(smem + nf);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int j = tid; j < nf; j += nthreads) sf[j] = __ldg(part_entry(tp.f, tp.nf, j));
  for (int j = tid; j < ni; j += nthreads) si[j] = __ldg(part_entry(tp.i, tp.ni, j));
  if (grad) {
    float* sg = reinterpret_cast<float*>(si + ni);
    for (int j = tid; j < nf; j += nthreads) sg[j] = 0.0f;
    *grad = sg;
  }
  __syncthreads();
  return make_tables(sf, si, P.nP, P.nS, P.nB, P.nK);
}

__device__ __forceinline__ float sign3(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// Component-plane analytic normal + curvature (scene/normals.py); later
// tables override earlier ones, as the tensor code's where-chain does.
template <typename S>
__device__ void normal_curv(const Tables& T, V3T<S> hl, int ho, V3T<S>& n, S& c) {
  n = mk(S(0.0f), S(0.0f), S(0.0f));
  c = 0.0f;
  for (int i = 0; i < T.nP; ++i) {
    if (ho == T.plane_ids[i])
      n = mk(tab<S>(T, T.planes + i * 4), tab<S>(T, T.planes + i * 4 + 1), tab<S>(T, T.planes + i * 4 + 2));
  }
  for (int i = 0; i < T.nS; ++i) {
    if (ho != T.sphere_ids[i]) continue;
    const int q = T.spheres + i * 4;
    V3T<S> d = mk(hl.x - tab<S>(T, q), hl.y - tab<S>(T, q + 1), hl.z - tab<S>(T, q + 2));
    S inv = rsqrtf(fmaxf(dot(d, d), 1e-12f));
    n = scale(d, inv);
    c = EPS * inv;
  }
  for (int i = 0; i < T.nB; ++i) {
    if (ho != T.box_ids[i]) continue;
    const int q = T.boxes + i * 7;
    S qv[3] = {hl.x - tab<S>(T, q), hl.y - tab<S>(T, q + 1), hl.z - tab<S>(T, q + 2)};
    S d[3], m[3];
    float kpos = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d[k] = fabsf(qv[k]) - tab<S>(T, q + 3 + k);
      m[k] = fmaxf(d[k], 0.0f);
      kpos = kpos + (d[k] > 0.0f ? 1.0f : 0.0f);
    }
    S inv = rsqrtf(fmaxf(m[0] * m[0] + m[1] * m[1] + m[2] * m[2], 1e-12f));
    n = mk(m[0] * sign3(val(qv[0])) * inv, m[1] * sign3(val(qv[1])) * inv, m[2] * sign3(val(qv[2])) * inv);
    c = 0.0005f * fmaxf(kpos - 1.0f, 0.0f) * inv;
  }
}

// The primary ray of image pixel (px, py), py counting from the image
// bottom (geometry.frag:38-39,67): aspect-scaled NDC, rsqrt normalize,
// pitch/yaw rotation.
template <typename S>
__device__ __forceinline__ void primary_ray(const Tables& T, const FrameParams& P, int px, int py, V3T<S>& ro,
                                            V3T<S>& rd) {
  const float asp = (float)((double)P.width / (double)P.height);
  const float xf = (2.0f * ((float)px + 0.5f) / (float)P.width - 1.0f) * asp;
  const float yf = 2.0f * ((float)py + 0.5f) / (float)P.height - 1.0f;
  const float zf = P.fov;
  const float inv = rsqrtf(xf * xf + yf * yf + zf * zf);
  const float dx = xf * inv, dy = yf * inv, dz = zf * inv;
  const S o0 = tab<S>(T, T.orient), o1 = tab<S>(T, T.orient + 1);
  const S cx = cosf(o0), sx = sinf(o0);
  const S cy = cosf(o1), sy = sinf(o1);
  const S y2 = dy * cx + dz * sx;
  const S z1 = -dy * sx + dz * cx;
  rd = mk(dx * cy + z1 * sy, y2, -dx * sy + z1 * cy);
  ro = mk(tab<S>(T, T.cam), tab<S>(T, T.cam + 1), tab<S>(T, T.cam + 2));
}

// The 13 float planes (add_d 3, add_s 3, alb 3, ene 2, depth, curv) and the
// object ID of image pixel (px, py); py counts from the image bottom.
template <typename S>
__device__ void frame_pixel(const Tables& T, const FrameParams& P, int px, int py, S out[13], int& oid_out) {
  V3T<S> ro, rd;
  primary_ray(T, P, px, py, ro, rd);

  // Per-pixel Weyl seed (common.glsl:39-41), int32 wraparound via uint32.
  const uint32_t upx = (uint32_t)px, upy = (uint32_t)py;
  const int seed = (int)((((uint32_t)P.frame << 12) + upx + (upy << 1)) ^ (upx * (uint32_t)P.height) ^
                         (upy * (uint32_t)P.width));

  // Primary intersect + analytic normal/curvature.
  S t;
  int oid;
  trace(T, ro, rd, -1, t, oid);
  const bool hit = oid > 0;
  V3T<S> hn;
  S curv;
  normal_curv(T, mk(ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t), oid, hn, curv);
  if (!hit) hn = mk(S(0.0f), S(0.0f), S(0.0f));

  // Shading point: one more eps back along the ray (geometry.frag:71).
  const S depth = t - EPS;
  const V3T<S> hl = mk(ro.x + rd.x * depth, ro.y + rd.y * depth, ro.z + rd.z * depth);

  S est_d[3] = {0.0f, 0.0f, 0.0f}, est_s[3] = {0.0f, 0.0f, 0.0f};
  const bool shade = oid != T.light_id && hit;
  if (shade) {
    if (P.biased) {
      for (int i = 0; i < P.smp; ++i) {
        S ed[3], es[3];
        shade_core(T, hn, rd, oid, hl, fold_seed(seed, i, P.decorrelate != 0), P.soft_beta, P.gloss, ed, es);
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
      shade_core_unbiased(T, vval(hn), vval(rd), oid, vval(hl), seed, P.smp, P.decorrelate != 0, est_d, est_s);
    }
  }

  // Emission + primary material (diffuse.frag:54-56; passthrough.frag:39-41).
  S alb[3], emi[3], ene[2];
  surface<S>(T, oid, vval(hl), alb, emi, ene);

  out[0] = emi[0] + est_d[0];
  out[1] = emi[1] + est_d[1];
  out[2] = emi[2] + est_d[2];
  out[3] = emi[0] + est_s[0];
  out[4] = emi[1] + est_s[1];
  out[5] = emi[2] + est_s[2];
  out[6] = alb[0];
  out[7] = alb[1];
  out[8] = alb[2];
  out[9] = ene[0];
  out[10] = ene[1];
  out[11] = depth;
  out[12] = curv;
  oid_out = oid;
}

}  // namespace kpt
