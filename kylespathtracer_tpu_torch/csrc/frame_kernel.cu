// K1: the fused full-frame forward kernel.
//
// Replaces kylespathtracer_tpu/ops/frame_kernel.py:frame_forward_pallas
// (its body `_frame_kernel` → `frame_block`). Per pixel: raygen, nearest
// analytic hit, closed-form normal and curvature, dual-MIS shade (or the
// unbiased estimators), emission and primary material → 13 f32 planes and
// the i32 object ID, written as SoA planes out_f[13][rows][width] and
// out_oid[rows][width].
//
// What bounds it on an H100: arithmetic and branches. Each shaded pixel
// runs ~9 visibility traces over the scene tables; the only device-memory
// traffic is 56 bytes of output per pixel plus the few hundred bytes of
// tables per block. So the design keeps the tables in shared memory (read
// by every thread, with broadcast loads) and spends its effort on the
// per-thread scalar path: one thread per pixel, early exits where the
// tensor code would compute-then-mask (misses and the light skip the
// shade entirely), no per-pixel state beyond registers and the per-plane
// roulette arrays. Divergence between neighbouring pixels (hit/miss,
// roulette choice) is the main cost left; 16×8 blocks keep a warp on two
// image rows of 16 pixels, which are mostly coherent.
//
// Row mode: `row_base`/`rows` render image rows [row_base, row_base+rows)
// of a `height`-tall image; NDC and seeds use the full height, as in
// frame_kernel.py:355-356.
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

__device__ __forceinline__ float sign3(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// Component-plane analytic normal + curvature (scene/normals.py); later
// tables override earlier ones, as the tensor code's where-chain does.
__device__ void normal_curv(const Tables& T, V3 hl, int ho, V3& n, float& c) {
  n = mk(0.0f, 0.0f, 0.0f);
  c = 0.0f;
  for (int i = 0; i < T.nP; ++i) {
    if (ho == T.plane_ids[i]) n = mk(T.planes[i * 4], T.planes[i * 4 + 1], T.planes[i * 4 + 2]);
  }
  for (int i = 0; i < T.nS; ++i) {
    if (ho != T.sphere_ids[i]) continue;
    const float* sp = T.spheres + i * 4;
    V3 d = mk(hl.x - sp[0], hl.y - sp[1], hl.z - sp[2]);
    float inv = rsqrtf(fmaxf(dot(d, d), 1e-12f));
    n = scale(d, inv);
    c = EPS * inv;
  }
  for (int i = 0; i < T.nB; ++i) {
    if (ho != T.box_ids[i]) continue;
    const float* B = T.boxes + i * 7;
    float q[3] = {hl.x - B[0], hl.y - B[1], hl.z - B[2]};
    float d[3], m[3];
    float kpos = 0.0f;
    for (int k = 0; k < 3; ++k) {
      d[k] = fabsf(q[k]) - B[3 + k];
      m[k] = fmaxf(d[k], 0.0f);
      kpos = kpos + (d[k] > 0.0f ? 1.0f : 0.0f);
    }
    float inv = rsqrtf(fmaxf(m[0] * m[0] + m[1] * m[1] + m[2] * m[2], 1e-12f));
    n = mk(m[0] * sign3(q[0]) * inv, m[1] * sign3(q[1]) * inv, m[2] * sign3(q[2]) * inv);
    c = 0.0005f * fmaxf(kpos - 1.0f, 0.0f) * inv;
  }
}

__global__ void __launch_bounds__(128) frame_kernel(const float* __restrict__ ftab,
                                                    const int* __restrict__ itab, FrameParams P,
                                                    float* __restrict__ out_f, int* __restrict__ out_oid) {
  extern __shared__ float smem[];
  const int nf = table_floats(P.nP, P.nS, P.nB, P.nK);
  const int ni = table_ints(P.nP, P.nS, P.nB);
  float* sf = smem;
  int* si = reinterpret_cast<int*>(smem + nf);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < nf; i += nthreads) sf[i] = ftab[i];
  for (int i = tid; i < ni; i += nthreads) si[i] = itab[i];
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= P.width || r >= P.rows) return;
  const Tables T = make_tables(sf, si, P.nP, P.nS, P.nB, P.nK);

  // Raygen (geometry.frag:38-39,67): aspect-scaled NDC, rsqrt normalize,
  // pitch/yaw rotation. Row 0 is the image bottom.
  const int px = x;
  const int py = P.row_base + r;
  const float asp = (float)((double)P.width / (double)P.height);
  const float xf = (2.0f * ((float)px + 0.5f) / (float)P.width - 1.0f) * asp;
  const float yf = 2.0f * ((float)py + 0.5f) / (float)P.height - 1.0f;
  const float zf = P.fov;
  const float inv = rsqrtf(xf * xf + yf * yf + zf * zf);
  const float dx = xf * inv, dy = yf * inv, dz = zf * inv;
  const float cx = cosf(T.orient[0]), sx = sinf(T.orient[0]);
  const float cy = cosf(T.orient[1]), sy = sinf(T.orient[1]);
  const float y2 = dy * cx + dz * sx;
  const float z1 = -dy * sx + dz * cx;
  const V3 rd = mk(dx * cy + z1 * sy, y2, -dx * sy + z1 * cy);
  const V3 ro = mk(T.cam[0], T.cam[1], T.cam[2]);

  // Per-pixel Weyl seed (common.glsl:39-41), int32 wraparound via uint32.
  const uint32_t upx = (uint32_t)px, upy = (uint32_t)py;
  const int seed = (int)((((uint32_t)P.frame << 12) + upx + (upy << 1)) ^ (upx * (uint32_t)P.height) ^
                         (upy * (uint32_t)P.width));

  // Primary intersect + analytic normal/curvature.
  float t;
  int oid;
  trace(T, ro, rd, -1, t, oid);
  const bool hit = oid > 0;
  V3 hn;
  float curv;
  normal_curv(T, mk(ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t), oid, hn, curv);
  if (!hit) hn = mk(0.0f, 0.0f, 0.0f);

  // Shading point: one more eps back along the ray (geometry.frag:71).
  const float depth = t - EPS;
  const V3 hl = mk(ro.x + rd.x * depth, ro.y + rd.y * depth, ro.z + rd.z * depth);

  float est_d[3] = {0.0f, 0.0f, 0.0f}, est_s[3] = {0.0f, 0.0f, 0.0f};
  const bool shade = oid != T.light_id && hit;
  if (shade) {
    if (P.biased) {
      for (int i = 0; i < P.smp; ++i) {
        float ed[3], es[3];
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
      shade_core_unbiased(T, hn, rd, oid, hl, seed, P.smp, P.decorrelate != 0, est_d, est_s);
    }
  }

  // Emission + primary material (diffuse.frag:54-56; passthrough.frag:39-41).
  float alb[3], emi[3], ene[2];
  surface(T, oid, hl, alb, emi, ene);

  const size_t plane = (size_t)P.rows * (size_t)P.width;
  const size_t o = (size_t)r * (size_t)P.width + (size_t)x;
  const float vals[13] = {
      emi[0] + est_d[0], emi[1] + est_d[1], emi[2] + est_d[2],
      emi[0] + est_s[0], emi[1] + est_s[1], emi[2] + est_s[2],
      alb[0], alb[1], alb[2], ene[0], ene[1], depth, curv,
  };
#pragma unroll
  for (int k = 0; k < 13; ++k) out_f[k * plane + o] = vals[k];
  out_oid[o] = oid;
}

}  // namespace kpt

extern "C" int kpt_frame_forward(const float* ftab, const int* itab, int nP, int nS, int nB, int nK,
                                 int width, int height, float fov, int frame, int row_base, int rows,
                                 int smp, int decorrelate, int biased, float soft_beta, int gloss,
                                 float* out_f, int* out_oid, void* stream) {
  if (nP > kpt::MAX_PLANES) return (int)cudaErrorInvalidValue;
  kpt::FrameParams P{nP, nS, nB, nK, width, height, fov, frame, row_base, rows,
                     smp, decorrelate, biased, soft_beta, gloss};
  const size_t shmem = sizeof(float) * kpt::table_floats(nP, nS, nB, nK) +
                       sizeof(int) * kpt::table_ints(nP, nS, nB);
  const dim3 block(16, 8);
  const dim3 grid((width + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
  kpt::frame_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(ftab, itab, P, out_f, out_oid);
  return (int)cudaGetLastError();
}

extern "C" const char* kpt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
