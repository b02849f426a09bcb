// K3: the geometry pass (primary-visibility raycast) as one kernel.
//
// Replaces kylespathtracer_tpu/ops/frame_kernel.py:geometry_pass_pallas
// (its body `_geometry_kernel`). Per pixel: raygen, nearest analytic hit
// with no exclusion, closed-form normal and curvature → five f32 planes
// out_f[5][height][width] (depth = t - eps, curv, nx, ny, nz; the normal is
// zero on a miss) and out_oid[height][width]. A miss writes the trace's
// (ZFAR, 0), so depth ZFAR - eps, as the JAX kernel does.
//
// What bounds it on an H100: ~1.5 GFLOP of trace arithmetic at 1080p (22 us
// at the f32 peak) against 24 bytes of output per pixel (50 MB, 15 us at
// 3.35 TB/s): the operations, narrowly. The design is K1's without the
// shade: one thread per pixel, the scene tables in shared memory (broadcast
// reads), and each plane written by consecutive threads to consecutive
// addresses.
// Built with -fmad=false (ops/_build.py), so it rounds like its plain
// version.
#include "frame_core.cuh"

namespace kpt {

__global__ void __launch_bounds__(128) geometry_kernel(const float* __restrict__ ftab,
                                                       const int* __restrict__ itab, FrameParams P,
                                                       float* __restrict__ out_f, int* __restrict__ out_oid) {
  extern __shared__ float smem[];
  const Tables T = load_tables(smem, ftab, itab, P);

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= P.width || y >= P.height) return;

  V3 ro, rd;
  primary_ray(T, P, x, y, ro, rd);
  float t;
  int oid;
  trace(T, ro, rd, -1, t, oid);
  V3 hn;
  float curv;
  normal_curv(T, mk(ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t), oid, hn, curv);
  if (oid <= 0) hn = mk(0.0f, 0.0f, 0.0f);

  const size_t plane = (size_t)P.height * (size_t)P.width;
  const size_t o = (size_t)y * (size_t)P.width + (size_t)x;
  out_f[o] = t - EPS;
  out_f[plane + o] = curv;
  out_f[2 * plane + o] = hn.x;
  out_f[3 * plane + o] = hn.y;
  out_f[4 * plane + o] = hn.z;
  out_oid[o] = oid;
}

}  // namespace kpt

extern "C" int kpt_geometry_pass(const float* ftab, const int* itab, int nP, int nS, int nB, int nK, int width,
                                 int height, float fov, float* out_f, int* out_oid, void* stream) {
  kpt::FrameParams P{};
  P.nP = nP; P.nS = nS; P.nB = nB; P.nK = nK;
  P.width = width; P.height = height; P.fov = fov;
  P.rows = height;
  const size_t shmem = kpt::table_smem(nP, nS, nB, nK, false);
  const dim3 block(16, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  kpt::geometry_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(ftab, itab, P, out_f, out_oid);
  return (int)cudaGetLastError();
}
