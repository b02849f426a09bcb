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
//
// Registers: five resident blocks of 128 threads per SM cap a thread at 102
// registers (the build report of chip_smoke.py phase 1 shows what ptxas
// allocates, and that nothing spills); left free, ptxas takes more and the
// kernel runs slower, with fewer warps resident.
#include "frame_core.cuh"

namespace kpt {

__global__ void __launch_bounds__(128, 5) frame_kernel(const float* __restrict__ ftab,
                                                       const int* __restrict__ itab, FrameParams P,
                                                       float* __restrict__ out_f, int* __restrict__ out_oid) {
  extern __shared__ float smem[];
  const Tables T = load_tables(smem, ftab, itab, P);

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= P.width || r >= P.rows) return;

  float vals[13];
  int oid;
  frame_pixel<float>(T, P, x, P.row_base + r, vals, oid);

  const size_t plane = (size_t)P.rows * (size_t)P.width;
  const size_t o = (size_t)r * (size_t)P.width + (size_t)x;
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
  const size_t shmem = kpt::table_smem(nP, nS, nB, nK, false);
  const dim3 block(16, 8);
  const dim3 grid((width + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
  kpt::frame_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(ftab, itab, P, out_f, out_oid);
  return (int)cudaGetLastError();
}

extern "C" const char* kpt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
