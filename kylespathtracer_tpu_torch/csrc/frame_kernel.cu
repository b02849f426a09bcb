// K1: the fused full-frame forward kernel.
//
// Replaces kylespathtracer_tpu/ops/frame_kernel.py:frame_forward_pallas
// (its body `_frame_kernel` → `frame_block`). Per pixel: raygen, nearest
// analytic hit, closed-form normal and curvature, dual-MIS shade (or the
// unbiased estimators), emission and primary material → the frame dict's
// planes, written in their own layouts: add_d, add_s, alb [rows][width][3],
// ene [rows][width][2], depth, curv [rows][width] and the i32 object ID.
//
// What bounds it on an H100: arithmetic and branches. Each shaded pixel
// runs ~9 visibility traces over the scene tables; the only device-memory
// traffic is 56 bytes of output per pixel plus the few hundred bytes of
// tables per block. One thread per pixel (frame_body.cuh): the tables in
// shared memory, gathered there from the scene's own tensors (no packing
// launch), the plane strategies in the thread's slots of shared memory (no
// stack), the rounded box culled by a slab test before its 26 candidates.
// 16×8 tiles keep a warp on two image rows of 16 pixels, which are mostly
// coherent.

// Row mode: `row_base`/`rows` render image rows [row_base, row_base+rows)
// of a `height`-tall image; NDC and seeds use the full height, as in
// frame_kernel.py:355-356.
//
// Registers: five resident blocks of 128 threads per SM cap a thread at 102
// registers (the build report of chip_smoke.py phase 1 shows what ptxas
// allocates and spills).
#include "frame_body.cuh"

namespace kpt {

// The frame dict's planes, [rows][width](×3, ×2).
struct FrameOut {
  float *add_d, *add_s, *alb, *ene, *depth, *curv;
  int* oid;
};

__global__ void __launch_bounds__(BLOCK, 5) frame_kernel(TableParts tp, FrameParams P, FrameOut out) {
  extern __shared__ float smem[];
  const Tables T = load_table_parts(smem, tp, P);
  const Slot slot = thread_slot(smem, P);
  Block& B = *block_values(smem, P);
  if (threadIdx.x == 0) camera_trig(T, B);
  __syncthreads();

  const int x = blockIdx.x * TILE_W + threadIdx.x % TILE_W;
  const int r = blockIdx.y * TILE_H + threadIdx.x / TILE_W;

  float vals[13];
  int oid;
  if (x >= P.width || r >= P.rows) return;
  V3 ro, rd;
  frame_body(T, P, B, slot, x, P.row_base + r, vals, oid, ro, rd);

  const size_t p = (size_t)r * (size_t)P.width + (size_t)x;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out.add_d[3 * p + c] = vals[c];
    out.add_s[3 * p + c] = vals[3 + c];
    out.alb[3 * p + c] = vals[6 + c];
  }
  out.ene[2 * p] = vals[9];
  out.ene[2 * p + 1] = vals[10];
  out.depth[p] = vals[11];
  out.curv[p] = vals[12];
  out.oid[p] = oid;
}

}  // namespace kpt

extern "C" int kpt_frame_forward(const kpt::TableParts* tp, int nP, int nS, int nB, int nK, int width, int height,
                                 float fov, int frame, int row_base, int rows, int smp, int decorrelate, int biased,
                                 float soft_beta, int gloss, const kpt::FrameOut* out, void* stream) {
  if (nP > kpt::MAX_PLANES) return (int)cudaErrorInvalidValue;
  kpt::FrameParams P{nP, nS, nB, nK, width, height, fov, frame, row_base, rows,
                     smp, decorrelate, biased, soft_beta, gloss};
  const size_t shmem = kpt::body_smem(nP, nS, nB, nK);
  if (shmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kpt::frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((width + kpt::TILE_W - 1) / kpt::TILE_W, (rows + kpt::TILE_H - 1) / kpt::TILE_H);
  kpt::frame_kernel<<<grid, kpt::BLOCK, shmem, (cudaStream_t)stream>>>(*tp, P, *out);
  return (int)cudaGetLastError();
}

extern "C" const char* kpt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
