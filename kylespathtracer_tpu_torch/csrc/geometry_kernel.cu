// K3: the geometry pass (primary-visibility raycast) as one kernel.
//
// Replaces kylespathtracer_tpu/ops/frame_kernel.py:geometry_pass_pallas
// (its body `_geometry_kernel`). Per pixel: raygen, nearest analytic hit
// with no exclusion, closed-form normal and curvature → the dict's tensors
// in their own layouts: depth = t - eps and curv [H][W], the normal
// [H][W][3] (zero on a miss), the i32 object ID [H][W]. A miss writes the
// trace's (ZFAR, 0), so depth ZFAR - eps, as the JAX kernel does.
//
// What bounds it on an H100: ~1.5 GFLOP of trace arithmetic at 1080p (22 us
// at the f32 peak) if every pixel ran the rounded box's 26 candidates, 24
// bytes of output per pixel (50 MB, 15 us at 3.35 TB/s). The design takes
// the box out of the arithmetic and leaves the writes:
//
// - the trace culls the box lane by lane (CULL, shade_core.cuh:box_may_hit,
//   with tmax the nearest plane or sphere hit), which leaves t and oid bit
//   for bit; before it, a test without division against each box's bounding
//   sphere (`near_a_box`, what it needs of the camera computed once per
//   block) leaves the boxes out of the trace of a ray that passes far from
//   all of them, which is most camera rays;
// - the tables are gathered into shared memory straight from the scene's
//   tensors (frame_body.cuh:load_table_parts), so the wrapper packs
//   nothing; the camera's rotation is computed once per block (`Block`);
// - one thread per pixel on 1-D blocks of 128 threads over 32×4 pixel
//   tiles, a warp on one 128-byte line of each plane; as many blocks as the
//   card holds at once, each walking the tiles spaced by the grid, so the
//   table gather is paid once per resident block and the box's rays spread
//   over the blocks;
// - the kernel writes the dict's layouts directly, so the wrapper stacks
//   nothing, with streaming (evict-first) stores;
// - nine resident blocks of 128 threads per SM cap a thread at 56
//   registers, which ptxas meets without spilling (58 uncapped).
//
// Built with -fmad=false (ops/_build.py), so it rounds like its plain
// version. ops/adjoint_variants.py --geometry times the alternatives.
#include "frame_body.cuh"

namespace kpt {

// The dict's tensors.
struct GeoOut {
  float *depth, *curv, *normal;
  int* oid;
};

// A rounded box seen from a ray origin o: the box's center from o (oc), |oc|²
// (c), and the squared radius (r2) of the bounding sphere of the box grown
// past the slab of box_may_hit (h + 1e-3·h + 1e-5·|oc| + 1e-4 per axis, h
// the half extent plus the rounding radius). K3's rays all start at the
// camera, so each block computes these once per box.
struct BoxSphere {
  float oc[3], c, r2;
};

namespace geo {
constexpr int TILE_W = 32, TILE_H = 4;
static_assert(TILE_W * TILE_H == BLOCK, "a tile is one block of threads");

// Bytes of shared memory: the tables, `Block` and a `BoxSphere` per box.
__host__ __device__ inline size_t smem_bytes(int nP, int nS, int nB, int nK) {
  return table_smem(nP, nS, nB, nK, false) + sizeof(Block) + sizeof(BoxSphere) * (size_t)nB;
}
}  // namespace geo

__device__ inline BoxSphere box_sphere(const Tables& T, int bx, V3 o) {
  const float* B = T.f + T.boxes + bx * 7;
  BoxSphere s{{B[0] - o.x, B[1] - o.y, B[2] - o.z}, 0.0f, 0.0f};
  s.c = s.oc[0] * s.oc[0] + s.oc[1] * s.oc[1] + s.oc[2] * s.oc[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float h = B[3 + k] + B[6];
    const float g = 1.01f * h + 1e-3f * fabsf(s.oc[k]) + 1e-3f;
    s.r2 = s.r2 + g * g;
  }
  return s;
}

// Can the ray o + t·d (d of unit length up to rounding), t >= 0, come near
// any of the nB boxes, each seen from o? The ray misses a box's sphere if
// the sphere lies behind the origin or the line passes farther than its
// radius from the center, with a margin of 1e-4·|oc|² over the rounding of
// this test. false only where box_may_hit rules out every box for any
// tmax, so a trace without the boxes gives t and oid bit for bit.
__device__ __forceinline__ bool near_a_box(const BoxSphere* S, int nB, V3 d) {
  bool near = false;
  for (int bx = 0; bx < nB; ++bx) {
    const BoxSphere& s = S[bx];
    const float b = s.oc[0] * d.x + s.oc[1] * d.y + s.oc[2] * d.z;
    const bool behind = b < 0.0f && b * b > s.r2;
    const bool wide = s.c - b * b > s.r2 + 1e-4f * s.c;
    near = near || !(behind || wide);
  }
  return near;
}

// Block b works on tiles b, b + gridDim.x, ... in row-major order, so each
// block's pixels spread over the image and the box's rays over the blocks.
__global__ void __launch_bounds__(BLOCK, 9) geometry_kernel(TableParts tp, FrameParams P, GeoOut out, int tiles_x,
                                                             int n_tiles) {
  extern __shared__ float smem[];
  const Tables T = load_table_parts(smem, tp, P);
  Block& B = *block_values(smem, P);
  BoxSphere* spheres = reinterpret_cast<BoxSphere*>(&B + 1);
  // The camera's rotation on warp 0, the box spheres on the other warps.
  if (threadIdx.x == 0) camera_trig(T, B);
  for (int bx = (int)threadIdx.x - 32; bx >= 0 && bx < T.nB; bx += BLOCK - 32)
    spheres[bx] = box_sphere(T, bx, mk(T.f[T.cam], T.f[T.cam + 1], T.f[T.cam + 2]));
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int x = (tile % tiles_x) * geo::TILE_W + threadIdx.x % geo::TILE_W;
    const int y = (tile / tiles_x) * geo::TILE_H + threadIdx.x / geo::TILE_W;
    if (x >= P.width || y >= P.height) continue;
    V3 ro, rd;
    primary_ray_block(T, P, B, x, y, ro, rd);
    Tables Tr = T;
    if (!near_a_box(spheres, T.nB, rd)) Tr.nB = 0;
    float t;
    int oid;
    trace<float, false, false, true>(Tr, ro, rd, -1, t, oid);
    V3 hn;
    float curv;
    normal_curv(T, mk(ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t), oid, hn, curv);
    if (oid <= 0) hn = mk(0.0f, 0.0f, 0.0f);

    // Nothing here reads the outputs again: stores with the evict-first hint.
    const size_t o = (size_t)y * (size_t)P.width + (size_t)x;
    __stcs(out.depth + o, t - EPS);
    __stcs(out.curv + o, curv);
    __stcs(out.normal + 3 * o, hn.x);
    __stcs(out.normal + 3 * o + 1, hn.y);
    __stcs(out.normal + 3 * o + 2, hn.z);
    __stcs(out.oid + o, oid);
  }
}

}  // namespace kpt

extern "C" int kpt_geometry_pass(const kpt::TableParts* tp, int nP, int nS, int nB, int nK, int width, int height,
                                 float fov, const kpt::GeoOut* out, void* stream) {
  if (width < 1 || height < 1) return (int)cudaErrorInvalidValue;
  kpt::FrameParams P{};
  P.nP = nP; P.nS = nS; P.nB = nB; P.nK = nK;
  P.width = width; P.height = height; P.fov = fov;
  P.rows = height;
  const size_t shmem = kpt::geo::smem_bytes(nP, nS, nB, nK);
  cudaError_t err = cudaSuccess;
  if (shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(kpt::geometry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles_x = (width + kpt::geo::TILE_W - 1) / kpt::geo::TILE_W;
  const int n_tiles = tiles_x * ((height + kpt::geo::TILE_H - 1) / kpt::geo::TILE_H);
  // As many blocks as the card holds at once.
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kpt::geometry_kernel, kpt::BLOCK, shmem)) !=
          cudaSuccess)
    return (int)err;
  const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  kpt::geometry_kernel<<<grid, kpt::BLOCK, shmem, (cudaStream_t)stream>>>(*tp, P, *out, tiles_x, n_tiles);
  return (int)cudaGetLastError();
}
