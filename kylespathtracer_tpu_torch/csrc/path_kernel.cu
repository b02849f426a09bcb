// K7: the multi-bounce wavefront path integrator, one whole path per thread.
//
// Replaces kylespathtracer_tpu/ops/path_kernel.py:pathtrace_pallas (its
// body `_path_kernel` → `path_block`). Per pixel and sample s = 0..spp-1:
// raygen, then per bounce an inside-hit nearest trace, the closed-form
// normal, the material, emission weighted by the balance heuristic against
// the previous vertex's next-event estimate, one next-event estimate toward
// the sphere light (near-root occlusion test), and a BSDF sample (diffuse,
// glossy, mirror or dielectric) that continues the path. The sampler is the
// PCG-rotated R2 sequence in uint32: sample n = frame·spp + s, stream
// pid·0x85EBCA6B + bounce·3 + pair. The samples are summed in order and the
// sum divided by spp once → out[height][width][3] (HDR radiance).
//
// What bounds it on an H100: arithmetic. Each path segment is one trace,
// one occlusion test, a normal, a material row and a BSDF (~1,200
// operations on the default scene, over half of them the rounded box's
// trace) against 12 bytes of output per pixel, so the device memory is idle; the path state (ray, throughput,
// radiance, MIS bookkeeping) lives in registers for all bounces, and the
// scene and material tables in shared memory. Where the tensor code
// evaluates every lobe and selects, this code branches on the material
// kind and stops a path at its first miss or when its throughput dies:
// the selected values are the same, the rest never reaches the output.
// Neighbouring paths diverge after the first bounce, which is the cost
// left. Built with -fmad=false (ops/_build.py): a contracted multiply-add
// moves sampling decisions (a lobe, a TIR test, a Fresnel roulette) away
// from the plain version's, and one such decision changes a whole path.
#include "frame_core.cuh"

namespace kpt {

constexpr float INV_PI = (float)(1.0 / 3.1415926);
constexpr float DELTA_PDF = 1e8f;
constexpr uint32_t R2_A1 = 3242174889u;
constexpr uint32_t R2_A2 = 2447445413u;
constexpr int GLOSSY = 1, MIRROR = 2, DIELECTRIC = 3;  // BSDF kinds; 0 and the rest: DIFFUSE

struct PathParams {
  FrameParams F;  // scene counts, width, height, fov, frame
  int spp, max_depth, gloss;
};

// core/sampler.r2_pair: the n-th R2 point, PCG-rotated by the stream.
__device__ __forceinline__ void r2_pair(uint32_t n, uint32_t stream, float& u1, float& u2) {
  const uint32_t rot1 = pcg_hash(stream);
  const uint32_t rot2 = pcg_hash(rot1 ^ 0x9E3779B9u);
  u1 = (float)(int)((n * R2_A1 + rot1) >> 8) * 5.9604644775390625e-8f;  // 2^-24
  u2 = (float)(int)((n * R2_A2 + rot2) >> 8) * 5.9604644775390625e-8f;
}

// The per-launch constants of the glossy lobe, rounded from double as the
// JAX package's weak-typed Python floats are.
struct Gloss {
  int n;
  float f_fac, pdf_fac, w_fac, exponent;  // (g+2)/2π, (g+1)/2π, (g+2)/(g+1), 1/(g+1)
};

__device__ __forceinline__ Gloss make_gloss(int g) {
  const double d = (double)g;
  return {g, (float)((d + 2.0) / 6.2831853), (float)((d + 1.0) / 6.2831853), (float)((d + 2.0) / (d + 1.0)),
          (float)(1.0 / (d + 1.0))};
}

// Uniform solid-angle cone sample toward the light (wavefront._sample_light).
__device__ __forceinline__ void light_sample(const Tables& T, V3 hl, float u1, float u2, V3& wi, float& pdf,
                                             bool& outside) {
  const float* L = T.f + T.light;
  const V3 lv = mk(L[0] - hl.x, L[1] - hl.y, L[2] - hl.z);
  const float d2 = fmaxf(dot(lv, lv), 1e-12f);
  const float r2 = L[3] * L[3];
  const float cos_max = sqrtf(fmaxf(1e-9f, 1.0f - clip(r2 / d2, 0.0f, 1.0f)));
  const float ct = 1.0f - u1 * (1.0f - cos_max);
  const float st = sqrtf(fmaxf(1e-12f, 1.0f - ct * ct));
  const float phi = TWOPI * u2;
  const V3 w = normalize(lv);
  V3 f, r;
  basis(w, f, r);
  const float cp = cosf(phi), sp = sinf(phi);
  wi = mk(f.x * (st * cp) + r.x * (st * sp) + w.x * ct, f.y * (st * cp) + r.y * (st * sp) + w.y * ct,
          f.z * (st * cp) + r.z * (st * sp) + w.z * ct);
  pdf = 1.0f / (TWOPI * fmaxf(1e-9f, 1.0f - cos_max));
  outside = d2 > r2;
}

// Solid-angle pdf of the light sampler toward the light from ro
// (wavefront._nee_pdf_toward_light).
__device__ __forceinline__ float nee_pdf_from(const Tables& T, V3 ro) {
  const float* L = T.f + T.light;
  const V3 lv = mk(L[0] - ro.x, L[1] - ro.y, L[2] - ro.z);
  const float d2 = fmaxf(dot(lv, lv), 1e-12f);
  const float cos_max = sqrtf(fmaxf(1e-9f, 1.0f - clip(L[3] * L[3] / d2, 0.0f, 1.0f)));
  return 1.0f / (TWOPI * fmaxf(1e-9f, 1.0f - cos_max));
}

// (f·cosθi per channel, pdf) of the non-delta lobes (bsdf.eval_pdf).
__device__ __forceinline__ void bsdf_eval_pdf(int kind, const float rho_d[3], const float rho_s[3], V3 n, V3 rd,
                                              V3 wi, const Gloss& G, float f[3], float& pdf) {
  const float ci = fmaxf(0.0f, dot(n, wi));
  f[0] = f[1] = f[2] = 0.0f;
  pdf = 0.0f;
  if (kind >= MIRROR || ci <= 0.0f) return;
  if (kind == GLOSSY) {
    const float ca = fmaxf(0.0f, dot(reflect(rd, n), wi));
    const float ca_g = powi(ca, G.n);
    const float fac = G.f_fac * ca_g * ci;
    for (int c = 0; c < 3; ++c) f[c] = rho_s[c] * fac;
    pdf = G.pdf_fac * ca_g;
  } else {
    for (int c = 0; c < 3; ++c) f[c] = rho_d[c] * (INV_PI * ci);
    pdf = ci * INV_PI;
  }
}

// Sample wi from the BSDF of `kind` (bsdf.sample): the direction, the
// throughput weight f·cos/pdf, the pdf, and whether the lobe is a delta and
// the ray refracts. `eta` is the relative index of the medium entered.
__device__ __forceinline__ void bsdf_sample(int kind, const float rho_d[3], const float rho_s[3], float eta, V3 n,
                                            V3 rd, const Gloss& G, float u1, float u2, float u3, V3& wi,
                                            float weight[3], float& pdf, bool& is_delta, bool& transmit) {
  is_delta = kind == MIRROR || kind == DIELECTRIC;
  transmit = false;
  if (is_delta) {
    for (int c = 0; c < 3; ++c) weight[c] = rho_d[c] + rho_s[c];
    pdf = DELTA_PDF;
  }
  if (kind == MIRROR) {
    wi = reflect(rd, n);
    return;
  }
  if (kind == DIELECTRIC) {
    // Schlick-Fresnel reflect/refract with total internal reflection.
    const V3 wo = mk(-rd.x, -rd.y, -rd.z);
    const float ci = fmaxf(1e-6f, dot(n, wo));
    const float sin2t = eta * eta * fmaxf(0.0f, 1.0f - ci * ci);
    const bool tir = sin2t > 1.0f;
    const float cost = sqrtf(fmaxf(1e-9f, 1.0f - sin2t));
    float r0 = (eta - 1.0f) / (eta + 1.0f);
    r0 = r0 * r0;
    const float u = 1.0f - ci;
    const float uu = u * u;
    const float fres = r0 + (1.0f - r0) * uu * uu * u;
    const bool take_refl = u3 < (tir ? 1.0f : fres);
    if (take_refl) {
      wi = reflect(rd, n);
    } else {
      const float fac = eta * ci - cost;
      wi = normalize(mk(-wo.x * eta + n.x * fac, -wo.y * eta + n.y * fac, -wo.z * eta + n.z * fac));
      transmit = true;
    }
    return;
  }
  const float phi = TWOPI * u2;
  const float cp = cosf(phi), sp = sinf(phi);
  if (kind == GLOSSY) {
    // Power-cosine lobe around the mirror direction.
    const V3 refl = reflect(rd, n);
    V3 fg, rg;
    basis(refl, fg, rg);
    const float ca = powf(u1, G.exponent);
    const float sa = sqrtf(fmaxf(0.0f, 1.0f - ca * ca));
    wi = mk(fg.x * (sa * cp) + rg.x * (sa * sp) + refl.x * ca, fg.y * (sa * cp) + rg.y * (sa * sp) + refl.y * ca,
            fg.z * (sa * cp) + rg.z * (sa * sp) + refl.z * ca);
    const float wfac = fmaxf(0.0f, G.w_fac * dot(n, wi));
    for (int c = 0; c < 3; ++c) weight[c] = rho_s[c] * wfac;
    pdf = G.pdf_fac * powi(ca, G.n);
    return;
  }
  // DIFFUSE (and any other kind): cosine-weighted hemisphere.
  V3 f, r;
  basis(n, f, r);
  const float srt = sqrtf(u1);
  const float x = srt * cp, y = srt * sp;
  const float z = sqrtf(fmaxf(0.0f, 1.0f - u1));
  wi = mk(f.x * x + r.x * y + n.x * z, f.y * x + r.y * y + n.y * z, f.z * x + r.z * y + n.z * z);
  for (int c = 0; c < 3; ++c) weight[c] = rho_d[c];
  pdf = z * INV_PI;
}

// One radiance sample of the path from (ro, rd) (path_kernel.path_block).
// `stream0` is pid·0x85EBCA6B; kinds/iors are the per-id material tables.
__device__ void path_sample(const Tables& T, const int* kinds, const float* iors, const PathParams& P,
                            const Gloss& G, V3 ro, V3 rd, uint32_t n_idx, uint32_t stream0, float rad[3]) {
  float tp[3] = {1.0f, 1.0f, 1.0f};
  rad[0] = rad[1] = rad[2] = 0.0f;
  int excl = -1;
  float prev_pdf = 0.0f;
  bool prev_delta = true, prev_nee = false, inside = false;

  for (int bounce = 0; bounce < P.max_depth; ++bounce) {
    float t;
    int oid;
    trace<float, true>(T, ro, rd, excl, t, oid);
    if (oid == 0) break;  // a miss ends the path: nothing more reaches rad
    const V3 hl = mk(ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t);

    V3 n;
    float curv;
    normal_curv(T, hl, oid, n, curv);
    if (dot(n, n) < 0.5f) n = mk(0.0f, 1.0f, 0.0f);
    if (!(dot(rd, n) < 0.0f)) n = mk(-n.x, -n.y, -n.z);

    float alb[3], emi[3], ene[2];
    surface<float>(T, oid, hl, alb, emi, ene);
    const bool known = oid >= 0 && oid < T.nK;
    const int kind = known ? kinds[oid] : 0;
    const float ior = known ? iors[oid] : 0.0f;
    float rho_d[3], rho_s[3];
    for (int c = 0; c < 3; ++c) {
      rho_d[c] = alb[c] * ene[0];
      rho_s[c] = alb[c] * ene[1];
    }

    // Emitted radiance, balance-weighted against the previous NEE.
    const bool is_light = oid == T.light_id;
    float w_mis = 1.0f;
    if (!(prev_delta || !prev_nee || !is_light))
      w_mis = prev_pdf / fmaxf(1e-12f, prev_pdf + nee_pdf_from(T, ro));
    for (int c = 0; c < 3; ++c) rad[c] = rad[c] + tp[c] * emi[c] * w_mis;

    // Next-event estimation toward the light.
    const uint32_t stream = stream0 + (uint32_t)(bounce * 3);
    float u1, u2;
    r2_pair(n_idx, stream, u1, u2);
    V3 l_wi;
    float l_pdf;
    bool l_ok;
    light_sample(T, hl, u1, u2, l_wi, l_pdf, l_ok);
    if (l_ok && !is_light) {
      const V3 ro_off = mk(hl.x + n.x * EPS, hl.y + n.y * EPS, hl.z + n.z * EPS);
      if (light_visible(T, ro_off, l_wi, oid)) {
        float f_cos[3], b_pdf;
        bsdf_eval_pdf(kind, rho_d, rho_s, n, rd, l_wi, G, f_cos, b_pdf);
        const float w_nee = l_pdf / fmaxf(1e-12f, l_pdf + b_pdf);
        const float nee_fac = w_nee / fmaxf(1e-12f, l_pdf);
        for (int c = 0; c < 3; ++c) rad[c] = rad[c] + tp[c] * f_cos[c] * T.f[T.light_color + c] * nee_fac;
      }
    }

    // Continue the path with a BSDF sample.
    float b1, b2, b3, unused;
    r2_pair(n_idx, stream + 1u, b1, b2);
    r2_pair(n_idx, stream + 2u, b3, unused);
    const float eta = inside ? ior : 1.0f / fmaxf(ior, 1e-6f);
    V3 wi;
    float weight[3], pdf;
    bool is_delta, transmit;
    bsdf_sample(kind, rho_d, rho_s, eta, n, rd, G, b1, b2, b3, wi, weight, pdf, is_delta, transmit);
    for (int c = 0; c < 3; ++c) tp[c] = tp[c] * weight[c];
    if (!(fmaxf(tp[0], fmaxf(tp[1], tp[2])) > 1e-5f)) break;  // the throughput died

    const float s = transmit ? -EPS : EPS;
    ro = mk(hl.x + n.x * s, hl.y + n.y * s, hl.z + n.z * s);
    rd = wi;
    excl = (transmit || inside) ? -1 : oid;
    prev_pdf = pdf;
    prev_delta = is_delta;
    prev_nee = l_ok && !is_light;
    inside = transmit != inside;
  }
}

__global__ void __launch_bounds__(128) path_kernel(const float* __restrict__ ftab, const int* __restrict__ itab,
                                                   const int* __restrict__ kinds, const float* __restrict__ iors,
                                                   PathParams P, float* __restrict__ out) {
  extern __shared__ float smem[];
  const FrameParams& F = P.F;
  const Tables T = load_tables(smem, ftab, itab, F);
  // The material kinds and iors follow the scene tables in shared memory.
  int* s_kinds = reinterpret_cast<int*>(smem + table_floats(F.nP, F.nS, F.nB, F.nK)) + table_ints(F.nP, F.nS, F.nB);
  float* s_iors = reinterpret_cast<float*>(s_kinds + F.nK);
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < F.nK; i += blockDim.x * blockDim.y) {
    s_kinds[i] = kinds[i];
    s_iors[i] = iors[i];
  }
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= F.width || y >= F.height) return;

  V3 ro, rd;
  primary_ray(T, F, x, y, ro, rd);
  const Gloss G = make_gloss(P.gloss);
  const uint32_t stream0 = ((uint32_t)y * (uint32_t)F.width + (uint32_t)x) * 0x85EBCA6Bu;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < P.spp; ++s) {
    float rad[3];
    path_sample(T, s_kinds, s_iors, P, G, ro, rd, (uint32_t)F.frame * (uint32_t)P.spp + (uint32_t)s, stream0, rad);
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + rad[c];
  }
  const size_t o = ((size_t)y * (size_t)F.width + (size_t)x) * 3;
  for (int c = 0; c < 3; ++c) out[o + c] = acc[c] / (float)P.spp;
}

}  // namespace kpt

extern "C" int kpt_pathtrace(const float* ftab, const int* itab, const int* kinds, const float* iors, int nP, int nS,
                             int nB, int nK, int width, int height, float fov, int frame, int spp, int max_depth,
                             int gloss, float* out, void* stream) {
  kpt::PathParams P{};
  P.F.nP = nP; P.F.nS = nS; P.F.nB = nB; P.F.nK = nK;
  P.F.width = width; P.F.height = height; P.F.fov = fov; P.F.frame = frame;
  P.F.rows = height;
  P.spp = spp; P.max_depth = max_depth; P.gloss = gloss;
  const size_t shmem = kpt::table_smem(nP, nS, nB, nK, false) + (size_t)nK * (sizeof(int) + sizeof(float));
  const dim3 block(16, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  kpt::path_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(ftab, itab, kinds, iors, P, out);
  return (int)cudaGetLastError();
}
