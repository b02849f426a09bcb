"""Multi-bounce wavefront path integrator (the JAX package's BASELINE
config #3).

Port of kylespathtracer_tpu/render/wavefront.py: explicit BSDFs
(render/bsdf.py), next-event estimation toward the sphere light with
solid-angle pdfs and a balance heuristic against BSDF sampling, the
PCG-rotated R2 sampler, and a fixed `max_depth` bounce loop (the JAX
`lax.scan` becomes a Python loop over [H, W] tensors; a dead path carries a
mask).

`pathtrace` dispatches on `config.path_backend`: "auto" and "pallas" run the
path kernel (ops/path_kernel.py: K7 on the card, its plain version on the
CPU); "xla" runs this module's integrator, the oracle. The two differ on
purpose, as in the JAX package: here the sphere roots take sqrt(max(disc,
0)), eta is 1/ior, the gloss power is `pow_static` and the shadow ray is a
full `intersect`; the kernel takes sqrt(max(disc, 1e-12)), 1/max(ior,
1e-6), `_powi` and the occlusion test `_light_visible`.

Each `render_pathtraced` call is one `pathtrace` span holding its stages in
order (STAGES): `pathtrace.paths`, the radiance image, then
`pathtrace.tonemap`, exposure, ACES and sRGB in plain tensor ops; so a
profiler trace splits the image's device time, launches and idle time by
stage. On the card with the path kernel ("auto", "pallas") K7 tonemaps in
its epilogue: `pathtrace.paths` is K7's wrapper and its one launch, which
writes the sRGB image, and there is no `pathtrace.tonemap`. Outside a
profiler a span is one boolean check (utils/metrics.py:span).

The integrator ("xla") is differentiable end to end: `intersect` carries
the implicit-function backward of scene/sdf.py, so pixel gradients reach
the scene's tables. The path kernel is forward only, as the JAX package's
`pathtrace_pallas` is, and refuses an input that requires grad.
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core import color as color_mod
from kylespathtracer_tpu_torch.core import gmath, sampler
from kylespathtracer_tpu_torch.render import bsdf as bsdf_mod
from kylespathtracer_tpu_torch.render.camera import Camera, ray_dirs
from kylespathtracer_tpu_torch.scene import intersect as isect_mod
from kylespathtracer_tpu_torch.scene import materials as mat_mod
from kylespathtracer_tpu_torch.scene import normals as nrm_mod
from kylespathtracer_tpu_torch.scene import sdf as sdf_mod
from kylespathtracer_tpu_torch.scene.types import Scene, bsdf_table
from kylespathtracer_tpu_torch.utils.metrics import span

# The profiler spans of render_pathtraced's stages, in order; children of
# its `pathtrace` span. On the card's path-kernel route the first alone: K7
# writes the tonemapped image.
STAGES = ("pathtrace.paths", "pathtrace.tonemap")

_PAIRS_PER_BOUNCE = 3  # (nee u1,u2), (bsdf u1,u2), (bsdf u3, unused)
_M32 = 0xFFFFFFFF


def _surface_normal(scene: Scene, p: torch.Tensor) -> torch.Tensor:
    """The exact outward surface normal: the normalized gradient of the
    scene's distance field at p (the JAX package's oracle). Under autograd
    the gradient keeps its graph, so the normal differentiates in the scene
    and in p as `jax.grad` inside a differentiated function does."""
    tracked = p.requires_grad or any(t.requires_grad for t in (scene.planes, scene.spheres, scene.boxes))
    keep = torch.is_grad_enabled() and tracked
    with torch.enable_grad():
        q = p if p.requires_grad else p.detach().requires_grad_()
        (g,) = torch.autograd.grad(sdf_mod.sdf_dist(scene, q).sum(), q, create_graph=keep)
    return gmath.normalize(g)


def _hit_normal(scene: Scene, p, oid, config) -> torch.Tensor:
    """Surface normal at hit points: with `normal_mode="tetra"` the sdf
    gradient (`_surface_normal`), else per primitive by object id, misses
    getting the finite placeholder (0, 1, 0)."""
    if config.normal_mode == "tetra":
        return _surface_normal(scene, p)
    n, _ = nrm_mod.normal_curv(scene, p, oid)
    up = torch.zeros_like(n)
    up[..., 1] = 1.0
    return torch.where((gmath.dot(n, n) < 0.5)[..., None], up, n)


def _sample_light(scene: Scene, hl, u1, u2):
    """Uniform solid-angle cone sample toward the light → (wi[...,3],
    pdf[...], outside[...]); pdf = 1 / (2π(1-cosθmax))."""
    li = scene.light
    lv = li[:3] - hl
    d2 = torch.clamp(gmath.dot(lv, lv), min=1e-12)
    r2 = li[3] * li[3]
    cos_max = torch.sqrt(torch.clamp(1.0 - torch.clamp(r2 / d2, 0.0, 1.0), min=1e-9))
    ct = 1.0 - u1 * (1.0 - cos_max)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=1e-12))
    phi = gmath.TWOPI * u2
    w = gmath.normalize(lv)
    f, r = gmath.basis(w)
    wi = (f * (st * torch.cos(phi))[..., None] + r * (st * torch.sin(phi))[..., None]
          + w * ct[..., None])
    pdf = 1.0 / (gmath.TWOPI * torch.clamp(1.0 - cos_max, min=1e-9))
    return wi, pdf, d2 > r2


def _nee_pdf_toward_light(scene: Scene, origin):
    """The solid-angle pdf `_sample_light` gives a light-reaching direction
    from `origin` (the MIS counterpart term)."""
    li = scene.light
    lv = li[:3] - origin
    d2 = torch.clamp(gmath.dot(lv, lv), min=1e-12)
    cos_max = torch.sqrt(torch.clamp(1.0 - torch.clamp(li[3] * li[3] / d2, 0.0, 1.0), min=1e-9))
    return 1.0 / (gmath.TWOPI * torch.clamp(1.0 - cos_max, min=1e-9))


def trace_sample(scene: Scene, ro, rd, px, py, config, sample_index: int) -> torch.Tensor:
    """One radiance sample per pixel → f32[..., 3]. ro, rd: f32[..., 3]
    primary rays; px, py: i32[...] pixel coordinates (the sampler's stream
    ids); sample_index: frame·spp + s (uint32)."""
    kinds_tab, ior_tab = bsdf_table(scene.materials)
    gloss = config.gloss
    light_id = scene.light_id
    batch = ro.shape[:-1]
    dev = ro.device
    n_idx = torch.full(batch, int(sample_index) & _M32, dtype=torch.int64, device=dev)

    def u2_for(pair, bounce):
        stream = sampler.pixel_stream(px, py, config.width, bounce * _PAIRS_PER_BOUNCE + pair)
        return sampler.r2_pair(n_idx, stream)

    throughput = torch.ones(batch + (3,), dtype=ro.dtype, device=dev)
    radiance = torch.zeros(batch + (3,), dtype=ro.dtype, device=dev)
    alive = torch.ones(batch, dtype=torch.bool, device=dev)
    excl = torch.full(batch, -1, dtype=torch.int32, device=dev)
    prev_pdf = torch.zeros(batch, dtype=ro.dtype, device=dev)
    prev_delta = torch.ones(batch, dtype=torch.bool, device=dev)  # bounce 0: camera "delta"
    prev_nee = torch.zeros(batch, dtype=torch.bool, device=dev)   # did NEE run at the last vertex?
    inside = torch.zeros(batch, dtype=torch.bool, device=dev)

    for bounce in range(config.max_depth):
        t, oid = isect_mod.intersect(scene, ro, rd, excl, inside_hits=True)
        hit = (oid != 0) & alive
        hl = ro + rd * t[..., None]

        n_geo = _hit_normal(scene, hl, oid, config)
        into = gmath.dot(rd, n_geo) < 0.0
        n = torch.where(into[..., None], n_geo, -n_geo)
        wo = -rd

        albedo, emission, energy = mat_mod.surface(scene.materials, oid, hl)
        kid = torch.clamp(oid, 0, kinds_tab.shape[0] - 1).long()
        kind = kinds_tab[kid]
        ior = ior_tab[kid]
        rho_d = albedo * energy[..., 0:1]
        rho_s = albedo * energy[..., 1:2]

        # Emitted radiance, balance-weighted against the previous NEE when
        # NEE ran there and the lobe was not a delta.
        is_light = oid == light_id
        w_mis = torch.where(
            prev_delta | ~prev_nee | ~is_light, 1.0,
            prev_pdf / torch.clamp(prev_pdf + _nee_pdf_toward_light(scene, ro), min=1e-12))
        radiance = radiance + torch.where(
            hit[..., None], throughput * emission * w_mis[..., None], 0.0)

        # Next-event estimation (non-delta lobes only).
        u1, u2 = u2_for(0, bounce)
        l_wi, l_pdf, l_ok = _sample_light(scene, hl, u1, u2)
        _, vis_id = isect_mod.intersect(scene, hl + n * gmath.EPS, l_wi, oid)
        f_cos, b_pdf = bsdf_mod.eval_pdf(kind, rho_d, rho_s, n, wo, l_wi, gloss)
        w_nee = l_pdf / torch.clamp(l_pdf + b_pdf, min=1e-12)
        nee_on = hit & (vis_id == light_id) & l_ok & ~is_light
        radiance = radiance + torch.where(
            nee_on[..., None],
            throughput * f_cos * scene.light_color
            * (w_nee / torch.clamp(l_pdf, min=1e-12))[..., None],
            0.0,
        )

        # Continue the path with a BSDF sample.
        b1, b2 = u2_for(1, bounce)
        b3, _ = u2_for(2, bounce)
        eta_rel = torch.where(inside, ior, 1.0 / ior)
        wi, weight, pdf, is_delta, transmit = bsdf_mod.sample(
            kind, rho_d, rho_s, eta_rel, n, wo, gloss, b1, b2, b3)
        new_tp = throughput * weight
        alive = hit & (new_tp.amax(-1) > 1e-5)

        ro = hl + torch.where(transmit[..., None], -n, n) * gmath.EPS
        rd = wi
        throughput = torch.where(alive[..., None], new_tp, 0.0)
        # A reflected ray outside its convex object cannot re-hit it; a ray
        # travelling inside (refracted, or reflected at the exit) must.
        excl = torch.where(transmit | inside, -1, oid)
        prev_pdf = pdf
        prev_delta = is_delta
        prev_nee = hit & l_ok & ~is_light
        inside = transmit ^ inside

    return radiance


def pathtrace(scene: Scene, camera: Camera, config, frame=0) -> torch.Tensor:
    """HDR radiance image f32[H, W, 3]: `config.spp` samples per pixel at
    depth `config.max_depth`, on the scene's device. "auto"/"pallas": the
    path kernel (K7 on the card); "xla": this module's integrator."""
    backend = config.path_backend
    if backend in ("auto", "pallas"):
        from kylespathtracer_tpu_torch.ops import path_kernel as pk

        return pk.pathtrace(scene, camera, config, frame)
    if backend != "xla":
        raise ValueError(f"unknown path_backend {backend!r}")
    h, w = config.height, config.width
    rd = ray_dirs(camera, w, h, config.fov)
    ro = camera.loc.expand(rd.shape)
    py, px = torch.meshgrid(
        torch.arange(h, dtype=torch.int32, device=rd.device),
        torch.arange(w, dtype=torch.int32, device=rd.device), indexing="ij")
    spp = max(1, config.spp)
    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=rd.device)
    for s in range(spp):
        acc = acc + trace_sample(scene, ro, rd, px, py, config, int(frame) * spp + s)
    return acc / spp


def render_pathtraced(scene: Scene, camera: Camera, config, frame=0) -> torch.Tensor:
    """Tonemapped sRGB image f32[H, W, 3] in [0, 1]: exposure → ACES →
    sRGB (reference passthrough.frag:27,45). On the card with the path
    kernel, one K7 launch that tonemaps in its epilogue, the same operations
    as the plain chain; elsewhere the HDR image, then the plain chain."""
    fused = scene.device.type == "cuda" and config.path_backend in ("auto", "pallas")
    with span("pathtrace"):
        with span("pathtrace.paths"):
            if fused:
                from kylespathtracer_tpu_torch.ops import path_kernel as pk

                return pk.pathtrace(scene, camera, config, frame, brightness=config.brightness)
            hdr = pathtrace(scene, camera, config, frame)
        with span("pathtrace.tonemap"):
            img = color_mod.linear_srgb(color_mod.aces_fitted(hdr * config.brightness))
    return img
