"""Soft visibility: smooth sphere silhouettes for shadow terms.

Port of kylespathtracer_tpu/diff/softvis.py. With config.soft_shadows =
β > 0 the hard light-occlusion test for *sphere* occluders becomes a
smooth transmittance

    T(ray) = Π_spheres σ( sd_i / (β · t_i) )

sd_i the signed closest-approach distance of the shadow ray to sphere i
over the segment to the light, t_i the distance of that closest point. Planes
and boxes stay hard occluders, so callers (render/mis.dual_mis) still gate
it with the hard trace result. The fused frame has the same transmittance
inside its shade core (ops/shade_kernel._soft_transmittance).
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.scene.types import Scene


def sphere_soft_transmittance(
    scene: Scene,
    ro: torch.Tensor,       # f32[...,3] shadow-ray origins
    rd: torch.Tensor,       # f32[...,3] unit directions toward the light
    t_max: torch.Tensor,    # f32[...] distance to the light surface
    exclude: torch.Tensor,  # i32[...] object id of the shaded surface
    beta: float,
) -> torch.Tensor:
    """Smooth transmittance in (0, 1] through all non-light spheres."""
    trans = torch.ones(ro.shape[:-1], dtype=ro.dtype, device=ro.device)
    light_id = scene.light_id
    for i in range(int(scene.spheres.shape[0])):
        c = scene.spheres[i, :3]
        r = scene.spheres[i, 3]
        oc = c - ro
        tc = torch.minimum(torch.clamp((oc * rd).sum(-1), min=gmath.EPS), t_max)
        closest = ro + rd * tc[..., None]
        sd = gmath.length(closest - c) - r
        v = torch.sigmoid(sd / (beta * tc))
        skip = (scene.sphere_ids[i] == light_id) | (scene.sphere_ids[i] == exclude)
        trans = trans * torch.where(skip, 1.0, v)
    return trans


def soft_direct_light(scene: Scene, hl, hn, ho, beta: float) -> torch.Tensor:
    """Direct lighting at surface points: analytic solid angle × Lambert ×
    soft sphere transmittance → f32[...,3]."""
    lv = scene.light[:3] - hl
    dist = gmath.length(lv)
    ndir = lv / torch.clamp(dist, min=1e-6)[..., None]
    pdf = gmath.solid_angle(dist * dist, scene.light[3] ** 2)
    lam = gmath.lambertian(hn, ndir)
    t_surface = torch.clamp(dist - scene.light[3], min=gmath.EPS)
    trans = sphere_soft_transmittance(scene, hl, ndir, t_surface, ho, beta)
    return (pdf * lam * trans)[..., None] * scene.light_color
