"""Composite + tonemap (reference: passthrough.frag:29-47).

Port of kylespathtracer_tpu/render/composite.py.
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core import color
from kylespathtracer_tpu_torch.render.passes import Channel
from kylespathtracer_tpu_torch.scene import materials as mat_mod


def composite(scene, config, gb, camera, diffuse: Channel, specular: Channel) -> torch.Tensor:
    """The pass pipeline's composite: the primary surface re-fetched at the
    G-buffer hits (passthrough.frag:38), then `composite_from`."""
    hl = camera.loc + gb.ray_dir * gb.depth[..., None]
    albedo, _, energy = mat_mod.surface(scene.materials, gb.obj_id, hl)
    return composite_from(albedo, energy, diffuse, specular, config)


def composite_from(
    albedo: torch.Tensor,
    energy: torch.Tensor,
    diffuse: Channel,
    specular: Channel,
    config,
) -> torch.Tensor:
    """Modulate the accumulators by the primary surface (albedo/energy from
    the frame kernel), average by sample count, tonemap → sRGB f32[H,W,3]."""
    # diffuse × albedo·E_d; specular × sqrt(albedo)·E_s (passthrough.frag:39-41).
    pos = albedo > 0.0
    alb_sqrt = torch.where(pos, torch.sqrt(torch.where(pos, albedo, 1.0)), 0.0)
    d = diffuse.rgb * albedo * energy[..., 0:1]
    s = specular.rgb * alb_sqrt * energy[..., 1:2]
    img = (
        d / torch.clamp(torch.floor(diffuse.cnt), min=1.0)[..., None]
        + s / torch.clamp(torch.floor(specular.cnt), min=1.0)[..., None]
    )
    return color.linear_srgb(color.aces_fitted(img * config.brightness))
