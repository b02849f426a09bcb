"""Composite + tonemap (reference: passthrough.frag:29-47).

Port of kylespathtracer_tpu/render/composite.py:composite_from.
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core import color
from kylespathtracer_tpu_torch.render.passes import Channel


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
