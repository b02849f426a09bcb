"""Material evaluation: the `Materials` table at hit points.

Port of kylespathtracer_tpu/scene/materials.py (reference: the procedural
`getSurface` switch, common.glsl:237-262).
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.scene.types import Materials


def checker(hl: torch.Tensor, freq: torch.Tensor) -> torch.Tensor:
    """3D checkerboard |(floor(x f) + floor(y f) + floor(z f)) mod 2|
    (reference: common.glsl:244, 250)."""
    s = (torch.floor(hl[..., 0] * freq) + torch.floor(hl[..., 1] * freq)
         + torch.floor(hl[..., 2] * freq))
    return torch.remainder(s, 2.0).abs()


def surface(materials: Materials, ho: torch.Tensor, hl: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(albedo[...,3], emission[...,3], energy[...,2]) at hit points.

    ho: int32[...] object IDs, clipped into the table (0 = miss reads row 0).
    hl: f32[...,3] hit locations (for the procedural checker).
    """
    k = torch.clamp(ho, 0, materials.num_ids - 1).long()
    s = materials.s0[k] + materials.s1[k] * checker(hl, materials.freq[k])
    s = s[..., None]
    albedo = materials.alb_const[k] + materials.alb_scale[k] * s
    energy = materials.en_const[k] + materials.en_scale[k] * s
    return albedo, materials.emission[k], energy
