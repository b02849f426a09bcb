"""Temporal-accumulation state and the history tail of the frame.

Port of the parts of kylespathtracer_tpu/render/passes.py the fused
temporal frame uses: `Channel`, `count_floor` and `_temporal_clamp`
(diffuse.frag:45-51, specular.frag:45-49).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class Channel:
    """One accumulation buffer (diffuse or specular), SoA for the
    reference's RGBA texel with count+ID packed in alpha (common.glsl:629-635)."""

    rgb: torch.Tensor  # f32[H,W,3]
    cnt: torch.Tensor  # f32[H,W]
    oid: torch.Tensor  # i32[H,W] object ID at accumulation time

    @classmethod
    def zeros(cls, height: int, width: int, device=DEFAULT_DEVICE) -> "Channel":
        return cls(
            rgb=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
            cnt=torch.zeros((height, width), dtype=torch.float32, device=device),
            oid=torch.zeros((height, width), dtype=torch.int32, device=device),
        )

    def to(self, device) -> "Channel":
        return Channel(self.rgb.to(device), self.cnt.to(device), self.oid.to(device))


def channel_from_numpy(tree: dict, device=DEFAULT_DEVICE) -> Channel:
    """The port's `Channel` from a JAX `Channel` given as numpy arrays."""
    t = lambda k, dt: torch.as_tensor(np.array(tree[k], dt), device=device)
    return Channel(rgb=t("rgb", np.float32), cnt=t("cnt", np.float32),
                   oid=t("oid", np.int32))


def count_floor(cnt: torch.Tensor) -> torch.Tensor:
    """floor(count + 1e-4): the reprojected-sample-count floor
    (diffuse.frag:46) with the epsilon that keeps counts reconstructed as
    c·(1-1e-4) by f32 bilinear weights from dropping to c-1."""
    return torch.floor(cnt + 1e-4)


def _temporal_clamp(rep_rgb, rep_cnt, vv, config):
    """Velocity-adaptive history clamp (diffuse.frag:49-51):
    lvv = min(T-1, floor(T·2·sqrt(|vv|))); texels holding more than T-lvv
    samples are rescaled down to exactly T-lvv."""
    T = float(config.temporal)
    lvv = torch.clamp(torch.floor(T * 2.0 * torch.sqrt(vv)), max=T - 1.0)
    limit = T - lvv
    over = rep_cnt > limit
    scale = torch.where(over, limit / torch.clamp(rep_cnt, min=1e-6), 1.0)
    return rep_rgb * scale[..., None], torch.where(over, limit, rep_cnt)
