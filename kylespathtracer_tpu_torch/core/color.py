"""sRGB transfer and the fitted ACES tonemap (reference: common.glsl:111-139).

Port of kylespathtracer_tpu/core/color.py.
"""

from __future__ import annotations

import torch

# ACES input/output matrices, stored rows-as-written (each row is one GLSL
# column), applied as explicit f32 multiply-add chains like the JAX package.
_ACES_IN = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
_ACES_OUT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)


def linear_srgb(x: torch.Tensor) -> torch.Tensor:
    """Linear → sRGB transfer (reference: common.glsl:111-113)."""
    lo = 12.92 * x
    hi = 1.055 * torch.pow(torch.clamp(x, min=1e-10), 1.0 / 2.4) - 0.055
    return torch.where(x <= 0.0031308, lo, hi)


def _mat3(v: torch.Tensor, m) -> torch.Tensor:
    """Row-vector × mat3 as explicit f32 multiply-add chains."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [x * m[r][0] + y * m[r][1] + z * m[r][2] for r in range(3)], dim=-1
    )


def aces_fitted(color: torch.Tensor) -> torch.Tensor:
    """Paniq/MJP fitted ACES RRT+ODT (reference: common.glsl:120-139)."""
    c = _mat3(color, _ACES_IN)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    c = _mat3(a / b, _ACES_OUT)
    return torch.clamp(c, 0.0, 1.0)
