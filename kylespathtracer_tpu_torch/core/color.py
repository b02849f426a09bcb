"""Color pipeline: sRGB transfer, ACES tonemap, spectral ramp, smooth
texel fetch (reference: common.glsl:70-139).

Port of kylespathtracer_tpu/core/color.py. Divisions by constants are by
tensors on the input's device: on the card torch divides by a Python scalar
as a multiply by its reciprocal.
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


def _const(x: torch.Tensor, value) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=x.device)


def srgb_linear(x: torch.Tensor) -> torch.Tensor:
    """sRGB → linear transfer (reference: common.glsl:115-117)."""
    lo = x / _const(x, 12.92)
    hi = torch.pow(torch.clamp((x + 0.055) / _const(x, 1.055), min=1e-10), 2.4)
    return torch.where(x <= 0.04045, lo, hi)


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


# Spectral→RGB piecewise-quadratic fit (reference: common.glsl:86-108).
_FR1 = (400., 410., 545., 595., 650., 415., 475., 585., 400., 475.)
_FR2 = (410., 475., 595., 650., 700., 475., 585., 639., 475., 560.)
_DV1 = (10., 65., 50., 55., 50., 60., 115., 54., 75., 85.)
_C = (
    (0.0, 0.33, -0.2), (0.14, 0.0, -0.13), (0.0, 1.98, -1.0),
    (0.98, 0.06, -0.4), (0.65, -0.84, 0.2), (0.0, 0.0, 0.8),
    (0.8, 0.76, -0.8), (0.84, -0.84, 0.0), (0.0, 2.2, -1.5),
    (0.7, -1.0, 0.3),
)


def texture_good(tex: torch.Tensor, x: torch.Tensor, bits: int) -> torch.Tensor:
    """Smoothstep-weighted bilinear texel fetch with power-of-two wraparound
    (reference: common.glsl:70-79; unused upstream, kept for parity).

    tex: f32[S,S,C] with S = bits+1 a power of two; x: f32[...,2] continuous
    texel coordinates. Integer texel coordinates are int32 and wrap with
    `& bits`, as the reference's.
    """
    p = torch.floor(x).to(torch.int32)
    f = x - p
    f = f * f * (3.0 - 2.0 * f)

    def fetch(dx, dy):
        q = (p + torch.tensor([dx, dy], dtype=torch.int32, device=x.device)) & bits
        return tex[q[..., 1].long(), q[..., 0].long()]

    fx = f[..., 0:1]
    fy = f[..., 1:2]
    top = fetch(0, 0) * (1 - fx) + fetch(1, 0) * fx
    bot = fetch(0, 1) * (1 - fx) + fetch(1, 1) * fx
    return top * (1 - fy) + bot * fy


def spectrum(x: torch.Tensor) -> torch.Tensor:
    """Normalized wavelength (0=400nm..1=700nm) → RGB (common.glsl:86-108)."""
    fr1, fr2, dv1, c = (_const(x, v) for v in (_FR1, _FR2, _DV1, _C))
    l = (x * 300.0 + 400.0)[..., None]
    t = (l - fr1) / dv1
    in_range = (l >= fr1) & (l <= fr2)
    seg = torch.where(in_range, c[:, 0] + c[:, 1] * t + c[:, 2] * t * t, 0.0)
    rgb = torch.stack([seg[..., 0:5].sum(-1), seg[..., 5:8].sum(-1), seg[..., 8:10].sum(-1)], dim=-1)
    return rgb * rgb
