"""Geometry/shading math on tensors with a trailing xyz axis.

Port of kylespathtracer_tpu/core/gmath.py (reference: common.glsl:33-196).
Every function runs on the device and dtype of its inputs.
"""

from __future__ import annotations

import torch

# Constants (reference: common.glsl:33-34).
EPS = 1e-3
IEPS = 0.999
ZFAR = 50.0
FOV = 1.5  # focal z of the ray direction, not an angle (common.glsl:33)
HPI = 1.5707963
PI = 3.1415926
TWOPI = 6.2831853
SQRT2 = 1.4142136
SC45 = 0.7071068


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing xyz axis, keepdims dropped."""
    return (a * b).sum(-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize; zero vectors map to zero instead of NaN."""
    n2 = (v * v).sum(-1, keepdim=True)
    return v * torch.reciprocal(torch.sqrt(torch.clamp(n2, min=eps)))


def normalize_fast(v: torch.Tensor) -> torch.Tensor:
    """GLSL-style normalize (no zero guard); use where inputs are nonzero."""
    return v * torch.reciprocal(torch.sqrt((v * v).sum(-1, keepdim=True)))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def rotate_xy(p: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Pitch-then-yaw camera rotation (reference: common.glsl:61-67):
    angle[..., 0] = pitch (rotates yz), angle[..., 1] = yaw (rotates xz)."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    cx, cy = c[..., 0], c[..., 1]
    sx, sy = s[..., 0], s[..., 1]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    y2 = y * cx + z * sx
    z1 = -y * sx + z * cx
    x2 = x * cy + z1 * sy
    z2 = -x * sy + z1 * cy
    return torch.stack([x2, y2, z2], dim=-1)


def mix(a, b, t):
    """GLSL mix(a, b, t) = a*(1-t) + b*t, written as a + (b-a)*t."""
    return a + (b - a) * t


def smoothstep01(t):
    """GLSL smoothstep(0, 1, t) interior polynomial t*t*(3-2t)."""
    return t * t * (3.0 - 2.0 * t)
