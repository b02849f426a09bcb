"""Constants, vector helpers and the sample-stream fold of the plain reference.

Frozen copies of the PyTorch port's `core/gmath.py` and
`core/sampler.fold_seed` (reference shaders: common.glsl:33-196), kept so
that no change to the program moves the yardstick. Every function runs on
the device and dtype of its inputs.
"""

from __future__ import annotations

import torch

# Constants (common.glsl:33-34).
EPS = 1e-3
IEPS = 0.999
ZFAR = 50.0
FOV = 1.5
PI = 3.1415926
TWOPI = 6.2831853

_M32 = 0xFFFFFFFF


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize; zero vectors map to zero instead of NaN."""
    n2 = (v * v).sum(-1, keepdim=True)
    return v * torch.reciprocal(torch.sqrt(torch.clamp(n2, min=eps)))


def normalize_fast(v: torch.Tensor) -> torch.Tensor:
    """GLSL-style normalize (no zero guard)."""
    return v * torch.reciprocal(torch.sqrt((v * v).sum(-1, keepdim=True)))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def rotate_xy(p: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Pitch-then-yaw camera rotation (common.glsl:61-67)."""
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
    """GLSL mix(a, b, t), written as a + (b-a)*t."""
    return a + (b - a) * t


def _pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG-RXS-M-XS over uint32, carried in int64."""
    x = x.to(torch.int64) & _M32
    state = (x * 747796405 + 2891336453) & _M32
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def fold_seed(seed: torch.Tensor, i: int, decorrelate: bool = False) -> torch.Tensor:
    """The i-th sample stream of a pixel seed: `seed + i`, or the PCG hash
    of (seed, i) when decorrelating. Sample 0 is the identity."""
    if not decorrelate or i == 0:
        return seed + i
    mixed = (seed.to(torch.int64) & _M32) ^ ((i * 0x9E3779B9) & _M32)
    u = _pcg_hash(mixed)
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)
