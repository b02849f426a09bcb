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


def dot_k(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing xyz axis, keepdims kept."""
    return (a * b).sum(-1, keepdim=True)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize; zero vectors map to zero instead of NaN."""
    n2 = (v * v).sum(-1, keepdim=True)
    return v * torch.reciprocal(torch.sqrt(torch.clamp(n2, min=eps)))


def normalize_fast(v: torch.Tensor) -> torch.Tensor:
    """GLSL-style normalize (no zero guard); use where inputs are nonzero."""
    return v * torch.reciprocal(torch.sqrt((v * v).sum(-1, keepdim=True)))


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """GLSL reflect: i - 2*dot(n,i)*n."""
    return i - 2.0 * (n * i).sum(-1, keepdim=True) * n


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless orthonormal basis around unit n → (f, r)
    (reference: common.glsl:53-59)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = 1.0 / (s + nz)
    b = -nx * ny * a
    f = torch.stack([1.0 - nx * nx * a * s, b * s, -nx * s], dim=-1)
    r = torch.stack([b, s - ny * ny * a, -ny], dim=-1)
    return f, r


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


def linear_angle(d: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Apparent (linear) angle of a sphere of radius r at distance d
    (reference: common.glsl:141-144); d is guarded away from 0."""
    return torch.arcsin(torch.clamp(r / torch.clamp(d, min=1e-12), EPS, IEPS))


def tan_linear_angle(d: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """tan(linear_angle(d, r)) as x/sqrt(1-x²), x = clip(r/d, eps, ieps)."""
    x = torch.clamp(r / torch.clamp(d, min=1e-12), EPS, IEPS)
    return x * torch.rsqrt(1.0 - x * x)


def solid_angle(d2: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Solid angle of a sphere from squared distance and squared radius
    (reference: common.glsl:146-149)."""
    return (1.0 - torch.sqrt(1.0 - torch.clamp(r2 / torch.clamp(d2, min=1e-24), 0.0, 1.0))) * TWOPI


def schlick(r1, r2, vn: torch.Tensor) -> torch.Tensor:
    """Schlick fresnel between refractive indices r1, r2 (common.glsl:151-154);
    the fifth power in jnp's integer_pow order."""
    r0 = (r1 - r2) / (r1 + r2)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * powi(1.0 - vn, 5)


def lambertian(hn: torch.Tensor, nlv: torch.Tensor) -> torch.Tensor:
    """Clamped cosine term max(eps, n.l) (common.glsl:156-158)."""
    return torch.clamp(dot(nlv, hn), min=EPS)


def phong(rd: torch.Tensor, hn: torch.Tensor, nlv: torch.Tensor, gloss) -> torch.Tensor:
    """Phong lobe max(eps, l.reflect(rd,n))^gloss (common.glsl:160-162)."""
    return pow_static(torch.clamp(dot(nlv, reflect(rd, hn)), min=EPS), gloss)


def powi(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n by squaring for a static integer n, in the JAX package's
    multiplication order."""
    n = int(n)
    acc = None
    base = x
    while n:
        if n & 1:
            acc = base if acc is None else acc * base
        n >>= 1
        if n:
            base = base * base
    return acc if acc is not None else torch.ones_like(x)


def pow_static(x: torch.Tensor, e) -> torch.Tensor:
    """x**e, using `powi` when e is a static integral number."""
    if isinstance(e, (int, float)) and float(e).is_integer():
        return powi(x, int(e))
    return x ** e


def mix(a, b, t):
    """GLSL mix(a, b, t) = a*(1-t) + b*t, written as a + (b-a)*t."""
    return a + (b - a) * t


def smoothstep01(t):
    """GLSL smoothstep(0, 1, t) interior polynomial t*t*(3-2t)."""
    return t * t * (3.0 - 2.0 * t)
