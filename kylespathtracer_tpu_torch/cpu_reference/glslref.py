"""NumPy re-execution of the parts of the reference's GLSL math that the
direct-light oracle of bench_configs.py's config 1 needs.

A copy of those functions of kylespathtracer_tpu/cpu_reference/glslref.py
(which the port may not import at run time): GLSL semantics preserved,
int32 two's-complement wraparound, float32 evaluation, column-major mat3
row-vector products. Vectorized over a leading pixel batch, vec3s as
trailing-axis arrays. tests/test_torch_bench.py holds each function to the
JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32
i32 = np.int32

EPS = f32(0.001)
IEPS = f32(0.999)
ZFAR = f32(50.0)
FOV = f32(1.5)
TWOPI = f32(6.2831853)


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _length(v):
    return np.sqrt(np.sum(v * v, axis=-1))


def _normalize(v):
    return v / _length(v)[..., None]


def gen_seed(frame, px, py, res_x, res_y):
    """common.glsl:39-41, int32 wraparound."""
    with np.errstate(over="ignore"):
        frame = i32(frame)
        px = np.asarray(px, i32)
        py = np.asarray(py, i32)
        a = i32(frame << 12) + px + (py << 1)
        return a ^ (px * i32(res_y)) ^ (py * i32(res_x))


def weyl3(v):
    """common.glsl:43-45: fract(float(v*k)/2^24) with int32 wrap."""
    v = np.asarray(v, i32)
    with np.errstate(over="ignore"):
        prod = v[..., None] * np.array([13743434, 11258243, 9222443], i32)
    x = prod.astype(f32) / f32(16777216.0)
    return x - np.floor(x)


def uniform_cone_dir(lv, lr, seed):
    """common.glsl:188-196."""
    rnd = weyl3(seed)
    sa = linear_angle(_length(lv), lr)
    rad = np.sqrt(rnd[..., 0]) * np.tan(sa)
    tha = rnd[..., 1] * TWOPI
    nlv = _normalize(lv)
    r, u = basis(nlv)
    return _normalize(
        nlv + rad[..., None] * (r * np.cos(tha)[..., None] + u * np.sin(tha)[..., None])
    )


def basis(n):
    """common.glsl:53-59 → (f, r)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = np.where(nz >= 0.0, f32(1.0), f32(-1.0))
    a = f32(1.0) / (s + nz)
    b = -nx * ny * a
    f = np.stack([f32(1.0) - nx * nx * a * s, b * s, -nx * s], axis=-1)
    r = np.stack([b, s - ny * ny * a, -ny], axis=-1)
    return f, r


def rotate_xy(p, angle):
    """common.glsl:61-67: o.yz *= mat2(cx,sx,-sx,cx); o.xz *= mat2(cy,sy,-sy,cy)."""
    angle = np.asarray(angle, f32)
    cx, cy = np.cos(angle[..., 0]), np.cos(angle[..., 1])
    sx, sy = np.sin(angle[..., 0]), np.sin(angle[..., 1])
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    y2 = y * cx + z * sx
    z1 = -y * sx + z * cx
    x2 = x * cy + z1 * sy
    z2 = -x * sy + z1 * cy
    return np.stack([x2, y2, z2], axis=-1)


def linear_angle(d, r):
    return np.arcsin(np.clip(r / d, EPS, IEPS))


def solid_angle(d2, r2):
    return (f32(1.0) - np.sqrt(f32(1.0) - np.clip(r2 / d2, 0.0, 1.0))) * TWOPI


def linear_srgb(x):
    return np.where(
        x <= f32(0.0031308),
        f32(12.92) * x,
        f32(1.055) * np.power(np.maximum(x, 1e-10), f32(1.0 / 2.4)) - f32(0.055),
    )


def aces_fitted(color):
    """common.glsl:120-139; GLSL vec*mat3 dots against columns."""
    m1 = np.array(
        [
            [0.59719, 0.35458, 0.04823],
            [0.07600, 0.90834, 0.01566],
            [0.02840, 0.13383, 0.83777],
        ],
        f32,
    )
    m2 = np.array(
        [
            [1.60475, -0.53108, -0.07367],
            [-0.10208, 1.10813, -0.00605],
            [-0.00327, -0.07276, 1.07602],
        ],
        f32,
    )
    c = color @ m1.T
    a = c * (c + f32(0.0245786)) - f32(0.000090537)
    b = c * (f32(0.983729) * c + f32(0.4329510)) + f32(0.238081)
    c = (a / b) @ m2.T
    return np.clip(c, 0.0, 1.0)
