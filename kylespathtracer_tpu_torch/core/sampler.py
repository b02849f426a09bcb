"""Low-discrepancy per-pixel RNG.

Port of kylespathtracer_tpu/core/sampler.py (reference: common.glsl:39-51).
int32 `*`, `+` and `<<` wrap in two's complement on torch tensors exactly
as in jnp. torch has no uint32 `>>` on the CPU, so the PCG hash and the R2
sampler run in int64 with `& 0xFFFFFFFF` after every step that can leave
32 bits; a product of two 32-bit words goes through `_mul32`, which never
leaves int64's range.
"""

from __future__ import annotations

import torch

WEYL = (13743434, 11258243, 9222443)  # common.glsl:44
_EXP2_24 = 16777216.0
_M32 = 0xFFFFFFFF


def gen_seed(frame, px: torch.Tensor, py: torch.Tensor, res_x, res_y
             ) -> torch.Tensor:
    """Unique int32 per pixel/frame (reference: common.glsl:39-41):
    ((frame<<12) + x + (y<<1)) ^ x*res.y ^ y*res.x, all int32 wraparound."""
    frame = torch.as_tensor(frame, dtype=torch.int32, device=px.device)
    px = px.to(torch.int32)
    py = py.to(torch.int32)
    return ((frame << 12) + px + (py << 1)) ^ (px * int(res_y)) ^ (py * int(res_x))


def weyl3(v: torch.Tensor) -> torch.Tensor:
    """fract(float(v*k)/2^24) for the three Weyl constants → f32[..., 3]."""
    v = v.to(torch.int32)[..., None]
    k = torch.tensor(WEYL, dtype=torch.int32, device=v.device)
    prod = (v * k).to(torch.float32) / _EXP2_24
    return prod - torch.floor(prod)


# R2 lattice constants round(2^32 / phi2^k), phi2 the plastic constant.
_R2_A1 = 3242174889
_R2_A2 = 2447445413


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x·c) mod 2^32 for x in [0, 2^32) held in int64 and a constant c in
    [0, 2^32), in two 16-bit halves of c so no product passes 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG-RXS-M-XS over uint32, carried in int64 → int64 in [0, 2^32)."""
    x = x.to(torch.int64) & _M32
    state = (x * 747796405 + 2891336453) & _M32
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def _to_int32(u: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 bit pattern → the int32 with the same bits."""
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def fold_seed(seed: torch.Tensor, i: int, decorrelate: bool = False
              ) -> torch.Tensor:
    """The i-th sample stream of a pixel seed: `seed + i` (the reference's
    Weyl-lattice stride), or the PCG hash of (seed, i) when decorrelating.
    Sample 0 is the identity in both modes."""
    if not decorrelate or i == 0:
        return seed + i
    mixed = (seed.to(torch.int64) & _M32) ^ ((i * 0x9E3779B9) & _M32)
    return _to_int32(pcg_hash(mixed))


def r2_pair(n: torch.Tensor, stream: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The n-th point of the 2D R2 sequence, PCG-rotated per stream → two
    f32 uniforms in [0, 1). n and stream hold uint32 bit patterns (any
    integer dtype; int32 is reinterpreted). The low 8 bits are dropped
    before the exact 24-bit conversion, so u never reaches 1."""
    n = n.to(torch.int64) & _M32
    rot1 = pcg_hash(stream)
    rot2 = pcg_hash(rot1 ^ 0x9E3779B9)
    u1 = ((_mul32(n, _R2_A1) + rot1) & _M32) >> 8
    u2 = ((_mul32(n, _R2_A2) + rot2) & _M32) >> 8
    return u1.to(torch.float32) * 2.0**-24, u2.to(torch.float32) * 2.0**-24


def pixel_stream(px: torch.Tensor, py: torch.Tensor, width: int, pair) -> torch.Tensor:
    """Stream id of (pixel, dimension pair): (py·width + px)·0x85EBCA6B +
    pair in uint32, held in int64."""
    pid = (_mul32(py.to(torch.int64) & _M32, int(width) & _M32)
           + (px.to(torch.int64) & _M32)) & _M32
    return (_mul32(pid, 0x85EBCA6B) + (int(pair) & _M32)) & _M32
