"""Low-discrepancy per-pixel RNG.

Port of kylespathtracer_tpu/core/sampler.py (reference: common.glsl:39-51).
int32 `*`, `+` and `<<` wrap in two's complement on torch tensors exactly
as in jnp. torch has no uint32 `>>` on the CPU, so the PCG hash runs in
int64 with `& 0xFFFFFFFF` after every step that can leave 32 bits.
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
