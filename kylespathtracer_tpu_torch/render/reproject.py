"""Temporal reprojection: previous-camera projection and the exact gather.

Port of kylespathtracer_tpu/render/reproject.py (reference:
common.glsl:661-694). The exact 2×2 gather here is the oracle the windowed
reprojection kernel (ops/reproject_kernel.py) is held against.
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core import gmath


def reproject_query(
    prev_loc: torch.Tensor,
    prev_orient: torch.Tensor,
    hl: torch.Tensor,
    fov: float,
    image_size: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project anchor points into the previous camera → (iuv, duv, inside).

    iuv i32[...,2]: integer corner pixel of the 2×2 tap window (trunc, not
    floor, so border fractions can be negative); duv f32[...,2] the bilinear
    fraction; inside the NDC on-screen mask (common.glsl:663-677)."""
    H, W = image_size
    asp = W / H
    vec = lambda *v: torch.tensor(v, dtype=hl.dtype, device=hl.device)

    # Previous camera basis (common.glsl:663-665).
    lf = gmath.rotate_xy(vec(0.0, 0.0, 1.0), prev_orient)
    r = gmath.normalize(gmath.cross(lf, vec(0.0, 1.0, 0.0)))
    u = gmath.normalize(gmath.cross(lf, r))

    # Direction from hit point to the previous camera (common.glsl:667).
    nhl = gmath.normalize(prev_loc - hl)
    denom = gmath.dot(nhl, lf)
    denom = torch.where(denom.abs() < 1e-6, 1e-6, denom)
    luv = torch.stack([gmath.dot(nhl, r), gmath.dot(nhl, u)], dim=-1)
    luv = luv / denom[..., None] * fov / vec(asp, 1.0)

    inside = ((luv <= 1.0) & (luv >= -1.0)).all(dim=-1)  # common.glsl:673

    # NDC → pixel coords minus the half-pixel center offset (common.glsl:677).
    fuv = (luv * -0.5 + 0.5) * vec(W, H) - 0.5
    iuv = torch.trunc(fuv).to(torch.int32)
    duv = fuv - iuv
    return iuv, duv, inside


def reproject(
    prev_loc: torch.Tensor,     # f32[3] previous camera position
    prev_orient: torch.Tensor,  # f32[2] previous camera orientation
    hl: torch.Tensor,           # f32[H,W,3] reprojection anchor points
    ho: torch.Tensor,           # i32[H,W] current object IDs
    prev_rgb: torch.Tensor,     # f32[H,W,3]
    prev_cnt: torch.Tensor,     # f32[H,W]
    prev_id: torch.Tensor,      # i32[H,W]
    fov: float = gmath.FOV,
    image_size: tuple[int, int] | None = None,
    buffer_row0: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (rgb[...,3], cnt[...]): the history carried to this frame by an
    exact bilinear 2×2 gather with per-tap object-ID rejection, any motion.

    The query points may cover only a row window of the image (a tile);
    `image_size` (H, W) fixes the NDC→pixel mapping (default: the history's
    shape). The history may also be a row window (a tile plus its halo
    rows, parallel/shard.py) whose first row is image row `buffer_row0`;
    taps outside the window carry zero weight, so the history restarts
    there as at an off-screen tap (common.glsl:673-674)."""
    H, W = prev_cnt.shape if image_size is None else image_size
    window = prev_cnt.shape[0]
    iuv, duv, inside = reproject_query(prev_loc, prev_orient, hl, fov, (H, W))

    def tap(dx, dy):
        xs = iuv[..., 0] + dx
        ys = iuv[..., 1] + dy  # image row
        inb = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        yl = ys - buffer_row0  # row of the history window
        inb = inb & (yl >= 0) & (yl < window)
        x = xs.clamp(0, W - 1).long()
        y = yl.clamp(0, window - 1).long()
        m = ((prev_id[y, x] == ho) & inb & inside).to(hl.dtype)
        return prev_rgb[y, x] * m[..., None], prev_cnt[y, x] * m

    rgb00, c00 = tap(0, 0)
    rgb10, c10 = tap(1, 0)
    rgb01, c01 = tap(0, 1)
    rgb11, c11 = tap(1, 1)

    dx = duv[..., 0]
    dy = duv[..., 1]
    rgb = gmath.mix(
        gmath.mix(rgb00, rgb10, dx[..., None]),
        gmath.mix(rgb01, rgb11, dx[..., None]),
        dy[..., None],
    )
    cnt = gmath.mix(gmath.mix(c00, c10, dx), gmath.mix(c01, c11, dx), dy)
    return rgb, cnt
