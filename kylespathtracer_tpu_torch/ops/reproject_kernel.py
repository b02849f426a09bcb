"""Windowed temporal reprojection: one CUDA kernel (K2) and its plain version.

Port of kylespathtracer_tpu/ops/reproject_kernel.py, full-frame mode.
Temporal reprojection only reads near the current pixel, so each 2×2
bilinear history tap is kept only when its row and column offsets lie
inside ±K; taps beyond restart the history, exactly like an off-screen tap
(common.glsl:673-674). The query head `_queries` stays plain tensor code
(it is XLA in the JAX package); the tap sum is the kernel,
csrc/reproject_kernel.cu, launched once per channel set.
"""

from __future__ import annotations

import warnings

import torch

from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.render import reproject as rep_mod
from kylespathtracer_tpu_torch.render.passes import Channel

# Launches of the CUDA kernel by `reproject_set` in this process.
LAUNCHES = 0
# The widest window the JAX kernel serves: its vertical halo is one 8-row
# block, so it clamps the window to 8 and the port does the same.
MAX_WINDOW = 8


def _queries(prev_cam, anchor, ho, fov, H, W):
    """Per-pixel tap offsets and separable bilinear weights.

    The 2×2 tap weight factorizes, w(tx,ty) = wy_ty·wx_tx, because the
    bilinear fraction and the per-tap bounds check are per-axis; the
    off-screen `inside` reject is folded into the x axis only. Border
    fractions can be negative (trunc), and so can their weights."""
    iuv, duv, inside = rep_mod.reproject_query(
        prev_cam.loc, prev_cam.orient, anchor, fov, (H, W)
    )
    dev = anchor.device
    gy = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    gx = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    ix, iy = iuv[..., 0], iuv[..., 1]
    dx, dy = duv[..., 0], duv[..., 1]
    dyrel = iy - gy
    dxrel = ix - gx
    wy0 = torch.where((iy >= 0) & (iy < H), 1.0 - dy, 0.0)
    wy1 = torch.where((iy + 1 >= 0) & (iy + 1 < H), dy, 0.0)
    wx0 = torch.where((ix >= 0) & (ix < W) & inside, 1.0 - dx, 0.0)
    wx1 = torch.where((ix + 1 >= 0) & (ix + 1 < W) & inside, dx, 0.0)
    return dyrel, dxrel, (wy0, wy1, wx0, wx1)


def reproject_window_plain(ho, dyrel, dxrel, w4, prev: Channel, K: int):
    """The windowed tap sum as plain tensor ops → (rgb[H,W,3], cnt[H,W]).
    Taps are summed in the kernel's order: (tx, ty) = (0,0), (0,1), (1,0),
    (1,1)."""
    H, W = ho.shape
    wy = w4[0:2]
    wx = w4[2:4]
    gy = torch.arange(H, device=ho.device)[:, None]
    gx = torch.arange(W, device=ho.device)[None, :]
    dyl, dxl = dyrel.long(), dxrel.long()
    rgb = torch.zeros((H, W, 3), dtype=torch.float32, device=ho.device)
    cnt = torch.zeros((H, W), dtype=torch.float32, device=ho.device)
    for tx in (0, 1):
        for ty in (0, 1):
            o, l = dyl + ty, dxl + tx
            sy, sx = gy + o, gx + l
            live = (o >= -K) & (o <= K) & (l >= -K) & (l <= K)
            live = live & (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
            sy, sx = sy.clamp(0, H - 1), sx.clamp(0, W - 1)
            live = live & (prev.oid[sy, sx] == ho)
            w = torch.where(live, wy[ty] * wx[tx], 0.0)
            rgb = rgb + w[..., None] * prev.rgb[sy, sx]
            cnt = cnt + w * prev.cnt[sy, sx]
    return rgb, cnt


def reproject_set(ho, dyrel, dxrel, w4, prev: Channel, K: int):
    """One channel set's reprojected history → (rgb[H,W,3], cnt[H,W]).
    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    global LAUNCHES
    device = ho.device
    if device.type == "cpu":
        return reproject_window_plain(ho, dyrel, dxrel, w4, prev, K)
    if device.type != "cuda":
        raise ValueError(f"reproject_set: unsupported device {device}")
    H, W = ho.shape
    i32, f32 = torch.int32, torch.float32
    _check = _build.check_tensor
    _check("ho", ho, i32, (H, W), device)
    _check("dyrel", dyrel, i32, (H, W), device)
    _check("dxrel", dxrel, i32, (H, W), device)
    for name, w in zip(("wy0", "wy1", "wx0", "wx1"), w4):
        _check(name, w, f32, (H, W), device)
    _check("prev.rgb", prev.rgb, f32, (H, W, 3), device)
    _check("prev.cnt", prev.cnt, f32, (H, W), device)
    _check("prev.oid", prev.oid, i32, (H, W), device)
    rgb = torch.empty((H, W, 3), dtype=f32, device=device)
    cnt = torch.empty((H, W), dtype=f32, device=device)
    err = _build.load().kpt_reproject_window(
        ho.data_ptr(), dyrel.data_ptr(), dxrel.data_ptr(),
        *(w.data_ptr() for w in w4),
        prev.rgb.data_ptr(), prev.cnt.data_ptr(), prev.oid.data_ptr(),
        rgb.data_ptr(), cnt.data_ptr(), H, W, int(K),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "kpt_reproject_window")
    LAUNCHES += 1
    return rgb, cnt


def reproject_window(
    prev_cam,
    hl: torch.Tensor,
    sl: torch.Tensor,
    ho: torch.Tensor,
    prev_d: Channel,
    prev_s: Channel,
    fov: float,
    window: int = 8,
):
    """Both reprojections (diffuse anchor hl, specular anchor sl), one
    launch each → ((rgb_d, cnt_d), (rgb_s, cnt_s)). Taps beyond
    K = min(window, MAX_WINDOW) rows or columns drop their history."""
    H, W = ho.shape
    if window > MAX_WINDOW:
        warnings.warn(
            f"reproject window={window} exceeds the reference kernel's "
            f"one-block vertical halo; clamping to {MAX_WINDOW}.",
            stacklevel=2,
        )
    K = min(window, MAX_WINDOW)

    def one_set(anchor, prev):
        dyrel, dxrel, w4 = _queries(prev_cam, anchor, ho, fov, H, W)
        return reproject_set(ho, dyrel, dxrel, w4, prev, K)

    return one_set(hl, prev_d), one_set(sl, prev_s)
