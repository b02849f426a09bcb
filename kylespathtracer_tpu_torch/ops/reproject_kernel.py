"""Windowed temporal reprojection: one CUDA kernel (K2) and its plain version.

Port of kylespathtracer_tpu/ops/reproject_kernel.py. Temporal
reprojection only reads near the current pixel, so each 2×2 bilinear
history tap is kept only when its row and column offsets lie inside ±K;
taps beyond restart the history, exactly like an off-screen tap
(common.glsl:673-674). The query head `_queries` stays plain tensor code
(it is XLA in the JAX package); the tap sum is the kernel,
csrc/reproject_kernel.cu, launched once per channel set.

Tile mode (`image_height`/`row_base`/`hist_halo`, the sharded renderer's,
parallel/shard.py): the queries cover image rows [row_base, row_base+rows)
of an `image_height`-row image, and the history is the window of
rows + 2·hist_halo rows around them that the halo exchange assembles.
"""

from __future__ import annotations

import warnings

import torch

from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.render import reproject as rep_mod
from kylespathtracer_tpu_torch.render.passes import Channel

# Launches of the CUDA kernel by `reproject_set` in this process, and the
# tile-mode launches among them.
LAUNCHES = 0
TILE_LAUNCHES = 0
# The widest window the JAX kernel serves: its vertical halo is one 8-row
# block (the `block_rows` that the JAX callers pass), so it clamps the
# window to 8 and the port does the same; in tile mode rows and the halo
# must be multiples of it.
MAX_WINDOW = 8
BLOCK_ROWS = MAX_WINDOW


def _queries(prev_cam, anchor, ho, fov, H, W, row0=0):
    """Per-pixel tap offsets and separable bilinear weights.

    The 2×2 tap weight factorizes, w(tx,ty) = wy_ty·wx_tx, because the
    bilinear fraction and the per-tap bounds check are per-axis; the
    off-screen `inside` reject is folded into the x axis only. Border
    fractions can be negative (trunc), and so can their weights. `anchor`
    may cover only image rows [row0, row0+rows) (a tile); H and W are the
    full image's, so the NDC mapping and the bounds are global."""
    iuv, duv, inside = rep_mod.reproject_query(
        prev_cam.loc, prev_cam.orient, anchor, fov, (H, W)
    )
    dev = anchor.device
    gy = row0 + torch.arange(ho.shape[0], dtype=torch.int32, device=dev)[:, None]
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


def reproject_window_plain(ho, dyrel, dxrel, w4, prev: Channel, K: int,
                           image_height: int | None = None, row_base: int = 0,
                           hist_halo: int = 0):
    """The windowed tap sum as plain tensor ops → (rgb[rows,W,3],
    cnt[rows,W]) for image rows [row_base, row_base+rows) of an
    `image_height`-row image (default: the query rows are the image);
    `prev` holds image rows from row_base - hist_halo on. Taps are summed in
    the kernel's order: (tx, ty) = (0,0), (0,1), (1,0), (1,1)."""
    rows, W = ho.shape
    H = rows if image_height is None else image_height
    window = prev.cnt.shape[0]
    wy = w4[0:2]
    wx = w4[2:4]
    gy = row_base + torch.arange(rows, device=ho.device)[:, None]
    gx = torch.arange(W, device=ho.device)[None, :]
    dyl, dxl = dyrel.long(), dxrel.long()
    rgb = torch.zeros((rows, W, 3), dtype=torch.float32, device=ho.device)
    cnt = torch.zeros((rows, W), dtype=torch.float32, device=ho.device)
    for tx in (0, 1):
        for ty in (0, 1):
            o, l = dyl + ty, dxl + tx
            sy, sx = gy + o, gx + l
            live = (o >= -K) & (o <= K) & (l >= -K) & (l <= K)
            live = live & (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
            # The tap's row of the history window.
            sy = sy - (row_base - hist_halo)
            live = live & (sy >= 0) & (sy < window)
            sy, sx = sy.clamp(0, window - 1), sx.clamp(0, W - 1)
            live = live & (prev.oid[sy, sx] == ho)
            w = torch.where(live, wy[ty] * wx[tx], 0.0)
            rgb = rgb + w[..., None] * prev.rgb[sy, sx]
            cnt = cnt + w * prev.cnt[sy, sx]
    return rgb, cnt


def reproject_set(ho, dyrel, dxrel, w4, prev: Channel, K: int,
                  image_height: int | None = None, row_base: int = 0, hist_halo: int = 0):
    """One channel set's reprojected history → (rgb[rows,W,3], cnt[rows,W]);
    the rows and the history window as in `reproject_window_plain`. CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    global LAUNCHES, TILE_LAUNCHES
    device = ho.device
    if device.type == "cpu":
        return reproject_window_plain(ho, dyrel, dxrel, w4, prev, K, image_height, row_base, hist_halo)
    if device.type != "cuda":
        raise ValueError(f"reproject_set: unsupported device {device}")
    rows, W = ho.shape
    H = rows if image_height is None else int(image_height)
    window = rows + 2 * hist_halo
    if row_base < 0 or row_base + rows > H or hist_halo < 0:
        raise ValueError(f"reproject_set: rows [{row_base}, {row_base + rows}) with a "
                         f"{hist_halo}-row halo do not fit a {H}-row image")
    i32, f32 = torch.int32, torch.float32
    _check = _build.check_tensor
    _check("ho", ho, i32, (rows, W), device)
    _check("dyrel", dyrel, i32, (rows, W), device)
    _check("dxrel", dxrel, i32, (rows, W), device)
    for name, w in zip(("wy0", "wy1", "wx0", "wx1"), w4):
        _check(name, w, f32, (rows, W), device)
    _check("prev.rgb", prev.rgb, f32, (window, W, 3), device)
    _check("prev.cnt", prev.cnt, f32, (window, W), device)
    _check("prev.oid", prev.oid, i32, (window, W), device)
    rgb = torch.empty((rows, W, 3), dtype=f32, device=device)
    cnt = torch.empty((rows, W), dtype=f32, device=device)
    err = _build.load().kpt_reproject_window(
        ho.data_ptr(), dyrel.data_ptr(), dxrel.data_ptr(),
        *(w.data_ptr() for w in w4),
        prev.rgb.data_ptr(), prev.cnt.data_ptr(), prev.oid.data_ptr(),
        rgb.data_ptr(), cnt.data_ptr(), rows, H, W, int(K), int(row_base),
        int(row_base - hist_halo), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "kpt_reproject_window")
    LAUNCHES += 1
    if rows != H or hist_halo:
        TILE_LAUNCHES += 1
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
    image_height: int | None = None,
    row_base: int = 0,
    hist_halo: int = 0,
):
    """Both reprojections (diffuse anchor hl, specular anchor sl), one
    launch each → ((rgb_d, cnt_d), (rgb_s, cnt_s)). Taps beyond
    K = min(window, MAX_WINDOW) rows or columns drop their history.

    Full frame by default. `image_height` other than the query rows selects
    tile mode: hl/sl/ho cover image rows [row_base, row_base+rows), and the
    history channels are a window of rows + 2·hist_halo rows whose first
    row is image row row_base - hist_halo. As in the JAX kernel, rows and
    hist_halo must be multiples of BLOCK_ROWS and hist_halo >= K (a smaller
    halo would let taps read past the window); unlike it, a halo on a
    history that spans the image raises, where the JAX kernel ignores the
    halo and reads the window shifted."""
    rows, W = ho.shape
    tile = image_height is not None and image_height != rows
    H = image_height if tile else rows
    if window > MAX_WINDOW:
        warnings.warn(
            f"reproject window={window} exceeds the reference kernel's "
            f"one-block vertical halo; clamping to {MAX_WINDOW}.",
            stacklevel=2,
        )
    K = min(window, MAX_WINDOW)
    if tile:
        if rows % BLOCK_ROWS or hist_halo % BLOCK_ROWS:
            raise ValueError(
                f"tile mode needs rows ({rows}) and hist_halo ({hist_halo}) "
                f"divisible by block_rows ({BLOCK_ROWS})")
        if hist_halo < K:
            raise ValueError(
                f"hist_halo ({hist_halo}) < reprojection window K ({K}): "
                "cross-tile taps would silently read wrong history rows")
    elif hist_halo:
        raise ValueError(
            f"hist_halo ({hist_halo}) given, but the {rows} query rows span the "
            "image: a halo'd history window needs tile mode")
    for name, ch in (("prev_d", prev_d), ("prev_s", prev_s)):
        if ch.cnt.shape[0] != rows + 2 * hist_halo:
            raise ValueError(f"{name}: a history of {ch.cnt.shape[0]} rows; expected "
                             f"{rows} query rows + 2 × {hist_halo} halo rows")

    def one_set(anchor, prev):
        dyrel, dxrel, w4 = _queries(prev_cam, anchor, ho, fov, H, W, row0=row_base)
        return reproject_set(ho, dyrel, dxrel, w4, prev, K, H, row_base, hist_halo)

    return one_set(hl, prev_d), one_set(sl, prev_s)
