"""Windowed temporal reprojection: one CUDA kernel (K2) and its plain version,
with or without the split frame's tail.

Port of kylespathtracer_tpu/ops/reproject_kernel.py. Temporal
reprojection only reads near the current pixel, so each 2×2 bilinear
history tap is kept only when its row and column offsets lie inside ±K;
taps beyond restart the history, exactly like an off-screen tap
(common.glsl:673-674). On CUDA tensors `reproject_window` is one launch of
csrc/reproject_kernel.cu for both channel sets, the query head included
(the JAX package runs the head as XLA and the tap sum as one kernel per
set); the kernel reads the previous camera on the device, so the launch
makes no host copy. On CPU tensors it runs the plain version: the query
head `_queries` (render/reproject.py:reproject_query) and the tap sum
`reproject_window_plain`, which the kernel repeats operation for operation.

`reproject_tail` is the split temporal frame from K1's outputs on: the
primary rays (render/camera.py:ray_dirs_window) and both reprojection
anchors (render/passes.py:reprojection_anchors) from K1's depth and
curvature, both reprojections, then per channel set the count floor,
velocity clamp and accumulate (render/passes.py:accumulate) against the
camera's speed, then the ACES composite (render/composite.py:
composite_from) → (image, the new history). On CUDA tensors it is the same
single launch of K2, which builds the rays and anchors in its head and runs
the tail as its epilogue: it reads K1's planes, both cameras, the light and
the histories, and writes the new history and the image and nothing
between; on CPU tensors it runs those plain functions one after another,
the twin the kernel repeats operation for operation.

Tile mode (`image_height`/`row_base`/`hist_halo`, the sharded renderer's,
parallel/shard.py): the queries cover image rows [row_base, row_base+rows)
of an `image_height`-row image, and the history is the window of
rows + 2·hist_halo rows around them that the halo exchange assembles.
"""

from __future__ import annotations

import warnings

import torch

from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.render import reproject as rep_mod
from kylespathtracer_tpu_torch.render.composite import composite_from
from kylespathtracer_tpu_torch.render.passes import Channel, accumulate, reprojection_anchors

# Launches of the CUDA kernel by `reproject_window` and `reproject_tail` in
# this process (one a split frame, both channel sets), the tile-mode
# launches among them, and the launches that built the primary rays and
# both anchors in the kernel and ran the tail (`reproject_tail`; the two
# always engage together).
LAUNCHES = 0
TILE_LAUNCHES = 0
TAIL_LAUNCHES = 0
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


def reproject_frame_plain(prev_cam, hl, sl, ho, prev_d: Channel, prev_s: Channel, fov, K: int, H: int,
                          row_base: int = 0, hist_halo: int = 0):
    """K2's plain version on the tensors' device → ((rgb_d, cnt_d), (rgb_s,
    cnt_s)): per channel set the query head `_queries` and the tap sum
    `reproject_window_plain`, for image rows [row_base, row_base+rows) of an
    H-row image, the history's first row image row row_base - hist_halo."""
    W = ho.shape[1]

    def one_set(anchor, prev):
        dyrel, dxrel, w4 = _queries(prev_cam, anchor, ho, fov, H, W, row0=row_base)
        return reproject_window_plain(ho, dyrel, dxrel, w4, prev, K, H, row_base, hist_halo)

    return one_set(hl, prev_d), one_set(sl, prev_s)


def _window(ho, prev_d: Channel, prev_s: Channel, window: int, image_height: int | None, hist_halo: int):
    """Check the window and the tile of a reprojection → (K, H): the taps'
    reach and the image's rows."""
    rows, W = ho.shape
    tile = image_height is not None and image_height != rows
    H = image_height if tile else rows
    if window > MAX_WINDOW:
        warnings.warn(
            f"reproject window={window} exceeds the reference kernel's "
            f"one-block vertical halo; clamping to {MAX_WINDOW}.",
            stacklevel=3,
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
    if ho.device.type not in ("cpu", "cuda"):
        raise ValueError(f"reproject_window: unsupported device {ho.device}")
    return K, H


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
    """Both reprojections (diffuse anchor hl, specular anchor sl) →
    ((rgb_d, cnt_d), (rgb_s, cnt_s)): on CUDA tensors one launch of K2,
    on CPU tensors the plain version. Taps beyond K = min(window,
    MAX_WINDOW) rows or columns drop their history.

    Full frame by default. `image_height` other than the query rows selects
    tile mode: hl/sl/ho cover image rows [row_base, row_base+rows), and the
    history channels are a window of rows + 2·hist_halo rows whose first
    row is image row row_base - hist_halo. As in the JAX kernel, rows and
    hist_halo must be multiples of BLOCK_ROWS and hist_halo >= K (a smaller
    halo would let taps read past the window); unlike it, a halo on a
    history that spans the image raises, where the JAX kernel ignores the
    halo and reads the window shifted."""
    K, H = _window(ho, prev_d, prev_s, window, image_height, hist_halo)
    if ho.device.type == "cpu":
        return reproject_frame_plain(prev_cam, hl, sl, ho, prev_d, prev_s, fov, K, H, row_base, hist_halo)
    return _launch(prev_cam, hl, sl, ho, prev_d, prev_s, fov, K, H, row_base, hist_halo)[:2]


def reproject_tail(
    scene,
    camera,
    prev_cam,
    out: dict,
    prev_d: Channel,
    prev_s: Channel,
    config,
    image_height: int | None = None,
    row_base: int = 0,
    hist_halo: int = 0,
):
    """The split temporal frame from K1's `out` on, for `camera` (this
    frame's) and `prev_cam` (the history's) → (sRGB image f32[rows,W,3], new
    diffuse Channel, new specular Channel): the anchors of
    render/passes.py:reprojection_anchors (the light is `scene.light`), both
    reprojections (window
    `config.reproject_window`; the tile as in `reproject_window`), each
    accumulated onto this frame's estimate with the velocity clamp of the
    camera's move from prev_cam.loc to camera.loc, then the composite. The
    new channels' oid is out["oid"]. On CUDA tensors one launch of K2,
    which builds the rays and anchors itself; on CPU tensors the plain
    functions."""
    ho = out["oid"]
    K, H = _window(ho, prev_d, prev_s, config.reproject_window, image_height, hist_halo)
    if ho.device.type == "cpu":
        hl, sl = reprojection_anchors(scene, camera, out, config.fov, H, row_base)
        (rgb_d, cnt_d), (rgb_s, cnt_s) = reproject_frame_plain(prev_cam, hl, sl, ho, prev_d, prev_s, config.fov,
                                                               K, H, row_base, hist_halo)
        vv = gmath.length(camera.loc - prev_cam.loc)
        d = accumulate(rgb_d, cnt_d, out["add_d"], vv, ho, config)
        s = accumulate(rgb_s, cnt_s, out["add_s"], vv, ho, config)
        return composite_from(out["alb"], out["ene"], d, s, config), d, s
    (rgb_d, cnt_d), (rgb_s, cnt_s), image = _launch(prev_cam, None, None, ho, prev_d, prev_s, config.fov, K, H,
                                                    row_base, hist_halo, tail=(scene, camera, out, config))
    return image, Channel(rgb=rgb_d, cnt=cnt_d, oid=ho), Channel(rgb=rgb_s, cnt=cnt_s, oid=ho)


def _launch(prev_cam, hl, sl, ho, prev_d: Channel, prev_s: Channel, fov, K: int, H: int, row_base: int,
            hist_halo: int, tail=None):
    """One launch of K2 for both channel sets, after checking every tensor
    it reads; no tensor op, so nothing waits on the device. Without `tail`
    the kernel reads the anchors hl, sl. `tail` (scene, camera, K1's out,
    config) replaces them: the kernel builds them from the camera, the
    scene's light and K1's depth and curvature, and runs the tail; the
    outputs are then the new history, and the image is returned third
    (else None)."""
    global LAUNCHES, TILE_LAUNCHES, TAIL_LAUNCHES
    rows, W = ho.shape
    window = rows + 2 * hist_halo
    device = ho.device
    if row_base < 0 or row_base + rows > H or hist_halo < 0:
        raise ValueError(f"reproject_window: rows [{row_base}, {row_base + rows}) with a "
                         f"{hist_halo}-row halo do not fit a {H}-row image")
    i32, f32 = torch.int32, torch.float32
    _check = _build.check_tensor
    if tail is None:
        _check("hl", hl, f32, (rows, W, 3), device)
        _check("sl", sl, f32, (rows, W, 3), device)
    _check("ho", ho, i32, (rows, W), device)
    _check("prev_cam.loc", prev_cam.loc, f32, (3,), device)
    _check("prev_cam.orient", prev_cam.orient, f32, (2,), device)
    for name, ch in (("prev_d", prev_d), ("prev_s", prev_s)):
        _check(f"{name}.rgb", ch.rgb, f32, (window, W, 3), device)
        _check(f"{name}.cnt", ch.cnt, f32, (window, W), device)
        _check(f"{name}.oid", ch.oid, i32, (window, W), device)
    rgb_d = torch.empty((rows, W, 3), dtype=f32, device=device)
    cnt_d = torch.empty((rows, W), dtype=f32, device=device)
    rgb_s = torch.empty((rows, W, 3), dtype=f32, device=device)
    cnt_s = torch.empty((rows, W), dtype=f32, device=device)
    image = tail_struct = None
    if tail is not None:
        scene, camera, out, config = tail
        _check("camera.loc", camera.loc, f32, (3,), device)
        _check("camera.orient", camera.orient, f32, (2,), device)
        _check("scene.light", scene.light, f32, (4,), device)
        planes = ("depth", "curv", "add_d", "add_s", "alb", "ene")
        for key, n in zip(planes, ((), (), (3,), (3,), (3,), (2,))):
            _check(f"out[{key!r}]", out[key], f32, (rows, W, *n), device)
        image = torch.empty((rows, W, 3), dtype=f32, device=device)
        T = float(config.temporal)
        tail_struct = _build.SPLIT_TAIL.pack(
            *(t.data_ptr() for t in (camera.loc, camera.orient, scene.light, *(out[k] for k in planes), image)),
            T, T * 2.0, T - 1.0, float(config.brightness))
    err = _build.load().kpt_reproject_frame(
        None if hl is None else hl.data_ptr(), None if sl is None else sl.data_ptr(), ho.data_ptr(),
        prev_cam.loc.data_ptr(), prev_cam.orient.data_ptr(),
        *(t.data_ptr() for ch in (prev_d, prev_s) for t in (ch.rgb, ch.cnt, ch.oid)),
        rgb_d.data_ptr(), cnt_d.data_ptr(), rgb_s.data_ptr(), cnt_s.data_ptr(),
        float(fov), W / H, rows, H, W, int(K), int(row_base), int(row_base - hist_halo), tail_struct,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "kpt_reproject_frame")
    LAUNCHES += 1
    if rows != H or hist_halo:
        TILE_LAUNCHES += 1
    TAIL_LAUNCHES += tail is not None
    return (rgb_d, cnt_d), (rgb_s, cnt_s), image
