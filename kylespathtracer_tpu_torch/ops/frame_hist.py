"""The mono temporal frame: one CUDA kernel (K8) and its plain version.

Port of kylespathtracer_tpu/ops/frame_hist.py (`temporal_fusion="mono"`).
The whole history-path frame in one pass:

    raygen → intersect → normals → dual-MIS shade        (frame_block)
    → hit point + curvature-pushed specular anchor        (specular.frag:45-49)
    → previous-camera projection + bounded-window select  (common.glsl:661-694)
    → floor(count) + velocity-adaptive temporal clamp     (diffuse.frag:49-51)
    → history accumulate (rgb + estimator, count + 1)

`frame_hist` launches csrc/frame_hist.cu on CUDA tensors and runs
`frame_hist_plain` on CPU tensors. The query head is the JAX kernel's own,
not the split frame's (`reproject_kernel._queries`): its basis and
normalizations guard with rsqrt(max(·, 1e-20)) and it divides fov by the
denominator first, so the mono and the split frame part by association
ulps, and a tap on a knife edge can flip between them.

Tile mode (`row_base`/`rows`/`hist_halo`, the sharded renderer's,
parallel/shard.py): the frame covers image rows [row_base, row_base+rows),
with the full image's NDC, seeds and projection, and the history channels
are the window of rows + 2·hist_halo rows around them that the halo
exchange assembles.
"""

from __future__ import annotations

import math
import warnings

import torch

from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.ops import shade_kernel as sk
from kylespathtracer_tpu_torch.render.passes import Channel

# Launches of the CUDA kernel by `frame_hist` in this process, and the
# tile-mode launches among them.
LAUNCHES = 0
TILE_LAUNCHES = 0
# How far a kernel's result dict may part from its plain version on the
# same inputs, plane by plane (K8 here, K4's estimator pair too): the same
# f32 math compiled differently flips a few decisions (a tap on a knife
# edge, a count floor, a roulette choice), so the median |Δ| is at most
# MEDIAN_ABS, at most FAR_SHARE of the components lie beyond
# 1e-3·max(1, |ref|), and `oid` differs on at most OID_SHARE of the pixels.
MEDIAN_ABS = 1e-5
FAR_SHARE = 1e-3
OID_SHARE = 1e-3


def auto_block_rows(config, rows: int | None = None, hist_halo: int = 0) -> int:
    """The JAX kernel's row-block height when the caller gives none:
    max(8, min(32, (65536 // (W·4)) & ~7)) rows (8 at 1920 wide, 32 at 64
    wide). In tile mode, unlike the JAX code (which only caps it at `rows`,
    and then may refuse its own choice), the largest multiple of 8 at most
    that which divides both `rows` and `hist_halo`; 8 when none does, which
    the tile checks then refuse."""
    block_rows = max(8, min(32, (65536 // (config.width * 4)) & ~7))
    if rows is None:
        return block_rows
    g = math.gcd(rows, hist_halo)
    return next((b for b in range(min(block_rows, rows) // 8 * 8, 7, -8) if g % b == 0), 8)


def window_k(config, block_rows: int | None = None) -> int:
    """The reprojection window K of the JAX kernel: its history halo is one
    row block, so it clamps the window to the block height (`block_rows`,
    by default `auto_block_rows`), and warns when it clamps."""
    if block_rows is None:
        block_rows = auto_block_rows(config)
    if config.reproject_window > block_rows:
        warnings.warn(
            f"reproject window={config.reproject_window} exceeds the fused "
            f"temporal kernel's one-block halo (block_rows={block_rows}); "
            f"clamping to {block_rows}. Taps beyond it restart the history.",
            stacklevel=3,
        )
    return min(config.reproject_window, block_rows)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """x as a 0-d f32 tensor beside `like`: a numerator that the division
    then rounds once (torch computes `float / tensor` as a reciprocal times
    the float, two roundings)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _prev_basis(prev_orient):
    """The previous camera's basis (frame_hist.py:_prev_basis): lf =
    rotate_xy((0,0,1), orient), r = normalize(cross(lf, up)) =
    (-lf_z, 0, lf_x)/|·|, u = normalize(cross(lf, r)); 0-d tensors."""
    px_, py_ = prev_orient[0, 0], prev_orient[0, 1]
    cx, sx = torch.cos(px_), torch.sin(px_)
    cy, sy = torch.cos(py_), torch.sin(py_)
    lf = (cx * sy, sx, cx * cy)
    rlen = torch.rsqrt(torch.clamp(lf[0] * lf[0] + lf[2] * lf[2], min=1e-20))
    r = (-lf[2] * rlen, torch.zeros_like(rlen), lf[0] * rlen)
    u = (lf[1] * r[2] - lf[2] * r[1], lf[2] * r[0] - lf[0] * r[2], lf[0] * r[1] - lf[1] * r[0])
    u = sk._scale(u, torch.rsqrt(torch.clamp(sk._dot(u, u), min=1e-20)))
    return lf, r, u


def _queries_block(anchor, prev_loc, basis, py, px, width, height, fov):
    """Project the anchor planes into the previous camera
    (frame_hist.py:_queries_block) → (dyrel, dxrel, (wy0, wy1, wx0, wx1))."""
    lf, r, u = basis
    asp = float(width) / float(height)
    nhl = sk._normalize(tuple(prev_loc[0, k] - anchor[k] for k in range(3)))
    denom = sk._dot(nhl, lf)
    denom = torch.where(denom.abs() < 1e-6, 1e-6, denom)
    inv_den = _f32(fov, denom) / denom
    luv_x = sk._dot(nhl, r) * inv_den * (1.0 / asp)
    luv_y = sk._dot(nhl, u) * inv_den
    inside = (luv_x <= 1.0) & (luv_x >= -1.0) & (luv_y <= 1.0) & (luv_y >= -1.0)

    fu = (luv_x * -0.5 + 0.5) * float(width) - 0.5
    fv = (luv_y * -0.5 + 0.5) * float(height) - 0.5
    iu = torch.trunc(fu).to(torch.int32)
    iv = torch.trunc(fv).to(torch.int32)
    du = fu - iu.to(torch.float32)
    dv = fv - iv.to(torch.float32)
    wy0 = torch.where((iv >= 0) & (iv < height), 1.0 - dv, 0.0)
    wy1 = torch.where((iv + 1 >= 0) & (iv + 1 < height), dv, 0.0)
    wx0 = torch.where((iu >= 0) & (iu < width) & inside, 1.0 - du, 0.0)
    wx1 = torch.where((iu + 1 >= 0) & (iu + 1 < width) & inside, du, 0.0)
    return iv - py, iu - px, (wy0, wy1, wx0, wx1)


def _temporal_clamp_block(rgb, cnt, vv, temporal):
    """The velocity-adaptive history clamp in component form
    (frame_hist.py:_temporal_clamp_block; diffuse.frag:49-51)."""
    T = float(temporal)
    lvv = torch.clamp(torch.floor(T * 2.0 * torch.sqrt(vv)), max=T - 1.0)
    limit = T - lvv
    over = cnt > limit
    scale = torch.where(over, limit / torch.clamp(cnt, min=1e-6), 1.0)
    return [c * scale for c in rgb], torch.where(over, limit, cnt)


def tile_window_k(config, block_rows: int | None = None, row_base: int = 0,
                  rows: int | None = None, hist_halo: int = 0) -> int:
    """K for a frame over image rows [row_base, row_base+rows) (`rows` None:
    the full frame) with a ±hist_halo history window, after the JAX
    kernel's argument checks: in tile mode rows and hist_halo multiples of
    the block height, hist_halo >= K (a smaller halo would let taps read
    past the window), and the rows inside the image."""
    if rows is None:
        if row_base or hist_halo:
            raise ValueError("frame_hist: row_base and hist_halo need rows (tile mode)")
        return window_k(config, block_rows)
    if block_rows is None:
        block_rows = auto_block_rows(config, rows, hist_halo)
    K = window_k(config, block_rows)
    if rows % block_rows or hist_halo % block_rows:
        raise ValueError(f"tile mode needs rows ({rows}) and hist_halo ({hist_halo}) "
                         f"divisible by block_rows ({block_rows})")
    if hist_halo < K:
        raise ValueError(f"hist_halo ({hist_halo}) < reprojection window K ({K}): "
                         "cross-tile taps would silently read wrong history rows")
    if row_base < 0 or row_base + rows > config.height:
        raise ValueError(f"rows [{row_base}, {row_base + rows}) outside the {config.height}-row image")
    return K


def _tap_sums(scene, camera, prev_camera, history_d: Channel, history_s: Channel, frame,
              config, K: int, row_base: int = 0, rows: int | None = None, hist_halo: int = 0):
    """The frame's 14 planes over image rows [row_base, row_base+rows), and
    each channel set's windowed tap sum before the count floor →
    (planes, ((rgb_d, cnt_d), (rgb_s, cnt_s)), vv)."""
    H, W = config.height, config.width
    R = H if rows is None else rows
    ops = fk.small_operands(scene, camera, frame)
    sc = dict(zip(fk.SC_KEYS, ops[:17]))
    cam, orient = ops[17], ops[18]
    outs = fk.frame_planes(ops, scene, frame, config, row_base, R)
    depth, curv, oid = outs[11], outs[12], outs[13]

    # Anchors: hit point for diffuse, curvature-pushed virtual-image point
    # for specular, on the frame's own primary rays.
    px, py, ro, rd = fk._raygen((R, W), cam, orient, W, H, config.fov, row_base, depth.device)
    hl = tuple(ro[k] + rd[k] * depth for k in range(3))
    lv = tuple(hl[k] - sc["light"][0, k] for k in range(3))
    light_dist = torch.sqrt(torch.clamp(sk._dot(lv, lv), min=1e-20))
    fac = _f32(gmath.EPS, curv) / torch.sqrt(torch.clamp(curv, min=gmath.EPS))
    push = light_dist * fac
    sl = tuple(hl[k] + rd[k] * push for k in range(3))

    prev_loc = prev_camera.loc.reshape(1, 3)
    dv = tuple(cam[0, k] - prev_loc[0, k] for k in range(3))
    vv = torch.sqrt(torch.clamp(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2], min=0.0))
    basis = _prev_basis(prev_camera.orient.reshape(1, 2))

    def taps(hist, anchor):
        dyrel, dxrel, w4 = _queries_block(anchor, prev_loc, basis, py, px, W, H, config.fov)
        return rk.reproject_window_plain(oid, dyrel, dxrel, w4, hist, K, H, row_base, hist_halo)

    return outs, (taps(history_d, hl), taps(history_s, sl)), vv


def frame_hist_plain(scene, camera, prev_camera, history_d: Channel, history_s: Channel,
                     frame, config, block_rows: int | None = None, row_base: int = 0,
                     rows: int | None = None, hist_halo: int = 0) -> dict:
    """The mono temporal frame as plain tensor ops, on the scene's device →
    {"d_rgb", "s_rgb", "alb": f32[R,W,3]; "d_cnt", "s_cnt": f32[R,W];
    "ene": f32[R,W,2]; "oid": i32[R,W]} over image rows [row_base,
    row_base+R), R = `rows` (tile mode) or the image's height; the history
    channels hold R + 2·hist_halo rows. `block_rows` sets K and the tile
    checks (`tile_window_k`)."""
    K = tile_window_k(config, block_rows, row_base, rows, hist_halo)
    outs, sums, vv = _tap_sums(scene, camera, prev_camera, history_d, history_s, frame, config, K,
                               row_base, rows, hist_halo)

    def accumulate(rgb, cnt, add):
        # floor(cnt + 1e-4): exact counts survive f32 bilinear weights.
        rgb, cnt = _temporal_clamp_block([rgb[..., c] for c in range(3)],
                                         torch.floor(cnt + 1e-4), vv, config.temporal)
        return torch.stack([rgb[c] + add[c] for c in range(3)], dim=-1), cnt + 1.0

    d_rgb, d_cnt = accumulate(*sums[0], outs[0:3])
    s_rgb, s_cnt = accumulate(*sums[1], outs[3:6])
    return {
        "d_rgb": d_rgb, "d_cnt": d_cnt, "s_rgb": s_rgb, "s_cnt": s_cnt,
        "alb": torch.stack(outs[6:9], dim=-1), "ene": torch.stack(outs[9:11], dim=-1),
        "oid": outs[13],
    }


def frame_hist(scene, camera, prev_camera, history_d: Channel, history_s: Channel,
               frame, config, block_rows: int | None = None, row_base: int = 0,
               rows: int | None = None, hist_halo: int = 0) -> dict:
    """One mono temporal frame → the dict of `frame_hist_plain`, over the
    same rows. The scene's device picks the route: CUDA launches the kernel
    (or raises), CPU runs the plain version. Taps beyond
    K = `tile_window_k(config, block_rows, ...)` rows or columns restart the
    history, as in the JAX kernel."""
    fk.check_planes_for_biased(scene, config)
    if scene.device.type == "cpu":
        return frame_hist_plain(scene, camera, prev_camera, history_d, history_s, frame, config,
                                block_rows, row_base, rows, hist_halo)
    launch, out = frame_hist_launch(scene, camera, prev_camera, history_d, history_s, frame, config,
                                    block_rows, row_base, rows, hist_halo)
    launch()
    return out


def frame_hist_launch(scene, camera, prev_camera, history_d: Channel, history_s: Channel,
                      frame, config, block_rows: int | None = None, row_base: int = 0,
                      rows: int | None = None, hist_halo: int = 0):
    """`frame_hist`'s CUDA route in two steps → (launch, out): the arguments
    are checked and the result dict allocated here; launch() launches K8
    once into it and counts it. chip_smoke.py and ops/adjoint_variants.py
    time launch() alone beside frame_hist."""
    fk.check_planes_for_biased(scene, config)
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"frame_hist: unsupported device {device}")
    K = tile_window_k(config, block_rows, row_base, rows, hist_halo)
    (nP, nS, nB, nK, W, height, fov), shading = fk.kernel_args(scene, camera, config)
    H = height if rows is None else int(rows)
    tile = rows is not None
    f32, i32 = torch.float32, torch.int32
    for name, ch in (("history_d", history_d), ("history_s", history_s)):
        _build.check_tensor(f"{name}.rgb", ch.rgb, f32, (H + 2 * hist_halo, W, 3), device)
        _build.check_tensor(f"{name}.cnt", ch.cnt, f32, (H + 2 * hist_halo, W), device)
        _build.check_tensor(f"{name}.oid", ch.oid, i32, (H + 2 * hist_halo, W), device)
    for name, t, n in (("prev_camera.loc", prev_camera.loc, 3), ("prev_camera.orient", prev_camera.orient, 2)):
        _build.check_tensor(name, t, f32, (n,), device)
    parts = fk.table_parts(scene, camera)
    T = float(config.temporal)
    out = {k: torch.empty((H, W) + tail, dtype=f32, device=device) for k, tail in (
        ("d_rgb", (3,)), ("d_cnt", ()), ("s_rgb", (3,)), ("s_cnt", ()), ("alb", (3,)), ("ene", (2,)))}
    out["oid"] = torch.empty((H, W), dtype=i32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch():
        global LAUNCHES, TILE_LAUNCHES
        err = _build.load().kpt_frame_hist(
            fk.table_parts_struct(*parts), prev_camera.loc.data_ptr(),
            prev_camera.orient.data_ptr(), nP, nS, nB, nK, W, height, fov,
            fk._wrap32(int(frame)), *shading, int(K), 1.0 / (float(W) / float(height)), T, T * 2.0, T - 1.0,
            int(row_base), H, int(row_base - hist_halo),
            history_d.rgb.data_ptr(), history_d.cnt.data_ptr(), history_d.oid.data_ptr(),
            history_s.rgb.data_ptr(), history_s.cnt.data_ptr(), history_s.oid.data_ptr(),
            *(out[k].data_ptr() for k in ("d_rgb", "d_cnt", "s_rgb", "s_cnt", "alb", "ene", "oid")),
            stream,
        )
        _build.check(err, "kpt_frame_hist")
        LAUNCHES += 1
        TILE_LAUNCHES += tile

    return launch, out


def check_agreement(out: dict, ref: dict, what: str) -> dict:
    """Two result dicts (f32 planes [H,W] or [H,W,C], optionally an "oid")
    held to MEDIAN_ABS, FAR_SHARE and OID_SHARE channel by channel; raises
    AssertionError naming every broken bound, else → {"<plane>.<c>":
    (median |Δ|, share beyond), "oid": share that differs, "max_abs"}."""
    stats, broken, worst = {}, [], 0.0
    for key, b in ref.items():
        a = out[key]
        if key == "oid":
            stats["oid"] = (a != b).float().mean().item()
            if stats["oid"] > OID_SHARE:
                broken.append("oid")
            continue
        a3, b3 = (a, b) if a.ndim == 3 else (a[..., None], b[..., None])
        for c in range(b3.shape[-1]):
            d = (a3[..., c] - b3[..., c]).abs()
            far = (d > 1e-3 * torch.clamp(b3[..., c].abs(), min=1.0)).float().mean().item()
            name = key if a.ndim == 2 else f"{key}.{c}"
            stats[name] = (d.median().item(), far)
            worst = max(worst, d.max().item())
            if not (stats[name][0] <= MEDIAN_ABS and far <= FAR_SHARE):
                broken.append(name)
    stats["max_abs"] = worst
    if broken:
        raise AssertionError(f"{what}: the kernel parts from its plain version on {broken}: {stats}")
    return stats
