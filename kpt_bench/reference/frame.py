"""The plain reference of the frames and the losses the benchmark checks.

Plain PyTorch, no kernels, no cache. It imports nothing of the program: the
per-pixel frame is a frozen copy of the port's plain frame
(`ops/frame_kernel.frame_block`, with the shade core in `shade.py`), the
windowed reprojection and the temporal tail are frozen copies of the port's
plain versions (`ops/reproject_kernel.reproject_window_plain`, `_queries`;
`render/passes.py`; `render/composite.py`), and the fresh-history composite
is the component-plane copy of `ops/loss_kernel._composite_planes`. All of
them transcribe the reference shaders (common.glsl, geometry.frag,
diffuse.frag, specular.frag, passthrough.frag).

The scene reaches it as numpy tables (`scene_tables`), the camera as
numbers: it takes nothing the program has made. `dtype` is float32 for the
reference and bfloat16 for the control of `correct`.
"""

from __future__ import annotations

import numpy as np
import torch

from kpt_bench.reference import gm
from kpt_bench.reference import shade as sk

# ACES input/output matrices, rows as written (core/color.py).
ACES_IN = ((0.59719, 0.35458, 0.04823), (0.07600, 0.90834, 0.01566), (0.02840, 0.13383, 0.83777))
ACES_OUT = ((1.60475, -0.53108, -0.07367), (-0.10208, 1.10813, -0.00605), (-0.00327, -0.07276, 1.07602))
# The widest reprojection window (ops/reproject_kernel.MAX_WINDOW).
MAX_WINDOW = 8


# ------------------------------------------------------------ the tables

def scene_tables(tree: dict, device, dtype=torch.float32, grad_keys=(), params=None) -> dict:
    """A scene given as numpy tables → the dict `sc` the frame reads, in the
    shapes of the port's `frame_kernel.small_operands` (zero-row geometry
    padded to one unread row). `params` ("spheres", "alb_const" tensors)
    replace those tables; `grad_keys` of them become leaves that require
    grad; the light row is taken from the sphere table."""
    m = tree["materials"]

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    def pad1(a):
        return a if a.shape[0] else torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype, device=device)

    params = params or {}
    spheres = params["spheres"].detach().to(device, dtype) if "spheres" in params else t(tree["spheres"])
    alb_const = params["alb_const"].detach().to(device, dtype) if "alb_const" in params else t(m["alb_const"])
    leaves = {}
    if "spheres" in grad_keys:
        spheres = leaves["spheres"] = spheres.clone().requires_grad_()
    if "alb_const" in grad_keys:
        alb_const = leaves["alb_const"] = alb_const.clone().requires_grad_()
    i32 = torch.int32
    li = int(tree.get("light_index", 0))
    sc = {
        "planes": pad1(t(tree["planes"]).reshape(-1, 4)),
        "plane_ids": pad1(t(tree["plane_ids"], i32).reshape(-1, 1)),
        "spheres": spheres,
        "sphere_ids": t(tree["sphere_ids"], i32).reshape(-1, 1),
        "boxes": pad1(t(tree["boxes"]).reshape(-1, 7)),
        "box_ids": pad1(t(tree["box_ids"], i32).reshape(-1, 1)),
        "light_color": t(tree["light_color"]).reshape(1, 3),
        "light": spheres[li].reshape(1, 4),
        "light_id_arr": t(np.asarray(tree["sphere_ids"])[li], i32).reshape(1, 1),
        "mat_s0": t(m["s0"]).reshape(-1, 1), "mat_s1": t(m["s1"]).reshape(-1, 1),
        "mat_freq": t(m["freq"]).reshape(-1, 1), "mat_alb_const": alb_const,
        "mat_alb_scale": t(m["alb_scale"]), "mat_emission": t(m["emission"]),
        "mat_en_const": t(m["en_const"]), "mat_en_scale": t(m["en_scale"]),
    }
    sc["nK"] = int(np.asarray(m["s0"]).shape[0])
    sc["counts"] = (int(np.asarray(tree["planes"]).reshape(-1, 4).shape[0]),
                    int(np.asarray(tree["spheres"]).shape[0]),
                    int(np.asarray(tree["boxes"]).reshape(-1, 7).shape[0]))
    sc["leaves"] = leaves
    return sc


# ------------------------------------------------------------ the frame

def _normal_curv(sc, counts, hl, ho):
    """Component-plane analytic normal + curvature (scene/normals.py)."""
    nP, nS, nB = counts
    zero = torch.zeros_like(hl[0])
    n = [zero, zero, zero]
    c = zero
    for i in range(nP):
        sel = ho == sc["plane_ids"][i, 0]
        for k in range(3):
            n[k] = torch.where(sel, sc["planes"][i, k], n[k])
    for i in range(nS):
        sel = ho == sc["sphere_ids"][i, 0]
        d = tuple(hl[k] - sc["spheres"][i, k] for k in range(3))
        inv = torch.rsqrt(torch.clamp(sk._dot(d, d), min=1e-12))
        for k in range(3):
            n[k] = torch.where(sel, d[k] * inv, n[k])
        c = torch.where(sel, gm.EPS * inv, c)
    for i in range(nB):
        sel = ho == sc["box_ids"][i, 0]
        q = tuple(hl[k] - sc["boxes"][i, k] for k in range(3))
        d = tuple(q[k].abs() - sc["boxes"][i, 3 + k] for k in range(3))
        m = tuple(torch.clamp(d[k], min=0.0) for k in range(3))
        inv = torch.rsqrt(torch.clamp(sk._dot(m, m), min=1e-12))
        kpos = sum((d[k] > 0.0).to(hl[0].dtype) for k in range(3))
        for k in range(3):
            n[k] = torch.where(sel, m[k] * torch.sign(q[k]) * inv, n[k])
        c = torch.where(sel, 0.5 * gm.EPS * torch.clamp(kpos - 1.0, min=0.0) * inv, c)
    return tuple(n), c


def _raygen(shape, cam, orient, width, height, fov, row0, device):
    """Pixel grid + primary rays for image rows [row0, row0+shape[0])
    (geometry.frag:38-39,67) → (px, py, ro, rd) component planes."""
    rows, cols = shape
    dt = orient.dtype
    px = torch.arange(cols, dtype=torch.int32, device=device).expand(rows, cols)
    py = (torch.arange(rows, dtype=torch.int32, device=device) + row0)[:, None].expand(rows, cols)
    asp = float(width) / float(height)
    div = lambda n: torch.tensor(float(n), dtype=dt, device=device)
    xf = (2.0 * (px.to(dt) + 0.5) / div(width) - 1.0) * asp
    yf = 2.0 * (py.to(dt) + 0.5) / div(height) - 1.0
    zf = torch.full(shape, float(fov), dtype=dt, device=device)
    inv = torch.rsqrt(xf * xf + yf * yf + zf * zf)
    dx, dy, dz = xf * inv, yf * inv, zf * inv
    cx, sx = torch.cos(orient[0]), torch.sin(orient[0])
    cy, sy = torch.cos(orient[1]), torch.sin(orient[1])
    y2 = dy * cx + dz * sx
    z1 = -dy * sx + dz * cx
    rd = (dx * cy + z1 * sy, y2, -dx * sy + z1 * cy)
    zero = torch.zeros(shape, dtype=dt, device=device)
    ro = tuple(zero + cam[k] for k in range(3))
    return px, py, ro, rd


def _wrap32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def frame_planes(sc, cam, orient, frame: int, rc: dict, row0: int = 0, rows: int | None = None):
    """The fused frame's per-pixel math on image rows [row0, row0+rows) →
    dict of planes: add_d, add_s, alb (3-tuples), ene (2-tuple), depth,
    curv, oid. `rc` holds width, height, fov, gloss, smp, biased,
    decorrelate_samples, soft_shadows. `cam`, `orient` are 1-D tensors."""
    counts, nK = sc["counts"], sc["nK"]
    width, height = int(rc["width"]), int(rc["height"])
    rows = height if rows is None else rows
    device = sc["planes"].device
    dt = sc["planes"].dtype
    shape = (rows, width)
    px, py, ro, rd = _raygen(shape, cam, orient, width, height, rc["fov"], row0, device)
    if isinstance(frame, torch.Tensor):
        # A batch of frames [B] over the same pixels: the seeds, and all that
        # the shade computes from them, gain a leading axis; the primary hit
        # does not depend on the frame. The same elementwise math as a frame
        # rendered alone (to rounding: broadcast operands may take other
        # vector paths). Frames below 2**19, whose << 12 stays in int32.
        f = frame.to(torch.int32).reshape(-1, 1, 1) << 12
        seed = ((f + px) + (py << 1)) ^ (px * height) ^ (py * width)
    else:
        seed = ((_wrap32(int(frame) << 12) + px) + (py << 1)) ^ (px * height) ^ (py * width)

    no_excl = torch.full(shape, -1, dtype=torch.int32, device=device)
    t, oid = sk._trace(sc, ro, rd, no_excl, *counts)
    hit = oid > 0
    hl_n = tuple(ro[k] + rd[k] * t for k in range(3))
    hn, curv = _normal_curv(sc, counts, hl_n, oid)
    zero = torch.zeros_like(t)
    hn = sk._where_v(hit, hn, (zero, zero, zero))
    depth = t - gm.EPS
    hl = tuple(ro[k] + rd[k] * depth for k in range(3))

    smp, gloss = int(rc["smp"]), rc["gloss"]
    decorrelate = bool(rc.get("decorrelate_samples", False))
    if rc["biased"]:
        est_d = [torch.zeros(shape, dtype=dt, device=device) for _ in range(3)]
        est_s = [torch.zeros(shape, dtype=dt, device=device) for _ in range(3)]
        for i in range(smp):
            ed, es = sk._shade_core(sc, counts, nK, gloss, hn, rd, oid, hl,
                                    gm.fold_seed(seed, i, decorrelate),
                                    soft_beta=float(rc["soft_shadows"]))
            for c in range(3):
                est_d[c] = est_d[c] + ed[c]
                est_s[c] = est_s[c] + es[c]
        if smp > 1:
            est_d = [e * (1.0 / smp) for e in est_d]
            est_s = [e * (1.0 / smp) for e in est_s]
    else:
        est_d, est_s = sk._shade_core_unbiased(sc, counts, gloss, hn, rd, oid, hl, seed, smp, decorrelate)

    alb, emi, ene = sk._surface(sc, oid, hl, nK)
    shade = (oid != sc["light_id_arr"][0, 0]) & hit
    return {
        "add_d": tuple(emi[c] + torch.where(shade, est_d[c], 0.0) for c in range(3)),
        "add_s": tuple(emi[c] + torch.where(shade, est_s[c], 0.0) for c in range(3)),
        "alb": alb, "ene": ene, "depth": depth, "curv": curv, "oid": oid,
    }


# ------------------------------------------------------- fresh-history image

def _mat3_planes(v, m):
    x, y, z = v
    return tuple(x * m[r][0] + y * m[r][1] + z * m[r][2] for r in range(3))


def fresh_image_planes(out: dict, brightness: float):
    """The single-frame image (both counts 1; the `no_history` frame) as three
    planes: composite, ACES, clamp, linear → sRGB (passthrough.frag:29-47)."""
    alb, ene, add_d, add_s = out["alb"], out["ene"], out["add_d"], out["add_s"]
    lin = []
    for c in range(3):
        pos = alb[c] > 0.0
        alb_sqrt = torch.where(pos, torch.sqrt(torch.where(pos, alb[c], 1.0)), 0.0)
        lin.append((add_d[c] * alb[c] * ene[0] + add_s[c] * alb_sqrt * ene[1]) * brightness)
    cpl = _mat3_planes(lin, ACES_IN)
    rat = []
    for c in range(3):
        a = cpl[c] * (cpl[c] + 0.0245786) - 0.000090537
        b = cpl[c] * (0.983729 * cpl[c] + 0.4329510) + 0.238081
        rat.append(a / b)
    cpl = _mat3_planes(rat, ACES_OUT)
    img = []
    for c in range(3):
        x = torch.clamp(cpl[c], 0.0, 1.0)
        hi = 1.055 * torch.pow(torch.clamp(x, min=1e-10), 1.0 / 2.4) - 0.055
        img.append(torch.where(x <= 0.0031308, 12.92 * x, hi))
    return img


@torch.no_grad()
def fresh_image(sc, cam, orient, frame, rc: dict, block_rows: int = 270) -> torch.Tensor:
    """The single-frame sRGB image f32[H,W,3], rendered in blocks of rows;
    for a tensor of B frames, the B images f32[B,H,W,3]."""
    end = int(rc["height"])
    parts = []
    for r0 in range(0, end, block_rows):
        n = min(block_rows, end - r0)
        img = fresh_image_planes(frame_planes(sc, cam, orient, frame, rc, r0, n), float(rc["brightness"]))
        parts.append(torch.stack(torch.broadcast_tensors(*img), dim=-1).float())
    return torch.cat(parts, dim=-3)


def mse_loss_and_grad(sc, cam, orient, frame: int, rc: dict, target: torch.Tensor,
                      block_rows: int = 135, row_range=None):
    """mean((image - target)**2) over H·W·3 and its gradient in the leaves of
    `sc` (scene_tables' grad_keys), by autograd through the plain frame in
    blocks of rows: the loss is a sum over pixels, so the blocks' gradients
    add up → (loss f32, {key: grad f32}). `row_range` (start, stop) sums
    over those image rows alone, still over H·W·3."""
    H, W = int(rc["height"]), int(rc["width"])
    n = float(H * W * 3)
    first, stop = (0, H) if row_range is None else row_range
    keys = list(sc["leaves"])
    leaves = [sc["leaves"][k] for k in keys]
    total = torch.zeros((), dtype=torch.float64, device=target.device)
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    for r0 in range(first, stop, block_rows):
        rows = min(block_rows, stop - r0)
        with torch.enable_grad():
            img = fresh_image_planes(frame_planes(sc, cam, orient, frame, rc, r0, rows), float(rc["brightness"]))
            tgt = target[r0:r0 + rows]
            part = sum(((img[c] - tgt[..., c].to(img[c].dtype)) ** 2).sum() for c in range(3)) / n
            g = torch.autograd.grad(part, leaves, allow_unused=True)
        total += part.detach().double()
        for acc, gi in zip(grads, g):
            if gi is not None:
                acc += gi.float()
    return total.float(), dict(zip(keys, grads))


# --------------------------------------------------- the temporal frame

def ray_dirs(cam_orient, width: int, height: int, fov: float, device, dtype) -> torch.Tensor:
    """Primary ray directions f32[H, W, 3] (render/camera.ray_dirs)."""
    asp = width / height
    ar = lambda n: torch.arange(n, dtype=dtype, device=device)
    div = lambda n: torch.tensor(float(n), dtype=dtype, device=device)
    x = (2.0 * (ar(width) + 0.5) / div(width) - 1.0) * asp
    y = 2.0 * (ar(height) + 0.5) / div(height) - 1.0
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    ndca = torch.stack([gx, gy], dim=-1)
    d = torch.cat([ndca, torch.full_like(ndca[..., :1], fov)], dim=-1)
    return gm.rotate_xy(gm.normalize_fast(d), cam_orient)


def _reproject_query(prev_loc, prev_orient, hl, fov, H, W):
    """Project anchors into the previous camera → (iuv, duv, inside)
    (common.glsl:661-677; render/reproject.reproject_query)."""
    asp = W / H
    vec = lambda *v: torch.tensor(v, dtype=hl.dtype, device=hl.device)
    lf = gm.rotate_xy(vec(0.0, 0.0, 1.0), prev_orient)
    r = gm.normalize(gm.cross(lf, vec(0.0, 1.0, 0.0)))
    u = gm.normalize(gm.cross(lf, r))
    nhl = gm.normalize(prev_loc - hl)
    denom = gm.dot(nhl, lf)
    denom = torch.where(denom.abs() < 1e-6, 1e-6, denom)
    luv = torch.stack([gm.dot(nhl, r), gm.dot(nhl, u)], dim=-1)
    luv = luv / denom[..., None] * fov / vec(asp, 1.0)
    inside = ((luv <= 1.0) & (luv >= -1.0)).all(dim=-1)
    fuv = (luv * -0.5 + 0.5) * vec(W, H) - 0.5
    iuv = torch.trunc(fuv).to(torch.int32)
    return iuv, fuv - iuv, inside


def _queries(prev_loc, prev_orient, anchor, ho, fov, H, W):
    """Per-pixel tap offsets and separable bilinear weights
    (ops/reproject_kernel._queries)."""
    iuv, duv, inside = _reproject_query(prev_loc, prev_orient, anchor, fov, H, W)
    dev = anchor.device
    gy = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    gx = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    ix, iy = iuv[..., 0], iuv[..., 1]
    dx, dy = duv[..., 0], duv[..., 1]
    wy0 = torch.where((iy >= 0) & (iy < H), 1.0 - dy, 0.0)
    wy1 = torch.where((iy + 1 >= 0) & (iy + 1 < H), dy, 0.0)
    wx0 = torch.where((ix >= 0) & (ix < W) & inside, 1.0 - dx, 0.0)
    wx1 = torch.where((ix + 1 >= 0) & (ix + 1 < W) & inside, dx, 0.0)
    return iy - gy, ix - gx, (wy0, wy1, wx0, wx1)


def _reproject_window(ho, dyrel, dxrel, w4, prev: dict, K: int):
    """The windowed 2×2 tap sum with per-tap object-ID rejection; taps beyond
    ±K rows or columns restart the history (ops/reproject_kernel
    .reproject_window_plain, full frame)."""
    H, W = ho.shape
    wy, wx = w4[0:2], w4[2:4]
    gy = torch.arange(H, device=ho.device)[:, None]
    gx = torch.arange(W, device=ho.device)[None, :]
    dyl, dxl = dyrel.long(), dxrel.long()
    rgb = torch.zeros((H, W, 3), dtype=prev["rgb"].dtype, device=ho.device)
    cnt = torch.zeros((H, W), dtype=prev["cnt"].dtype, device=ho.device)
    for tx in (0, 1):
        for ty in (0, 1):
            o, l = dyl + ty, dxl + tx
            sy, sx = gy + o, gx + l
            live = (o >= -K) & (o <= K) & (l >= -K) & (l <= K)
            live = live & (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
            sy, sx = sy.clamp(0, H - 1), sx.clamp(0, W - 1)
            live = live & (prev["oid"][sy, sx] == ho)
            w = torch.where(live, wy[ty] * wx[tx], 0.0)
            rgb = rgb + w[..., None] * prev["rgb"][sy, sx]
            cnt = cnt + w * prev["cnt"][sy, sx]
    return rgb, cnt


def _accumulate(rgb, cnt, add, vv, oid, temporal: int) -> dict:
    """Count floor, velocity clamp, plus this frame's sample
    (diffuse.frag:46-56; render/passes.py)."""
    cnt = torch.floor(cnt + 1e-4)
    T = float(temporal)
    lvv = torch.clamp(torch.floor(T * 2.0 * torch.sqrt(vv)), max=T - 1.0)
    limit = T - lvv
    over = cnt > limit
    scale = torch.where(over, limit / torch.clamp(cnt, min=1e-6), 1.0)
    rgb, cnt = rgb * scale[..., None], torch.where(over, limit, cnt)
    return {"rgb": rgb + add, "cnt": cnt + 1.0, "oid": oid}


def _aces_srgb(img: torch.Tensor) -> torch.Tensor:
    def mat3(v, m):
        x, y, z = v[..., 0], v[..., 1], v[..., 2]
        return torch.stack([x * m[r][0] + y * m[r][1] + z * m[r][2] for r in range(3)], dim=-1)

    c = mat3(img, ACES_IN)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    x = torch.clamp(mat3(a / b, ACES_OUT), 0.0, 1.0)
    hi = 1.055 * torch.pow(torch.clamp(x, min=1e-10), 1.0 / 2.4) - 0.055
    return torch.where(x <= 0.0031308, 12.92 * x, hi)


def _composite(alb, ene, d: dict, s: dict, brightness: float) -> torch.Tensor:
    """render/composite.composite_from: accumulators × the primary surface,
    averaged by count, ACES, sRGB."""
    pos = alb > 0.0
    alb_sqrt = torch.where(pos, torch.sqrt(torch.where(pos, alb, 1.0)), 0.0)
    img = (d["rgb"] * alb * ene[..., 0:1] / torch.clamp(torch.floor(d["cnt"]), min=1.0)[..., None]
           + s["rgb"] * alb_sqrt * ene[..., 1:2] / torch.clamp(torch.floor(s["cnt"]), min=1.0)[..., None])
    return _aces_srgb(img * brightness)


@torch.no_grad()
def temporal_frame(sc, cam_loc, cam_orient, prev: dict, frame: int, rc: dict):
    """One split temporal frame (render/pipeline.split_temporal_frame: the
    frame, both windowed reprojections, the tail) from the previous history
    `prev` = {"d": {rgb, cnt, oid}, "s": {...}, "loc", "orient"} →
    (sRGB image [H,W,3], the new history in the same form)."""
    H, W = int(rc["height"]), int(rc["width"])
    dt = sc["planes"].dtype
    out = frame_planes(sc, cam_loc, cam_orient, frame, rc)
    st = lambda planes: torch.stack(list(planes), dim=-1)
    rd = ray_dirs(cam_orient, W, H, rc["fov"], cam_loc.device, dt)
    hl = cam_loc + rd * out["depth"][..., None]
    light = sc["light"][0]
    fac = gm.EPS / torch.sqrt(torch.clamp(out["curv"], min=gm.EPS))
    sl = hl + rd * (gm.length(hl - light[:3]) * fac)[..., None]
    vv = gm.length(cam_loc - prev["loc"])
    K = min(int(rc["reproject_window"]), MAX_WINDOW)
    ho = out["oid"]
    new = {"loc": cam_loc, "orient": cam_orient}
    for key, anchor, add in (("d", hl, st(out["add_d"])), ("s", sl, st(out["add_s"]))):
        dyrel, dxrel, w4 = _queries(prev["loc"], prev["orient"], anchor, ho, rc["fov"], H, W)
        rgb, cnt = _reproject_window(ho, dyrel, dxrel, w4, prev[key], K)
        new[key] = _accumulate(rgb, cnt, add, vv, ho, int(rc["temporal"]))
    image = _composite(st(out["alb"]), st(out["ene"]), new["d"], new["s"], float(rc["brightness"]))
    return image, new
