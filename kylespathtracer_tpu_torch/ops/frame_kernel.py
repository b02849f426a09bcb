"""The fused full-frame forward: one CUDA kernel (K1) and its plain version.

Per pixel: raygen → primary analytic intersect → closed-form normal and
curvature → dual-MIS shade (direct light + 4 plane roulettes, about 9
occlusion traces; or the unbiased estimators with `biased=False`) →
emission + primary material. Out: 13 f32 planes + the i32 object ID.

Port of kylespathtracer_tpu/ops/frame_kernel.py. `frame_forward` is the
counterpart of `frame_forward_pallas`: on a CUDA tensor it launches
csrc/frame_kernel.cu, on a CPU tensor it runs `frame_forward_plain`, the
component-plane `frame_block` over the whole image.
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.core.sampler import fold_seed as _fold_seed
from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.ops import shade_kernel as sk
from kylespathtracer_tpu_torch.scene.types import Scene

# Launches of the CUDA kernel by `frame_forward` in this process, and the
# row-mode launches (fewer rows than the image) among them.
LAUNCHES = 0
ROW_LAUNCHES = 0
# csrc/shade_core.cuh MAX_PLANES: the roulette keeps one direction per plane.
MAX_PLANES = 8


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
        c = torch.where(sel, gmath.EPS * inv, c)

    for i in range(nB):
        sel = ho == sc["box_ids"][i, 0]
        q = tuple(hl[k] - sc["boxes"][i, k] for k in range(3))
        d = tuple(q[k].abs() - sc["boxes"][i, 3 + k] for k in range(3))
        m = tuple(torch.clamp(d[k], min=0.0) for k in range(3))
        inv = torch.rsqrt(torch.clamp(sk._dot(m, m), min=1e-12))
        kpos = sum((d[k] > 0.0).to(hl[0].dtype) for k in range(3))
        for k in range(3):
            n[k] = torch.where(sel, m[k] * torch.sign(q[k]) * inv, n[k])
        c = torch.where(
            sel, 0.5 * gmath.EPS * torch.clamp(kpos - 1.0, min=0.0) * inv, c)

    return tuple(n), c


# Ordered names of the 17 scene tables; `small_operands` appends the
# camera loc, orient and the frame index.
SC_KEYS = (
    "planes", "plane_ids", "spheres", "sphere_ids", "boxes", "box_ids",
    "light_color", "light", "light_id_arr", "mat_s0", "mat_s1", "mat_freq",
    "mat_alb_const", "mat_alb_scale", "mat_emission", "mat_en_const",
    "mat_en_scale",
)


def smp_of(config) -> int:
    """The per-strategy sample count from the six SMP_* knobs, which the
    fused frame requires equal and >= 1 (common.glsl:13-24)."""
    smp = config.smp_direct_lambert
    if not (
        smp == config.smp_lambert_surface_lambert
        == config.smp_lambert_surface_phong == config.smp_direct_phong
        == config.smp_phong_surface_lambert == config.smp_phong_surface_phong
    ) or smp < 1:
        raise ValueError(
            "the fused pipeline requires all six smp_* counts equal and >=1 "
            f"(got {smp}, {config.smp_lambert_surface_lambert}, "
            f"{config.smp_lambert_surface_phong}, {config.smp_direct_phong}, "
            f"{config.smp_phong_surface_lambert}, "
            f"{config.smp_phong_surface_phong}); use pipeline='pass' for "
            "per-strategy counts"
        )
    return int(smp)


def _raygen(shape, cam, orient, width, height, fov, row0, device):
    """Pixel grid + primary rays for image rows [row0, row0+shape[0])
    (geometry.frag:38-39,67): aspect-scaled NDC → rsqrt normalize →
    pitch/yaw rotation. Returns (px, py, ro, rd) component planes."""
    rows, cols = shape
    dt = orient.dtype  # float32; float64 for a float64 witness of the frame
    px = torch.arange(cols, dtype=torch.int32, device=device).expand(rows, cols)
    py = (torch.arange(rows, dtype=torch.int32, device=device) + row0)[:, None]
    py = py.expand(rows, cols)
    asp = float(width) / float(height)
    # Divisors as tensors on the device: on the card torch divides by a
    # Python scalar as a multiply by its reciprocal, an ulp off the true
    # quotient the kernels compute (the same on the CPU either way).
    div = lambda n: torch.tensor(float(n), dtype=dt, device=device)
    xf = (2.0 * (px.to(dt) + 0.5) / div(width) - 1.0) * asp
    yf = 2.0 * (py.to(dt) + 0.5) / div(height) - 1.0
    zf = torch.full(shape, float(fov), dtype=dt, device=device)
    inv = torch.rsqrt(xf * xf + yf * yf + zf * zf)
    dx, dy, dz = xf * inv, yf * inv, zf * inv
    cx, sx = torch.cos(orient[0, 0]), torch.sin(orient[0, 0])
    cy, sy = torch.cos(orient[0, 1]), torch.sin(orient[0, 1])
    y2 = dy * cx + dz * sx
    z1 = -dy * sx + dz * cx
    rd = (dx * cy + z1 * sy, y2, -dx * sy + z1 * cy)
    zero = torch.zeros(shape, dtype=dt, device=device)
    ro = tuple(zero + cam[0, k] for k in range(3))
    return px, py, ro, rd


def _wrap32(v: int) -> int:
    """A Python int reduced to the int32 with the same low 32 bits."""
    return (v + 2**31) % 2**32 - 2**31


def frame_block(
    sc, cam, orient, frame: int, row0: int,
    *, counts, nK, gloss, width, height, fov, block_rows, soft_beta=0.0,
    smp=1, decorrelate=False, biased=True,
):
    """The fused frame's per-pixel math on image rows [row0, row0+block_rows)
    of a `height`-tall image, as plain tensor ops → the 14 planes
    (13 f32 + oid i32), each (block_rows, width)."""
    sc = dict(sc)
    sc["nK"] = nK
    device = sc["planes"].device
    shape = (block_rows, width)

    # Pixel grid of this block. Row 0 is the image bottom (GL fragCoord).
    px, py, ro, rd = _raygen(shape, cam, orient, width, height, fov, row0, device)

    # Per-pixel Weyl seed (common.glsl:39-41), all int32 wraparound.
    seed = (
        ((_wrap32(int(frame) << 12) + px) + (py << 1))
        ^ (px * int(height)) ^ (py * int(width))
    )

    # Primary intersect (geometry.frag:67-68) + analytic normal/curvature.
    no_excl = torch.full(shape, -1, dtype=torch.int32, device=device)
    t, oid = sk._trace(sc, ro, rd, no_excl, *counts)
    hit = oid > 0
    hl_n = tuple(ro[k] + rd[k] * t for k in range(3))
    hn, curv = _normal_curv(sc, counts, hl_n, oid)
    zero = torch.zeros_like(t)
    hn = sk._where_v(hit, hn, (zero, zero, zero))

    # Shading point: one more eps back along the ray (geometry.frag:71).
    depth = t - gmath.EPS
    hl = tuple(ro[k] + rd[k] * depth for k in range(3))

    if biased:
        # Dual-MIS estimators averaged over the smp per-strategy samples.
        est_d = [torch.zeros(shape, dtype=torch.float32, device=device) for _ in range(3)]
        est_s = [torch.zeros(shape, dtype=torch.float32, device=device) for _ in range(3)]
        for i in range(smp):
            ed, es = sk._shade_core(
                sc, counts, nK, gloss, hn, rd, oid, hl,
                _fold_seed(seed, i, decorrelate), soft_beta=soft_beta,
            )
            for c in range(3):
                est_d[c] = est_d[c] + ed[c]
                est_s[c] = est_s[c] + es[c]
        if smp > 1:
            inv_smp = 1.0 / float(smp)
            est_d = [e * inv_smp for e in est_d]
            est_s = [e * inv_smp for e in est_s]
    else:
        # Unbiased ground-truth mode (BIASED off, common.glsl:394-415).
        est_d, est_s = sk._shade_core_unbiased(
            sc, counts, gloss, hn, rd, oid, hl, seed, smp, decorrelate
        )

    # Emission + primary material (diffuse.frag:54-56; passthrough.frag:39-41).
    alb, emi, ene = sk._surface(sc, oid, hl, nK)
    shade = (oid != sc["light_id_arr"][0, 0]) & hit

    return (
        *(emi[c] + torch.where(shade, est_d[c], 0.0) for c in range(3)),
        *(emi[c] + torch.where(shade, est_s[c], 0.0) for c in range(3)),
        alb[0], alb[1], alb[2], ene[0], ene[1], depth, curv, oid,
    )


def small_operands(scene: Scene, camera, frame):
    """The 20 small operands: the SC_KEYS tables, then camera loc [1,3],
    orient [1,2] and frame [1,1]. Zero-row geometry tables are padded to
    one dummy row, as the JAX code pads them; the counts taken from the
    scene mean no code reads the dummy."""
    mats = scene.materials
    dev = scene.device

    def pad1(a):
        return a if a.shape[0] else torch.zeros((1,) + a.shape[1:], dtype=a.dtype, device=dev)

    col = lambda a: pad1(a.reshape(-1, 1))
    row = lambda a: a.reshape(1, -1)
    return (
        pad1(scene.planes), col(scene.plane_ids), pad1(scene.spheres),
        col(scene.sphere_ids), pad1(scene.boxes), col(scene.box_ids),
        row(scene.light_color), row(scene.light), scene.light_id.reshape(1, 1),
        col(mats.s0), col(mats.s1), col(mats.freq), mats.alb_const,
        mats.alb_scale, mats.emission, mats.en_const, mats.en_scale,
        row(camera.loc), row(camera.orient),
        torch.tensor([[int(frame)]], dtype=torch.int32, device=dev),
    )


def _counts(scene: Scene):
    return (int(scene.planes.shape[0]), int(scene.spheres.shape[0]),
            int(scene.boxes.shape[0]))


def assemble_planes(outs, H):
    """14 planes → the frame dict, rows cropped to H."""
    crop = lambda a: a[:H]
    return {
        "add_d": torch.stack([crop(o) for o in outs[0:3]], dim=-1),
        "add_s": torch.stack([crop(o) for o in outs[3:6]], dim=-1),
        "alb": torch.stack([crop(o) for o in outs[6:9]], dim=-1),
        "ene": torch.stack([crop(o) for o in outs[9:11]], dim=-1),
        "depth": crop(outs[11]),
        "curv": crop(outs[12]),
        "oid": crop(outs[13]),
    }


def frame_planes(ops, scene: Scene, frame, config, row_base: int = 0,
                 rows: int | None = None):
    """`frame_block` over image rows [row_base, row_base+rows) on the 20
    small operands `ops` (`small_operands` order) → the 14 planes. The
    gradient plain versions (ops/frame_grad.py, ops/loss_kernel.py) pass
    operands that require grad."""
    H = config.height if rows is None else rows
    sc = dict(zip(SC_KEYS, ops[:17]))
    return frame_block(
        sc, ops[17], ops[18], int(frame), int(row_base),
        counts=_counts(scene), nK=int(scene.materials.s0.shape[0]),
        gloss=config.gloss, width=config.width, height=config.height,
        fov=config.fov, block_rows=H, soft_beta=float(config.soft_shadows),
        smp=smp_of(config), decorrelate=bool(config.decorrelate_samples),
        biased=bool(config.biased),
    )


def frame_forward_plain(scene: Scene, camera, frame, config, row_base: int = 0,
                        rows: int | None = None):
    """`frame_block` over image rows [row_base, row_base+rows) as plain
    tensor ops, on the scene's device → the frame dict."""
    H = config.height if rows is None else rows
    ops = small_operands(scene, camera, frame)
    return assemble_planes(frame_planes(ops, scene, frame, config, row_base, H), H)


# The 13 float planes of the frame dict, one (key, channel) per plane.
FLOAT_PLANES = tuple(
    (k, c) for k, n in (("add_d", 3), ("add_s", 3), ("alb", 3), ("ene", 2))
    for c in range(n)
) + (("depth", None), ("curv", None))
# How far the kernel may part from its plain version on the same inputs.
# Both are the same f32 math compiled differently (fma contraction, rsqrt and
# division rounding), which flips a few decisions (hit/miss, roulette
# choice): `oid` may differ on OID_SHARE of the pixels, each float plane may
# have FAR_SHARE of its components beyond its bound (see `disagreement`),
# and the median |Δ| over all planes is at most MEDIAN_ABS.
OID_SHARE = 1e-3
FAR_SHARE = 1e-4
MEDIAN_ABS = 1e-5


def disagreement(out: dict, ref: dict) -> dict:
    """How far two frame dicts part → {"oid": share of pixels whose oid
    differs, "<plane>": share of that plane's components beyond its bound,
    "median", "max_abs": |Δ| over all float planes}. A radiance or material
    component is far beyond 1e-3·max(1,|ref|). depth and curv are
    primary-hit geometry, which no sampled decision touches: on pixels of
    equal oid they are far beyond 1e-4·|ref| + 1e-7 (curv is 1e-3/r on a
    sphere, so a zero curv is far)."""
    same = out["oid"] == ref["oid"]
    stats = {"oid": 1.0 - same.float().mean().item()}
    diffs = []
    for key, c in FLOAT_PLANES:
        a, b = (out[key], ref[key]) if c is None else (out[key][..., c], ref[key][..., c])
        d = (a - b).abs()
        diffs.append(d.reshape(-1))
        if c is None:
            far = same & (d > 1e-4 * b.abs() + 1e-7)
        else:
            far = d > 1e-3 * torch.clamp(b.abs(), min=1.0)
        stats[key if c is None else f"{key}.{c}"] = far.float().mean().item()
    d = torch.cat(diffs)
    stats["median"] = d.median().item()
    stats["max_abs"] = d.max().item()
    return stats


# Relative forward disagreement beyond which `ill_conditioned` flags a pixel.
ILL = 4e-6


def ill_conditioned(out: dict, ref: dict) -> torch.Tensor:
    """bool[H,W]: pixels where two frame dicts of the same inputs part by
    more than ILL·(1+|ref|) on some float plane, or on oid. There a ray
    grazes a surface or a sampling decision sits on a rounding boundary, so
    f32 rounding decides the derivative: a comparison of two gradient
    computations gives these pixels no cotangent."""
    bad = out["oid"] != ref["oid"]
    for key in ("add_d", "add_s", "alb", "ene", "depth", "curv"):
        d = (out[key] - ref[key]).abs() > ILL * (1.0 + ref[key].abs())
        bad = bad | (d.any(-1) if d.ndim == 3 else d)
    return bad


def check_agreement(out: dict, ref: dict, what: str) -> dict:
    """`disagreement` held to OID_SHARE, FAR_SHARE and MEDIAN_ABS; raises
    AssertionError naming every bound broken, else returns the stats."""
    stats = disagreement(out, ref)
    broken = [k for k, v in stats.items()
              if (k == "oid" and v > OID_SHARE) or (k == "median" and v > MEDIAN_ABS)
              or (k not in ("oid", "median", "max_abs") and v > FAR_SHARE)]
    if broken:
        raise AssertionError(f"{what}: the frame kernel parts from its plain "
                             f"version on {broken}: {stats}")
    return stats


def _table_tensors(scene: Scene, camera):
    """The tensors of the scene tables and the camera, in the order of the
    flat tables that csrc/shade_core.cuh `Tables` reads: f32 planes P·4,
    spheres S·4, boxes B·7, light_color 3, light 4, s0 K, s1 K, freq K,
    alb_const K·3, alb_scale K·3, emission K·3, en_const K·2, en_scale K·2,
    cam loc 3, orient 2; i32 plane_ids P, sphere_ids S, box_ids B, light
    id 1."""
    m = scene.materials
    return ((scene.planes, scene.spheres, scene.boxes, scene.light_color,
             scene.light, m.s0, m.s1, m.freq, m.alb_const, m.alb_scale,
             m.emission, m.en_const, m.en_scale, camera.loc, camera.orient),
            (scene.plane_ids, scene.sphere_ids, scene.box_ids,
             scene.light_id.reshape(1)))


def part_sizes(nP: int, nS: int, nB: int, nK: int):
    """Entries of each of `_table_tensors`' tensors for nP planes, nS
    spheres, nB boxes and nK materials (the offsets of `make_tables` in
    csrc/shade_core.cuh are their running sums) → (f32 sizes, i32 sizes)."""
    return ((nP * 4, nS * 4, nB * 7, 3, 4, nK, nK, nK, nK * 3, nK * 3, nK * 3,
             nK * 2, nK * 2, 3, 2), (nP, nS, nB, 1))


def table_parts(scene: Scene, camera):
    """The tensors that every frame-table kernel (K1 and K3-K8) gathers
    into its shared-memory tables (csrc/frame_core.cuh:TableParts) →
    (f32 tensors, i32 tensors), each contiguous, in `_table_tensors`' order.
    Raises unless every tensor has its dtype, the scene's device and the
    size `part_sizes` gives it."""
    f, i = _table_tensors(scene, camera)
    want = part_sizes(*_counts(scene), int(scene.materials.s0.shape[0]))
    device = scene.device
    for tensors, sizes, dtype in ((f, want[0], torch.float32), (i, want[1], torch.int32)):
        for k, (t, n) in enumerate(zip(tensors, sizes)):
            if t.dtype != dtype or t.device != device or t.numel() != n:
                raise ValueError(f"table part {k}: expected {n} {dtype} on {device}, "
                                 f"got {t.numel()} {t.dtype} on {t.device}")
    return [t.contiguous() for t in f], [t.contiguous() for t in i]


def table_parts_struct(f, i) -> bytes:
    """`table_parts`' tensors packed as csrc/frame_core.cuh:TableParts
    (pointers, then lengths), for a kernel entry point's `parts`."""
    return _build.TABLE_PARTS.pack(*(t.data_ptr() for t in f), *(t.data_ptr() for t in i),
                                   *(t.numel() for t in f), *(t.numel() for t in i))


def box_cull_plain(boxes, o, d, tmax):
    """csrc/shade_core.cuh:box_may_hit, the box cull of K1, K4, K7 and K8, on
    tensors: boxes [B,7], ray origins and directions [...,3], tmax [...] →
    bool [...,B], False only where the ray o + t·d, 0 <= t <= tmax, cannot
    meet the rounded box. A slab test against the box's bounds grown by its
    rounding radius and a margin; the kernels skip a culled box's
    candidates."""
    oc = o[..., None, :] - boxes[:, :3]
    dv = d[..., None, :].expand_as(oc)
    h = boxes[:, 3:6] + boxes[:, 6:7]
    m = 1e-3 * h + 1e-5 * oc.abs() + 1e-4
    lo, hi = -h - m - oc, h + m - oc
    flat = dv == 0.0
    inv = 1.0 / torch.where(flat, 1.0, dv)
    ta, tb = lo * inv, hi * inv
    inf = torch.full_like(ta, float("inf"))
    near = torch.where(flat, -inf, torch.minimum(ta, tb))
    far = torch.where(flat, inf, torch.maximum(ta, tb))
    t0 = torch.fmax(torch.zeros_like(tmax)[..., None], near.amax(-1))
    t1 = torch.fmin(tmax[..., None], far.amin(-1))
    outside = (flat & ((lo > 0.0) | (hi < 0.0))).any(-1)
    return ~outside & (t0 <= t1)


def _check_scene(scene: Scene, camera, device):
    m = scene.materials
    for name, t in (
        ("planes", scene.planes), ("spheres", scene.spheres),
        ("boxes", scene.boxes), ("light_color", scene.light_color),
        ("materials.s0", m.s0), ("materials.alb_const", m.alb_const),
        ("camera.loc", camera.loc), ("camera.orient", camera.orient),
    ):
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {device}, got "
                             f"{t.dtype} on {t.device}")
    if scene.planes.shape[1:] != (4,) or scene.spheres.shape[1:] != (4,) \
            or scene.boxes.shape[1:] != (7,) or camera.loc.shape != (3,) \
            or camera.orient.shape != (2,):
        raise ValueError("scene/camera tables have unexpected shapes")
    if scene.spheres.shape[0] < 1:
        raise ValueError("the frame kernel needs the light sphere")
    if scene.planes.shape[0] > MAX_PLANES:
        raise ValueError(f"the frame kernel takes at most {MAX_PLANES} planes")


def forward_only(what: str, plain_route: str, scene: Scene, camera, *more) -> None:
    """Raise if the scene's or the camera's tensors, or `more`, require
    grad: the kernel `what` (and its plain version, which stands in for it
    on the CPU) is forward only, and its output would silently carry no
    gradient. `plain_route` names the differentiable route to take."""
    m = scene.materials
    tensors = (scene.planes, scene.spheres, scene.boxes, scene.light_color, m.s0, m.s1, m.freq, m.alb_const,
               m.alb_scale, m.emission, m.en_const, m.en_scale, m.ior, camera.loc, camera.orient, *more)
    if any(t is not None and t.requires_grad for t in tensors):
        raise ValueError(f"{what} is forward only and an input requires grad; take {plain_route}")


def kernel_args(scene: Scene, camera, config) -> tuple:
    """Raise on what the frame-body kernels (K1 here, K5 in frame_grad.py,
    K6 in loss_kernel.py) do not take; else → their scene and shading
    arguments (nP, nS, nB, nK, width, height, fov) and (smp, decorrelate,
    biased, soft_beta, gloss), in the C entry points' order."""
    _check_scene(scene, camera, scene.device)
    gloss = float(config.gloss)
    if gloss != int(gloss) or gloss < 1:
        raise ValueError(f"the frame kernel needs an integral gloss >= 1 (got {gloss})")
    counts = (*_counts(scene), int(scene.materials.s0.shape[0]),
              int(config.width), int(config.height), float(config.fov))
    shading = (smp_of(config), int(bool(config.decorrelate_samples)),
               int(bool(config.biased)), float(config.soft_shadows), int(gloss))
    return counts, shading


def check_planes_for_biased(scene: Scene, config) -> None:
    """The plane-strategy roulettes need a plane (the JAX code fails too)."""
    if config.biased and scene.planes.shape[0] == 0:
        raise ValueError("the biased estimators need at least one plane")


def frame_forward(scene: Scene, camera, frame, config, row_base: int = 0,
                  rows: int | None = None):
    """Run the fused forward frame → dict of full-frame planes:
    {"add_d","add_s","alb": f32[H,W,3]; "ene": f32[H,W,2];
    "depth","curv": f32[H,W]; "oid": i32[H,W]}.

    `row_base`/`rows` restrict the render to image rows
    [row_base, row_base+rows); NDC and seeds stay those of the full
    `config.height` image. The scene's device picks the route: CUDA
    launches the kernel (or raises), CPU runs `frame_forward_plain`."""
    check_planes_for_biased(scene, config)
    device = scene.device
    if device.type == "cpu":
        return frame_forward_plain(scene, camera, frame, config, row_base, rows)
    launch, out = frame_launch(scene, camera, frame, config, row_base, rows)
    launch()
    return out


def frame_launch(scene: Scene, camera, frame, config, row_base: int = 0,
                 rows: int | None = None):
    """`frame_forward`'s CUDA route in two steps → (launch, out): the
    arguments are checked and the frame dict allocated here; launch()
    launches K1 once into it and counts it. ops/adjoint_variants.py times
    launch() alone beside frame_forward."""
    check_planes_for_biased(scene, config)
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"frame_forward: unsupported device {device}")
    (nP, nS, nB, nK, W, height, fov), shading = kernel_args(scene, camera, config)
    H = height if rows is None else int(rows)
    if H < 1 or W < 1 or row_base < 0 or row_base + H > height:
        raise ValueError(f"rows [{row_base}, {row_base + H}) outside the "
                         f"{height}-row image")
    parts = table_parts(scene, camera)
    out = {k: torch.empty((H, W) + tail, dtype=torch.float32, device=device) for k, tail in (
        ("add_d", (3,)), ("add_s", (3,)), ("alb", (3,)), ("ene", (2,)), ("depth", ()), ("curv", ()))}
    out["oid"] = torch.empty((H, W), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    # launch() reads `parts` and `out` itself, so it keeps alive what the
    # kernel reads and writes after the caller has dropped them.
    def launch():
        global LAUNCHES, ROW_LAUNCHES
        err = _build.load().kpt_frame_forward(
            table_parts_struct(*parts), nP, nS, nB, nK, W, height, fov,
            _wrap32(int(frame)), int(row_base), H, *shading,
            _build.FRAME_OUT.pack(*(t.data_ptr() for t in out.values())), stream,
        )
        _build.check(err, "kpt_frame_forward")
        LAUNCHES += 1
        ROW_LAUNCHES += H != height

    return launch, out
