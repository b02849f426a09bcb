"""The geometry pass (primary-visibility raycast): one CUDA kernel (K3) and
its plain version.

Port of kylespathtracer_tpu/ops/frame_kernel.py:geometry_pass_pallas (body
`_geometry_kernel`): raygen + nearest analytic hit + closed-form normal and
curvature, nothing else → depth (t - eps), curv, normal (zero on a miss)
and oid. On a CUDA tensor `geometry_pass` launches
csrc/geometry_kernel.cu; on a CPU tensor it runs `geometry_pass_plain`.
A miss gives the trace's (ZFAR, 0): depth ZFAR - eps, as in the JAX kernel
and in render/gbuffer.py.
"""

from __future__ import annotations

import functools

import torch

from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import shade_kernel as sk
from kylespathtracer_tpu_torch.scene.types import Scene

# Launches of the CUDA kernel by `geometry_pass` in this process.
LAUNCHES = 0
# How far the kernel may part from its plain version on the same inputs: oid
# may differ on OID_SHARE of the pixels (a ray that grazes a surface); on
# equal oid, depth and curv within REL·|ref| + 1e-7; the normal within
# NORMAL_ABS where the depths agree to GRAZE·|ref| (where they part, the ray
# grazes the surface and the hit, and its normal, slide along it, which the
# depth bound holds); misses (oid 0 on both sides) bitwise. The two part at
# all because torch divides by a Python scalar as a multiplication by its
# reciprocal on the card, which moves the raygen's NDC by an ulp.
OID_SHARE = 1e-3
REL = 1e-4
NORMAL_ABS = 1e-5
GRAZE = 1e-6


def geometry_pass_plain(scene: Scene, camera, frame, config) -> dict:
    """`_geometry_kernel`'s body as component-plane tensor ops over the
    whole image, on the scene's device → {"depth", "curv": f32[H,W];
    "normal": f32[H,W,3]; "oid": i32[H,W]}. `frame` is not read (the JAX
    kernel takes it as an operand only)."""
    del frame
    H, W = config.height, config.width
    ops = fk.small_operands(scene, camera, 0)
    sc = dict(zip(fk.SC_KEYS, ops[:17]))
    _, _, ro, rd = fk._raygen((H, W), ops[17], ops[18], W, H, config.fov, 0, scene.device)
    counts = fk._counts(scene)
    no_excl = torch.full((H, W), -1, dtype=torch.int32, device=scene.device)
    t, oid = sk._trace(sc, ro, rd, no_excl, *counts)
    hit = oid > 0
    hl = tuple(ro[k] + rd[k] * t for k in range(3))
    hn, curv = fk._normal_curv(sc, counts, hl, oid)
    zero = torch.zeros_like(t)
    hn = sk._where_v(hit, hn, (zero, zero, zero))
    return {"depth": t - gmath.EPS, "curv": curv, "normal": torch.stack(hn, dim=-1), "oid": oid}


def geometry_pass(scene: Scene, camera, frame, config) -> dict:
    """Primary-visibility raycast → the dict of `geometry_pass_plain`. The
    scene's device picks the route: CUDA launches the kernel once (or
    raises), CPU runs `geometry_pass_plain`. Forward only: an input that
    requires grad raises (render/gbuffer.geometry_pass differentiates)."""
    fk.forward_only("the geometry kernel (K3)", "render/gbuffer.geometry_pass", scene, camera)
    if scene.device.type == "cpu":
        return geometry_pass_plain(scene, camera, frame, config)
    launch, out = geometry_launch(scene, camera, frame, config)
    launch()
    return out


def geometry_launch(scene: Scene, camera, frame, config):
    """`geometry_pass`'s CUDA route in two steps → (launch, out): the
    arguments are checked, the scene's table tensors gathered and the dict
    allocated here; launch() launches K3 once into it and counts it.
    ops/adjoint_variants.py times launch() alone beside geometry_pass.
    `frame` is not read."""
    del frame
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"geometry_pass: unsupported device {device}")
    fk._check_scene(scene, camera, device)
    H, W = int(config.height), int(config.width)
    if H < 1 or W < 1:
        raise ValueError(f"geometry_pass: empty image {W}x{H}")
    parts = fk.table_parts(scene, camera)
    counts = (*fk._counts(scene), int(scene.materials.s0.shape[0]))
    out = {"depth": torch.empty((H, W), dtype=torch.float32, device=device),
           "curv": torch.empty((H, W), dtype=torch.float32, device=device),
           "normal": torch.empty((H, W, 3), dtype=torch.float32, device=device),
           "oid": torch.empty((H, W), dtype=torch.int32, device=device)}
    args = (fk.table_parts_struct(*parts), *counts, W, H, float(config.fov),
            _build.GEO_OUT.pack(*(t.data_ptr() for t in out.values())),
            torch.cuda.current_stream(device).cuda_stream)
    return functools.partial(_launch, _build.load().kpt_geometry_pass, args, parts, out), out


def _launch(kernel, args, *held) -> None:
    """One launch of K3 with `args`, counted; `held` are the tensors whose
    addresses `args` carries, which the launch keeps alive."""
    global LAUNCHES
    _build.check(kernel(*args), "kpt_geometry_pass")
    LAUNCHES += 1


def near_a_box_plain(boxes, o, d):
    """csrc/geometry_kernel.cu:near_a_box with its box_sphere, box by box,
    on tensors: boxes [B,7], ray origins and unit directions [...,3] → bool
    [...,B], False only where the ray passes far from the bounding sphere
    of the box grown past box_may_hit's slab (frame_kernel.box_cull_plain),
    which then rules the box out for any tmax."""
    oc = boxes[:, :3] - o[..., None, :]
    dv = d[..., None, :]
    g = 1.01 * (boxes[:, 3:6] + boxes[:, 6:7]) + 1e-3 * oc.abs() + 1e-3
    r2 = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]
    b = oc[..., 0] * dv[..., 0] + oc[..., 1] * dv[..., 1] + oc[..., 2] * dv[..., 2]
    c = oc[..., 0] * oc[..., 0] + oc[..., 1] * oc[..., 1] + oc[..., 2] * oc[..., 2]
    behind = (b < 0.0) & (b * b > r2)
    wide = c - b * b > r2 + 1e-4 * c
    return ~(behind | wide)


def box_work_plain(scene: Scene, camera, config) -> dict:
    """How much of the rounded boxes' code K3 runs on this image, from the
    plain mirrors of its two tests → {"pixels"; "near": the rays that
    `near_a_box_plain` passes for some box, each of which runs the slab
    test (`frame_kernel.box_cull_plain`) on every box; "boxes": the (ray,
    box) pairs of those rays that the slab test passes with tmax the
    nearest plane or sphere hit, each of which runs the box's 26
    candidates}. tmax is the plain trace's pulled t plus EPS (no hit: no
    bound), which may part from the kernel's by the pull's rounding."""
    H, W = config.height, config.width
    ops = fk.small_operands(scene, camera, 0)
    sc = dict(zip(fk.SC_KEYS, ops[:17]))
    _, _, ro, rd = fk._raygen((H, W), ops[17], ops[18], W, H, config.fov, 0, scene.device)
    nP, nS, _ = fk._counts(scene)
    no_excl = torch.full((H, W), -1, dtype=torch.int32, device=scene.device)
    t, oid = sk._trace(sc, ro, rd, no_excl, nP, nS, 0)
    tmax = torch.where(oid > 0, t + gmath.EPS, torch.full_like(t, float("inf")))
    o, d = torch.stack(ro, -1), torch.stack(rd, -1)
    near = near_a_box_plain(scene.boxes, o, d).any(-1)
    boxes = fk.box_cull_plain(scene.boxes, o, d, tmax) & near[..., None]
    return {"pixels": H * W, "near": int(near.sum().item()), "boxes": int(boxes.sum().item())}


def disagreement(out: dict, ref: dict) -> dict:
    """How far two geometry dicts part → {"oid": share of pixels whose oid
    differs; "depth", "curv": largest |Δ|/(|ref| + 1e-7/REL) on equal oid;
    "normal": largest |Δ| on equal oid where the depths agree to GRAZE,
    "normal_all" on every equal-oid pixel, "grazing": the share of pixels
    left out of "normal"; "miss_bitwise": whether every plane is bitwise
    equal on the pixels both sides miss}."""
    same = out["oid"] == ref["oid"]
    miss = same & (ref["oid"] == 0)
    stats = {"oid": 1.0 - same.float().mean().item()}
    for key in ("depth", "curv"):
        d = (out[key] - ref[key]).abs() / (ref[key].abs() + 1e-7 / REL)
        stats[key] = d[same].max().item() if same.any() else 0.0
    dn = (out["normal"] - ref["normal"]).abs().amax(-1)
    steady = same & ((out["depth"] - ref["depth"]).abs() <= GRAZE * ref["depth"].abs())
    stats["normal"] = dn[steady].max().item() if steady.any() else 0.0
    stats["normal_all"] = dn[same].max().item() if same.any() else 0.0
    stats["grazing"] = (same & ~steady).float().mean().item()
    stats["miss_bitwise"] = all(
        torch.equal(out[k][miss], ref[k][miss]) for k in ("depth", "curv", "normal"))
    return stats


def check_agreement(out: dict, ref: dict, what: str) -> dict:
    """`disagreement` held to OID_SHARE, REL, NORMAL_ABS and bitwise misses;
    raises AssertionError naming every bound broken, else returns the stats."""
    stats = disagreement(out, ref)
    broken = [k for k, bar in (("oid", OID_SHARE), ("depth", REL), ("curv", REL),
                               ("normal", NORMAL_ABS)) if not stats[k] <= bar]
    if not stats["miss_bitwise"]:
        broken.append("miss_bitwise")
    if broken:
        raise AssertionError(f"{what}: the geometry kernel parts from its plain "
                             f"version on {broken}: {stats}")
    return stats
