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


def _assemble(depth, curv, nx, ny, nz, oid) -> dict:
    return {"depth": depth, "curv": curv, "normal": torch.stack([nx, ny, nz], dim=-1), "oid": oid}


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
    return _assemble(t - gmath.EPS, curv, *hn, oid)


def geometry_pass(scene: Scene, camera, frame, config) -> dict:
    """Primary-visibility raycast → the dict of `geometry_pass_plain`. The
    scene's device picks the route: CUDA launches the kernel (or raises),
    CPU runs `geometry_pass_plain`."""
    global LAUNCHES
    device = scene.device
    if device.type == "cpu":
        return geometry_pass_plain(scene, camera, frame, config)
    if device.type != "cuda":
        raise ValueError(f"geometry_pass: unsupported device {device}")
    fk._check_scene(scene, camera, device)
    H, W = int(config.height), int(config.width)
    ftab, itab = fk.pack_tables(scene, camera)
    out_f = torch.empty((5, H, W), dtype=torch.float32, device=device)
    out_oid = torch.empty((H, W), dtype=torch.int32, device=device)
    err = _build.load().kpt_geometry_pass(
        ftab.data_ptr(), itab.data_ptr(), *fk._counts(scene), scene.materials.num_ids,
        W, H, float(config.fov), out_f.data_ptr(), out_oid.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "kpt_geometry_pass")
    LAUNCHES += 1
    return _assemble(*out_f.unbind(0), out_oid)


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
