"""Closed-form ray intersection with planes, spheres and rounded boxes.

Port of kylespathtracer_tpu/scene/intersect.py. Hit semantics mirror the
reference's march (common.glsl:283-295): t is pulled back by eps from the
exact surface, misses return (ZFAR, 0), and later primitives win ties.
Gradients use the march's implicit-function-theorem backward
(scene/sdf.py:ift_backward), through `sdf.IntersectFunction`.
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.scene import sdf as sdf_mod
from kylespathtracer_tpu_torch.scene.types import Scene

_INF = 1e9


def _safe(x: torch.Tensor) -> torch.Tensor:
    """x with |x| < 1e-12 replaced by 1e-12 (a divisor guard)."""
    return torch.where(x.abs() < 1e-12, 1e-12, x)


def _plane_hits(scene: Scene, ro, rd):
    """t to each plane from its positive side; (..., P)."""
    n = scene.planes[:, :3]
    w = scene.planes[:, 3]
    denom = (rd[..., None, :] * n).sum(-1)
    sd0 = (ro[..., None, :] * n).sum(-1) + w
    t = -sd0 / _safe(denom)
    valid = (denom < -1e-7) & (t > 0)
    return torch.where(valid, t, _INF)


def _sphere_hits(scene: Scene, ro, rd, inside_hits: bool):
    """Nearest positive root of each sphere; (..., S). With `inside_hits`
    a ray starting inside a sphere takes the far root (the exit point)."""
    c = scene.spheres[:, :3]
    r = scene.spheres[:, 3]
    oc = ro[..., None, :] - c
    b = (oc * rd[..., None, :]).sum(-1)
    c2 = (oc * oc).sum(-1) - r * r
    disc = b * b - c2
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_near = -b - sq
    t = torch.where(t_near > 0, t_near, -b + sq) if inside_hits else t_near
    valid = (disc > 0) & (t > 0)
    return torch.where(valid, t, _INF)


def _box_hits(scene: Scene, ro, rd):
    """Rounded boxes as the Minkowski sum of the core box and a sphere: 6
    face rectangles, 12 edge quarter-cylinders and 8 corner octants, each
    with its region mask, min-reduced; (..., B)."""
    half = scene.boxes[:, 3:6]
    rnd = scene.boxes[:, 6]
    o = ro[..., None, :] - scene.boxes[:, :3]
    d = rd[..., None, :].expand(o.shape)
    best = torch.full(o.shape[:-1], _INF, dtype=ro.dtype, device=ro.device)

    def consider(best, t, valid):
        return torch.minimum(best, torch.where(valid & (t > 0), t, _INF))

    for k in range(3):
        j1, j2 = (k + 1) % 3, (k + 2) % 3
        dk = _safe(d[..., k])
        for s in (1.0, -1.0):
            t = (s * (half[:, k] + rnd) - o[..., k]) / dk
            p1 = o[..., j1] + d[..., j1] * t
            p2 = o[..., j2] + d[..., j2] * t
            best = consider(best, t, (p1.abs() <= half[:, j1]) & (p2.abs() <= half[:, j2]))

    for k in range(3):
        i, j = (k + 1) % 3, (k + 2) % 3
        di, dj = d[..., i], d[..., j]
        a = torch.clamp(di * di + dj * dj, min=1e-12)
        for si in (1.0, -1.0):
            for sj in (1.0, -1.0):
                oi = o[..., i] - si * half[:, i]
                oj = o[..., j] - sj * half[:, j]
                b = oi * di + oj * dj
                cq = oi * oi + oj * oj - rnd * rnd
                disc = b * b - a * cq
                t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / a
                pk = o[..., k] + d[..., k] * t
                best = consider(best, t, (disc > 0) & (pk.abs() <= half[:, k])
                                & ((oi + di * t) * si > 0) & ((oj + dj * t) * sj > 0))

    for sx in (1.0, -1.0):
        for sy in (1.0, -1.0):
            for sz in (1.0, -1.0):
                s = torch.stack([sx * half[:, 0], sy * half[:, 1], sz * half[:, 2]], dim=-1)
                oc = o - s
                b = (oc * d).sum(-1)
                cq = (oc * oc).sum(-1) - rnd * rnd
                disc = b * b - cq
                t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
                p = oc + d * t[..., None]
                best = consider(best, t, (disc > 0) & (p[..., 0] * sx > 0)
                                & (p[..., 1] * sy > 0) & (p[..., 2] * sz > 0))
    return best


def _intersect_fwd(scene: Scene, ro, rd, excl, inside_hits: bool):
    """The nearest hit of every primitive → (t, object_id); `excl`: i32,
    broadcast to the rays."""
    batch = ro.shape[:-1]
    parts = [torch.full(batch + (1,), _INF, dtype=ro.dtype, device=ro.device)]
    ids = [torch.zeros((1,), dtype=torch.int32, device=ro.device)]
    if scene.planes.shape[0]:
        parts.append(_plane_hits(scene, ro, rd))
        ids.append(scene.plane_ids)
    if scene.spheres.shape[0]:
        parts.append(_sphere_hits(scene, ro, rd, inside_hits))
        ids.append(scene.sphere_ids)
    if scene.boxes.shape[0]:
        parts.append(_box_hits(scene, ro, rd))
        ids.append(scene.box_ids)
    ts = torch.cat(parts, dim=-1)
    idv = torch.cat(ids)
    ts = torch.where(idv == excl[..., None], _INF, ts)

    t = ts[..., 0]
    oid = torch.zeros(batch, dtype=torch.int32, device=ro.device)
    for slot in range(1, int(idv.shape[0])):
        ti = ts[..., slot]
        take = (ti <= t) & (ti < _INF)
        t = torch.where(take, ti, t)
        oid = torch.where(take, idv[slot], oid)

    # Pull back eps, clamp misses to (zfar, 0) (common.glsl:289-294).
    t = t - gmath.EPS
    miss = (t > gmath.ZFAR) | (oid == 0)
    return torch.where(miss, gmath.ZFAR, t), torch.where(miss, 0, oid)


def intersect(scene: Scene, ro: torch.Tensor, rd: torch.Tensor, exclude=-1,
              steps: int = 255, inside_hits: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Analytic nearest hit → (t, object_id) for rays ro, rd f32[..., 3];
    `exclude` (an ID, or an i32[...] of them) is skipped. `steps` is
    accepted for the march's signature and ignored. `inside_hits` (not
    differentiated) gives a ray that starts inside a sphere its far root,
    the exit point (the wavefront integrator's dielectrics). Differentiable
    in the scene's planes, spheres and boxes, ro and rd through the
    implicit-function backward."""
    del steps
    fwd = lambda sc, o, d, ex: _intersect_fwd(sc, o, d, ex, inside_hits)
    return sdf_mod.apply_intersector(fwd, scene, ro, rd, exclude)
