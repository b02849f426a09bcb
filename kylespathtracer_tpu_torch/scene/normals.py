"""Analytic surface normals and curvature, per primitive by object ID.

Port of kylespathtracer_tpu/scene/normals.py: plane n = its normal, curv 0;
sphere n = (p-c)/|p-c|, curv eps/|p-c|; rounded box n = m·sign(q)/|m| with
m = max(|q|-half, 0), curv 0.5·eps·max(k-1, 0)/|m| (k = positive
components of |q|-half). The tetrahedron estimator is `sdf.norcurv`.
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.scene.types import Scene


def normal_curv(scene: Scene, p: torch.Tensor, oid: torch.Tensor,
                ep: float = gmath.EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form (normal[...,3], curvature[...]) of the hit primitive;
    oid 0 (miss) gives a zero normal and curvature."""
    n = torch.zeros_like(p)
    c = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)

    for i in range(int(scene.planes.shape[0])):
        sel = (oid == scene.plane_ids[i])[..., None]
        n = torch.where(sel, scene.planes[i, :3], n)

    for i in range(int(scene.spheres.shape[0])):
        sel = oid == scene.sphere_ids[i]
        diff = p - scene.spheres[i, :3]
        l = torch.sqrt(torch.clamp(gmath.dot(diff, diff), min=1e-12))
        n = torch.where(sel[..., None], diff / l[..., None], n)
        c = torch.where(sel, ep / l, c)

    for i in range(int(scene.boxes.shape[0])):
        sel = oid == scene.box_ids[i]
        q = p - scene.boxes[i, :3]
        d = q.abs() - scene.boxes[i, 3:6]
        m = torch.clamp(d, min=0.0)
        l = torch.sqrt(torch.clamp(gmath.dot(m, m), min=1e-12))
        nb = m * torch.sign(q) / l[..., None]
        k = (d > 0.0).to(p.dtype).sum(-1)
        n = torch.where(sel[..., None], nb, n)
        c = torch.where(sel, 0.5 * ep * torch.clamp(k - 1.0, min=0.0) / l, c)

    return n, c
