"""Geometry pass: primary intersection → struct-of-arrays G-buffer.

Port of kylespathtracer_tpu/render/gbuffer.py in analytic mode (closed-form
intersect and normals). The sphere-traced intersector
(`intersect_mode="march"`) and the tetrahedron normals wait for the port of
scene/sdf.py (ROADMAP Queue 1 #11) and raise. The same pass as one kernel
is `ops/geometry_kernel.geometry_pass` (K3).
"""

from __future__ import annotations

import dataclasses

import torch

from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.render import camera as cam_mod
from kylespathtracer_tpu_torch.scene import intersect as isect
from kylespathtracer_tpu_torch.scene import normals as nrm_mod
from kylespathtracer_tpu_torch.scene.types import Scene


@dataclasses.dataclass(frozen=True)
class GBuffer:
    normal: torch.Tensor   # f32[H,W,3]; zeros on a miss
    obj_id: torch.Tensor   # i32[H,W]; 0 on a miss
    depth: torch.Tensor    # f32[H,W]: hit t - eps (geometry.frag:71)
    ray_dir: torch.Tensor  # f32[H,W,3] primary directions
    curv: torch.Tensor     # f32[H,W] surface curvature at the hit


def use_tetra_normals(config) -> bool:
    """Tetrahedron normals for march parity, closed-form ones otherwise."""
    if config.normal_mode == "auto":
        return config.intersect_mode == "march"
    return config.normal_mode == "tetra"


def geometry_pass(scene: Scene, camera: cam_mod.Camera, config, row0: int = 0,
                  rows: int | None = None) -> GBuffer:
    """Primary intersection + analytic normals and curvature at the hits
    (reference: geometry.frag:66-72), on the scene's device; of image rows
    [row0, row0+rows) with `rows` (a tile of the sharded renderer)."""
    if config.intersect_mode != "analytic" or use_tetra_normals(config):
        raise NotImplementedError(
            "geometry_pass: intersect_mode='march' and tetrahedron normals "
            "need scene/sdf.py, which waits for ROADMAP Queue 1 #11")
    rd = cam_mod.ray_dirs_window(camera, config.width, config.height, row0,
                                 config.height if rows is None else rows, config.fov)
    ro = camera.loc.expand(rd.shape)
    t, oid = isect.intersect(scene, ro, rd, -1, config.steps)
    hl = ro + rd * t[..., None]
    n, c = nrm_mod.normal_curv(scene, hl, oid)
    n = torch.where((oid > 0)[..., None], n, 0.0)
    return GBuffer(normal=n, obj_id=oid, depth=t - gmath.EPS, ray_dir=rd, curv=c)
