"""Scene builders.

Port of kylespathtracer_tpu/scene/scene.py: `default_scene` is the
reference's Cornell-style room (common.glsl:220-273); `sphere_scene` the
parameterized N-sphere scenes. Tables are built in numpy (f32) and moved
to `device` (default: the card) once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE
from kylespathtracer_tpu_torch.scene.types import OBJ, Materials, Scene


def _plane_tint(obj_id: int) -> tuple[float, float, float]:
    """Per-ID cos/sin tint of the generic plane branch (common.glsl:252-254)."""
    cm = math.cos(float(obj_id)) * 0.025
    sm = math.sin(float(obj_id)) * 0.025
    return (0.05 + cm, 0.05 + sm, 0.05 - (cm + sm) * 0.25)


def _material_arrays(K: int, light_color) -> dict:
    """Zeroed table of K rows with the reference's LIGHT row filled in."""
    m = {
        "s0": np.zeros(K, np.float32), "s1": np.zeros(K, np.float32),
        "freq": np.ones(K, np.float32),
        "alb_const": np.zeros((K, 3), np.float32),
        "alb_scale": np.zeros((K, 3), np.float32),
        "emission": np.zeros((K, 3), np.float32),
        "en_const": np.zeros((K, 2), np.float32),
        "en_scale": np.zeros((K, 2), np.float32),
        "bsdf": np.zeros(K, np.int32), "ior": np.full(K, 1.5, np.float32),
    }
    # LIGHT (common.glsl:239-242): white albedo, lightColor emission, (1,1)·0.7.
    m["s0"][OBJ.LIGHT] = 1.0
    m["alb_const"][OBJ.LIGHT] = 1.0
    m["emission"][OBJ.LIGHT] = light_color
    m["en_const"][OBJ.LIGHT] = (0.7, 0.7)
    return m


def _materials(m: dict, device) -> Materials:
    return Materials(**{k: torch.as_tensor(v, device=device) for k, v in m.items()})


def default_materials(light_color=(10.0, 10.0, 10.0), device=DEFAULT_DEVICE) -> Materials:
    """Material table reproducing `getSurface` (common.glsl:237-262), rows
    indexed by object ID 0..7, the global ×0.7 energy scale folded in."""
    m = _material_arrays(8, light_color)
    # BOX (common.glsl:243-246): albedo = 0.025 + 0.1·checker(4·hl).
    m["s0"][OBJ.BOX] = 0.025
    m["s1"][OBJ.BOX] = 0.1
    m["freq"][OBJ.BOX] = 4.0
    m["alb_scale"][OBJ.BOX] = 1.0
    m["en_const"][OBJ.BOX] = (0.7, 0.7)
    # Generic planes (common.glsl:249-256).
    for oid in (OBJ.FLOOR, OBJ.CEIL, OBJ.WALL1, OBJ.WALL2):
        checkered = oid in (OBJ.FLOOR, OBJ.CEIL)
        m["s0"][oid] = 0.9 if checkered else 0.8
        m["s1"][oid] = 0.2 if checkered else 0.0
        m["alb_scale"][oid] = _plane_tint(oid)
        m["en_scale"][oid] = (0.7, 0.35)
    return _materials(m, device)


def default_scene(device=DEFAULT_DEVICE) -> Scene:
    """The reference's room: 4 planes + sphere light + rounded box."""
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=device)
    return Scene(
        planes=f32([
            [0.0, 1.0, 0.0, 0.0],    # floor
            [0.0, -1.0, 0.0, 10.0],  # ceiling
            [-1.0, 0.0, 0.0, 10.0],  # wall1
            [0.0, 0.0, 1.0, 10.0],   # wall2
        ]),
        plane_ids=i32([OBJ.FLOOR, OBJ.CEIL, OBJ.WALL1, OBJ.WALL2]),
        spheres=f32([[6.0, 5.0, -4.0, 1.0]]),
        sphere_ids=i32([OBJ.LIGHT]),
        boxes=f32([[7.5, 0.93, -7.5, 0.8, 0.8, 0.8, 0.1]]),
        box_ids=i32([OBJ.BOX]),
        light_color=f32([10.0, 10.0, 10.0]),
        materials=default_materials(device=device),
        light_index=0,
    )


def sphere_scene(
    centers,
    radii,
    albedos,
    light=(6.0, 5.0, -4.0, 1.0),
    light_color=(10.0, 10.0, 10.0),
    with_floor: bool = True,
    diffuse_energy: float = 0.7,
    specular_energy: float = 0.35,
    kinds=None,
    iors=None,
    device=DEFAULT_DEVICE,
) -> Scene:
    """N spheres (+ floor plane + sphere light). Sphere i gets object ID
    3+i with constant albedo `albedos[i]`."""
    centers = np.asarray(centers, np.float32).reshape(-1, 3)
    radii = np.asarray(radii, np.float32).reshape(-1)
    albedos = np.asarray(albedos, np.float32).reshape(-1, 3)
    n = centers.shape[0]
    m = _material_arrays(3 + n, light_color)
    m["s0"][OBJ.FLOOR] = 0.9
    m["s1"][OBJ.FLOOR] = 0.2
    m["alb_scale"][OBJ.FLOOR] = _plane_tint(OBJ.FLOOR)
    m["en_scale"][OBJ.FLOOR] = (0.7, 0.35)
    for i in range(n):
        oid = 3 + i
        m["s0"][oid] = 1.0
        m["alb_const"][oid] = albedos[i]
        m["en_const"][oid] = (diffuse_energy, specular_energy)
        if kinds is not None:
            m["bsdf"][oid] = int(kinds[i])
        if iors is not None:
            m["ior"][oid] = float(iors[i])

    if with_floor:
        planes = np.asarray([[0.0, 1.0, 0.0, 0.0]], np.float32)
        plane_ids = np.asarray([OBJ.FLOOR], np.int32)
    else:
        planes = np.zeros((0, 4), np.float32)
        plane_ids = np.zeros((0,), np.int32)
    spheres = np.concatenate(
        [np.asarray(light, np.float32)[None, :],
         np.concatenate([centers, radii[:, None]], axis=1)], axis=0,
    )
    sphere_ids = np.concatenate(
        [np.asarray([OBJ.LIGHT], np.int32), 3 + np.arange(n, dtype=np.int32)]
    )
    t = lambda a: torch.as_tensor(a, device=device)
    return Scene(
        planes=t(planes), plane_ids=t(plane_ids),
        spheres=t(spheres), sphere_ids=t(sphere_ids),
        boxes=t(np.zeros((0, 7), np.float32)),
        box_ids=t(np.zeros((0,), np.int32)),
        light_color=t(np.asarray(light_color, np.float32)),
        materials=_materials(m, device),
        light_index=0,
    )
