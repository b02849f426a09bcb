"""The benchmark's inputs: scenes and cameras, made from numbers and a seed.

Every table is numpy, so the program and the plain reference are handed the
same inputs and neither takes anything the other made. Frozen copies of the
PyTorch port's builders (`scene/scene.py`: `default_scene`, `sphere_scene`;
`diff/inverse.py`: `recovery_scenes`, `look_at`; `render/camera.py`:
`camera_pose_spline`), kept here so that no change to the program moves the
inputs.
"""

from __future__ import annotations

import math

import numpy as np

# Object ids (common.glsl:220-226).
LIGHT, FLOOR, WALL1, BOX, WALL2, CEIL = 1, 2, 3, 4, 6, 7


def _plane_tint(obj_id: int) -> tuple:
    cm = math.cos(float(obj_id)) * 0.025
    sm = math.sin(float(obj_id)) * 0.025
    return (0.05 + cm, 0.05 + sm, 0.05 - (cm + sm) * 0.25)


def _materials(K: int, light_color) -> dict:
    m = {
        "s0": np.zeros(K, np.float32), "s1": np.zeros(K, np.float32),
        "freq": np.ones(K, np.float32),
        "alb_const": np.zeros((K, 3), np.float32), "alb_scale": np.zeros((K, 3), np.float32),
        "emission": np.zeros((K, 3), np.float32),
        "en_const": np.zeros((K, 2), np.float32), "en_scale": np.zeros((K, 2), np.float32),
        "bsdf": np.zeros(K, np.int32), "ior": np.full(K, 1.5, np.float32),
    }
    m["s0"][LIGHT] = 1.0
    m["alb_const"][LIGHT] = 1.0
    m["emission"][LIGHT] = light_color
    m["en_const"][LIGHT] = (0.7, 0.7)
    return m


def default_scene() -> dict:
    """The reference's room (common.glsl:220-273): 4 planes, the sphere
    light and the rounded box."""
    m = _materials(8, (10.0, 10.0, 10.0))
    m["s0"][BOX], m["s1"][BOX], m["freq"][BOX] = 0.025, 0.1, 4.0
    m["alb_scale"][BOX] = 1.0
    m["en_const"][BOX] = (0.7, 0.7)
    for oid in (FLOOR, CEIL, WALL1, WALL2):
        checkered = oid in (FLOOR, CEIL)
        m["s0"][oid] = 0.9 if checkered else 0.8
        m["s1"][oid] = 0.2 if checkered else 0.0
        m["alb_scale"][oid] = _plane_tint(oid)
        m["en_scale"][oid] = (0.7, 0.35)
    f32 = lambda a: np.asarray(a, np.float32)
    return {
        "planes": f32([[0, 1, 0, 0], [0, -1, 0, 10], [-1, 0, 0, 10], [0, 0, 1, 10]]),
        "plane_ids": np.asarray([FLOOR, CEIL, WALL1, WALL2], np.int32),
        "spheres": f32([[6.0, 5.0, -4.0, 1.0]]), "sphere_ids": np.asarray([LIGHT], np.int32),
        "boxes": f32([[7.5, 0.93, -7.5, 0.8, 0.8, 0.8, 0.1]]), "box_ids": np.asarray([BOX], np.int32),
        "light_color": f32([10.0, 10.0, 10.0]), "materials": m, "light_index": 0,
    }


def sphere_scene(centers, radii, albedos) -> dict:
    """N spheres + the floor plane + the sphere light; sphere i has object id
    3+i and constant albedo `albedos[i]`."""
    centers = np.asarray(centers, np.float32).reshape(-1, 3)
    radii = np.asarray(radii, np.float32).reshape(-1)
    albedos = np.asarray(albedos, np.float32).reshape(-1, 3)
    n = centers.shape[0]
    m = _materials(3 + n, (10.0, 10.0, 10.0))
    m["s0"][FLOOR], m["s1"][FLOOR] = 0.9, 0.2
    m["alb_scale"][FLOOR] = _plane_tint(FLOOR)
    m["en_scale"][FLOOR] = (0.7, 0.35)
    for i in range(n):
        m["s0"][3 + i] = 1.0
        m["alb_const"][3 + i] = albedos[i]
        m["en_const"][3 + i] = (0.7, 0.35)
    light = np.asarray([6.0, 5.0, -4.0, 1.0], np.float32)
    return {
        "planes": np.asarray([[0.0, 1.0, 0.0, 0.0]], np.float32),
        "plane_ids": np.asarray([FLOOR], np.int32),
        "spheres": np.concatenate([light[None], np.concatenate([centers, radii[:, None]], 1)]).astype(np.float32),
        "sphere_ids": np.concatenate([[LIGHT], 3 + np.arange(n)]).astype(np.int32),
        "boxes": np.zeros((0, 7), np.float32), "box_ids": np.zeros((0,), np.int32),
        "light_color": np.asarray([10.0, 10.0, 10.0], np.float32), "materials": m, "light_index": 0,
    }


def look_at(loc, at) -> tuple:
    """A camera at `loc` facing `at` → (loc f32[3], orient f32[2]) with
    pitch = asin(d.y), yaw = atan2(d.x, d.z)."""
    d = np.asarray(at, np.float32) - np.asarray(loc, np.float32)
    d = d / max(float(np.linalg.norm(d)), 1e-8)
    return (np.asarray(loc, np.float32),
            np.asarray([np.arcsin(d[1]), np.arctan2(d[0], d[2])], np.float32))


def recovery_scenes(num_spheres: int, views: int, seed: int, perturb: float) -> dict:
    """The inverse-rendering problem of the recovery recipe (diff/inverse
    .recovery_scenes): the ground-truth scene, the perturbed start (geometry
    jittered, albedos reset to gray) and `views` cameras on an arc around
    the spheres' centre at two alternating heights."""
    rng = np.random.default_rng(seed)
    centers = np.stack([rng.uniform(-4.0, 4.0, num_spheres), rng.uniform(0.6, 3.0, num_spheres),
                        rng.uniform(4.0, 10.0, num_spheres)], axis=-1)
    radii = rng.uniform(0.4, 0.9, num_spheres)
    albedos = rng.uniform(0.2, 0.9, (num_spheres, 3))
    mid = centers.mean(axis=0)
    cams = [look_at((float(mid[0]) + 9.0 * np.sin(a), 2.5 if i % 2 == 0 else 4.5,
                     float(mid[2]) - 9.0 * np.cos(a)), (float(mid[0]), float(mid[1]), float(mid[2])))
            for i, a in enumerate(np.linspace(-0.7, 0.7, views))]
    start = sphere_scene(centers + rng.normal(0, perturb, centers.shape),
                         np.clip(radii + rng.normal(0, perturb * 0.3, radii.shape), 0.2, 1.2),
                         np.full_like(albedos, 0.5))
    return {"truth": sphere_scene(centers, radii, albedos), "start": start,
            "cam_loc": np.stack([c[0] for c in cams]), "cam_orient": np.stack([c[1] for c in cams])}


def recovery_problem(num_spheres: int, views: int, layout_seed: int, seed: int, perturb: float) -> dict:
    """The recipe's problem of `layout_seed` (geometry, cameras, start) with
    true albedos drawn from `seed`: every seed renders the same geometry, so
    the same work, against other targets."""
    prob = recovery_scenes(num_spheres, views, layout_seed, perturb)
    albedos = np.random.default_rng(seed).uniform(0.2, 0.9, (num_spheres, 3)).astype(np.float32)
    prob["truth"]["materials"]["alb_const"][3:] = albedos
    return prob


_POSE_LOC = np.asarray([[4.8, 0.5, -9.5], [4.8, 0.5, -4.8], [-3.5, 2.5, -4.0]], np.float32)
_POSE_OR = np.asarray([[0.20, 0.85], [0.15, 2.33], [0.10, 1.80]], np.float32)


def pose_spline(t: float) -> tuple:
    """The scripted camera of geometry.frag:26-55: smoothstep between three
    poses on a 6-second loop → (loc f32[3], orient f32[2]), in float32."""
    tt = np.float32(t) * np.float32(0.5)
    i0 = int(np.floor(np.remainder(tt, np.float32(6.0)) / np.float32(2.0)))
    i1 = int(np.floor(np.remainder(tt + np.float32(1.0), np.float32(6.0)) / np.float32(2.0)))
    f = tt - np.floor(tt)
    ft = np.float32(f * f * (np.float32(3.0) - np.float32(2.0) * f))
    loc = _POSE_LOC[i0] + (_POSE_LOC[i1] - _POSE_LOC[i0]) * ft
    orient = _POSE_OR[i0] + (_POSE_OR[i1] - _POSE_OR[i0]) * ft
    return loc.astype(np.float32), orient.astype(np.float32)
