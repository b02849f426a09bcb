"""PyTorch port, scene/sdf.py against the JAX package and the CPU oracle
(kylespathtracer_tpu/cpu_reference): the distance-field functions on
numpy-seeded points (atol 1e-6), the sphere trace's t and object IDs, the
implicit-function backward through both autograd Functions (the march and
the analytic intersect) against `jax.vjp` (1e-4·max per table), the march's
t gradients against finite differences (tests/test_scene.py:86-123), and
the sphere-traced pass frames against the oracle
(tests/test_pipeline_vs_ref.py's march cases, at its bars)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import np_, to_torch_camera, to_torch_config, to_torch_scene
from kylespathtracer_tpu.cpu_reference import render_ref as rr
from kylespathtracer_tpu.render.camera import Camera
from kylespathtracer_tpu.scene import default_scene
from kylespathtracer_tpu.scene import intersect as jisect
from kylespathtracer_tpu.scene import sdf as jsdf
from kylespathtracer_tpu.scene.scene import sphere_scene
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.render import pipeline
from kylespathtracer_tpu_torch.scene import intersect as isect
from kylespathtracer_tpu_torch.scene import sdf
from kylespathtracer_tpu_torch.scene.types import OBJ

SCENE = default_scene()
BOX = np.asarray(SCENE.boxes[0, :3])
LIGHT = np.asarray(SCENE.spheres[0, :3])


def _room_points(rng, n):
    return rng.uniform([-9.5, 0.25, -9.5], [9.5, 9.75, 9.5], (n, 3)).astype(np.float32)


def _near_box(rng, n):
    """Points around the rounded box: on its faces, edges and corners (the
    core's half-extent 0.8 plus the 0.1 rounding, jittered across it)."""
    s = rng.choice([-1.0, 0.0, 1.0], (n, 3))
    return (BOX + s * 0.9 + rng.normal(0, 0.05, (n, 3))).astype(np.float32)


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(name, rng):
    """(JAX call, port call) on the same numpy-seeded inputs."""
    p = np.concatenate([_room_points(rng, 384), _near_box(rng, 128)])
    ts = to_torch_scene(SCENE)
    if name == "sd_box":
        half = np.float32([0.8, 0.5, 1.2])
        q = (p - BOX) * 0.8
        return (lambda: jsdf.sd_box(jnp.asarray(q), jnp.asarray(half)),
                lambda: sdf.sd_box(torch.from_numpy(q), torch.from_numpy(half)))
    if name in ("smin", "smax"):
        a, b = rng.uniform(-2, 2, (2, 512)).astype(np.float32)
        return (lambda: getattr(jsdf, name)(jnp.asarray(a), jnp.asarray(b), 0.5),
                lambda: getattr(sdf, name)(torch.from_numpy(a), torch.from_numpy(b), 0.5))
    if name in ("sdf", "sdf_dist"):
        excl = rng.choice(np.int32([-1, 0, OBJ.LIGHT, OBJ.FLOOR, OBJ.BOX, OBJ.CEIL]), len(p))
        return (lambda: getattr(jsdf, name)(SCENE, jnp.asarray(p), jnp.asarray(excl)),
                lambda: getattr(sdf, name)(ts, torch.from_numpy(p), torch.from_numpy(excl)))
    return (lambda: getattr(jsdf, name)(SCENE, jnp.asarray(p)),
            lambda: getattr(sdf, name)(ts, torch.from_numpy(p)))


@pytest.mark.parametrize("name", ["sd_box", "smin", "smax", "primitive_distances", "sdf", "sdf_dist",
                                  "norcurv"])
def test_sdf_functions_match_jax(name):
    """Every output within atol 1e-6 of JAX's; object IDs equal. `sdf` and
    `sdf_dist` take a per-point exclusion that includes 0 (where the JAX
    `sdf` keeps the zfar sentinel and `sdf_dist` masks it)."""
    ref, got = (f() for f in _inputs(name, np.random.default_rng(1)))
    ref, got = (ref, got) if isinstance(ref, tuple) else ((ref,), (got,))
    for a, b in zip(ref, got):
        a = np.asarray(a)
        if a.dtype == np.int32:
            np.testing.assert_array_equal(np_(b), a)
        else:
            np.testing.assert_allclose(np_(b), a, atol=1e-6, rtol=0)


def _march_rays(rng):
    """192 rays from the camera in every direction and 128 aimed at the box
    from room points outside it and outside the light, with per-ray
    exclusions."""
    ro1 = np.tile(np.float32([3.0, 2.0, -3.0]), (192, 1))
    ro2 = rng.uniform([-5, 0.2, -9.5], [9.5, 9.5, 5], (400, 3))
    ro2 = ro2[(np.abs(ro2 - BOX) > 1.1).any(-1) & (np.linalg.norm(ro2 - LIGHT, axis=-1) > 1.2)][:128]
    rd = np.concatenate([rng.standard_normal((192, 3)), BOX + rng.normal(0, 1.2, (128, 3)) - ro2])
    excl = rng.choice(np.int32([-1, OBJ.LIGHT, OBJ.FLOOR, OBJ.BOX]), 320)
    return np.concatenate([ro1, ro2]).astype(np.float32), _unit(rd), excl


def test_march_matches_jax_and_reference():
    """Object IDs equal to JAX's and to the oracle's `march_excl` on every
    ray; t within 1e-5 of both on every ray (none of these graze: the share
    beyond 1e-5 is 0). The loop's `CHECK_EVERY` changes nothing: 1, 8 and
    256 steps between looks give the same t and IDs bitwise."""
    ro, rd, excl = _march_rays(np.random.default_rng(5))
    t_j, id_j = jsdf.march(SCENE, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(excl))
    t_r, id_r = rr.march_excl(ro, rd, excl)
    ts = to_torch_scene(SCENE)
    runs = {}
    for every in (1, 8, 256):
        old, sdf.CHECK_EVERY = sdf.CHECK_EVERY, every
        try:
            steps, syncs = sdf.STEPS, sdf.SYNCS
            runs[every] = sdf.march(ts, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(excl))
            assert sdf.SYNCS - syncs == -(-(sdf.STEPS - steps) // every)
        finally:
            sdf.CHECK_EVERY = old
    t_t, id_t = (np_(x) for x in runs[8])
    for every in (1, 256):
        assert all(torch.equal(a, b) for a, b in zip(runs[every], runs[8])), every
    np.testing.assert_array_equal(id_t, np.asarray(id_j))
    np.testing.assert_array_equal(id_t, id_r)
    assert (id_t == OBJ.BOX).mean() > 0.1 and (id_t == 0).any()
    np.testing.assert_allclose(t_t, np.asarray(t_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_t, t_r, atol=1e-5, rtol=0)


def _ift_rays(rng):
    """300 rays that start outside the box and the light: toward the box
    (faces, edges and corners), the light and the room. A ray starting
    inside the box's core differs on purpose: there |max(d, 0)| is 0 and
    JAX's maximum passes the NaN of sqrt's gradient at 0 on, where torch's
    zeroes the smaller operand's cotangent."""
    ro = rng.uniform([-5, 0.3, -9.5], [9.5, 9.5, 5], (900, 3))
    ro = ro[(np.abs(ro - BOX) > 1.0).any(-1) & (np.linalg.norm(ro - LIGHT, axis=-1) > 1.1)][:300]
    aim = np.concatenate([_near_box(rng, 180), LIGHT + rng.normal(0, 0.6, (60, 3)), _room_points(rng, 60)])
    return ro.astype(np.float32), _unit(aim - ro)


def _grazing(ro, rd, which) -> np.ndarray:
    """bool[n]: rays whose hit is within ~3° of tangent, |∇f·d| < 0.05 (the
    port's hit). There t's gradient grows as 1/(∇f·d) and its change with
    the hit point as its square, so the ulp by which XLA's fused
    multiply-adds move the march's t from the port's moves the gradient by
    up to 4e-4 of its size."""
    ts = to_torch_scene(SCENE)
    t, _ = {"march": sdf.march, "intersect": isect.intersect}[which](ts, torch.from_numpy(ro), torch.from_numpy(rd))
    p = (torch.from_numpy(ro) + torch.from_numpy(rd) * t[:, None]).requires_grad_()
    (gp,) = torch.autograd.grad(sdf.sdf_dist(ts, p).sum(), p)
    return np_((gp * torch.from_numpy(rd)).sum(-1).abs() < 0.05)


@pytest.mark.parametrize("which", ["march", "intersect"])
def test_ift_backward_matches_jax_vjp(which):
    """The gradients of Σ g·t (g seeded) in planes, spheres, boxes, ro and
    rd through the port's autograd Function against `jax.vjp` of the JAX
    custom VJP, 1e-4·max per table, on rays that hit the rounded box's
    faces, edges and corners, the light and the room. Grazing rays
    (`_grazing`: 3 of the 300 for the march, 2 for the intersect) get no
    cotangent."""
    rng = np.random.default_rng(7)
    ro, rd = _ift_rays(rng)
    g = rng.standard_normal(len(ro)).astype(np.float32)
    graze = _grazing(ro, rd, which)
    assert graze.mean() <= 0.01
    g[graze] = 0.0
    jfn = {"march": lambda sc, o, d: jsdf.march(sc, o, d, -1, 255),
           "intersect": lambda sc, o, d: jisect.intersect(sc, o, d, -1)}[which]
    (t_j, id_j), vjp = jax.vjp(lambda pl, sp, bx, o, d: jfn(SCENE.replace(planes=pl, spheres=sp, boxes=bx), o, d),
                               SCENE.planes, SCENE.spheres, SCENE.boxes, jnp.asarray(ro), jnp.asarray(rd))
    ref = vjp((jnp.asarray(g), np.zeros(len(ro), jax.dtypes.float0)))
    ts = to_torch_scene(SCENE)
    leaves = [x.clone().requires_grad_() for x in (ts.planes, ts.spheres, ts.boxes, torch.from_numpy(ro),
                                                   torch.from_numpy(rd))]
    sc = dataclasses.replace(ts, planes=leaves[0], spheres=leaves[1], boxes=leaves[2])
    t_t, id_t = {"march": sdf.march, "intersect": isect.intersect}[which](sc, leaves[3], leaves[4])
    np.testing.assert_array_equal(np_(id_t), np.asarray(id_j))
    assert (np_(id_t) == OBJ.BOX).sum() > 100 and (np_(id_t) == OBJ.LIGHT).sum() > 20
    got = torch.autograd.grad((t_t * torch.from_numpy(g)).sum(), leaves)
    for name, a, b in zip(("planes", "spheres", "boxes", "ro", "rd"), ref, got):
        a = np.asarray(a)
        assert np.isfinite(a).all() and np.abs(a).max() > 0, name
        np.testing.assert_allclose(np_(b), a, rtol=0, atol=1e-4 * np.abs(a).max(), err_msg=name)


@pytest.mark.parametrize("offset,inside_core", [(0.5, True), (0.85, False)], ids=["in_core", "in_rounding"])
def test_ray_from_inside_the_box_core_is_a_reference_side_fault(offset, inside_core):
    """A reference-side fault that the port does not copy: a ray that starts
    inside the rounded box's core (every |p - c| - half < 0, `offset` 0.5)
    hits at once, and there max(d, 0) is 0 in every component: JAX's
    maximum passes the NaN of sqrt's gradient at 0 on to every input, where
    torch's maximum zeroes the smaller operand's cotangent, so the port's
    gradient is finite. Started just outside the core, in the 0.1 rounding
    (`offset` 0.85), the same ray gets equal t, IDs and gradients (1e-4·max)
    from both."""
    ro = (BOX + np.float32([offset, 0.2, -0.1]))[None].astype(np.float32)
    rd = _unit(np.float32([[1.0, 0.3, 0.2]]))
    (t_j, id_j), vjp = jax.vjp(lambda bx, o, d: jsdf.march(SCENE.replace(boxes=bx), o, d, -1, 255),
                               SCENE.boxes, jnp.asarray(ro), jnp.asarray(rd))
    ref = [np.asarray(a) for a in vjp((jnp.ones(1), np.zeros(1, jax.dtypes.float0)))]
    ts = to_torch_scene(SCENE)
    leaves = [x.clone().requires_grad_() for x in (ts.boxes, torch.from_numpy(ro), torch.from_numpy(rd))]
    t_t, id_t = sdf.march(dataclasses.replace(ts, boxes=leaves[0]), leaves[1], leaves[2])
    got = [np_(g) for g in torch.autograd.grad(t_t.sum(), leaves)]
    assert np_(id_t)[0] == int(id_j[0]) == OBJ.BOX
    np.testing.assert_allclose(np_(t_t.detach()), np.asarray(t_j), atol=1e-6, rtol=0)
    assert all(np.isfinite(g).all() for g in got) and np.abs(got[0]).max() > 0
    for name, a, b in zip(("boxes", "ro", "rd"), ref, got):
        if inside_core:
            assert np.isnan(a).all(), name
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * np.abs(a).max(), err_msg=name)


@pytest.mark.parametrize("column,want", [(2, 1.0), (3, -1.0)], ids=["translation", "radius"])
def test_march_gradients_match_finite_differences(column, want):
    """tests/test_scene.py:86-123 in torch: a ray straight at a unit sphere;
    moving the sphere +z moves the hit +z (dt/dz = 1), growing its radius
    pulls the hit closer (dt/dr = -1): autograd through the march within
    5e-2 of that and of the central difference."""
    scene = to_torch_scene(sphere_scene(centers=[[0.0, 1.0, 5.0]], radii=[1.0], albedos=[[0.5, 0.5, 0.5]],
                                        with_floor=False))
    ro, rd = torch.tensor([[0.0, 1.0, 0.0]]), torch.tensor([[0.0, 0.0, 1.0]])

    def hit_t(delta):
        spheres = scene.spheres.clone()
        spheres[1, column] = spheres[1, column] + delta
        return sdf.march(dataclasses.replace(scene, spheres=spheres), ro, rd)[0][0]

    x = torch.tensor(0.0, requires_grad=True)
    (g,) = torch.autograd.grad(hit_t(x), x)
    with torch.no_grad():
        fd = (hit_t(1e-3) - hit_t(-1e-3)) / 2e-3
    assert abs(float(g) - want) < 5e-2 and abs(float(g) - float(fd)) < 5e-2, (float(g), float(fd))


@pytest.mark.parametrize("frames,far,share", [(1, 2e-2, 0.02), (4, 3e-2, 0.03)], ids=["frame0", "four_frames"])
def test_march_pass_frames_match_reference(frames, far, share):
    """tests/test_pipeline_vs_ref.py's march cases on the port: the pass
    pipeline with `intersect_mode="march"` (and its tetrahedron normals) at
    48×32 against the NumPy re-execution of the GLSL shaders, frame 0 and
    after 4 frames: under `share` of the components beyond `far` (and the
    median under 2e-3 for frame 0)."""
    W, H = 48, 32
    loc, ori = (3.0, 2.0, -3.0), (0.0, 0.7)
    cfg = to_torch_config(RenderConfig(width=W, height=H, intersect_mode="march"))
    cam = to_torch_camera(Camera.create(loc=loc, orient=ori))
    img, _ = pipeline.render_image(to_torch_scene(SCENE), cam, cfg, frames=frames)
    hist = rr.zero_history(W, H)
    for i in range(frames):
        ref, hist = rr.render_frame(loc, ori, loc, ori, hist, i, W, H)
    d = np.abs(np_(img) - ref)
    assert (d > far).mean() < share, f"{(d > far).mean():.3%} differ, max {d.max():.4f}"
    if frames == 1:
        assert np.median(d) < 2e-3
