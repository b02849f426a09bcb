"""PyTorch port, geometry pass (K3's module, ops/geometry_kernel.py, and
render/gbuffer.py) against the JAX package: the plain version against the
real `geometry_pass_pallas` in interpret mode (two row blocks), and the
G-buffer against JAX's `gbuffer.geometry_pass`. Bars as
tests/test_pallas_small.py:41-47: oid exact, depth atol 1e-5, curv 1e-6;
the normal atol 1e-5. The interpret-mode comparison runs on the default
scene: on the sphere scene a few pixels graze a sphere, where XLA's and
torch's rsqrt in the raygen round the ray an ulp apart and the hit moves by
up to 3e-5 (the G-buffer comparison, which normalizes with sqrt, holds the
sphere scene to the same bars)."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_helpers import np_, to_torch_camera, to_torch_config, to_torch_scene
from kylespathtracer_tpu.ops import frame_kernel as jfk
from kylespathtracer_tpu.render import gbuffer as jgb
from kylespathtracer_tpu.render.camera import Camera
from kylespathtracer_tpu.scene import default_scene
from kylespathtracer_tpu.scene.scene import sphere_scene
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.ops import adjoint_variants as av
from kylespathtracer_tpu_torch.ops import geometry_kernel as gk
from kylespathtracer_tpu_torch.render import gbuffer as gb

CAM = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))


def _spheres():
    return sphere_scene(
        [[5.5, 1.0, 0.0], [4.0, 0.5, 1.0], [6.0, 2.5, -1.5]], [1.0, 0.5, 0.7],
        [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]],
    )


def _check(out, ref):
    assert (np_(out["oid"]) == np.asarray(ref["oid"])).all()
    np.testing.assert_allclose(np_(out["depth"]), np.asarray(ref["depth"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_(out["curv"]), np.asarray(ref["curv"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np_(out["normal"]), np.asarray(ref["normal"]), atol=1e-5, rtol=0)


def test_geometry_pass_plain_matches_pallas_interpret():
    scene = default_scene()
    cfg = RenderConfig(width=64, height=32)
    ref = jfk.geometry_pass_pallas(scene, CAM, jnp.int32(0), cfg, block_rows=16, interpret=True)
    before = gk.LAUNCHES
    out = gk.geometry_pass(to_torch_scene(scene), to_torch_camera(CAM), 0, to_torch_config(cfg))
    assert gk.LAUNCHES == before  # a CPU tensor runs the plain version
    _check(out, ref)
    # Misses write the trace's (ZFAR, 0): depth ZFAR - eps, normal zero.
    miss = np_(out["oid"]) == 0
    assert miss.any()
    np.testing.assert_array_equal(np_(out["depth"])[miss], np.float32(50.0) - np.float32(1e-3))
    assert (np_(out["normal"])[miss] == 0).all()


@pytest.mark.parametrize("scene_fn", [default_scene, _spheres], ids=["default", "spheres"])
def test_gbuffer_matches_jax(scene_fn):
    scene = scene_fn()
    cfg = RenderConfig(width=64, height=32)
    ref = jgb.geometry_pass(scene, CAM, cfg)
    out = gb.geometry_pass(to_torch_scene(scene), to_torch_camera(CAM), to_torch_config(cfg))
    _check(
        {"oid": out.obj_id, "depth": out.depth, "curv": out.curv, "normal": out.normal},
        {"oid": ref.obj_id, "depth": ref.depth, "curv": ref.curv, "normal": ref.normal},
    )
    np.testing.assert_allclose(np_(out.ray_dir), np.asarray(ref.ray_dir), atol=1e-6, rtol=0)


def test_gbuffer_and_plain_kernel_agree():
    """The two routes to the G-buffer (the tensor-level module and K3's
    plain version) give the same hits."""
    scene, cam = to_torch_scene(default_scene()), to_torch_camera(CAM)
    cfg = to_torch_config(RenderConfig(width=48, height=32))
    g = gb.geometry_pass(scene, cam, cfg)
    k = gk.geometry_pass_plain(scene, cam, 0, cfg)
    assert (np_(g.obj_id) == np_(k["oid"])).all()
    np.testing.assert_allclose(np_(g.depth), np_(k["depth"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_(g.normal), np_(k["normal"]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("view", ["raycast", "box_aimed"])
def test_box_work_counts_the_rays_that_reach_the_box(view):
    """The tally behind K3's bound (`box_work_plain`): from the raycast's
    view no ray comes near the box, so K3 runs none of its code; from the
    box-aimed view every pixel on which JAX's G-buffer finds the box is
    among the (ray, box) pairs that run its candidates, and those are a
    small share of the rays."""
    scene = default_scene()
    cam = Camera.create(loc=av.VIEW_LOC, orient=av.BOX_AIMED if view == "box_aimed" else av.RAYCAST_VIEW)
    cfg = RenderConfig(width=64, height=32)
    work = gk.box_work_plain(to_torch_scene(scene), to_torch_camera(cam), to_torch_config(cfg))
    box_px = int(np.isin(np.asarray(jgb.geometry_pass(scene, cam, cfg).obj_id), np.asarray(scene.box_ids)).sum())
    assert work["pixels"] == 64 * 32
    if view == "raycast":
        assert box_px == 0 and work["near"] == 0 and work["boxes"] == 0
    else:
        assert box_px > 50, "the view sees too little of the box; the check is vacuous"
        assert box_px <= work["boxes"] <= work["near"] < 0.2 * work["pixels"]


@pytest.mark.parametrize("kw", [dict(intersect_mode="march"), dict(normal_mode="tetra")])
def test_gbuffer_unported_modes_raise(kw):
    """The G-buffer modes that once raised: the sphere trace (with its
    tetrahedron normals) and the tetrahedron normals on the analytic hits,
    against JAX's `gbuffer.geometry_pass` from the view aimed at the rounded
    box: oid exact, depth at `_check`'s bar, the normal and the curvature
    within 1e-4. The march's t is an ulp from JAX's where XLA fuses the
    multiply-add of ro + rd·t, and the tetrahedron's stencil (differences of
    distances 2·eps apart) scales that ulp by up to ~10³: the largest
    differences here are 1.2e-5 (normal) and 5.6e-6 (curvature)."""
    cfg = RenderConfig(width=64, height=32, **kw)
    cam = Camera.create(loc=av.VIEW_LOC, orient=av.BOX_AIMED)
    ref = jgb.geometry_pass(default_scene(), cam, cfg)
    out = gb.geometry_pass(to_torch_scene(default_scene()), to_torch_camera(cam), to_torch_config(cfg))
    assert (np_(out.obj_id) == np.asarray(ref.obj_id)).all()
    np.testing.assert_allclose(np_(out.depth), np.asarray(ref.depth), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_(out.normal), np.asarray(ref.normal), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np_(out.curv), np.asarray(ref.curv), atol=1e-4, rtol=0)
    assert (np_(out.obj_id) == 4).any(), "the view misses the rounded box"
