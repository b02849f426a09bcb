"""PyTorch port, scene and camera layer: the numpy converters, the native
scene builders (bitwise against the converted JAX scenes), ray generation
and the spline camera path."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (
    np_, to_torch_camera, to_torch_channel, to_torch_history, to_torch_scene,
)
from kylespathtracer_tpu.app import driver as jdriver
from kylespathtracer_tpu.render import camera as jcam
from kylespathtracer_tpu.render.passes import Channel as JChannel
from kylespathtracer_tpu.render.pipeline import History as JHistory
from kylespathtracer_tpu.scene import scene as jscene
from kylespathtracer_tpu_torch.app import driver
from kylespathtracer_tpu_torch.render import camera
from kylespathtracer_tpu_torch.scene import scene
from kylespathtracer_tpu_torch.scene.types import OBJ, Materials, Scene

SPHERES = dict(
    centers=[[0.0, 1.0, 0.0], [2.0, 0.5, -1.0], [-1.0, 0.7, -2.0]],
    radii=[1.0, 0.5, 0.7],
    albedos=[[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]],
)


def _assert_scene_bitwise(a: Scene, b: Scene):
    assert a.light_index == b.light_index
    for f in dataclasses.fields(Scene):
        if f.name in ("materials", "light_index"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        assert torch.equal(x, y), f.name
    for f in dataclasses.fields(Materials):
        x, y = getattr(a.materials, f.name), getattr(b.materials, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), f.name


@pytest.mark.parametrize(
    "build",
    [
        lambda m, **dev: m.default_scene(**dev),
        lambda m, **dev: m.sphere_scene(**SPHERES, **dev),
        lambda m, **dev: m.sphere_scene(**SPHERES, with_floor=False, kinds=[0, 1, 3],
                                        iors=[1.5, 1.5, 1.33], **dev),
    ],
    ids=["default", "spheres", "spheres_nofloor_bsdf"],
)
def test_native_scene_equals_converted_jax_scene(build):
    native = build(scene, device="cpu")
    converted = to_torch_scene(build(jscene))
    _assert_scene_bitwise(native, converted)
    assert native.planes.dtype == torch.float32
    assert native.plane_ids.dtype == torch.int32


def test_scene_converter_fields_and_properties():
    js = jscene.sphere_scene(**SPHERES)
    ts = to_torch_scene(js)
    np.testing.assert_array_equal(np_(ts.light), np.asarray(js.light))
    assert int(ts.light_id) == int(js.light_id) == OBJ.LIGHT
    assert ts.boxes.shape == (0, 7) and ts.materials.num_ids == 6
    assert ts.to("cpu").device.type == "cpu"


def test_camera_channel_history_converters():
    cam = jcam.Camera.create(loc=(1.0, 2.0, 3.0), orient=(0.1, -0.2))
    tc = to_torch_camera(cam)
    np.testing.assert_array_equal(np_(tc.loc), np.asarray(cam.loc))
    np.testing.assert_array_equal(np_(tc.orient), np.asarray(cam.orient))
    rng = np.random.default_rng(4)
    ch = JChannel(
        rgb=jnp.asarray(rng.uniform(0, 1, (4, 5, 3)), jnp.float32),
        cnt=jnp.asarray(rng.integers(0, 9, (4, 5)).astype(np.float32)),
        oid=jnp.asarray(rng.integers(0, 8, (4, 5)).astype(np.int32)),
    )
    tch = to_torch_channel(ch)
    assert tch.oid.dtype == torch.int32
    np.testing.assert_array_equal(np_(tch.rgb), np.asarray(ch.rgb))
    hist = to_torch_history(JHistory(diffuse=ch, specular=ch, camera=cam))
    np.testing.assert_array_equal(np_(hist.specular.cnt), np.asarray(ch.cnt))
    np.testing.assert_array_equal(np_(hist.camera.loc), np.asarray(cam.loc))


@pytest.mark.parametrize("size", [(64, 32), (48, 20)])
def test_ray_dirs_match_jax(size):
    W, H = size
    cam = jcam.Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.05, 0.7))
    np.testing.assert_array_equal(
        np_(camera.ndc_grid(W, H, device="cpu")), np.asarray(jcam.ndc_grid(W, H))
    )
    np.testing.assert_allclose(
        np_(camera.ray_dirs(to_torch_camera(cam), W, H, 1.5)),
        np.asarray(jcam.ray_dirs(cam, W, H, 1.5)), atol=1e-6,
    )


def test_spline_cameras_match_jax():
    ours = driver.spline_cameras(400, device="cpu")
    ref = jdriver.spline_cameras(400)
    np.testing.assert_allclose(np_(ours.loc), np.asarray(ref.loc), atol=2e-5)
    np.testing.assert_allclose(np_(ours.orient), np.asarray(ref.orient), atol=2e-6)
    assert len(ours) == 400 and ours[3].loc.shape == (3,)
