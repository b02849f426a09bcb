"""Shared helpers of the PyTorch-port tests: carry JAX objects across to the
port as numpy trees, through the port's own converters."""

from __future__ import annotations

import dataclasses

import numpy as np

from kylespathtracer_tpu_torch.render.camera import camera_from_numpy
from kylespathtracer_tpu_torch.render.passes import channel_from_numpy
from kylespathtracer_tpu_torch.render.pipeline import history_from_numpy
from kylespathtracer_tpu_torch.scene.types import scene_from_numpy

_MAT_FIELDS = ("s0", "s1", "freq", "alb_const", "alb_scale", "emission",
               "en_const", "en_scale", "bsdf", "ior")
_SCENE_FIELDS = ("planes", "plane_ids", "spheres", "sphere_ids", "boxes",
                 "box_ids", "light_color")


def scene_tree(scene) -> dict:
    m = scene.materials
    tree = {k: np.asarray(getattr(scene, k)) for k in _SCENE_FIELDS}
    tree["materials"] = {
        k: np.asarray(getattr(m, k)) for k in _MAT_FIELDS
        if getattr(m, k) is not None
    }
    tree["light_index"] = int(scene.light_index)
    return tree


def camera_tree(cam) -> dict:
    return {"loc": np.asarray(cam.loc), "orient": np.asarray(cam.orient)}


def channel_tree(ch) -> dict:
    return {"rgb": np.asarray(ch.rgb), "cnt": np.asarray(ch.cnt),
            "oid": np.asarray(ch.oid)}


def to_torch_scene(scene, device="cpu"):
    return scene_from_numpy(scene_tree(scene), device)


def to_torch_camera(cam, device="cpu"):
    return camera_from_numpy(camera_tree(cam), device)


def to_torch_channel(ch, device="cpu"):
    return channel_from_numpy(channel_tree(ch), device)


def to_torch_history(hist, device="cpu"):
    return history_from_numpy({
        "diffuse": channel_tree(hist.diffuse),
        "specular": channel_tree(hist.specular),
        "camera": camera_tree(hist.camera),
    }, device)


def to_torch_config(cfg):
    """The port's RenderConfig with the JAX config's field values."""
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    return RenderConfig(**dataclasses.asdict(cfg))


def np_(t) -> np.ndarray:
    """A torch tensor or JAX array as a numpy array."""
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _default_path_case():
    from kylespathtracer_tpu.render.camera import Camera
    from kylespathtracer_tpu.scene import default_scene
    from kylespathtracer_tpu.utils.config import RenderConfig

    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    return default_scene(), cam, RenderConfig(width=64, height=48, spp=2, max_depth=3)


def _dielectric_path_case():
    """The dielectric sphere scene of tests/test_path_kernel.py:49-56."""
    from kylespathtracer_tpu.render.camera import Camera
    from kylespathtracer_tpu.scene.scene import sphere_scene
    from kylespathtracer_tpu.utils.config import RenderConfig

    scene = sphere_scene(
        centers=[[0.0, 1.0, 6.0], [2.0, 1.2, 7.0], [-2.0, 1.0, 6.5]],
        radii=[1.0, 0.8, 0.9],
        albedos=[[0.7, 0.3, 0.2], [0.9, 0.9, 0.9], [0.95, 0.95, 0.95]],
        kinds=[0, 2, 3],  # diffuse, mirror, dielectric
    )
    cam = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0))
    return scene, cam, RenderConfig(width=48, height=32, spp=2, max_depth=4)


# The path tracer's JAX comparison cases, as tests/test_path_kernel.py runs
# them: (JAX scene, JAX camera, JAX RenderConfig).
PATH_CASES = {"default": _default_path_case, "dielectric": _dielectric_path_case}


def assert_path_bar(img, ref) -> None:
    """tests/test_path_kernel.py:38-41: finite, median |Δ| < 1e-6, under
    0.2% of the components beyond 1e-3."""
    d = np.abs(img - ref)
    assert np.isfinite(img).all()
    assert np.median(d) < 1e-6
    assert (d > 1e-3).mean() < 0.002, f"{(d > 1e-3).mean():.3%} differ"
