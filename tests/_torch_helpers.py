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
