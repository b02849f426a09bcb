"""The frame pipeline.

Port of kylespathtracer_tpu/render/pipeline.py for the fused temporal
frame (`pipeline="fused"`, `reproject_backend="window"`,
`temporal_fusion="split"`):

    render_frame(scene, camera, history, frame, config) → (image, history)

Each frame is one frame-kernel launch (K1), one windowed-reprojection
launch per channel set (K2), and a short tail of tensor ops (count floor,
velocity clamp, accumulate, ACES composite). Everything runs on the
scene's device. Forward-only, as the JAX path is.

The stages are `torch.profiler` spans (STAGES), so a profiler trace splits
the frame's device time by stage; outside a profiler they cost a few
microseconds per frame.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.render import camera as cam_mod
from kylespathtracer_tpu_torch.render import composite as comp_mod
from kylespathtracer_tpu_torch.render.camera import Camera, camera_from_numpy
from kylespathtracer_tpu_torch.render.passes import (
    Channel,
    _temporal_clamp,
    channel_from_numpy,
    count_floor,
)
from kylespathtracer_tpu_torch.scene.types import Scene

# Profiler span names, in frame order.
STAGES = ("frame.ray_dirs", "frame.k1", "frame.anchors", "frame.reproject", "frame.tail")


@dataclasses.dataclass(frozen=True)
class History:
    diffuse: Channel
    specular: Channel
    camera: Camera  # the camera the buffers were rendered with

    @classmethod
    def zeros(cls, config, camera: Camera) -> "History":
        dev = camera.loc.device
        return cls(
            diffuse=Channel.zeros(config.height, config.width, dev),
            specular=Channel.zeros(config.height, config.width, dev),
            camera=camera,
        )

    def to(self, device) -> "History":
        return History(self.diffuse.to(device), self.specular.to(device),
                       self.camera.to(device))


def history_from_numpy(tree: dict, device="cpu") -> History:
    """The port's `History` from a JAX `History` given as numpy arrays
    (dicts for `diffuse`, `specular` and `camera`)."""
    return History(
        diffuse=channel_from_numpy(tree["diffuse"], device),
        specular=channel_from_numpy(tree["specular"], device),
        camera=camera_from_numpy(tree["camera"], device),
    )


def init_history(config, camera: Camera | None = None, device="cpu") -> History:
    return History.zeros(config, camera or Camera.create(device=device))


def _check_supported(config) -> None:
    """The port serves the fused temporal frame only; the other branches of
    the JAX `render_frame` are still to be ported (ROADMAP.md Queue 1)."""
    unported = (
        (config.pipeline != "fused",
         f"pipeline={config.pipeline!r} (ROADMAP Queue 1 #11, the pass pipeline)"),
        (config.no_history,
         "no_history=True (ROADMAP Queue 1 #9, the differentiable frame)"),
        (config.reproject_backend != "window",
         f"reproject_backend={config.reproject_backend!r} (ROADMAP Queue 1 #9)"),
        (config.temporal_fusion != "split",
         f"temporal_fusion={config.temporal_fusion!r} (ROADMAP Queue 1 #12)"),
    )
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"the PyTorch port does not serve {what} yet")


def render_frame(
    scene: Scene,
    camera: Camera,
    history: History,
    frame,
    config,
) -> tuple[torch.Tensor, History]:
    """One temporal frame → (sRGB image f32[H,W,3], new history)."""
    _check_supported(config)
    with record_function("frame.ray_dirs"):
        rd = cam_mod.ray_dirs(camera, config.width, config.height, config.fov)
    return split_temporal_frame(scene, camera, history, frame, config, rd)


def split_temporal_frame(
    scene: Scene,
    camera: Camera,
    prev_hist: History,
    frame,
    config,
    rd: torch.Tensor,  # primary ray dirs f32[H,W,3] (normalize_fast)
):
    """Frame kernel + one windowed reprojection per channel set + count
    floor / velocity clamp / accumulate + ACES composite (full frame)."""
    with record_function("frame.k1"):
        out = fk.frame_forward(scene, camera, frame, config)
    with record_function("frame.anchors"):
        # Hit point + curvature-pushed specular anchor (specular.frag:45-49).
        hl = camera.loc + rd * out["depth"][..., None]
        light_dist = gmath.length(hl - scene.light[:3])
        fac = gmath.EPS / torch.sqrt(torch.clamp(out["curv"], min=gmath.EPS))
        sl = hl + rd * (light_dist * fac)[..., None]
        vv = gmath.length(camera.loc - prev_hist.camera.loc)
    with record_function("frame.reproject"):
        (rgb_d, cnt_d), (rgb_s, cnt_s) = rk.reproject_window(
            prev_hist.camera, hl, sl, out["oid"],
            prev_hist.diffuse, prev_hist.specular, config.fov,
            window=config.reproject_window,
        )

    def accum(rgb, cnt, add):
        cnt = count_floor(cnt)
        rgb, cnt = _temporal_clamp(rgb, cnt, vv, config)
        return Channel(rgb=rgb + add, cnt=cnt + 1.0, oid=out["oid"])

    with record_function("frame.tail"):
        d = accum(rgb_d, cnt_d, out["add_d"])
        s = accum(rgb_s, cnt_s, out["add_s"])
        image = comp_mod.composite_from(out["alb"], out["ene"], d, s, config)
    return image, History(diffuse=d, specular=s, camera=camera)


@torch.no_grad()
def render_image(scene: Scene, camera: Camera, config, frames: int = 1,
                 history: History | None = None):
    """Render `frames` frames with a static camera → (last image, history)."""
    if history is None:
        history = init_history(config, camera)
    image = None
    for i in range(frames):
        image, history = render_frame(scene, camera, history, i, config)
    return image, history


@torch.no_grad()
def render_sequence(scene: Scene, cameras: Camera, history: History, config,
                    start_frame: int = 0):
    """Render along a stacked camera path (leaves with leading axis [T])
    → (images[T,H,W,3], history). A Python loop over `render_frame`."""
    images = []
    for i in range(len(cameras)):
        img, history = render_frame(scene, cameras[i], history, start_frame + i, config)
        images.append(img)
    return torch.stack(images), history
