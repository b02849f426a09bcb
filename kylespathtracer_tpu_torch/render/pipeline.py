"""The frame pipeline.

Port of kylespathtracer_tpu/render/pipeline.py:

    render_frame(scene, camera, history, frame, config) → (image, history)

`pipeline="fused"`: the temporal frame (`reproject_backend="window"`) is,
with `temporal_fusion="split"`, one frame-kernel launch (K1), one
windowed-reprojection launch per channel set (K2), and a short tail of
tensor ops (count floor, velocity clamp, accumulate, ACES composite); with
`"mono"`, one launch of the mono temporal kernel (K8) and the composite.
Both are forward-only, as the JAX paths are. The differentiable frame
(`no_history=True`, or `reproject_backend="xla"`) runs K1 through
ops/frame_grad.py, whose backward is K5, and the exact gather of
render/reproject.py. Any other `pipeline` is the pass pipeline: the
analytic G-buffer, then the diffuse and specular passes (render/passes.py,
the shade kernel K4 with `shade_backend="pallas"`), then the composite;
forward-only. Everything runs on the scene's device.

The stages are `torch.profiler` spans (STAGES), so a profiler trace splits
the frame's device time by stage; outside a profiler they cost a few
microseconds per frame.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from kylespathtracer_tpu_torch import DEFAULT_DEVICE
from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import frame_hist as fh
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.render import camera as cam_mod
from kylespathtracer_tpu_torch.render import composite as comp_mod
from kylespathtracer_tpu_torch.render import gbuffer as gb_mod
from kylespathtracer_tpu_torch.render import reproject as rep_mod
from kylespathtracer_tpu_torch.render.camera import Camera, camera_from_numpy
from kylespathtracer_tpu_torch.render.passes import (
    Channel,
    _temporal_clamp,
    channel_from_numpy,
    count_floor,
    shade_passes,
    specular_anchor,
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


def history_from_numpy(tree: dict, device=DEFAULT_DEVICE) -> History:
    """The port's `History` from a JAX `History` given as numpy arrays
    (dicts for `diffuse`, `specular` and `camera`)."""
    return History(
        diffuse=channel_from_numpy(tree["diffuse"], device),
        specular=channel_from_numpy(tree["specular"], device),
        camera=camera_from_numpy(tree["camera"], device),
    )


def init_history(config, camera: Camera | None = None, device=DEFAULT_DEVICE) -> History:
    return History.zeros(config, camera or Camera.create(device=device))


def _temporal_window(config) -> bool:
    """The forward-only temporal frame (windowed reprojection); every other
    fused frame is the differentiable one."""
    return not config.no_history and config.reproject_backend == "window"


def render_frame(
    scene: Scene,
    camera: Camera,
    history: History,
    frame,
    config,
) -> tuple[torch.Tensor, History]:
    """One frame → (sRGB image f32[H,W,3], new history)."""
    if config.pipeline != "fused":
        return pass_frame(scene, camera, history, frame, config)
    if not _temporal_window(config):
        return differentiable_frame(scene, camera, history, frame, config)
    if config.temporal_fusion == "mono":
        return mono_temporal_frame(scene, camera, history, frame, config)
    with record_function("frame.ray_dirs"):
        rd = cam_mod.ray_dirs(camera, config.width, config.height, config.fov)
    return split_temporal_frame(scene, camera, history, frame, config, rd)


def pass_frame(scene: Scene, camera: Camera, history: History, frame, config):
    """The pass pipeline (reference frame loop, main.cpp:344-350): the
    analytic G-buffer → the fused diffuse + specular passes → composite.
    `intersect_mode="march"` and tetrahedron normals raise (ROADMAP Queue
    1 #11)."""
    gb = gb_mod.geometry_pass(scene, camera, config)
    d, s = shade_passes(scene, config, gb, camera, history.camera,
                        history.diffuse, history.specular, frame)
    image = comp_mod.composite(scene, config, gb, camera, d, s)
    return image, History(diffuse=d, specular=s, camera=camera)


def mono_temporal_frame(scene: Scene, camera: Camera, history: History, frame, config):
    """The whole temporal frame in one kernel launch (ops/frame_hist.py,
    K8: shade + windowed reprojection + clamp + accumulate), then the
    composite."""
    o = fh.frame_hist(scene, camera, history.camera, history.diffuse, history.specular,
                      frame, config)
    d = Channel(rgb=o["d_rgb"], cnt=o["d_cnt"], oid=o["oid"])
    s = Channel(rgb=o["s_rgb"], cnt=o["s_cnt"], oid=o["oid"])
    image = comp_mod.composite_from(o["alb"], o["ene"], d, s, config)
    return image, History(diffuse=d, specular=s, camera=camera)


def differentiable_frame(scene: Scene, camera: Camera, history: History, frame, config):
    """The frame kernel with its backward kernel (ops/frame_grad.py) plus
    the exact reprojection gather: differentiable in the scene, the camera
    and the history. `no_history` renders a fresh single frame and skips
    the gather of an all-zero history (the same image)."""
    out = fg.frame_forward(scene, camera, frame, config)
    ho = out["oid"]

    if config.no_history:
        ones = torch.ones(ho.shape, dtype=torch.float32, device=ho.device)
        d = Channel(rgb=out["add_d"], cnt=ones, oid=ho)
        s = Channel(rgb=out["add_s"], cnt=ones, oid=ho)
        image = comp_mod.composite_from(out["alb"], out["ene"], d, s, config)
        return image, History(diffuse=d, specular=s, camera=camera)

    rd = cam_mod.ray_dirs(camera, config.width, config.height, config.fov)
    hl, sl = _anchors(scene, camera, rd, out)
    vv = gmath.length(camera.loc - history.camera.loc)
    prev = history.camera

    # reproject_backend="xla": the exact arbitrary-motion gather.
    def accum(anchor, hist, add):
        rgb, cnt = rep_mod.reproject(prev.loc, prev.orient, anchor, ho, hist.rgb, hist.cnt,
                                     hist.oid, config.fov)
        return _accumulate(rgb, cnt, add, vv, ho, config)

    d = accum(hl, history.diffuse, out["add_d"])
    s = accum(sl, history.specular, out["add_s"])
    image = comp_mod.composite_from(out["alb"], out["ene"], d, s, config)
    return image, History(diffuse=d, specular=s, camera=camera)


def _anchors(scene: Scene, camera: Camera, rd: torch.Tensor, out: dict):
    """The reprojection anchors: the hit point and the curvature-pushed
    specular anchor (specular.frag:45-49)."""
    hl = camera.loc + rd * out["depth"][..., None]
    return hl, specular_anchor(scene, hl, rd, out["curv"])


def _accumulate(rgb, cnt, add, vv, oid, config) -> Channel:
    """Reprojected history → count floor, velocity clamp, plus this frame's
    sample (diffuse.frag:46-56)."""
    rgb, cnt = _temporal_clamp(rgb, count_floor(cnt), vv, config)
    return Channel(rgb=rgb + add, cnt=cnt + 1.0, oid=oid)


def split_temporal_frame(
    scene: Scene,
    camera: Camera,
    prev_hist: History,
    frame,
    config,
    rd: torch.Tensor,  # primary ray dirs f32[rows,W,3] (normalize_fast)
    row_base: int = 0,
    rows: int | None = None,
    hist_halo: int = 0,
):
    """Frame kernel + one windowed reprojection per channel set + count
    floor / velocity clamp / accumulate + ACES composite.

    One body for the full frame (`rows` None) and the sharded renderer's
    tile (parallel/shard.py): image rows [row_base, row_base+rows), with a
    history window of rows + 2·hist_halo rows from the halo exchange, K1 in
    row mode and K2 in tile mode."""
    tile = rows is not None
    with record_function("frame.k1"):
        out = fk.frame_forward(scene, camera, frame, config, row_base, rows)
    with record_function("frame.anchors"):
        hl, sl = _anchors(scene, camera, rd, out)
        vv = gmath.length(camera.loc - prev_hist.camera.loc)
    with record_function("frame.reproject"):
        (rgb_d, cnt_d), (rgb_s, cnt_s) = rk.reproject_window(
            prev_hist.camera, hl, sl, out["oid"],
            prev_hist.diffuse, prev_hist.specular, config.fov,
            window=config.reproject_window,
            image_height=config.height if tile else None,
            row_base=row_base, hist_halo=hist_halo,
        )

    with record_function("frame.tail"):
        d = _accumulate(rgb_d, cnt_d, out["add_d"], vv, out["oid"], config)
        s = _accumulate(rgb_s, cnt_s, out["add_s"], vv, out["oid"], config)
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
