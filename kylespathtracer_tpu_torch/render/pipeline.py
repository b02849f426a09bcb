"""The frame pipeline.

Port of kylespathtracer_tpu/render/pipeline.py:

    render_frame(scene, camera, history, frame, config) → (image, history)

`pipeline="fused"`: the temporal frame (`reproject_backend="window"`) is,
with `temporal_fusion="split"`, one frame-kernel launch (K1) and one launch
of K2 that does the rest for both channel sets: the primary rays and the
reprojection anchors, query heads, windowed reprojection, count floor,
velocity clamp, accumulate and the ACES composite; with
`"mono"`, one launch of the mono temporal kernel (K8) and the composite.
Both are forward-only, as the JAX paths are. The differentiable frame
(`no_history=True`, or `reproject_backend="xla"`) runs K1 through
ops/frame_grad.py, whose backward is K5, and the exact gather of
render/reproject.py. Any other `pipeline` is the pass pipeline: the
G-buffer (analytic, or sphere-traced with `intersect_mode="march"`), then
the diffuse and specular passes (render/passes.py, the shade kernel K4 with
`shade_backend="pallas"`), then the composite; differentiable with
`shade_backend="xla"`, through the intersectors' implicit-function backward
(scene/sdf.py). Everything runs on the scene's device.

Each frame is one `frame` span, and the split temporal frame's stages are
its child spans (STAGES), so a profiler trace splits the frame's device
time, launches and idle time by stage; outside a profiler a span is one
boolean check (utils/metrics.py:span).
"""

from __future__ import annotations

import dataclasses

import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE
from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import frame_hist as fh
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.render import composite as comp_mod
from kylespathtracer_tpu_torch.render import gbuffer as gb_mod
from kylespathtracer_tpu_torch.render import reproject as rep_mod
from kylespathtracer_tpu_torch.render.camera import Camera, camera_from_numpy
from kylespathtracer_tpu_torch.render.passes import (
    Channel,
    accumulate,
    channel_from_numpy,
    reprojection_anchors,
    shade_passes,
)
from kylespathtracer_tpu_torch.scene.types import Scene
from kylespathtracer_tpu_torch.utils.metrics import span

# The split temporal frame's profiler spans, in frame order; children of
# the `frame` span of render_frame (the tiled renderer's tiles have no
# `frame` span around them).
STAGES = ("frame.k1", "frame.reproject")


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
    """One frame → (sRGB image f32[H,W,3], new history), inside one `frame`
    span whatever the pipeline."""
    with span("frame"):
        if config.pipeline != "fused":
            return pass_frame(scene, camera, history, frame, config)
        if not _temporal_window(config):
            return differentiable_frame(scene, camera, history, frame, config)
        if config.temporal_fusion == "mono":
            return mono_temporal_frame(scene, camera, history, frame, config)
        return split_temporal_frame(scene, camera, history, frame, config)


def pass_frame(scene: Scene, camera: Camera, history: History, frame, config):
    """The pass pipeline (reference frame loop, main.cpp:344-350): the
    G-buffer → the fused diffuse + specular passes → composite."""
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

    hl, sl = reprojection_anchors(scene, camera, out, config.fov, config.height)
    vv = gmath.length(camera.loc - history.camera.loc)
    prev = history.camera

    # reproject_backend="xla": the exact arbitrary-motion gather.
    def accum(anchor, hist, add):
        rgb, cnt = rep_mod.reproject(prev.loc, prev.orient, anchor, ho, hist.rgb, hist.cnt,
                                     hist.oid, config.fov)
        return accumulate(rgb, cnt, add, vv, ho, config)

    d = accum(hl, history.diffuse, out["add_d"])
    s = accum(sl, history.specular, out["add_s"])
    image = comp_mod.composite_from(out["alb"], out["ene"], d, s, config)
    return image, History(diffuse=d, specular=s, camera=camera)


def split_temporal_frame(
    scene: Scene,
    camera: Camera,
    prev_hist: History,
    frame,
    config,
    row_base: int = 0,
    rows: int | None = None,
    hist_halo: int = 0,
):
    """Frame kernel + one launch of K2 for the rest: the primary rays and
    both reprojection anchors from K1's depth and curvature, both channel
    sets' windowed reprojection, count floor, velocity clamp and
    accumulate, and the ACES composite (ops/reproject_kernel.py:
    reproject_tail; on CPU tensors its plain twin).

    One body for the full frame (`rows` None) and the sharded renderer's
    tile (parallel/shard.py): image rows [row_base, row_base+rows), with a
    history window of rows + 2·hist_halo rows from the halo exchange, K1 in
    row mode and K2 in tile mode."""
    tile = rows is not None
    with span("frame.k1"):
        out = fk.frame_forward(scene, camera, frame, config, row_base, rows)
    with span("frame.reproject"):
        image, d, s = rk.reproject_tail(
            scene, camera, prev_hist.camera, out, prev_hist.diffuse, prev_hist.specular, config,
            image_height=config.height if tile else None, row_base=row_base, hist_halo=hist_halo,
        )
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
