"""Frame-loop driver.

Port of kylespathtracer_tpu/app/driver.py: the scripted spline camera (the
benchmark path, geometry.frag:26-34) drives `render_frame` frame by frame.
Image output, metrics, checkpoint/resume and the terminal preview are
still to be ported (ROADMAP Queue 1 #14) and raise if asked for.
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE
from kylespathtracer_tpu_torch.render.camera import Camera, camera_pose_spline
from kylespathtracer_tpu_torch.render.pipeline import History, init_history, render_frame
from kylespathtracer_tpu_torch.scene.types import Scene


def spline_cameras(num_frames: int, fps: float = 60.0, device=DEFAULT_DEVICE) -> Camera:
    """Stacked cameras along the reference's scripted spline
    (t = iTime·0.5 with iTime in seconds)."""
    times = torch.arange(num_frames, dtype=torch.float32) / fps
    locs, orients = camera_pose_spline(times)
    return Camera(loc=locs.to(device), orient=orients.to(device))


@torch.no_grad()
def render_animation(
    scene: Scene,
    config,
    num_frames: int = 64,
    cameras: Camera | None = None,
    history: History | None = None,
    start_frame: int = 0,
    out_dir=None,
    save_every: int = 0,
    metrics=None,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
    preview: bool = False,
    resume: bool = False,
):
    """Render frames [start_frame, start_frame+num_frames) on the scene's
    device → (last image, history). Frame i uses cameras[i]."""
    unported = {
        "out_dir": out_dir, "save_every": save_every, "metrics": metrics,
        "checkpoint_dir": checkpoint_dir, "checkpoint_every": checkpoint_every,
        "preview": preview, "resume": resume,
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(
            f"render_animation: {', '.join(asked)} not ported yet "
            "(ROADMAP Queue 1 #14)"
        )
    device = scene.device
    if cameras is None:
        cameras = spline_cameras(start_frame + num_frames, device=device)
    cameras = cameras.to(device)
    if history is None:
        history = init_history(config, cameras[0])
    image = None
    for i in range(start_frame, start_frame + num_frames):
        image, history = render_frame(scene, cameras[i], history, i, config)
    return image, history
