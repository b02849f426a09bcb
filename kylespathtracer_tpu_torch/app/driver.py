"""Frame-loop driver.

Port of kylespathtracer_tpu/app/driver.py: the scripted spline camera (the
benchmark path, geometry.frag:26-34) drives `render_frame` frame by frame;
frames stream to PNG/PPM, metrics to JSONL. Checkpoint/resume (ROADMAP
Queue 1 #2) and the terminal preview (#4) are still to be ported and raise
if asked for.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE
from kylespathtracer_tpu_torch.render.camera import Camera, camera_pose_spline
from kylespathtracer_tpu_torch.render.pipeline import History, init_history, render_frame
from kylespathtracer_tpu_torch.scene.types import Scene
from kylespathtracer_tpu_torch.utils import image_io


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
    device → (last image, history). Frame i uses cameras[i]. With `out_dir`,
    every `save_every`-th frame goes to frame_<i>.png there and the last to
    final.png; `metrics` (utils/metrics.MetricsLogger) gets one record per
    frame, its wall time taken after the frame has finished on the device."""
    unported = {
        "checkpoint_dir": checkpoint_dir, "checkpoint_every": checkpoint_every,
        "preview": preview, "resume": resume,
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(
            f"render_animation: {', '.join(asked)} not ported yet "
            "(ROADMAP Queue 1 #2: checkpoint and resume; #4: the preview)"
        )
    device = scene.device
    if cameras is None:
        cameras = spline_cameras(start_frame + num_frames, device=device)
    cameras = cameras.to(device)
    if history is None:
        history = init_history(config, cameras[0])
    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
    rays = config.width * config.height
    image = None
    for i in range(start_frame, start_frame + num_frames):
        t0 = time.perf_counter()
        image, history = render_frame(scene, cameras[i], history, i, config)
        if metrics is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            metrics.log(frame=i, wall_s=round(dt, 6), rays_per_s=round(rays / dt, 1))
        if out_dir is not None and save_every and i % save_every == 0:
            image_io.save_image(Path(out_dir) / f"frame_{i:05d}.png", image)
    if out_dir is not None:
        image_io.save_image(Path(out_dir) / "final.png", image)
    return image, history
