"""Frame-loop driver.

Port of kylespathtracer_tpu/app/driver.py: the scripted spline camera (the
benchmark path, geometry.frag:26-34) or a played-back input script drives
`render_frame` frame by frame; frames stream to PNG/PPM and the terminal
preview, metrics to JSONL, and the loop checkpoints its history and resumes
mid-sequence.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE
from kylespathtracer_tpu_torch.app.controller import ControllerState, InputFrame, update_controller
from kylespathtracer_tpu_torch.render.camera import Camera, camera_pose_spline
from kylespathtracer_tpu_torch.render.pipeline import History, init_history, render_frame
from kylespathtracer_tpu_torch.scene.types import Scene
from kylespathtracer_tpu_torch.utils import checkpoint as ckpt_mod
from kylespathtracer_tpu_torch.utils import image_io
from kylespathtracer_tpu_torch.utils.preview import TerminalPreview


def spline_cameras(num_frames: int, fps: float = 60.0, device=DEFAULT_DEVICE) -> Camera:
    """Stacked cameras along the reference's scripted spline
    (t = iTime·0.5 with iTime in seconds)."""
    times = torch.arange(num_frames, dtype=torch.float32) / fps
    locs, orients = camera_pose_spline(times)
    return Camera(loc=locs.to(device), orient=orients.to(device))


def playback_cameras(state: ControllerState, inputs: InputFrame) -> Camera:
    """Run a recorded input script (an `InputFrame` with a leading [T]
    axis) through the fly controller → the T cameras, stacked."""
    locs, orients = [], []
    for i in range(len(inputs)):
        state = update_controller(state, inputs[i])
        locs.append(state.loc)
        orients.append(state.orient)
    return Camera(loc=torch.stack(locs), orient=torch.stack(orients))


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
    frame, and `preview` shows each frame in the terminal
    (utils/preview.py), both timed after the frame has finished on the
    device. With `checkpoint_dir`, frame i's history is saved as step i
    when i is not 0 and a multiple of `checkpoint_every`; `resume=True`
    restores the newest step there and continues the sequence from the
    frame after it, bitwise as if never stopped."""
    device = scene.device
    if resume and checkpoint_dir:
        like = {"history": init_history(config, Camera.create(device=device))}
        try:
            step, state = ckpt_mod.restore(checkpoint_dir, like=like)
            history = state["history"]
            num_frames = max(0, start_frame + num_frames - (step + 1))
            start_frame = step + 1
            print(f"resumed from checkpoint step {step}")
        except FileNotFoundError:
            pass  # fresh start
    if cameras is None:
        cameras = spline_cameras(start_frame + num_frames, device=device)
    cameras = cameras.to(device)
    if history is None:
        history = init_history(config, cameras[0])
    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
    tty = TerminalPreview() if preview else None
    rays = config.width * config.height
    image = None
    for i in range(start_frame, start_frame + num_frames):
        t0 = time.perf_counter()
        image, history = render_frame(scene, cameras[i], history, i, config)
        if metrics is not None or tty is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
        if metrics is not None:
            metrics.log(frame=i, wall_s=round(dt, 6), rays_per_s=round(rays / dt, 1))
        if tty is not None:
            tty.show(image.cpu().numpy(),
                     caption=f"frame {i}  {dt * 1e3:.1f} ms  {rays / dt / 1e6:.1f} Mrays/s")
        if out_dir is not None and save_every and i % save_every == 0:
            image_io.save_image(Path(out_dir) / f"frame_{i:05d}.png", image)
        if checkpoint_dir and checkpoint_every and i and i % checkpoint_every == 0:
            ckpt_mod.save(checkpoint_dir, step=i, state={"history": history})
    if out_dir is not None:
        image_io.save_image(Path(out_dir) / "final.png", image)
    return image, history
