"""Interactive fly-cam: the reference's live app loop, over a terminal.

Port of kylespathtracer_tpu/app/fly.py. The reference polls GLFW and blits
to an OpenGL window at ~60 Hz (main.cpp:328-357). Here the renderer is
headless and usually remote, so the loop is: raw-mode stdin → key parse →
InputFrame → `update_controller` (the exact handleInput semantics,
app/controller.py) → one frame on the device → ANSI half-block preview.

Keys (mouse-look is remapped to the arrow keys):
    w/a/s/d   fly forward/left/back/right     (main.cpp:264-275)
    space/c   up / down                        (space/shift upstream, :276-279)
    arrows    look (injected as mouse drag deltas, main.cpp:241-262)
    q or ESC  quit

The controller's physics (friction 0.9, accel 0.01, rot 0.002, max speed
0.5) are those of playback (app/driver.py:playback_cameras); `parse_keys`
is the only new logic. `fly` needs an interactive terminal on stdin.
"""

from __future__ import annotations

import select
import sys
import time

import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE
from kylespathtracer_tpu_torch.app.controller import ControllerState, InputFrame, update_controller
from kylespathtracer_tpu_torch.render.pipeline import init_history, render_frame
from kylespathtracer_tpu_torch.scene.scene import default_scene
from kylespathtracer_tpu_torch.utils.config import RenderConfig
from kylespathtracer_tpu_torch.utils.preview import TerminalPreview

# One arrow keypress = this many pixels of virtual mouse drag.
ARROW_PX = 24.0


def parse_keys(data: bytes):
    """Pending raw tty bytes → (move xyz, look dx dy, quit).

    move is the camera-space intent vector (x right, y up, z forward);
    look is a virtual mouse drag in pixels (arrow keys)."""
    move = [0.0, 0.0, 0.0]
    look = [0.0, 0.0]
    quit_ = False
    arrows = {b"\x1b[A": (1, -ARROW_PX), b"\x1b[B": (1, ARROW_PX),  # up = negative dy
              b"\x1b[C": (0, ARROW_PX), b"\x1b[D": (0, -ARROW_PX)}
    keys = {b"w": (2, 1.0), b"s": (2, -1.0), b"a": (0, -1.0), b"d": (0, 1.0),
            b" ": (1, 1.0), b"c": (1, -1.0)}
    i = 0
    while i < len(data):
        c = data[i:i + 1]
        if c == b"\x1b":
            arrow = arrows.get(data[i:i + 3])
            if arrow is None:
                quit_ = True  # bare ESC
                i += 1
                continue
            look[arrow[0]] += arrow[1]
            i += 3
            continue
        key = keys.get(c.lower())
        if key is not None:
            move[key[0]] += key[1]
        elif c in (b"q", b"Q"):
            quit_ = True
        i += 1
    return [max(-1.0, min(1.0, v)) for v in move], look, quit_


def _read_pending(fd) -> bytes:
    out = b""
    while select.select([fd], [], [], 0)[0]:
        chunk = sys.stdin.buffer.raw.read(64)
        if not chunk:
            break
        out += chunk
    return out


def fly_step(config: RenderConfig):
    """One (controller tick + frame) step: (scene, state, inp, hist, frame)
    → (state, image, hist). Shared by the live loop and the tests."""

    def step(scene, state, inp, hist, frame):
        state = update_controller(state, inp)
        img, hist = render_frame(scene, state.camera, hist, frame, config)
        return state, img, hist

    return torch.no_grad()(step)


def fly(
    config: RenderConfig | None = None,
    scene=None,
    fps: float = 20.0,
    max_w: int = 100,
    max_h: int = 48,
    frames: int | None = None,
    device=DEFAULT_DEVICE,
):
    """Run the interactive loop until q/ESC (or `frames` steps) on `device`;
    by default at 480×270 through the fused frame on the card and the pass
    pipeline on the CPU. Returns at once, with a message, when stdin is not
    a terminal."""
    import termios
    import tty

    device = torch.device(device)
    if config is None:
        config = RenderConfig(width=480, height=270,
                              pipeline="fused" if device.type == "cuda" else "pass")
    if scene is None:
        scene = default_scene(device=device)

    state = ControllerState.create(device=device)
    hist = init_history(config, state.camera)
    step = fly_step(config)
    preview = TerminalPreview(max_w=max_w, max_h=max_h)

    if not sys.stdin.isatty():
        print("kpt fly: stdin is not a tty; run from an interactive terminal", file=sys.stderr)
        return

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    frame_s = 1.0 / fps
    try:
        i = 0
        t_last = time.perf_counter()
        while frames is None or i < frames:
            move, look, quit_ = parse_keys(_read_pending(fd))
            if quit_:
                break
            looking = bool(look[0] or look[1])
            inp = InputFrame.create(move=move, mouse_delta=look, mouse_down=looking, device=device)
            # Arrow-look needs down on consecutive frames (mouseP logic):
            # pre-arm was_down so a single arrow press takes effect.
            if looking:
                state = state.replace(was_down=torch.tensor(True, device=device))
            state, img, hist = step(scene, state, inp, hist, i)
            img = img.cpu().numpy()
            now = time.perf_counter()
            dt, t_last = now - t_last, now
            loc = [round(v, 2) for v in state.loc.tolist()]
            preview.show(img, caption=(
                f"frame {i}  {1.0 / max(dt, 1e-6):5.1f} fps  loc {loc}  "
                "wasd fly · space/c up/down · arrows look · q quit"))
            i += 1
            sleep = frame_s - (time.perf_counter() - now)
            if sleep > 0:
                time.sleep(sleep)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
