"""Fly-camera controller.

Port of kylespathtracer_tpu/app/controller.py, the reference's `handleInput`
(main.cpp:239-295): mouse-drag look with pitch clamp and yaw wrap,
WASD/arrow/space/shift fly with friction, dead stop and speed limit. GLFW
polling becomes an explicit `InputFrame`, the mutated globals (main.cpp:41-44)
a `ControllerState` of f32 tensors, so input playback is deterministic.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE
from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.render.camera import Camera

# Reference constants (main.cpp:36).
ACCEL_SPEED = 0.01
ROT_SPEED = 0.002
MAX_SPEED = 0.5


@dataclasses.dataclass(frozen=True)
class InputFrame:
    """One frame of user intent (the poll results of main.cpp:241-279), or
    a script of them with a leading [T] axis.

    move: f32[3] intent in camera space — x right, y up, z forward
          (each in {-1, 0, 1}; diagonals are normalized like the reference).
    mouse_delta: f32[2] cursor (dx, dy) in pixels since last frame.
    mouse_down: bool — left button held.
    """

    move: torch.Tensor
    mouse_delta: torch.Tensor
    mouse_down: torch.Tensor

    @classmethod
    def create(cls, move=(0.0, 0.0, 0.0), mouse_delta=(0.0, 0.0), mouse_down=False,
               device=DEFAULT_DEVICE) -> "InputFrame":
        return cls(
            move=torch.as_tensor(np.asarray(move, np.float32), device=device),
            mouse_delta=torch.as_tensor(np.asarray(mouse_delta, np.float32), device=device),
            mouse_down=torch.as_tensor(np.asarray(mouse_down, bool), device=device),
        )

    def __getitem__(self, i) -> "InputFrame":
        """Frame i of a script."""
        return InputFrame(self.move[i], self.mouse_delta[i], self.mouse_down[i])

    def __len__(self) -> int:
        return self.move.shape[0]


@dataclasses.dataclass(frozen=True)
class ControllerState:
    """Camera state carried frame to frame (the globals of main.cpp:41-44)."""

    loc: torch.Tensor       # f32[3]
    vel: torch.Tensor       # f32[3]
    orient: torch.Tensor    # f32[2] (pitch, yaw)
    was_down: torch.Tensor  # bool: mouse held last frame (mouseP, main.cpp:44)

    @classmethod
    def create(cls, loc=(-2.0, 2.5, -5.0), orient=(0.1, 1.8), device=DEFAULT_DEVICE
               ) -> "ControllerState":
        """Defaults are the reference's start pose (main.cpp:41-43)."""
        return cls(
            loc=torch.tensor(loc, dtype=torch.float32, device=device),
            vel=torch.zeros(3, dtype=torch.float32, device=device),
            orient=torch.tensor(orient, dtype=torch.float32, device=device),
            was_down=torch.tensor(False, device=device),
        )

    @property
    def camera(self) -> Camera:
        return Camera(loc=self.loc, orient=self.orient)

    def replace(self, **changes) -> "ControllerState":
        return dataclasses.replace(self, **changes)


def controller_state_from_numpy(tree: dict, device=DEFAULT_DEVICE) -> ControllerState:
    """The port's `ControllerState` from a JAX one given as numpy arrays."""
    return ControllerState(
        loc=torch.as_tensor(np.array(tree["loc"], np.float32), device=device),
        vel=torch.as_tensor(np.array(tree["vel"], np.float32), device=device),
        orient=torch.as_tensor(np.array(tree["orient"], np.float32), device=device),
        was_down=torch.as_tensor(np.array(tree["was_down"], bool), device=device),
    )


def _rotate_y(p: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Yaw-only rotation of the intent vector into the view frame
    (reference: main.cpp:48-54 — the pitch row is commented out upstream)."""
    c = torch.cos(yaw)
    s = torch.sin(yaw)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([x * c + z * s, y, -x * s + z * c], dim=-1)


def update_controller(state: ControllerState, inp: InputFrame) -> ControllerState:
    """One tick of `handleInput` (main.cpp:239-295), in f32 on the state's
    device. The two divisions are by tensors: on the card torch divides by
    a Python scalar as a multiply by its reciprocal."""
    # Mouse look: only while held on consecutive frames (main.cpp:248-258).
    rot = torch.where(inp.mouse_down & state.was_down, ROT_SPEED, 0.0)
    pitch = state.orient[0] + -inp.mouse_delta[1] * rot
    yaw = state.orient[1] + inp.mouse_delta[0] * rot
    pitch = torch.clamp(pitch, -gmath.HPI, gmath.HPI)
    yaw = torch.where(yaw < -gmath.PI, yaw + gmath.TWOPI, yaw)
    yaw = torch.where(yaw > gmath.PI, yaw - gmath.TWOPI, yaw)
    orient = torch.stack([pitch, yaw])

    # Normalize diagonal intent (main.cpp:280-281).
    mlen = gmath.length(inp.move)
    move = torch.where(mlen > 1.0, inp.move / torch.clamp(mlen, min=1e-6), inp.move)

    # Friction, world-frame acceleration, dead stop, speed cap
    # (main.cpp:283-293).
    vel = state.vel * 0.9 + _rotate_y(move * ACCEL_SPEED, yaw)
    speed = gmath.length(vel)
    vel = torch.where(speed < ACCEL_SPEED, 0.0, vel)
    cap = torch.full_like(speed, MAX_SPEED) / torch.clamp(speed, min=1e-6)
    vel = torch.where(speed > MAX_SPEED, vel * cap, vel)

    return ControllerState(loc=state.loc + vel, vel=vel, orient=orient, was_down=inp.mouse_down)
