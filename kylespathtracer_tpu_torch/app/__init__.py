"""Application layer: frame-loop driver, fly-camera controller, CLI (port
of kylespathtracer_tpu/app)."""

from kylespathtracer_tpu_torch.app.controller import ControllerState, InputFrame, update_controller
from kylespathtracer_tpu_torch.app.driver import render_animation

__all__ = ["ControllerState", "InputFrame", "update_controller", "render_animation"]
