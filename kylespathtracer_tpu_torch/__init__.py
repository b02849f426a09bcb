"""kylespathtracer_tpu_torch — the path tracer on PyTorch and CUDA.

A port of kylespathtracer_tpu (JAX + Pallas for the TPU) to PyTorch, with
hand-written CUDA C++ kernels for NVIDIA Hopper (sm_90a) in place of the
Pallas kernels. Same layout and names as the JAX package:

  core/    math, sampler, color
  scene/   scene tables and builders
  render/  camera, reprojection, passes and MIS estimators, composite,
           pipeline, G-buffer, BSDFs, wavefront path integrator
  ops/     kernel wrappers (CUDA on CUDA tensors, plain tensor code on the
           CPU) and the nvcc build/loader
  csrc/    the CUDA sources
  diff/    inverse rendering (fit, run_recovery), soft visibility
  app/     frame-loop driver, CLI (`render`, `pathtrace`)
  utils/   config, image export, metrics

Every entry point that makes tensors runs on the card unless the caller
passes `device=` (DEFAULT_DEVICE); without a card such a call raises, as
torch does. Imports torch only; never jax or the JAX package.
"""

# The device the entry points make their tensors on unless told otherwise.
DEFAULT_DEVICE = "cuda"

from kylespathtracer_tpu_torch.utils.config import RenderConfig
from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene
from kylespathtracer_tpu_torch.scene.types import BSDF, OBJ, Materials, Scene, bsdf_table
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.render.gbuffer import GBuffer, geometry_pass
from kylespathtracer_tpu_torch.render.wavefront import pathtrace, render_pathtraced
from kylespathtracer_tpu_torch.render.pipeline import (
    History,
    init_history,
    render_frame,
    render_image,
    render_sequence,
)

__all__ = [
    "RenderConfig", "default_scene", "sphere_scene", "BSDF", "OBJ",
    "Materials", "Scene", "bsdf_table", "Camera", "GBuffer", "geometry_pass",
    "pathtrace", "render_pathtraced", "History", "init_history",
    "render_frame", "render_image", "render_sequence",
]
