"""Render configuration.

The same knobs and defaults as the JAX package's `RenderConfig`
(kylespathtracer_tpu/utils/config.py), copied rather than imported: that
package imports jax. Maps 1:1 onto the reference's compile-time quality
knobs (common.glsl:1-29) plus execution options. The PyTorch port serves
every `pipeline`, `reproject_backend`, `temporal_fusion`, `intersect_mode`
and `normal_mode`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Image.
    width: int = 1280          # reference window size (main.cpp:302)
    height: int = 720
    # Quality knobs (reference: common.glsl:1-29).
    biased: bool = True        # BIASED: MIS estimators vs unbiased ground truth
    bounces: int = 1           # BOUNCES (unused by the reference's estimators)
    steps: int = 255           # STEPS: max sphere-trace iterations
    temporal: int = 16         # TEMPORALSMOOTHING: history frames
    smp_direct_lambert: int = 1
    smp_lambert_surface_lambert: int = 1
    smp_lambert_surface_phong: int = 1
    smp_direct_phong: int = 1
    smp_phong_surface_lambert: int = 1
    smp_phong_surface_phong: int = 1
    smp_unbias: int = 4        # SMP_UNBIAS (unused by the reference)
    bias_weight: float = 1.0   # BIAS_WEIGHT (dead in the reference too)
    # Hash the per-sample streams instead of the reference's `seed + i`.
    decorrelate_samples: bool = False
    # Wavefront multi-bounce integrator.
    max_depth: int = 6
    spp: int = 1
    gloss: float = 5.0         # Phong exponent (common.glsl:536 et al.)
    brightness: float = 10.0   # exposure (passthrough.frag:27)
    intersect_mode: str = "analytic"   # "march" | "analytic"
    normal_mode: str = "auto"          # "auto" | "analytic" | "tetra"
    shade_backend: str = "xla"         # "xla" | "pallas"
    # Frame pipeline: "pass" (G-buffer, then the diffuse and specular passes)
    # or "fused" (the frame kernel plus windowed reprojection).
    pipeline: str = "pass"
    # Reprojection backend for the fused pipeline: "window" (bounded
    # ±reproject_window select kernel) or "xla" (exact gather).
    reproject_backend: str = "window"
    reproject_window: int = 4
    # "split" (frame kernel + reprojection kernel with the tail) or "mono".
    temporal_fusion: str = "split"
    path_backend: str = "auto"
    # Treat the previous history as empty (single-frame render).
    no_history: bool = False
    # Soft sphere visibility for the direct light (beta > 0).
    soft_shadows: float = 0.0
    # Camera (reference: common.glsl:33 FOV).
    fov: float = 1.5
    dtype: str = "float32"

    @property
    def resolution(self) -> tuple[int, int]:
        return (self.width, self.height)

    @property
    def aspect(self) -> float:
        return self.width / self.height
