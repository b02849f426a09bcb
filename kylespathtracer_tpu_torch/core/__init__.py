"""Math, sampler and color toolkit (port of kylespathtracer_tpu/core)."""
