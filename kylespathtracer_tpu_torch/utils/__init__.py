"""Configuration (port of kylespathtracer_tpu/utils)."""
