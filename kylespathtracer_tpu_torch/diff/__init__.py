"""Inverse rendering (port of kylespathtracer_tpu/diff)."""
