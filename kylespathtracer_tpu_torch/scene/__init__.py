"""Scene tables and builders (port of kylespathtracer_tpu/scene)."""
