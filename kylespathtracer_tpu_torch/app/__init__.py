"""Frame-loop driver (port of kylespathtracer_tpu/app)."""
