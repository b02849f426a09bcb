"""frame.ray_dirs.device_ms (ms a frame): device time of the work launched
inside the `frame.ray_dirs` span (render/pipeline.py:render_frame), the primary
rays' directions (render/camera.py:ray_dirs). Read by kpt_bench/spans.py from
the spans of the traced window. Moves frame_ms in temporal.spline1080."""

from kpt_bench.spans import stage_value


def read(ctx):
    return stage_value(ctx, "frame", "frame.ray_dirs", "device_ms")
