"""frame.outside.idle_ms (ms a frame): the device's idle time in the traced
window under no stage span of a frame: the loop between frames (its sync on the
displayed image), render_frame's own code between its stages. Read by
kpt_bench/spans.py from the spans of the traced window. Moves frame_ms in
temporal.spline1080."""

from kpt_bench.spans import stage_value


def read(ctx):
    return stage_value(ctx, "frame", "frame.outside", "idle_ms")
