"""frame.k1.idle_ms (ms a frame): the device's idle time while the host is
inside the `frame.k1` span (render/pipeline.py:split_temporal_frame), K1's
wrapper and launch (ops/frame_kernel.py:frame_forward). Read by
kpt_bench/spans.py from the spans of the traced window. Moves frame_ms in
temporal.spline1080."""

from kpt_bench.spans import stage_value


def read(ctx):
    return stage_value(ctx, "frame", "frame.k1", "idle_ms")
