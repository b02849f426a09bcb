"""frame.tail.launches (count a frame): device kernels, copies and fills
launched inside the `frame.tail` span
(render/pipeline.py:split_temporal_frame), the count floor, velocity clamp and
accumulate of both sets and the composite. Read by kpt_bench/spans.py from the
spans of the traced window. Moves frame_ms in temporal.spline1080."""

from kpt_bench.spans import stage_value


def read(ctx):
    return stage_value(ctx, "frame", "frame.tail", "launches")
