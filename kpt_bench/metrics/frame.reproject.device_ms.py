"""frame.reproject.device_ms (ms a frame): device time of the work launched
inside the `frame.reproject` span (render/pipeline.py:split_temporal_frame),
the query heads of both channel sets and their K2 launches
(ops/reproject_kernel.py). Read by kpt_bench/spans.py from the spans of the
traced window. Moves frame_ms in temporal.spline1080."""

from kpt_bench.spans import stage_value


def read(ctx):
    return stage_value(ctx, "frame", "frame.reproject", "device_ms")
