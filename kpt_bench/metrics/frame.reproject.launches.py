"""frame.reproject.launches (count a frame): device kernels, copies and fills
launched inside the `frame.reproject` span
(render/pipeline.py:split_temporal_frame), one K2 launch
(ops/reproject_kernel.py) for both channel sets, their query heads computed
in the kernel. Read by kpt_bench/spans.py from the spans of the traced
window. Moves frame_ms in temporal.spline1080."""

from kpt_bench.spans import stage_value


def read(ctx):
    return stage_value(ctx, "frame", "frame.reproject", "launches")
