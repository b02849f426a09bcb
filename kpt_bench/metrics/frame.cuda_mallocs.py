"""frame.cuda_mallocs (count a frame): the `cudaMalloc` runtime calls inside
the `frame` spans (render/pipeline.py:render_frame): the caching allocator
growing in the steady state, which a CUDA graph of the frame would have to rule
out. Read by kpt_bench/spans.py from the spans of the traced window. Moves
frame_ms in temporal.spline1080."""

from kpt_bench.spans import split


def read(ctx):
    s = split(ctx.traced, "frame")
    return None if s is None else s["mallocs"]
