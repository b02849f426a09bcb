"""pathtrace.paths.idle_ms (ms an image): the device's idle time while the host is
inside the `pathtrace.paths` span (render/wavefront.py:render_pathtraced), K7's
wrapper and launch (ops/path_kernel.py:pathtrace). Read by kpt_bench/spans.py
from the spans of the traced window. Moves frame_ms in pathtrace.spp4_1080."""

from kpt_bench.spans import stage_value


def read(ctx):
    return stage_value(ctx, "pathtrace", "pathtrace.paths", "idle_ms")
