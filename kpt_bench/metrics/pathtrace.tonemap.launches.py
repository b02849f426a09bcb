"""pathtrace.tonemap.launches (count an image): device kernels, copies and fills
launched inside the `pathtrace.tonemap` span
(render/wavefront.py:render_pathtraced): exposure, ACES fitted and sRGB on the
radiance image. Read by kpt_bench/spans.py from the spans of the traced window.
Moves frame_ms in pathtrace.spp4_1080."""

from kpt_bench.spans import stage_value


def read(ctx):
    return stage_value(ctx, "pathtrace", "pathtrace.tonemap", "launches")
