"""pathtrace.outside.idle_ms (ms an image): the device's idle time in the
traced window under no stage span of an image: the loop between images (its
sync on the image), render_pathtraced's own code between its stages. Read by
kpt_bench/spans.py from the spans of the traced window. Moves frame_ms in
pathtrace.spp4_1080."""

from kpt_bench.spans import stage_value


def read(ctx):
    return stage_value(ctx, "pathtrace", "pathtrace.outside", "idle_ms")
