"""pipeline.plain_ms_per_step (ms): device time per frame of the events that
are neither K1 (`kpt::frame_kernel(`) nor K2 (`kpt::reproject_kernel(`):
the plain tensor code of render/pipeline.py (ray directions, anchors, the
tail, the composite; the reprojection's query heads run inside K2). Moves
frame_ms."""

KERNELS = ("kpt::frame_kernel(", "kpt::reproject_kernel(")


def read(ctx):
    if not ctx.traced.kernel_count(lambda n: n.startswith(KERNELS)):
        return None
    return ctx.traced.kernel_seconds(lambda n: not n.startswith(KERNELS)) * 1e3 / ctx.steps
