"""device.idle_share (%), split by the end-to-end metric it moves:
device.idle_share.frame moves frame_ms (temporal.spline1080),
device.idle_share.step moves step_ms (inverse10.views1080),
device.idle_share.shard moves shard_step_ms (inverse10_rows4.step1080, read
on rank 0's trace).

1 - the union of the kernel, copy and fill intervals (trace.union_us) over
the traced window's span. Read under the profiler, whose own host cost
stretches the window, so it reads higher than an untraced run would."""


def read(ctx):
    busy = ctx.traced.busy_s()
    if ctx.traced.window_s <= 0 or busy <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - busy / ctx.traced.window_s)
