"""pipeline.launches_per_step (count): device kernel, copy and fill events
per frame in the traced window: K1, 2 × K2 and the plain tensor code of
render/pipeline.py, each a launch the host pays for. Moves frame_ms."""

from kpt_bench.trace import device_events


def read(ctx):
    n = len(device_events(ctx.traced.events))
    return n / ctx.steps if n and ctx.steps else None
