"""device.ms_per_step (ms), split by the end-to-end metric it moves:
device.ms_per_step.frame moves frame_ms (temporal.spline1080),
device.ms_per_step.step moves step_ms (inverse10.views1080),
device.ms_per_step.shard moves shard_step_ms (inverse10_rows4.step1080, on
rank 0's trace).

The union of the device's intervals in the traced window over the steps
(frames or optimizer steps) traced: the device's own time of a step, which
bounds the step from below."""


def read(ctx):
    busy = ctx.traced.busy_s()
    return busy * 1e3 / ctx.steps if busy > 0 and ctx.steps else None
