"""kernel.launches_per_step (count), split by the end-to-end metric it moves:
kernel.launches_per_step.frame moves frame_ms (temporal.spline1080: K1 and
K2 a frame), kernel.launches_per_step.step moves step_ms
(inverse10.views1080: one K6 a view of an optimizer step),
kernel.launches_per_step.shard moves shard_step_ms
(inverse10_rows4.step1080: K1 and K5 in row mode a step, on rank 0).

The program's own launch counters of its hand-written kernels (`LAUNCHES`
in ops/frame_kernel.py, reproject_kernel.py, frame_grad.py,
loss_kernel.py) over the window, per step."""


def read(ctx):
    return sum(ctx.counters.values()) or None
