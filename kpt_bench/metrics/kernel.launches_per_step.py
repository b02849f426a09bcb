"""kernel.launches_per_step (count), split by the end-to-end metric it moves:
kernel.launches_per_step.frame moves frame_ms (temporal.spline1080: K1 and
K2 a frame), kernel.launches_per_step.step moves step_ms
(inverse10.views1080: one K6 a view of an optimizer step),
kernel.launches_per_step.shard moves shard_step_ms
(inverse10_rows4.step1080: K1 and K5 in row mode a step, on rank 0).

The program's own launch counters of its hand-written kernels over the
window, per step, summed: `LAUNCHES` of every module of its ops package
that keeps one (harness.counted_modules; nine: K1-K9's wrappers), so a
kernel a cell adds is counted with no edit here."""


def read(ctx):
    return sum(ctx.counters.values()) or None
