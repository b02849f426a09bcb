"""fit.update.launches (count an optimizer step): device kernels, copies and
fills launched inside the `fit.update` span
(diff/inverse.py:ClippedAdam.update: the global-norm clip, Adam's step and the
schedule), a child of the step's `fit.step` span (diff/inverse.py:fit). Read by
kpt_bench/spans.py from the spans of the traced window. Moves step_ms in
inverse10.views1080."""

from kpt_bench.spans import stage_value


def read(ctx):
    return stage_value(ctx, "fit.step", "fit.update", "launches")
