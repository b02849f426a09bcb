"""fit.value_and_grad.launches (count an optimizer step): device kernels,
copies and fills launched inside the `fit.value_and_grad` span
(diff/inverse.py:value_and_grad: one K6 a view (each view's `fit.view` span
rolls up into it) and the views' mean), a child of the step's `fit.step` span
(diff/inverse.py:fit). Read by kpt_bench/spans.py from the spans of the traced
window. Moves step_ms in inverse10.views1080."""

from kpt_bench.spans import stage_value


def read(ctx):
    return stage_value(ctx, "fit.step", "fit.value_and_grad", "launches")
