"""fit.plain_ms_per_step (ms): device time per optimizer step of the events
that are not K6 (`kpt::loss_grad_kernel(`): diff/inverse.py's mean of the
views' losses and gradients, the gradients' unpacking and ClippedAdam's
update, all plain tensor code."""

K6 = "kpt::loss_grad_kernel("


def read(ctx):
    if not ctx.traced.kernel_count(lambda n: n.startswith(K6)):
        return None
    return ctx.traced.kernel_seconds(lambda n: not n.startswith(K6)) * 1e3 / ctx.steps
