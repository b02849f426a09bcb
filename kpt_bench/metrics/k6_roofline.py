"""k6_roofline (%): the least time the card could take for K6's launches in
the traced window, over K6's device time there (events whose name starts
with `kpt::loss_grad_kernel(`). The least time is the larger of the operations over
the f32 peak, 67e12/s, and the bytes over HBM's 3.35e12 B/s (the published
peaks of the SXM part at 700 W; roofline.least_seconds).

The count: K6 is the frame, the fresh-history composite and the loss, and
their reverse pass: the gradient of a scalar costs at most ~3 times its
forward's operations (reverse mode), so 3 × (roofline.frame_ops + ~120 a
pixel for the composite, ACES, sRGB and the squared error), the shaded
pixels read from the reference's object ids of the first view at the start;
the bytes: the tables and the target image read once.
Counted from the scene's tables, the frame's size and its hits, never from
a measured rate.
"""

from kpt_bench import roofline

MATCH = "kpt::loss_grad_kernel("


def work(f):
    """K6's (operations, bytes) per launch."""
    px = f["pixels"]
    ops = roofline.frame_ops(f["tree"], f["rc"], px, f["shaded"])
    return 3 * (ops + 120 * px), roofline.table_bytes(f["tree"]) + px * 3 * 4


def read(ctx):
    n = ctx.traced.kernel_count(lambda name: name.startswith(MATCH))
    t = ctx.traced.kernel_seconds(lambda name: name.startswith(MATCH))
    if not n or t <= 0 or "tree" not in ctx.facts:
        return None
    ops, nbytes = work(ctx.facts)
    return 100.0 * roofline.least_seconds(ops * n, nbytes * n) / t
