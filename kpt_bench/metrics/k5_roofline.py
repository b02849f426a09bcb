"""k5_roofline (%): the least time the card could take for K5's launches in
the traced window, over K5's device time there (events whose name starts
with `kpt::frame_grad_kernel(`). The least time is the larger of the
operations over the f32 peak, 67e12/s, and the bytes over HBM's 3.35e12 B/s
(the published peaks of the SXM part at 700 W; roofline.least_seconds).

K5 is the frame's reverse pass (csrc/frame_grad.cu on frame_adjoint.cuh):
it recomputes the frame and sweeps back through it, and the gradient of a
scalar costs at most ~3 times its forward's operations (reverse mode), so
3 × roofline.frame_ops on the launch's pixels (a tile's rows in row mode),
the shaded ones read from the reference's object ids; the bytes: the
tables, their gradients written once, and the cotangents of the 11 planes
the loss reads (alb, ene, add_d, add_s; not depth or curv) read once a
pixel. Counted from the scene's tables, the launch's size and its hits,
never from a measured rate.
"""

from kpt_bench import roofline

MATCH = "kpt::frame_grad_kernel("
COTANGENT_PLANES = 11


def work(f):
    """K5's (operations, bytes) per launch."""
    px = f["pixels"]
    ops = roofline.frame_ops(f["tree"], f["rc"], px, f["shaded"])
    return 3 * ops, 2 * roofline.table_bytes(f["tree"]) + px * COTANGENT_PLANES * 4


def read(ctx):
    n = ctx.traced.kernel_count(lambda name: name.startswith(MATCH))
    t = ctx.traced.kernel_seconds(lambda name: name.startswith(MATCH))
    if not n or t <= 0 or "tree" not in ctx.facts:
        return None
    ops, nbytes = work(ctx.facts)
    return 100.0 * roofline.least_seconds(ops * n, nbytes * n) / t
