"""k1_roofline (%): the least time the card could take for K1's launches in
the traced window, over K1's device time there (events whose name starts
with `kpt::frame_kernel(`). The least time is the larger of the operations over
the f32 peak, 67e12/s, and the bytes over HBM's 3.35e12 B/s (the published
peaks of the SXM part at 700 W; roofline.least_seconds).

The count: the fused frame (roofline.frame_ops) on the frame's pixels, of
which the shaded ones are read from the reference's object ids of the frames
the check compared; the bytes: the tables once and the 13 f32 output planes
and the i32 object id written once a pixel.
Counted from the scene's tables, the frame's size and its hits, never from
a measured rate.
"""

from kpt_bench import roofline

MATCH = "kpt::frame_kernel("


def work(f):
    """K1's (operations, bytes) per launch."""
    px = f["pixels"]
    return roofline.frame_ops(f["tree"], f["rc"], px, f["shaded"]), roofline.table_bytes(f["tree"]) + px * (13 * 4 + 4)


def read(ctx):
    n = ctx.traced.kernel_count(lambda name: name.startswith(MATCH))
    t = ctx.traced.kernel_seconds(lambda name: name.startswith(MATCH))
    if not n or t <= 0 or "tree" not in ctx.facts:
        return None
    ops, nbytes = work(ctx.facts)
    return 100.0 * roofline.least_seconds(ops * n, nbytes * n) / t
