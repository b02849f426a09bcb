"""k7_roofline (%): the least time the card could take for K7's launches in
the traced window, over K7's device time there (events whose name starts
with `kpt::path_kernel(`). The least time is the larger of the operations
over the f32 peak, 67e12/s, and the bytes over HBM's 3.35e12 B/s (the
published peaks of the SXM part at 700 W; roofline.least_seconds).

The count follows the paths: a path's length depends on what it meets (a
miss ends it after one segment, a glass chain runs to the depth), so the
segments traced and the vertices shaded of an image are the reference's own
(`reference/path.path_block`'s tally, the mean over the images the check
compared), and the count reads the same work whatever implements K7. The
f32 operations of csrc/path_kernel.cu on them, each once (K7 is built with
-fmad=false, so a multiply and an add count two; integer hashing is not
counted): once a pixel the primary ray and the mean over the samples, a sum
a sample; a segment one inside-hit trace (roofline.trace_ops, and a compare
and an add a sphere for the far root); a vertex the parts of VERTEX and one
light test (roofline.occlusion_ops). The lobes count as the diffuse one
(the glossy lobe's eval is ~20 operations more, a delta lobe's sample ~25
fewer), and the light test, the NEE weights and their sum count at every
vertex, those on the light too, which skip them. The bytes: the tables once
(with the per-id BSDF kinds and iors) and the 12 B of HDR radiance written
a pixel. Counted from the scene's tables, the image's size and the
reference's paths, never from a measured rate.
"""

from kpt_bench import roofline

MATCH = "kpt::path_kernel("
# Once a pixel: primary_ray (frame_core.cuh), the mean over the samples.
RAYGEN, MEAN = 34, 3
# A sample's radiance added to the pixel's sum.
SAMPLE_SUM = 3
# A shaded vertex of path_sample, by part.
VERTEX = {"hit point": 6, "normal and its side": 29, "material and rho": 28, "emission": 9,
          "three R2 pairs": 12, "light_sample": 73, "shadow origin": 6, "bsdf_eval_pdf": 12,
          "NEE weights and sum": 17, "relative index": 2, "bsdf_sample": 40, "throughput": 6, "next ray": 6}


def trace_ops(tree) -> int:
    """One inside-hit trace: the nearest-hit trace with the far root of
    every sphere (sphere_t_far)."""
    return roofline.trace_ops(tree) + 2 * roofline.counts(tree)[1]


def work(f):
    """K7's (operations, bytes) per launch."""
    tree, px = f["tree"], f["pixels"]
    ops = (px * (RAYGEN + MEAN + SAMPLE_SUM * f["spp"]) + f["traced"] * trace_ops(tree)
           + f["hits"] * (sum(VERTEX.values()) + roofline.occlusion_ops(tree)))
    ids = len(tree["materials"]["s0"])
    return ops, roofline.table_bytes(tree) + 8 * ids + 12 * px


def read(ctx):
    n = ctx.traced.kernel_count(lambda name: name.startswith(MATCH))
    t = ctx.traced.kernel_seconds(lambda name: name.startswith(MATCH))
    if not n or t <= 0 or "traced" not in ctx.facts:
        return None
    ops, nbytes = work(ctx.facts)
    return 100.0 * roofline.least_seconds(ops * n, nbytes * n) / t
