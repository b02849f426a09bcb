"""The H100's published peaks and the operation counts of the frame's work.

Frozen copies of the port's `chip_smoke.py` (`bound`, `F32_FLOPS`,
`HBM_BYTES`, `frame_ops`, `shade_ops`, `trace_ops`, `occlusion_ops`), with
the plane, sphere and box counts taken from the benchmark's own scene tables
(numpy) instead of the program's. Every count is f32 operations of the
algorithm on a frame's data, counted from the kernels' source
(csrc/frame_core.cuh, csrc/shade_core.cuh), each operation once: a fused
multiply-add counts one, so a share of the 67e12/s peak, which counts it
two, reads at most half of what the same work at full rate would.
"""

from __future__ import annotations

import numpy as np

# Peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W limit): f32
# outside the tensor cores, and HBM3.
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations over
    the f32 peak and the bytes over the memory rate."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES)


def counts(tree: dict) -> tuple:
    """(planes, spheres, boxes) of a scene's numpy tables."""
    return (int(np.asarray(tree["planes"]).reshape(-1, 4).shape[0]), int(np.asarray(tree["spheres"]).shape[0]),
            int(np.asarray(tree["boxes"]).reshape(-1, 7).shape[0]))


def table_bytes(tree: dict) -> int:
    """Bytes of the scene tables and the camera the kernels read."""
    m = tree["materials"]
    parts = [tree["planes"], tree["plane_ids"], tree["spheres"], tree["sphere_ids"], tree["boxes"],
             tree["box_ids"], tree["light_color"]] + [m[k] for k in (
                 "s0", "s1", "freq", "alb_const", "alb_scale", "emission", "en_const", "en_scale")]
    return int(sum(np.asarray(p).size * 4 for p in parts)) + 4 * (4 + 3 + 2 + 1)


def occlusion_ops(tree: dict) -> int:
    """One occlusion test toward the light (shade_core.cuh:light_visible):
    20 + 12 per plane + 20 per sphere + 160 per rounded box."""
    nP, nS, nB = counts(tree)
    return 20 + 12 * nP + 20 * nS + 160 * nB


def trace_ops(tree: dict) -> int:
    """One nearest-hit trace: 12 per plane, 20 per sphere, 584 per rounded
    box (6 faces × 8, 12 edges × 26, 8 corners × 28)."""
    nP, nS, nB = counts(tree)
    return 12 * nP + 20 * nS + 584 * nB


def shade_ops(tree: dict, rc: dict, shaded: int) -> float:
    """The shade on `shaded` pixels (hits other than the light): per pixel
    and sample the direct light with its visibility test, the two plane
    strategies per plane, and four roulettes, each a march to its plane and
    a light test; the unbiased pair otherwise."""
    nP, nS, _ = counts(tree)
    trace, occl = trace_ops(tree), occlusion_ops(tree)
    smp = int(rc["smp"])
    if rc["biased"]:
        direct = 60 + (trace + 30 * nS if float(rc["soft_shadows"]) > 0 else occl)
        sample = direct + 150 * nP + 4 * (2 * nP + 2 * occl + 65)
    else:
        sample = 40 + occl + (occl + 10) / smp
    return shaded * smp * sample


def frame_ops(tree: dict, rc: dict, pixels: int, shaded: int) -> float:
    """The fused frame (frame_core.cuh) on `pixels` pixels of which `shaded`
    are shaded: raygen, the primary trace, normal and material, the shade."""
    return pixels * (65 + trace_ops(tree)) + shade_ops(tree, rc, shaded)


def shaded_pixels(oid) -> int:
    """Pixels the shade runs on: hits (oid > 0) other than the light (id 1)."""
    return int(((oid > 0) & (oid != 1)).sum().item())
