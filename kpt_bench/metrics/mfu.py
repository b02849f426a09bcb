"""mfu (%), the whole step's share of the card's f32 peak, split by the
end-to-end metric it moves: mfu.frame moves frame_ms (temporal.spline1080:
K1 of a frame; K2, which has no roofline file, is not counted), mfu.step
moves step_ms (inverse10.views1080: K6 of every view of an optimizer step),
mfu.shard moves shard_step_ms (inverse10_rows4.step1080: K1 and K5 of a
step on rank 0's rows, over rank 0's traced time a step: its card's share).

The operations of the step's hand-written kernels, each counted by its
roofline metric's `work` (metrics/<kernel>_roofline.py) times its launches
a step (the loop's `facts()["per_step"]`), over the traced window's time
per step and 67e12/s. A kernel taken off the path leaves its roofline
silent; this share still bounds the step."""

from pathlib import Path

from kpt_bench import harness
from kpt_bench.roofline import F32_FLOPS


def read(ctx):
    step_s = ctx.facts.get("step_s")
    if not step_s or "per_step" not in ctx.facts:
        return None
    ops = 0.0
    for kernel, n in ctx.facts["per_step"].items():
        path = Path(__file__).with_name(f"{kernel}_roofline.py")
        if path.exists():
            ops += n * harness.load_module(path).work(ctx.facts)[0]
    return 100.0 * ops / (step_s * F32_FLOPS) if ops else None
