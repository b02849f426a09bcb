"""frame_ms_p95 (ms): the 95th percentile of every frame's own time in the
window, the stutters a viewer sees: CUDA events from the call of the
frame's `render_frame` on an idle device to the event after its last
launch, which the viewer waits on (kinds/temporal.py). The frames traced
under the profiler are left out. Moves frame_ms in temporal.spline1080."""

import numpy as np


def read(ctx):
    times = ctx.facts.get("frame_times_ms")
    return float(np.percentile(np.asarray(times, np.float64), 95)) if times else None
