"""Reading the device's side of a torch.profiler trace.

`union_us` and `summarize_trace` are frozen copies of the port's
`bench_profile.py`, `profiled` keeps the host margins of the port's
`utils/metrics.profiler_trace` (PROFILER_MARGIN_S): torch.profiler maps
device time onto the host clock and may place a kernel up to ~5 ms before
its launch, so the session starts before and ends after the traced steps.
Under the profiler the host's own cost stretches the span, so the idle
share read here is higher than without it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import tempfile
import time
from pathlib import Path

import torch

PROFILER_MARGIN_S = 0.02
# Chrome-trace categories of the work the device does.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_events(events: list) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES and "dur" in e]


def summarize_trace(events: list, frames: int) -> dict:
    """The device's side of a Chrome trace's `traceEvents` over `frames`
    steps → device_per_frame_ms (the union of the device events' intervals
    over frames), span_per_frame_ms, busy_share, idle_share, device_events
    and top_device_events by name."""
    dev = device_events(events)
    if not dev:
        raise ValueError("the trace holds no device event")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    busy = union_us(spans)
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    dur, cnt = collections.Counter(), collections.Counter()
    for e in dev:
        dur[e["name"]] += float(e["dur"])
        cnt[e["name"]] += 1
    return {
        "device_per_frame_ms": busy / 1e3 / frames,
        "span_per_frame_ms": span / 1e3 / frames,
        "busy_share": busy / span if span > 0 else 1.0,
        "idle_share": 1.0 - busy / span if span > 0 else 0.0,
        "device_events": len(dev),
        "top_device_events": [{"name": n, "total_ms": v / 1e3, "count": cnt[n], "per_frame_ms": v / 1e3 / frames}
                              for n, v in dur.most_common(TOP)],
    }


def idle_gaps(events: list, window: tuple) -> list:
    """The device's idle gaps inside `window` (µs), each named by the
    innermost host operation that covers its midpoint → [[name, seconds]],
    summed by name, longest first (at most TOP)."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device_events(events))
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                                                      "cuda_driver", "python_function") and "dur" in e]
    host.sort()
    gaps, end = [], window[0]
    for s, e in dev:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if window[1] > end:
        gaps.append((end, window[1]))
    starts = [s for s, _, _ in host]
    by = collections.Counter()
    for a, b in gaps:
        mid, best = (a + b) / 2, None
        # The innermost covering operation starts shortly before the midpoint.
        i = bisect.bisect_right(starts, mid)
        for s, e, name in host[max(0, i - 500):i][::-1]:
            if e >= mid and (best is None or e - s < best[0]):
                best = (e - s, name)
        by[best[1] if best else "(no host operation)"] += (b - a) / 1e6
    return [[n, v] for n, v in by.most_common(TOP)]


class Traced:
    """The result of a `profiled` block: the trace's events, the traced
    window (host clock, µs, from the block's start to its synchronized end)
    and its length in seconds."""

    def __init__(self):
        self.events: list = []
        self.window_us = (0.0, 0.0)
        self.window_s = 0.0

    def kernel_seconds(self, match) -> float:
        """Device seconds of the events whose name `match(name)` accepts."""
        return sum(float(e["dur"]) for e in device_events(self.events) if match(e["name"])) / 1e6

    def kernel_count(self, match) -> int:
        return sum(1 for e in device_events(self.events) if match(e["name"]))

    def busy_s(self) -> float:
        dev = device_events(self.events)
        return union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]) / 1e6


@contextlib.contextmanager
def profiled(device):
    """Trace the enclosed block with torch.profiler (CPU and CUDA) → yields a
    `Traced`, filled when the block ends. The trace is written to a temporary
    directory under TMPDIR, read and removed."""
    from torch.profiler import ProfilerActivity, profile

    out = Traced()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    with tempfile.TemporaryDirectory(prefix="kpt_bench_trace_") as tmp:
        with profile(activities=acts) as prof:
            time.sleep(PROFILER_MARGIN_S)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            with torch.profiler.record_function("kpt_bench.window"):
                yield out
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            out.window_s = time.perf_counter() - t0
            time.sleep(PROFILER_MARGIN_S)
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        out.events = json.loads(path.read_text())["traceEvents"]
    marks = [e for e in out.events if e.get("name") == "kpt_bench.window" and e.get("ph") == "X"]
    dev = device_events(out.events)
    if marks:
        s = float(marks[0]["ts"])
        e = max([s + float(marks[0]["dur"])] + [float(d["ts"]) + float(d["dur"]) for d in dev])
        out.window_us = (s, e)
