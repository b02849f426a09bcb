"""Structured metrics and profiling.

Port of kylespathtracer_tpu/utils/metrics.py: every step emits a JSONL
record (`MetricsLogger`), a block can be traced with torch.profiler
(`profiler_trace`) and every span of the port goes through `span` (the
frame and its stages, render/pipeline.py:STAGES; the optimizer step,
diff/inverse.py:FIT_STAGES; the path-traced image, render/wavefront.py:STAGES), `Timer` and `time_fn` time device work
behind a synchronize and `cuda_ms` with CUDA events. `slope_fit` is the arithmetic of the benches' slope
timings (bench.py, bench_ceiling.py) and `card_line` names the card beside
every measurement.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# Host time the profiler is given before and after the traced block:
# torch.profiler maps device time onto the host clock, and that mapping can
# place a kernel up to ~5 ms before its launch, so a kernel launched just
# after the session starts may fall outside it (tools/profiler_sessions.py).
PROFILER_MARGIN_S = 0.02

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler span named `name` (torch.profiler's `record_function`)
    while a profiler is active; otherwise a shared null context, so a span
    costs one boolean check when nothing traces."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (the first card)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() over `reps` runs, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def slope_fit(ks, totals, slack: float = 0.0) -> tuple[float, list, bool]:
    """The least-squares slope of `totals` over `ks` (three or more
    ascending counts), the slopes between neighbouring counts, and whether
    those agree: the largest at most 1.2 × the smallest + `slack` (the
    totals' unit)."""
    n = len(ks)
    mk, mt = sum(ks) / n, sum(totals) / n
    slope = sum((k - mk) * (t - mt) for k, t in zip(ks, totals)) / sum((k - mk) ** 2 for k in ks)
    sub = [(totals[i + 1] - totals[i]) / (ks[i + 1] - ks[i]) for i in range(n - 1)]
    return slope, sub, max(sub) <= min(sub) * 1.2 + slack


class MetricsLogger:
    """Append-only JSONL metrics sink (a file, else stderr)."""

    def __init__(self, path=None, echo: bool = False):
        self._file = open(path, "a") if path else None
        self._echo = echo or path is None
        self._t0 = time.perf_counter()

    def log(self, **record) -> None:
        record.setdefault("t", round(time.perf_counter() - self._t0, 6))
        line = json.dumps(record)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._file:
            self._file.close()


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profiler_trace(logdir):
    """Trace the enclosed block with torch.profiler (CPU, and CUDA when a
    card is present) and write a Chrome trace, `logdir/trace.json`
    (viewable in Perfetto); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        time.sleep(PROFILER_MARGIN_S)
        try:
            yield prof
        finally:
            _sync()
            time.sleep(PROFILER_MARGIN_S)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


class Timer:
    """Wall-clock timer; synchronizes the card on entry and exit when CUDA
    is initialised, so the time covers the device work of the block."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        _sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.elapsed = time.perf_counter() - self.t0
        return False


def time_fn(fn, *args, iters: int = 10, warmup: int = 1):
    """Time fn: `warmup` calls (at least one), a synchronize, then `iters`
    timed calls ended by a synchronize. Returns seconds per call."""
    for _ in range(max(warmup, 1)):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters
