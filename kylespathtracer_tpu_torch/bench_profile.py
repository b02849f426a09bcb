"""The device's own trace against the bench's event slope.

    python -m kylespathtracer_tpu_torch.bench_profile [round] [--out DIR]

The port's counterpart of bench_profile.py. Profiles K = 8 panned 1920×1080
fused frames (bench.py's forward cell, the history carried) with
torch.profiler through `utils/metrics.profiler_trace`, which keeps host
time on each side of the session so that no kernel is placed before its
start, and reads the device's side of the Chrome trace: the device time per
frame (the union of the kernel, copy and fill intervals over K), the
window's span per frame (first device event to last) and the device's busy
and idle shares of it, and the device events by name (`top_device_events`:
total_ms, count, per_frame_ms). It times the same frames by bench's event
slope and prints the slope over the device time.

JAX's slope is device time alone, so there the two agree within ~5%; here
the slope also holds the host's launch time, which on the split frame is
longer than its device time, so they need not agree. What is held instead:
the device time per frame is at most the slope × 1.05 (`device_within_slope`);
the process exits non-zero otherwise, and without a CUDA device.
One JSON line on stdout with the card named. `--out DIR` writes
profile.json and the trace (trace.json) into DIR, a new directory (refused
if it exists); without it the trace goes to a temporary directory that is
removed.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import tempfile
from pathlib import Path

import torch

from kylespathtracer_tpu_torch import bench
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.scene.scene import default_scene
from kylespathtracer_tpu_torch.utils.metrics import card_line, profiler_trace

K = 8
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


def summarize_trace(events: list, frames: int) -> dict:
    """The device's side of a Chrome trace's `traceEvents` (complete events,
    "ph": "X", of DEVICE_CATEGORIES; times in µs) over `frames` frames →
    device_per_frame_ms (the union of the events' intervals over frames),
    span_per_frame_ms (first start to last end over frames), busy_share and
    idle_share of that span, device_events, and top_device_events by name."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES and "dur" in e]
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


def profile_frames(logdir: Path, frames: int = K) -> tuple[dict, float, dict]:
    """Trace `frames` panned fused frames at 1080p into logdir/trace.json,
    and time them by bench's event slope → (the trace's summary, the slope
    in ms, the slope's detail)."""
    device = bench.require_cuda("cuda", "bench_profile")
    scene = default_scene(device=device)
    camera = Camera.create(loc=bench.CAM_LOC, orient=bench.CAM_ORIENT, device=device)
    step, hist = bench.forward_case(scene, camera, max(max(bench.KS["fwd"]), frames))
    bench.run_steps(step, hist, frames)  # warm
    torch.cuda.synchronize()
    with profiler_trace(logdir):
        bench.run_steps(step, hist, frames)
    summary = summarize_trace(json.loads((logdir / "trace.json").read_text())["traceEvents"], frames)
    slope, detail = bench.event_slope(step, hist, bench.KS["fwd"], "fwd_fused", device)
    return summary, slope, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("round", nargs="?", help="a label for the record (bench_configs.py's round)")
    ap.add_argument("--out", type=Path, help="write profile.json and trace.json into this new directory")
    args = ap.parse_args(argv)
    if args.out is not None and args.out.exists():
        sys.exit(f"bench_profile: {args.out} exists; give a new directory")
    if not torch.cuda.is_available():
        sys.exit("bench_profile: needs a CUDA device")
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        logdir = Path(tmp) if args.out is None else args.out
        if args.out is not None:
            logdir.mkdir(parents=True)
        summary, slope, detail = profile_frames(logdir)
        out = {
            "metric": "bench_profile", "round": args.round, "device": card, "frames": K,
            **summary,
            "fwd_frame_ms_1080p": slope,
            "slope_over_device": slope / summary["device_per_frame_ms"],
            "device_within_slope": bool(summary["device_per_frame_ms"] <= slope * 1.05),
            "slope_detail": detail,
            "note": "device time of K panned fused frames at 1080p from the torch.profiler trace; "
                    "fwd_frame_ms_1080p is bench's event slope of the same frames, host launch time included",
        }
        if args.out is not None:
            (args.out / "profile.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0 if out["device_within_slope"] else 1


if __name__ == "__main__":
    sys.exit(main())
