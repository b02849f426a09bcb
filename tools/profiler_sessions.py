"""Count the torch.profiler sessions whose trace misses a kernel that ran, and
follow where each kernel lands in its session's trace over the process's life.

    python3 tools/profiler_sessions.py [--seconds S] [--ballast N] [--margin-ms M]

Needs a CUDA device. In one process it opens torch.profiler sessions one
after another for S seconds, each around one call of the geometry kernel
(K3), the path kernel (K7) or the shade kernel (K4) at 64x32, as
tests/test_torch_cuda.py's profiler tests do, with N 1080p path-kernel
launches outside the profiler between sessions (the device work of the
tests that run between them). Sessions without and with a margin (the
host waits M ms after the session starts and after the call has finished
on the device, before the session stops) take turns. For every session it
checks that the call's launch counter moved, and records whether the trace
holds the kernel, the device start of the kernel less the host start of
its launch (`cudaLaunchKernel`) and less the first host event of the
trace, in µs.
Prints one JSON line per kernel and margin: sessions, misses (with the
session's second in the process), and those gaps over the first and the
last tenth of the sessions (min, median, max).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def session(call, counter, kernel: str, margin_s: float) -> dict:
    """One profiler session around `call` (which must launch `kernel` once),
    `margin_s` seconds of host time on each side of it → whether the trace
    holds it, and its gaps in µs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        call()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    if counter() - before != 1:
        raise AssertionError(f"{kernel} did not launch")
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    found = [e for e in events if e.device_type == DeviceType.CUDA and kernel in e.name]
    launch = [e for e in host if e.name == "cudaLaunchKernel"]
    out = {"found": bool(found), "host_events": len(host), "launches_seen": len(launch)}
    if found:
        start = found[0].time_range.start
        out["after_launch_us"] = start - launch[-1].time_range.start if launch else None
        out["after_first_host_us"] = start - min(e.time_range.start for e in host)
    return out


def spread(values) -> list:
    values = [v for v in values if v is not None]
    return [min(values), statistics.median(values), max(values)] if values else []


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=120.0, help="how long to open sessions")
    ap.add_argument("--ballast", type=int, default=4, help="1080p K7 launches between sessions")
    ap.add_argument("--margin-ms", type=float, default=20.0, help="the margin of the sessions that have one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profiler_sessions: needs a CUDA device")

    from kylespathtracer_tpu_torch.ops import geometry_kernel as gk
    from kylespathtracer_tpu_torch.ops import path_kernel as pk
    from kylespathtracer_tpu_torch.ops import shade_kernel as sk
    from kylespathtracer_tpu_torch.render import gbuffer, passes
    from kylespathtracer_tpu_torch.render.camera import Camera
    from kylespathtracer_tpu_torch.scene.scene import default_scene
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    dev = torch.device("cuda")
    scene = default_scene(device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cfg_p = RenderConfig(width=64, height=32, pipeline="pass", shade_backend="pallas")
    gb = gbuffer.geometry_pass(scene, cam, cfg_p)
    _, seed = passes._shade_common(scene, cfg_p, gb, cam, 3)
    big = RenderConfig(width=1920, height=1080, spp=1, max_depth=6)
    calls = {
        "geometry_kernel": (lambda: gk.geometry_pass(scene, cam, 0, RenderConfig(width=64, height=32)),
                            lambda: gk.LAUNCHES),
        "path_kernel": (lambda: pk.pathtrace(scene, cam, RenderConfig(width=64, height=32, spp=1), 0),
                        lambda: pk.LAUNCHES),
        "shade_kernel": (lambda: sk.dual_mis(scene, gb, cam, seed, cfg_p), lambda: sk.LAUNCHES),
    }
    for call, _ in calls.values():
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    margins = (0.0, args.margin_ms)
    runs = {(k, m): [] for k in calls for m in margins}
    while time.perf_counter() - t0 < args.seconds:
        for margin in margins:
            for kernel, (call, counter) in calls.items():
                for _ in range(args.ballast):
                    pk.pathtrace(scene, cam, big, 0)
                torch.cuda.synchronize()
                runs[kernel, margin].append((time.perf_counter() - t0,
                                             session(call, counter, kernel, margin / 1e3)))
    for (kernel, margin), got in runs.items():
        tenth = max(1, len(got) // 10)
        print(json.dumps({
            "kernel": kernel, "margin_ms": margin, "sessions": len(got),
            "misses_at_s": [round(t, 3) for t, r in got if not r["found"]],
            "missed_with_launch_seen": sum(1 for _, r in got if not r["found"] and r["launches_seen"]),
            "after_launch_us_first_last": [spread(r.get("after_launch_us") for _, r in got[:tenth]),
                                           spread(r.get("after_launch_us") for _, r in got[-tenth:])],
            "after_first_host_us_first_last": [spread(r.get("after_first_host_us") for _, r in got[:tenth]),
                                               spread(r.get("after_first_host_us") for _, r in got[-tenth:])],
            "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
