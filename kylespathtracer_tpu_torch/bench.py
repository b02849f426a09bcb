"""Benchmark of the port on the card: forward primary-ray throughput at 1080p.

    python -m kylespathtracer_tpu_torch.bench [--out PATH]

The port's counterpart of bench.py. Needs a CUDA device: without one it
exits non-zero, and no measurement falls back to the CPU or from one
pipeline to another; a failure raises and the process exits non-zero.
The last line of stdout is bench.py's headline, {"metric":
"primary_rays_per_s_fwd_1080p", "value", "unit": "rays/s", "vs_baseline"},
with "device": the card's name and power limit (nvidia-smi). The
supplementary metrics go to stderr as JSON lines under bench.py's names,
each with "device" too:

  * fwd: `render_frame`, pipeline="fused" (the split temporal frame: K1 +
    the anchors + K2 with its tail) at 1920×1080, panning 1e-3 rad a frame with the
    history carried → fwd_frame_ms_1080p, traced_rays_per_s_1080p (9 rays
    a pixel) and the headline;
  * fwd+bwd: `ops/loss_kernel.render_loss_and_grad`, loss="mean" (K6) →
    fwd_bwd_rays_per_s_1080p; the mean of the no_history fused frame
    differentiated by autograd in the sphere table (K1 + K5) →
    fwd_bwd_generic_rays_per_s_1080p;
  * raycast: `ops/geometry_kernel.geometry_pass` (K3) → raycast_rays_per_s_1080p;
  * wavefront: `render_pathtraced` at 4 spp, depth 6 (K7) →
    wavefront_segments_per_s_1080p.

Timing (`event_slope`, the counterpart of bench.py's `_timed_scan`): K
steps launched back to back from the host, the state carried from step to
step with no synchronize inside, bracketed by CUDA events; each total is
the best of `reps`, and the time of a step is the least-squares slope over
the K values, so the launch of the first step and the final wait cancel.
Unlike JAX's scan slope, which is device time alone, this slope also holds
the host's launch time wherever the host is slower than the device (the
split frame's ~354 launches): the time a user of the port pays. Each
metric's `{tag}_timing_detail` line keeps bench.py's keys, with "method":
"event-slope", "compile_s" the warm-up seconds (one untimed run of each
K), every repetition's total (rep_totals_ms) and the kernel launches of one
step; `blocked_single_dispatch_ms` is one step followed by a synchronize on
the host clock, less `host_device_roundtrip_ms` (a one-element kernel and
`.item()`). The kernels' build and load seconds and the CUDA context's
start stand on a line of their own (bench_setup). Rates are computed on
the host in Python floats.

`--out PATH` also writes every line to PATH, a new file; it refuses one that
exists. bench.py's `bench_scaling()` has no counterpart: it reads XLA's
HLO cost model, which has no meaning here.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import frame_hist as fh
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import geometry_kernel as geo_k
from kylespathtracer_tpu_torch.ops import loss_kernel as lk
from kylespathtracer_tpu_torch.ops import path_kernel as pk
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.ops import shade_kernel as sk
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.render.pipeline import init_history, render_frame
from kylespathtracer_tpu_torch.render.wavefront import render_pathtraced
from kylespathtracer_tpu_torch.scene.scene import default_scene
from kylespathtracer_tpu_torch.utils.config import RenderConfig
from kylespathtracer_tpu_torch.utils.metrics import card_line, slope_fit

BASELINE_RAYS_PER_S = 55.3e6  # 1280*720*60 (bench.py:57; BASELINE.md)
W, H = 1920, 1080
CAM_LOC, CAM_ORIENT = (3.0, 2.0, -3.0), (0.0, 0.7)
PAN = 1e-3  # yaw per frame (~0.3 px at 1080p): keeps the reprojection honestly exercised
# Rays a pixel traces per frame: the primary, the direct light's visibility,
# 4 roulette plane marches and 4 light re-samples (SURVEY §3.2).
TRACED_RAYS_PER_PIXEL = 9
REPS = 3
# bench.py's K values for each measurement.
KS = {"fwd": (4, 20, 36), "fused_loss": (4, 16, 28), "generic": (2, 10, 18), "raycast": (8, 40, 72),
      "wavefront": (1, 4, 7)}
# linear_ok's slack: bench.py's 1e-4 s.
LINEAR_SLACK_MS = 0.1
# The kernel modules whose launches a step's detail line counts, by name.
KERNELS = {"frame_forward": fk, "reproject_window": rk, "geometry_pass": geo_k, "dual_mis": sk,
           "frame_backward": fg, "render_loss_and_grad": lk, "pathtrace": pk, "frame_hist": fh}


class Emitter:
    """Writes one JSON line per record, with the card named, to stderr and
    to an open file (the --out record) when there is one."""

    def __init__(self, card: str, file=None):
        self.card = card
        self.file = file

    def __call__(self, **record) -> None:
        line = json.dumps({**record, "device": self.card})
        print(line, file=sys.stderr, flush=True)
        if self.file is not None:
            self.file.write(line + "\n")
            self.file.flush()


def launch_counts() -> dict:
    return {name: m.LAUNCHES for name, m in KERNELS.items()}


def require_cuda(device, what: str) -> torch.device:
    """`device` as a torch.device; raises unless it is a CUDA device (a
    measurement never falls back to the CPU)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"{what}: needs a CUDA device, got {device}")
    return device


def run_steps(step, carry, k: int):
    """k calls of step(carry, i), each carrying the last one's result."""
    for i in range(k):
        carry = step(carry, i)
    return carry


def timing_detail(tag: str, ks, rep_totals, warm_s: float, launches: dict, blocked_ms=None) -> dict:
    """The `{tag}_timing_detail` record of per-K repetition totals (ms):
    each K's best total, their least-squares slope, the sub-slopes between
    neighbouring K and whether they agree within 20% (+ LINEAR_SLACK_MS)."""
    totals = [min(t) for t in rep_totals]
    slope, sub, linear = slope_fit(ks, totals, LINEAR_SLACK_MS)
    detail = {"metric": f"{tag}_timing_detail", "method": "event-slope", "ks": list(ks), "totals_ms": totals,
              "rep_totals_ms": [list(t) for t in rep_totals], "sub_slopes_ms": sub, "slope_ms": slope,
              "linear_ok": bool(linear), "compile_s": warm_s, "reps": len(rep_totals[0]),
              "launches_per_step": launches}
    if blocked_ms is not None:
        detail["blocked_single_dispatch_ms"] = blocked_ms
        detail["slope_within_blocked"] = bool(slope <= blocked_ms * 1.2)
    return detail


def event_slope(step, carry, ks, tag: str, device, reps: int = REPS, blocked_ms=None) -> tuple[float, dict]:
    """Milliseconds of one step(carry, i) → carry on the card, and its
    detail record: for each K in `ks`, one untimed warm-up run of K steps,
    then `reps` runs of K steps back to back between two CUDA events, each
    from `carry`; the slope of the best totals over K (see the module
    docstring). Raises on a device that is not a card."""
    require_cuda(device, f"event_slope({tag})")
    warm_s, rep_totals, launches = 0.0, [], None
    for k in ks:
        before = launch_counts()
        t0 = time.perf_counter()
        run_steps(step, carry, k)
        torch.cuda.synchronize(device)
        warm_s += time.perf_counter() - t0
        if launches is None:
            launches = {n: (c - before[n]) / k for n, c in launch_counts().items() if c != before[n]}
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run_steps(step, carry, k)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        rep_totals.append(times)
    detail = timing_detail(tag, ks, rep_totals, warm_s, launches, blocked_ms)
    return max(detail["slope_ms"], 1e-6), detail


def roundtrip_ms(device) -> float:
    """One host → card → host round trip: a one-element kernel and
    `.item()`, the mean of 5 after one warm-up."""
    x = torch.zeros((), device=require_cuda(device, "roundtrip_ms"))
    (x + 1.0).item()
    t0 = time.perf_counter()
    for _ in range(5):
        (x + 1.0).item()
    return (time.perf_counter() - t0) / 5 * 1e3


def blocked_once(step, carry, iters: int, rtt_ms: float) -> float:
    """Single-dispatch blocked time of step(carry, i) (a sanity bound): each
    step followed by a synchronize on the host clock, less the round trip."""
    step(carry, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        step(carry, i)
        torch.cuda.synchronize()
    return max((time.perf_counter() - t0) / iters * 1e3 - rtt_ms, 1e-6)


def panned(camera: Camera, frames: int) -> list:
    """The camera of each of `frames` frames of bench.py's slow pan: orient
    + (0, PAN)·i, as f32 on the camera's device."""
    pan = torch.tensor([0.0, PAN], dtype=torch.float32, device=camera.orient.device)
    return [Camera(loc=camera.loc, orient=camera.orient + pan * float(i)) for i in range(frames)]


def forward_case(scene, camera: Camera, frames: int):
    """bench.py's forward cell → (step, history): step(history, i) renders
    frame i of the pan with render_frame (pipeline="fused") and returns the
    new history."""
    config = RenderConfig(width=W, height=H, pipeline="fused")
    cams = panned(camera, frames)

    def step(hist, i):
        return render_frame(scene, cams[i], hist, i, config)[1]

    return step, init_history(config, camera, device=camera.loc.device)


def bench_forward(scene, camera, rtt: float, emit, iters: int = 8) -> float:
    """The fused temporal frame at 1080p → primary rays a second."""
    step, hist = forward_case(scene, camera, max(KS["fwd"]))
    blocked = blocked_once(step, hist, iters, rtt)
    ms, detail = event_slope(step, hist, KS["fwd"], "fwd_fused", scene.device, blocked_ms=blocked)
    emit(**detail)
    emit(metric="fwd_frame_ms_1080p", pipeline="fused", value=ms)
    emit(metric="traced_rays_per_s_1080p", pipeline="fused", value=TRACED_RAYS_PER_PIXEL * W * H / (ms * 1e-3))
    return W * H / (ms * 1e-3)


def bench_fused_loss_grad(scene, camera, emit) -> float:
    """The fused loss-and-gradient kernel K6 (loss="mean", every table) on
    the single-frame render at 1080p → rays a second."""
    config = RenderConfig(width=W, height=H, no_history=True, pipeline="fused")

    def step(_, i):
        lk.render_loss_and_grad(scene, camera, i, config, loss="mean")

    ms, detail = event_slope(step, None, KS["fused_loss"], "fwd_bwd_fused_loss", scene.device)
    emit(**detail)
    rate = W * H / (ms * 1e-3)
    emit(metric="fwd_bwd_rays_per_s_1080p", value=rate, frame_ms=ms, pipeline="fused_loss_kernel")
    return rate


def bench_fwd_bwd(scene, camera, rtt: float, emit, iters: int = 10) -> float:
    """The value and gradient of mean(render_frame(...)) with no_history
    through the differentiable fused frame (K1 forward, K5 backward), by
    `torch.autograd.grad` in the sphere table (nothing accumulates) → rays
    a second."""
    config = RenderConfig(width=W, height=H, no_history=True, pipeline="fused")
    hist = init_history(config, camera, device=scene.device)
    spheres = scene.spheres.detach().clone().requires_grad_()
    sc = dataclasses.replace(scene, spheres=spheres)

    def step(_, i):
        with torch.enable_grad():
            img, _ = render_frame(sc, camera, hist, i, config)
            torch.autograd.grad(img.mean(), spheres)

    blocked = blocked_once(step, None, iters, rtt)
    ms, detail = event_slope(step, None, KS["generic"], "fwd_bwd", scene.device, blocked_ms=blocked)
    emit(**detail)
    rate = W * H / (ms * 1e-3)
    emit(metric="fwd_bwd_generic_rays_per_s_1080p", value=rate, frame_ms=ms, pipeline="fused")
    return rate


def bench_raycast(scene, camera, rtt: float, emit, iters: int = 30) -> float:
    """The primary-visibility raycast (K3: raygen, nearest hit, analytic
    normal and curvature, the G-buffer's write) at 1080p → rays a second."""
    config = RenderConfig(width=W, height=H)

    def step(_, i):
        geo_k.geometry_pass(scene, camera, i, config)

    blocked = blocked_once(step, None, iters, rtt)
    ms, detail = event_slope(step, None, KS["raycast"], "raycast", scene.device, blocked_ms=blocked)
    emit(**detail)
    rate = W * H / (ms * 1e-3)
    emit(metric="raycast_rays_per_s_1080p", value=rate, frame_ms=ms)
    return rate


def bench_wavefront(scene, camera, rtt: float, emit, iters: int = 5, spp: int = 4, depth: int = 6) -> float:
    """The multi-bounce path tracer (K7) at 1080p, `spp` samples a pixel,
    depth `depth` → path segments a second (W·H·spp·depth per frame)."""
    config = RenderConfig(width=W, height=H, spp=spp, max_depth=depth)

    def step(_, i):
        render_pathtraced(scene, camera, config, i)

    blocked = blocked_once(step, None, iters, rtt)
    ms, detail = event_slope(step, None, KS["wavefront"], "wavefront", scene.device, blocked_ms=blocked)
    emit(**detail)
    rate = W * H * spp * depth / (ms * 1e-3)
    emit(metric="wavefront_segments_per_s_1080p", value=rate, frame_ms=ms, spp=spp, depth=depth)
    return rate


def setup(device, emit) -> None:
    """Start the CUDA context and build (or find) and load the kernels,
    each timed on a line of its own (bench_setup)."""
    t0 = time.perf_counter()
    torch.zeros((), device=device).item()
    cuda_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.build()
    _build.load()
    emit(metric="bench_setup", cuda_init_s=cuda_s, kernels_build_load_s=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write every line to this new file (JSONL)")
    args = ap.parse_args(argv)
    if args.out is not None and args.out.exists():
        sys.exit(f"bench: {args.out} exists; give a new path")
    if not torch.cuda.is_available():
        sys.exit("bench: needs a CUDA device")
    device = torch.device("cuda")
    card = card_line()
    with open(args.out, "x") if args.out is not None else contextlib.nullcontext() as record:
        emit = Emitter(card, record)
        setup(device, emit)
        scene = default_scene(device=device)
        camera = Camera.create(loc=CAM_LOC, orient=CAM_ORIENT, device=device)
        rtt = roundtrip_ms(device)
        emit(metric="host_device_roundtrip_ms", value=rtt)
        rays_per_s = bench_forward(scene, camera, rtt, emit)
        bench_fused_loss_grad(scene, camera, emit)
        bench_fwd_bwd(scene, camera, rtt, emit)
        bench_raycast(scene, camera, rtt, emit)
        bench_wavefront(scene, camera, rtt, emit)
        headline = json.dumps({"metric": "primary_rays_per_s_fwd_1080p", "value": rays_per_s, "unit": "rays/s",
                               "vs_baseline": rays_per_s / BASELINE_RAYS_PER_S, "device": card})
        if record is not None:
            record.write(headline + "\n")
    print(headline, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
