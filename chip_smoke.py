"""GPU smoke run of the PyTorch port (kylespathtracer_tpu_torch).

Builds the CUDA kernels from `kylespathtracer_tpu_torch/csrc`, checks each
kernel against its plain PyTorch version on the card, drives the main path
(`app.driver.render_animation`, the fused temporal frame at 1920×1080)
through the kernels, compares the card with the CPU, times the frame and
the kernels with CUDA events, and splits the frame's device time by
pipeline stage with torch.profiler. Any failed check raises, so the script
exits non-zero; it needs one CUDA device and fails without one.

    python3 chip_smoke.py

The second-to-last line of stdout is a JSON object describing every kernel
of the path; the last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 1920, 1080
CAM_LOC = (3.0, 2.0, -3.0)
CAM_ORIENT = (0.0, 0.7)
PAN = 1e-3  # yaw per frame: the slow pan of bench.py (~0.3 px/frame at 1080p)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def frame_agreement(out: dict, ref: dict, what: str) -> dict:
    """K1 against its plain version, plane by plane (frame_kernel.check_agreement:
    oid differs on <= 0.1% of pixels, each float plane has <= 1e-4 of its
    components beyond its bound, median |d| <= 1e-5)."""
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk

    stats = fk.check_agreement(out, ref, what)
    planes = {k: v for k, v in stats.items() if k not in ("oid", "median", "max_abs")}
    worst = max(planes, key=planes.get)
    log(f"  {what}: oid differs {stats['oid']:.3g}, median |d| {stats['median']:.3g}, "
        f"max |d| {stats['max_abs']:.4g}; share beyond bound per plane: "
        + ", ".join(f"{k} {v:.3g}" for k, v in planes.items() if v)
        + f" (worst {worst} {planes[worst]:.3g})")
    return stats


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


def stage_split(fn, stages, frames: int) -> dict:
    """Run fn() `frames` times under torch.profiler → per-frame device ms:
    in all ("device_ms"), per pipeline stage span ("stages": each kernel is
    charged to the innermost stage span around the op that launched it; the
    two CUDA kernels by name, since ctypes launches have no op), the ten
    largest kernels by name ("top"), and launches per frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    by_stage = dict.fromkeys(stages, 0.0)
    by_stage["outside the stages"] = 0.0
    by_name, total, launches = {}, 0.0, 0
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in stages:
            us = e.time_range.elapsed_us()
            total += us
            launches += 1
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + us
            if "kpt::frame_kernel" in e.name:
                by_stage["frame.k1"] += us
            elif "kpt::reproject_kernel" in e.name:
                by_stage["frame.reproject"] += us
        elif e.device_type == DeviceType.CPU and e.kernels:
            p = e
            while p is not None and p.name not in stages:
                p = p.cpu_parent
            key = p.name if p is not None else "outside the stages"
            by_stage[key] += sum(k.duration for k in e.kernels if "kpt::" not in k.name)
    per = 1e3 * frames
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": total / per, "launches": launches / frames,
            "stages": {k: v / per for k, v in by_stage.items()},
            "top": [(k, v / per) for k, v in top]}


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this smoke run needs a GPU")

    from kylespathtracer_tpu_torch.app import driver
    from kylespathtracer_tpu_torch.ops import _build
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
    from kylespathtracer_tpu_torch.render import pipeline
    from kylespathtracer_tpu_torch.render.camera import Camera
    from kylespathtracer_tpu_torch.render.passes import Channel
    from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    dev = torch.device("cuda")

    # Phase 0: the card.
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"phase 0: card {card} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")

    # Phase 1: build the kernels from the sources in the checkout.
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.load()
    log(f"phase 1: built {path.name} in {time.perf_counter() - t0:.1f} s")

    def camera(yaw_step=0, device=dev):
        return Camera.create(
            loc=CAM_LOC, orient=(CAM_ORIENT[0], CAM_ORIENT[1] + PAN * yaw_step), device=device
        )

    # Phase 2: K1 against its plain version, both on the card.
    log("phase 2: frame kernel (K1) vs plain, on the card")
    scene = default_scene(device=dev)
    cfg = RenderConfig(width=W, height=H, pipeline="fused")
    out = fk.frame_forward(scene, camera(), 3, cfg)
    torch.cuda.synchronize()
    ref = fk.frame_forward_plain(scene, camera(), 3, cfg)
    k1_stats = frame_agreement(out, ref, f"default_scene {W}x{H} frame 3")
    spheres = sphere_scene(
        [[5.5, 1.0, 0.0], [4.0, 0.5, 1.0], [6.0, 2.5, -1.5]], [1.0, 0.5, 0.7],
        [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]], device=dev,
    )
    smp2 = {k: 2 for k in (
        "smp_direct_lambert", "smp_lambert_surface_lambert", "smp_lambert_surface_phong",
        "smp_direct_phong", "smp_phong_surface_lambert", "smp_phong_surface_phong")}
    for label, kw in (("biased=False", dict(biased=False)), ("smp=2", smp2),
                      ("soft_shadows=0.05", dict(soft_shadows=0.05))):
        c = RenderConfig(width=256, height=128, **kw)
        o = fk.frame_forward(spheres, camera(), 3, c)
        torch.cuda.synchronize()
        frame_agreement(o, fk.frame_forward_plain(spheres, camera(), 3, c),
                        f"sphere_scene 256x128 {label}")

    # Phase 3: K2 against its plain version at 1920x1080, same query planes.
    log("phase 3: reprojection kernel (K2) vs plain, on the card")
    rng = np.random.default_rng(0)

    def random_channel():
        return Channel(
            rgb=torch.from_numpy(rng.uniform(0, 2, (H, W, 3)).astype(np.float32)).to(dev),
            cnt=torch.from_numpy(rng.integers(0, 17, (H, W)).astype(np.float32)).to(dev),
            oid=ref["oid"].clone(),
        )

    from kylespathtracer_tpu_torch.render.camera import ray_dirs

    rd = ray_dirs(camera(1), W, H, cfg.fov)
    hl = camera(1).loc + rd * ref["depth"][..., None]
    prev = camera(0)
    hist = random_channel()
    K = min(cfg.reproject_window, rk.MAX_WINDOW)
    dyrel, dxrel, w4 = rk._queries(prev, hl, ref["oid"], cfg.fov, H, W)
    rgb_k, cnt_k = rk.reproject_set(ref["oid"], dyrel, dxrel, w4, hist, K)
    torch.cuda.synchronize()
    rgb_p, cnt_p = rk.reproject_window_plain(ref["oid"], dyrel, dxrel, w4, hist, K)
    k2_err = max((rgb_k - rgb_p).abs().max().item(), (cnt_k - cnt_p).abs().max().item())
    log(f"  {W}x{H} K={K}: max |d| rgb {(rgb_k - rgb_p).abs().max().item():.3g}, "
        f"cnt {(cnt_k - cnt_p).abs().max().item():.3g}; mean reprojected count "
        f"{cnt_k.mean().item():.4f}")
    torch.testing.assert_close(rgb_k, rgb_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(cnt_k, cnt_p, atol=1e-4, rtol=0)
    if cnt_k.mean().item() <= 1.0:
        raise AssertionError("K2 check carried almost no history; the check is vacuous")

    # Phase 4: the main path, through the kernels.
    log(f"phase 4: main path, render_animation 8 frames at {W}x{H} on the card")
    cams = [camera(i) for i in range(8)]
    stacked = Camera(loc=torch.stack([c.loc for c in cams]),
                     orient=torch.stack([c.orient for c in cams]))
    fk.LAUNCHES = 0
    rk.LAUNCHES = 0
    image, history = driver.render_animation(scene, cfg, num_frames=8, cameras=stacked)
    torch.cuda.synchronize()
    launches = {"frame": fk.LAUNCHES, "reproject": rk.LAUNCHES}
    mean_cnt = history.diffuse.cnt.mean().item()
    log(f"  launches {launches}; image {tuple(image.shape)} range "
        f"[{image.min().item():.4f}, {image.max().item():.4f}]; mean diffuse count {mean_cnt:.4f}")
    if not (torch.isfinite(image).all() and image.min() >= 0.0 and image.max() <= 1.0):
        raise AssertionError("main path image not finite in [0, 1]")
    if image.shape != (H, W, 3):
        raise AssertionError(f"main path image shape {tuple(image.shape)}")
    if launches != {"frame": 8, "reproject": 16}:
        raise AssertionError(f"main path did not run through both kernels: {launches}")
    if mean_cnt <= 4.0:
        raise AssertionError(f"history did not accumulate: mean diffuse count {mean_cnt}")

    # Phase 5: the card against the plain path on the CPU.
    log("phase 5: 3 pan frames at 256x128, card vs CPU plain path")
    small = RenderConfig(width=256, height=128, pipeline="fused")
    res = {}
    for d in (dev, torch.device("cpu")):
        sc = default_scene(device=d)
        h = pipeline.init_history(small, camera(0, d))
        for i in range(3):
            img, h = pipeline.render_frame(sc, camera(i, d), h, i, small)
        res[d.type] = (img.cpu(), h.to("cpu"))
    (img_g, h_g), (img_c, h_c) = res["cuda"], res["cpu"]
    items = {"cnt d": (h_g.diffuse.cnt, h_c.diffuse.cnt),
             "cnt s": (h_g.specular.cnt, h_c.specular.cnt)}
    for c in range(3):
        items[f"image.{c}"] = (img_g[..., c], img_c[..., c])
        items[f"rgb d.{c}"] = (h_g.diffuse.rgb[..., c], h_c.diffuse.rgb[..., c])
        items[f"rgb s.{c}"] = (h_g.specular.rgb[..., c], h_c.specular.rgb[..., c])
    for label, (a, b) in items.items():
        # Per plane: median |d| <= 1e-5 and <= 1e-3 of the components beyond
        # 1e-3*max(1,|ref|) (after 3 frames the flipped decisions of
        # phase 2 have spread through reprojection).
        dd = (a - b).abs()
        far = (dd > 1e-3 * torch.clamp(b.abs(), min=1.0)).float().mean().item()
        med = dd.median().item()
        log(f"  {label}: median |d| {med:.3g}, share beyond 1e-3 {far:.6f}")
        if med > 1e-5 or far > 1e-3:
            raise AssertionError(f"card and CPU disagree on {label}")
    oid_eq = (h_g.diffuse.oid == h_c.diffuse.oid).float().mean().item()
    log(f"  oid equal {oid_eq:.6f}")
    if oid_eq < 0.999:
        raise AssertionError("card and CPU disagree on oid")

    # Phase 6: times, CUDA events, medians after warm-up.
    log(f"phase 6: times on {card}")
    state = {"hist": history, "i": 8}

    def temporal_frame():
        i = state["i"]
        _, state["hist"] = pipeline.render_frame(scene, camera(i), state["hist"], i, cfg)
        state["i"] = i + 1

    frame_ms = cuda_ms(temporal_frame, reps=20, warmup=3)
    k1_ms = cuda_ms(lambda: fk.frame_forward(scene, camera(), 3, cfg), reps=20, warmup=2)
    k1_plain_ms = cuda_ms(lambda: fk.frame_forward_plain(scene, camera(), 3, cfg), reps=3, warmup=1)
    k2_ms = cuda_ms(lambda: rk.reproject_set(ref["oid"], dyrel, dxrel, w4, hist, K), reps=50, warmup=3)
    k2_plain_ms = cuda_ms(
        lambda: rk.reproject_window_plain(ref["oid"], dyrel, dxrel, w4, hist, K), reps=20, warmup=2)
    log(f"  temporal frame {W}x{H}: {frame_ms:.4f} ms, {W * H / frame_ms / 1e3:.2f} "
        f"primary Mrays/s [{card}]")
    log(f"  K1 frame kernel {W}x{H}: {k1_ms:.4f} ms; plain on the card {k1_plain_ms:.4f} ms [{card}]")
    log(f"  K2 reprojection {W}x{H} (one set): {k2_ms:.4f} ms; plain on the card "
        f"{k2_plain_ms:.4f} ms [{card}]")

    # Phase 7: where the time goes, from a profiler trace of 10 frames.
    log("phase 7: torch.profiler trace of 10 temporal frames")
    split = stage_split(temporal_frame, pipeline.STAGES, frames=10)
    busy = split["device_ms"] / frame_ms
    log(f"  device time per frame {split['device_ms']:.4f} ms in {split['launches']:.1f} "
        f"launches; busy {busy:.4f} of the {frame_ms:.4f} ms frame (phase 6) [{card}]")
    log("  device ms per frame by stage: " + ", ".join(
        f"{k} {v:.4f}" for k, v in split["stages"].items())
        + f" (sum {sum(split['stages'].values()):.4f}; a sum above the device "
        "time means a kernel was charged twice)")
    log("  device ms per frame by kernel: " + ", ".join(
        f"{k} {v:.4f}" for k, v in split["top"]))
    if split["device_ms"] <= 0.0:
        log("  the profiler recorded no device time; phase 6's CUDA events stand alone")
    n = 10000
    t0 = time.perf_counter()
    for _ in range(n):
        with torch.profiler.record_function("span"):
            pass
    log(f"  one profiler span with no profiler active: "
        f"{(time.perf_counter() - t0) / n * 1e6:.3f} us of host time "
        f"({len(pipeline.STAGES)} per frame)")

    kernels = [
        {"name": "frame_forward", "route": "cuda",
         "source": "kylespathtracer_tpu_torch/csrc/frame_kernel.cu",
         "replaces": "kylespathtracer_tpu/ops/frame_kernel.py:381",
         "launches": launches["frame"], "max_abs_err": k1_stats["max_abs"],
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "reproject_window", "route": "cuda",
         "source": "kylespathtracer_tpu_torch/csrc/reproject_kernel.cu",
         "replaces": "kylespathtracer_tpu/ops/reproject_kernel.py:290",
         "launches": launches["reproject"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
