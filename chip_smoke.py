"""GPU smoke run of the PyTorch port (kylespathtracer_tpu_torch).

Builds the CUDA kernels from `kylespathtracer_tpu_torch/csrc`, checks each
kernel against its plain PyTorch version on the card, and drives the port's
paths through the kernels, each with the launch counts set to 0 just before
it and read just after:

- the fused temporal frame (`app.driver.render_animation` at 1920×1080,
  K1 + K2; phases 2-7: card vs CPU, CUDA-event times, a torch.profiler
  split of the frame's device time by pipeline stage);
- the generic training step (`diff.inverse.train_step` at 1920×1080, K1 +
  the backward kernel K5; phase 10);
- inverse rendering (`diff.inverse.run_recovery`, the JAX package's
  RECOVERY recipe, K1 + the fused loss-and-gradient kernel K6; phase 11),
  held to its error bounds.

Gradient tables are held to max|Δ| <= 1e-4·max|ref| of their plain
versions: K5 and K6 at 256×128 with every pixel (phases 8-9), K6 (mean) at
1920×1080 (phase 12); K5 at 96×64 (phase 8), K6 on one view of the recovery
scene (phase 9) and K5 on train_step's own cotangent at 1920×1080 (phase 12)
without the ill-conditioned pixels (rays that graze a surface, sampling
decisions on a rounding boundary: frame_kernel.ill_conditioned), with the
comparison over every pixel logged beside. Phase 12 also logs K5 on random
cotangents at 1920×1080 with every table (tools/gradient_witness.py shows
the pixels behind it), then times K5, K6 and the generic step. Any failed
check raises, so the script exits non-zero; it needs one CUDA device and
fails without one.

    python3 chip_smoke.py

The second-to-last line of stdout is a JSON object describing every kernel
of the path; the last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
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


# Peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W limit): f32
# outside the tensor cores, and HBM3.
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the operations
    over the f32 peak and the bytes over the memory rate, and which it is."""
    t_ops, t_mem = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def frame_ops(scene, config, oid) -> float:
    """f32 operations of the fused frame (csrc/frame_core.cuh) on this
    frame's data, counted from the source: raygen, the primary trace, normal
    and material per pixel; per shaded pixel (a hit other than the light)
    and sample, the direct light with its visibility test, the two plane
    strategies per plane, and four roulettes, each a march to its plane and
    a light test. A trace costs 12 per plane, 20 per sphere and 584 per
    rounded box (6 faces × 8, 12 edges × 26, 8 corners × 28); an occlusion
    test 20 + 12 per plane + 20 per sphere + 160 per box."""
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk

    nP, nS, nB = fk._counts(scene)
    trace = 12 * nP + 20 * nS + 584 * nB
    occl = 20 + 12 * nP + 20 * nS + 160 * nB
    shaded = int(((oid > 0) & (oid != scene.light_id)).sum().item())
    smp = fk.smp_of(config)
    if config.biased:
        direct = 60 + (trace + 30 * nS if config.soft_shadows > 0 else occl)
        sample = direct + 150 * nP + 4 * (2 * nP + 2 * occl + 65)
    else:
        sample = 40 + occl + (occl + 10) / smp
    return oid.numel() * (65 + trace) + shaded * smp * sample


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


def table_check(got, ref, what: str) -> float:
    """Gradient tables (DIFF_IDX order, None where not computed) held to
    max|Δ| <= 1e-4·max|ref| each; raises naming the table, else → the
    largest |Δ|."""
    from kylespathtracer_tpu_torch.ops import frame_grad as fg

    worst_abs, worst_rel = 0.0, (0.0, "")
    for name, a, b in zip(fg.DIFF_NAMES, got, ref):
        if (a is None) != (b is None):
            raise AssertionError(f"{what}: table {name} computed on one side only")
        if a is None:
            continue
        scale = b.abs().max().item() if b.numel() else 0.0
        err = (a - b).abs().max().item() if b.numel() else 0.0
        if not err <= max(1e-4 * scale, 1e-10):
            raise AssertionError(f"{what}: table {name} off by {err:.4g} (max |ref| {scale:.4g})")
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, (err / scale if scale else 0.0, name))
    log(f"  {what}: worst table {worst_rel[1]}, |Δ|/max|ref| {worst_rel[0]:.3g}; "
        f"max |Δ| {worst_abs:.3g}")
    return worst_abs


def worst_entry(got, ref) -> tuple[int, int, float]:
    """The gradient entry farthest from its reference relative to its
    table's max |ref| → (table index in DIFF_NAMES, flat entry, |Δ|/max|ref|)."""
    best = (0, 0, -1.0)
    for i, (a, b) in enumerate(zip(got, ref)):
        if a is None or not b.numel() or not b.abs().max().item():
            continue
        d = (a - b).abs().flatten()
        rel = d.max().item() / b.abs().max().item()
        if rel > best[2]:
            best = (i, int(d.argmax()), rel)
    return best


def keep_planes(g: dict, bad) -> dict:
    """Cotangent planes with the pixels `bad` (bool[H,W]) zeroed."""
    keep = (~bad).to(torch.float32)
    return {k: v * (keep[..., None] if v.ndim == 3 else keep) for k, v in g.items()}


def plain_image(ref: dict, config) -> torch.Tensor:
    """The fresh-history image [H,W,3] of the frame dict `ref`: the composite
    K6 applies."""
    from kylespathtracer_tpu_torch.ops import loss_kernel as lk

    def ch(k, n):
        return [ref[k][..., i] for i in range(n)]

    return torch.stack(lk._composite_planes(ch("alb", 3), ch("ene", 2), ch("add_d", 3), ch("add_s", 3),
                                            float(config.brightness)), dim=-1)


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this smoke run needs a GPU")

    from kylespathtracer_tpu_torch.app import driver
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.ops import _build
    from kylespathtracer_tpu_torch.ops import frame_grad as fg
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.ops import loss_kernel as lk
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
    bad1080 = fk.ill_conditioned(out, ref)
    log(f"  ill-conditioned pixels (frame_kernel.ill_conditioned): {int(bad1080.sum())} of {W * H}")
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

    # Phase 8: K5 against its plain version, both on the card.
    log("phase 8: backward kernel (K5) vs plain, on the card, 256x128")
    GW, GH = 256, 128
    cases = {
        "default_hard": (scene, RenderConfig(width=GW, height=GH)),
        "spheres_soft_smp2": (spheres, RenderConfig(width=GW, height=GH, soft_shadows=0.05, **smp2)),
        "unbiased": (scene, RenderConfig(width=GW, height=GH, biased=False)),
    }
    rng = np.random.default_rng(1)

    def randn(shape):
        return torch.from_numpy(rng.normal(size=tuple(shape)).astype(np.float32)).to(dev)

    def k5_pair(sc, cam, c, g, needs=None):
        got = fg.frame_backward(sc, cam, 3, g, c, needs)
        torch.cuda.synchronize()
        return got, fg.frame_backward_plain(sc, cam, 3, g, c, needs)

    def k5_masked(sc, cam, c, g, bad, what, needs=None):
        """K5 against its plain version: logged with every pixel, held with
        the ill-conditioned pixels `bad` given no cotangent → max |Δ|."""
        ti, entry, rel = worst_entry(*k5_pair(sc, cam, c, g, needs))
        log(f"  {what}, all pixels: worst {fg.DIFF_NAMES[ti]}[{entry}], |Δ|/max|ref| {rel:.3g} (not held)")
        return table_check(*k5_pair(sc, cam, c, keep_planes(g, bad), needs),
                           f"{what}, {int(bad.sum())} ill-conditioned pixels masked")

    k5_err = 0.0
    for label, (sc, c) in cases.items():
        o = fk.frame_forward(sc, camera(), 3, c)
        for planes in (fg.OUT_KEYS[:6], ("add_d", "add_s", "alb", "ene")):
            g = {k: randn(o[k].shape) for k in planes}
            k5_err = max(k5_err, table_check(*k5_pair(sc, camera(), c, g), f"{label}, {len(planes)} keys"))
    # At 96x64 the sphere case holds a pixel whose ray grazes a sphere: an ulp
    # of ray direction moves the hit far, and the kernel and its plain version
    # round the ray that far apart (tools/gradient_witness.py finds it and
    # weighs both against float64).
    c = RenderConfig(width=96, height=64, soft_shadows=0.05, **smp2)
    o = fk.frame_forward(spheres, camera(), 3, c)
    bad = fk.ill_conditioned(o, fk.frame_forward_plain(spheres, camera(), 3, c))
    g = {k: randn(o[k].shape) for k in fg.OUT_KEYS[:6]}
    k5_err = max(k5_err, k5_masked(spheres, camera(), c, g, bad, "sphere_scene 96x64 soft smp=2"))

    # Phase 9: K6 against its plain version; targets from a perturbed scene
    # (the light 20% dimmer, every other sphere moved).
    log("phase 9: fused loss-and-gradient kernel (K6) vs plain, on the card, 256x128")

    def k6_check(sc, cam, frame, c, target, loss, what, needs=None, held=True):
        """K6 against its plain version: the loss to rtol 1e-5, the tables
        with table_check when `held`, else only logged → max |Δ|."""
        la, got = lk.render_loss_and_grad(sc, cam, frame, c, target, loss, needs)
        torch.cuda.synchronize()
        lb, want = lk.render_loss_and_grad_plain(sc, cam, frame, c, target, loss, needs)
        rel = abs(la.item() - lb.item()) / abs(lb.item())
        log(f"  {what}: loss {la.item():.7g} vs plain {lb.item():.7g} (rel {rel:.3g})")
        if not rel <= 1e-5:
            raise AssertionError(f"K6 loss, {what}: {la.item()} vs {lb.item()}")
        if held:
            return table_check(got, want, what)
        ti, entry, rel = worst_entry(got, want)
        log(f"  {what}: worst {fg.DIFF_NAMES[ti]}[{entry}], |Δ|/max|ref| {rel:.3g} (not held)")
        return 0.0

    k6_err = 0.0
    for label, (sc, c) in cases.items():
        bump = randn(sc.spheres.shape) * 0.05
        bump[sc.light_index] = 0.0
        other = dataclasses.replace(sc, spheres=sc.spheres + bump, light_color=sc.light_color * 0.8)
        target = inverse.render_once(other, camera(), dataclasses.replace(c, pipeline="fused"), 3)
        for loss in ("mse", "mean"):
            k6_err = max(k6_err, k6_check(sc, camera(), 3, c, target, loss, f"{label} {loss}"))
    # The recovery problem as run_recovery hands it to K6: one view of the
    # perturbed start against its seed-paired target (frame SEED_BASE), the
    # spheres and alb_const seeded, at the widest and the sharpest beta. Ten
    # spheres give many grazing silhouette pixels: logged with all pixels,
    # held with the ill-conditioned ones given the plain image as target,
    # which zeroes their residual.
    truth, start, views = inverse.recovery_scenes(10, 5, device=dev)
    rec_needs = fg.needs_for(("spheres", "alb_const"))
    f0 = inverse.SEED_BASE
    for beta in (0.05, 0.003):
        c = RenderConfig(width=192, height=128, soft_shadows=beta, pipeline="fused")
        target = inverse.render_once(truth, views[0], c, f0)
        o, p = fk.frame_forward(start, views[0], f0, c), fk.frame_forward_plain(start, views[0], f0, c)
        bad = fk.ill_conditioned(o, p)
        what = (f"recovery scene 192x128 beta={beta} mse, "
                f"{fg.seed_indices(start, rec_needs, dev).numel()} seeds")
        k6_check(start, views[0], f0, c, target, "mse", f"{what}, all pixels", rec_needs, held=False)
        held = torch.where(bad[..., None], plain_image(p, c), target)
        k6_err = max(k6_err, k6_check(start, views[0], f0, c, held, "mse",
                                      f"{what}, {int(bad.sum())} ill-conditioned pixels masked", rec_needs))

    # Phase 10: the generic training path, then its gradient against K6.
    log(f"phase 10: generic training path, train_step x3 at {W}x{H} (K1 + K5)")
    cfg_f = RenderConfig(width=W, height=H, pipeline="fused")
    # The target: the room under a light 20% dimmer.
    target_1080 = inverse.render_once(dataclasses.replace(scene, light_color=scene.light_color * 0.8),
                                      camera(), cfg_f, 3)
    opt = inverse.ClippedAdam(5e-2, 3, 0.05, clip=1.0)
    params = inverse.extract_params(scene, ("spheres", "light_color"))
    state = opt.init(params)
    fk.LAUNCHES = fg.LAUNCHES = lk.LAUNCHES = 0
    losses = []
    for _ in range(3):
        params, state, loss = inverse.train_step(params, state, opt, scene, camera(), target_1080, 3, cfg_f)
        losses.append(loss.item())
    torch.cuda.synchronize()
    train_launches = {"frame": fk.LAUNCHES, "backward": fg.LAUNCHES, "loss": lk.LAUNCHES}
    log(f"  launches {train_launches}; losses {losses}")
    if train_launches != {"frame": 3, "backward": 3, "loss": 0}:
        raise AssertionError(f"the generic step did not run through K1 and K5: {train_launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"generic training did not descend: {losses}")
    keys = ("spheres", "planes", "alb_const", "light_color")
    p = {k: v.detach().clone().requires_grad_() for k, v in inverse.extract_params(scene, keys).items()}
    mean_g = inverse.render_once(inverse.apply_params(scene, p), camera(), cfg_f, 3).mean()
    grads_g = torch.autograd.grad(mean_g, list(p.values()))
    mean_f, (d_scene, _) = lk.loss_and_grad(scene, camera(), 3, cfg_f, loss="mean", keys=keys)
    rel = abs(mean_f.item() - mean_g.item()) / abs(mean_g.item())
    log(f"  image mean: generic {mean_g.item():.7g}, fused {mean_f.item():.7g} (rel {rel:.3g})")
    if not rel <= 1e-5:
        raise AssertionError("generic and fused image means disagree")
    for k, gk in zip(p, grads_g):
        scale, err = gk.abs().max().item(), (d_scene[k] - gk).abs().max().item()
        log(f"  {k}: max |generic| {scale:.4g}, |fused - generic| {err:.3g} (rel {err / scale:.3g})")
        if not err <= 1e-4 * scale:
            raise AssertionError(f"generic and fused gradients of {k} disagree")

    # Phase 11: inverse rendering, the RECOVERY recipe (bench_configs.py:454-464).
    log("phase 11: run_recovery, 10 spheres, 800 steps, 192x128, 5 views, 4 beta phases")
    fk.LAUNCHES = fg.LAUNCHES = lk.LAUNCHES = 0
    t0 = time.perf_counter()
    res = inverse.run_recovery(num_spheres=10, steps=800, width=192, height=128, views=5,
                               betas=(0.05, 0.02, 0.008, 0.003), log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec_launches = {"frame": fk.LAUNCHES, "backward": fg.LAUNCHES, "loss": lk.LAUNCHES}
    log(f"  {res['steps']} steps in {wall:.3f} s, {wall / res['steps'] * 1e3:.3f} ms per step "
        f"(targets included) [{card}]; launches {rec_launches}")
    log(f"  loss {res['loss_initial']:.6g} -> {res['loss_final']:.6g}; err_position "
        f"{res['err_position']:.6g}, err_radius {res['err_radius']:.6g}, err_albedo "
        f"{res['err_albedo']:.6g}")
    if rec_launches["frame"] == 0 or rec_launches["loss"] == 0:
        raise AssertionError(f"run_recovery did not run through K1 and K6: {rec_launches}")
    if not (res["err_position"] < 0.01 and res["err_radius"] < 0.005
            and res["err_albedo"] < 0.01 and res["loss_final"] < res["loss_initial"]):
        raise AssertionError(f"recovery missed its bounds: {res}")

    # Phase 12: the gradient kernels at 1920x1080, all tables: against their
    # plain versions, then their times.
    log(f"phase 12: gradient kernels at {W}x{H} vs plain, then CUDA-event times [{card}]")
    # K5 as train_step drives it (phase 10): the cotangent its loss gives
    # the frame planes, the spheres and light_color seeded.
    planes = {k: v.requires_grad_() for k, v in fk.frame_forward(scene, camera(), 3, cfg).items()
              if k != "oid"}
    with torch.enable_grad():
        loss = torch.mean((plain_image(planes, cfg) - target_1080) ** 2)
        g_path = {k: d for k, d in zip(planes, torch.autograd.grad(loss, list(planes.values()),
                                                                    allow_unused=True)) if d is not None}
    k5_err = max(k5_err, k5_masked(scene, camera(), cfg, g_path, bad1080, f"K5 {W}x{H} train_step's cotangent",
                                   fg.needs_for(("spheres", "light_color"))))
    # Random cotangents on all 13 planes, every table: logged only. A few
    # pixels hold the distance, where a sampling or checker decision that
    # leaves the value unchanged sits on a rounding boundary
    # (tools/gradient_witness.py).
    g_all = {k: randn(ref[k].shape) for k in fg.OUT_KEYS[:6]}
    ti, entry, rel = worst_entry(*k5_pair(scene, camera(), cfg, keep_planes(g_all, bad1080)))
    log(f"  K5 {W}x{H}, random cotangents, 13 planes, {int(bad1080.sum())} ill-conditioned pixels masked: "
        f"worst {fg.DIFF_NAMES[ti]}[{entry}], |Δ|/max|ref| {rel:.3g} (not held)")
    k6_err = max(k6_err, k6_check(scene, camera(), 3, cfg, None, "mean", f"K6 {W}x{H} mean, all pixels"))
    k5_ms = cuda_ms(lambda: fg.frame_backward(scene, camera(), 3, g_all, cfg), reps=3)
    k6_ms = cuda_ms(lambda: lk.render_loss_and_grad(scene, camera(), 3, cfg, loss="mean"), reps=3)

    mats = ("s0", "s1", "alb_const", "alb_scale", "emission", "en_const", "en_scale")

    def generic_step():
        """bench.py's generic fwd+bwd: the image mean's gradient in every
        scene table, through the differentiable frame (K1, then K5)."""
        leaves = {k: t.detach().clone().requires_grad_()
                  for k, t in zip(fg.GRAD_NAMES[:11], fg._inputs(scene, camera()))}
        sc = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, **{k: leaves[k] for k in mats}),
            **{k: leaves[k] for k in ("planes", "spheres", "boxes", "light_color")})
        img = inverse.render_once(sc, camera(), cfg_f, 3)
        torch.autograd.grad(img.mean(), list(leaves.values()))

    gen_ms = cuda_ms(generic_step, reps=3)
    torch.cuda.reset_peak_memory_stats()
    k5_plain_ms = cuda_ms(lambda: fg.frame_backward_plain(scene, camera(), 3, g_all, cfg), reps=1)
    k6_plain_ms = cuda_ms(lambda: lk.render_loss_and_grad_plain(scene, camera(), 3, cfg, loss="mean"),
                          reps=1)
    plain_gib = torch.cuda.max_memory_allocated() / 2**30
    small = cases["default_hard"][1]
    g_small = {k: randn((GH, GW) + tuple(v.shape[2:])) for k, v in g_all.items()}
    k5_ms_s = cuda_ms(lambda: fg.frame_backward(scene, camera(), 3, g_small, small), reps=5)
    k5_plain_ms_s = cuda_ms(lambda: fg.frame_backward_plain(scene, camera(), 3, g_small, small), reps=3)
    k6_ms_s = cuda_ms(lambda: lk.render_loss_and_grad(scene, camera(), 3, small, loss="mean"), reps=5)
    k6_plain_ms_s = cuda_ms(
        lambda: lk.render_loss_and_grad_plain(scene, camera(), 3, small, loss="mean"), reps=3)
    log(f"  K5 backward, 13 cotangent planes, all {len(fg.seed_indices(scene, fg.needs_for(None), dev))} "
        f"table entries: {k5_ms:.4f} ms; plain {k5_plain_ms:.4f} ms [{card}]")
    log(f"  K6 loss='mean', all tables: {k6_ms:.4f} ms; plain {k6_plain_ms:.4f} ms; "
        f"fwd_bwd_rays_per_s_1080p {W * H / k6_ms * 1e3:.1f} [{card}]")
    log(f"  generic fwd+bwd (K1 + K5 through autograd, scene tables): {gen_ms:.4f} ms; "
        f"fwd_bwd_generic_rays_per_s_1080p {W * H / gen_ms * 1e3:.1f} [{card}]")
    log(f"  plain versions at {W}x{H}: peak {plain_gib:.2f} GiB of device memory")
    log(f"  at {GW}x{GH}: K5 {k5_ms_s:.4f} ms, plain {k5_plain_ms_s:.4f} ms; K6 {k6_ms_s:.4f} ms, "
        f"plain {k6_plain_ms_s:.4f} ms [{card}]")

    # Bounds, from this run's inputs (frame_ops, bound).
    ops1 = frame_ops(scene, cfg, ref["oid"])
    tab_bytes = sum(t.numel() * t.element_size() for t in fk.pack_tables(scene, camera()))
    k1_bound = bound(ops1, tab_bytes + W * H * (13 * 4 + 4))
    k2_io = (ref["oid"], dyrel, dxrel, *w4, hist.rgb, hist.cnt, hist.oid, rgb_k, cnt_k)
    k2_bound = bound(W * H * 4 * 10, sum(t.numel() * t.element_size() for t in k2_io))
    # The gradient of a scalar costs at most ~3 times its forward's operations
    # (reverse mode); K6 adds the composite and the loss (~120 per pixel).
    k5_bound = bound(3 * ops1, tab_bytes + sum(v.numel() * 4 for v in g_all.values()))
    k6_bound = bound(3 * (ops1 + 120 * W * H), tab_bytes)
    log(f"  bounds at {W}x{H}: K1 {k1_bound[0]:.4f} ms ({k1_bound[1]}, {ops1 / 1e9:.3f} GFLOP), "
        f"K2 {k2_bound[0]:.4f} ms ({k2_bound[1]}), K5 {k5_bound[0]:.4f} ms ({k5_bound[1]}), "
        f"K6 {k6_bound[0]:.4f} ms ({k6_bound[1]})")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": f"kylespathtracer_tpu_torch/csrc/{source}",
                "replaces": f"kylespathtracer_tpu/ops/{replaces}", "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None}

    kernels = [
        entry("frame_forward", "frame_kernel.cu", "frame_kernel.py:381", launches["frame"],
              k1_stats["max_abs"], k1_ms, k1_plain_ms, k1_bound),
        entry("reproject_window", "reproject_kernel.cu", "reproject_kernel.py:290",
              launches["reproject"], k2_err, k2_ms, k2_plain_ms, k2_bound),
        entry("frame_backward", "frame_grad.cu", "frame_grad.py:189", train_launches["backward"],
              k5_err, k5_ms, k5_plain_ms, k5_bound),
        entry("render_loss_and_grad", "loss_kernel.cu", "loss_kernel.py:216",
              rec_launches["loss"], k6_err, k6_ms, k6_plain_ms, k6_bound),
    ]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
