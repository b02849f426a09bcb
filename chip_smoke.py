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
  held to its error bounds. K5 and K6 are one reverse-mode adjoint pass
  over the pixels each (csrc/frame_adjoint.cuh);
- the primary-visibility raycast (`ops.geometry_kernel.geometry_pass` at
  1920×1080, K3; phase 13, held against its plain version and the G-buffer
  module);
- the multi-bounce path tracer (`render.wavefront.render_pathtraced` and
  the `pathtrace` CLI at 1920×1080, 4 spp, depth 6, K7; phase 16), after
  K7 is held against its plain version (phase 14) and against the port's
  XLA-style integrator on the JAX package's config 3 (phase 15);
- the mono temporal frame (`render_animation` at 1920×1080 with
  temporal_fusion="mono", K8 alone; phase 18), after K8 is held against
  its plain version at 1080p (phase 17);
- the pass pipeline (`render_animation` at 1920×1080 with pipeline="pass",
  shade_backend="pallas", the shade kernel K4; phase 20), after K4 is held
  against its plain version at 1080p (phase 19), and the `render` CLI at
  1920×1080 (its fused default, K1 + K2) and at 256×128 (`--pipeline pass`);
- the sharded renderer and trainer (`parallel/shard.py`): 3 tiles of 360
  rows at 1920×1080 in this process, two frames each of the split frame
  (K1 row mode + K2 tile mode) and the mono frame (K8 tile mode) from a
  populated history, stitched and held against the unsharded frame, each
  tile launch held against its plain version (phase 21); the tiled training
  step (K1 + K5 row mode) at 1920×1080 in 3 tiles and at the 192×128
  recovery view in 2, held against the unsharded `train_step` (phase 22);
  and 3 gloo ranks sharing this card through `multihost.initialize_from_env`
  (`render_frame_tiled` with its halo exchange, `train_step_tiled` with its
  all-reduce), held against the in-process tiles, with the halo exchange's
  and the frame's time per rank and end to end (phase 23). Three ranks on
  one card share it: their times are no scaling figure. The `kernels`
  line's launches of the four tile and row modes are phase 23's, counted
  on each rank and summed over the ranks.

Gradient tables are held to max|Δ| <= 1e-4·max|ref| of their plain
versions: K5 and K6 at 256×128 with every pixel (phases 8-9), K6 (mean) at
1920×1080 (phase 12); K5 at 96×64 (phase 8), K6 on one view of the recovery
scene (phase 9) and K5 on train_step's own cotangent at 1920×1080 (phase 12)
without the ill-conditioned pixels (rays that graze a surface, sampling
decisions on a rounding boundary: frame_kernel.ill_conditioned), with the
comparison over every pixel logged beside; so is K5 on random cotangents at
1920×1080 with every table (phase 12; tools/gradient_witness.py shows the
pixels behind the unmasked distance). Phase 12 then times K5, K6 and the
generic step, and K5 and K6 at the recovery view's shape (192×128, spheres
and alb_const), each beside its bound and the forward-mode kernels' time.
K1, K8, K7 and K4 are timed alone (CUDA events around their launch) and
with their wrappers (phases 6, 18, 16 and 19), K1 also at the recovery view,
beside the registers, stack and spill of their build (phase 1); phase 16
also prints K7's census (ops/path_kernel.census: per bounce the live lanes
and the warps that run the rounded box's candidates). Any failed
check raises, so the script exits non-zero; it needs one CUDA device and
fails without one.

    python3 chip_smoke.py

(`python3 chip_smoke.py --rank-worker DIR` is one rank of phase 23, which
starts it.) The second-to-last line of stdout is a JSON object describing every kernel
of the path; the last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

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


# The forward-mode K5 and K6 that the reverse-mode adjoint replaced, at
# 1920×1080 with every table (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
FORWARD_MODE_MS = {"K5": (224.7239, 227.5123), "K6": (227.3582, 227.3737)}

# Peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W limit): f32
# outside the tensor cores, and HBM3.
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def sm_clock_mhz() -> float:
    """The card's maximum SM clock (MHz), as nvidia-smi gives it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the operations
    over the f32 peak and the bytes over the memory rate, and which it is."""
    t_ops, t_mem = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def frame_ops(scene, config, oid) -> float:
    """f32 operations of the fused frame (csrc/frame_core.cuh) on this
    frame's data, counted from the source: raygen, the primary trace
    (`trace_ops`), normal and material per pixel, and the shade
    (`shade_ops`)."""
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk

    return oid.numel() * (65 + trace_ops(scene)) + shade_ops(scene, config, oid, fk.smp_of(config))


def shade_ops(scene, config, oid, smp: int) -> float:
    """f32 operations of the shade (csrc/shade_core.cuh) on this frame's
    data: per shaded pixel (a hit other than the light) and sample, the
    direct light with its visibility test (`occlusion_ops`), the two plane
    strategies per plane, and four roulettes, each a march to its plane and
    a light test."""
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk

    nP, nS, nB = fk._counts(scene)
    trace, occl = trace_ops(scene), occlusion_ops(scene)
    shaded = int(((oid > 0) & (oid != scene.light_id)).sum().item())
    if config.biased:
        direct = 60 + (trace + 30 * nS if config.soft_shadows > 0 else occl)
        sample = direct + 150 * nP + 4 * (2 * nP + 2 * occl + 65)
    else:
        sample = 40 + occl + (occl + 10) / smp
    return shaded * smp * sample


# K8's per-pixel work beyond K1's frame (csrc/frame_hist.cu): the anchors
# (~30), and per channel set the previous-camera projection (~45), the four
# taps (~10 each) and the count floor, clamp and accumulate (~15).
HIST_OPS = 30 + 2 * (45 + 4 * 10 + 15)


def occlusion_ops(scene) -> int:
    """f32 operations of one occlusion test toward the light
    (csrc/shade_core.cuh:light_visible): 20 + 12 per plane + 20 per sphere
    + 160 per rounded box."""
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk

    nP, nS, nB = fk._counts(scene)
    return 20 + 12 * nP + 20 * nS + 160 * nB


def trace_ops(scene, inside_hits: bool = False) -> int:
    """f32 operations of one nearest-hit trace (csrc/shade_core.cuh): 12 per
    plane, 20 per sphere (23 with the far root of the path kernel's
    inside-hit trace), 584 per rounded box (6 faces × 8, 12 edges × 26, 8
    corners × 28)."""
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk

    nP, nS, nB = fk._counts(scene)
    return 12 * nP + (23 if inside_hits else 20) * nS + 584 * nB


def geometry_ops(scene, pixels: int) -> int:
    """K3 (csrc/geometry_kernel.cu): per pixel the raygen (~25), the trace
    and the normal with the hit point (~40)."""
    return pixels * (65 + trace_ops(scene))


def path_ops(scene, pixel_samples: int, tally: dict) -> int:
    """K7 (csrc/path_kernel.cu) on this run's data, from the plain version's
    tally of the work (path_kernel.path_block): per pixel and sample the
    raygen (~25); per traced segment the inside-hit trace; per segment that
    hits, the vertex: the occlusion test toward the light (counted at
    every vertex, though NEE skips the light itself), the normal (~25), the
    material (~20), three R2 pairs (~78 integer operations), the light
    sample (~60), the NEE pdf (~15), the BSDF evaluation (~20) and sample
    (~50), and the path bookkeeping (~50)."""
    return (pixel_samples * 25 + tally["traced"] * trace_ops(scene, inside_hits=True)
            + tally["hits"] * (occlusion_ops(scene) + 318))


def ptxas_lines(report: str, source: str) -> str:
    """The registers/stack/spill lines of `source` in a verbose build report."""
    part = report.split(f"--- {source}\n", 1)[1].split("\n--- ", 1)[0]
    return "; ".join(ln.strip() for ln in part.splitlines()
                     if re.search(r"Used \d+ registers|bytes stack frame", ln))


def png_pixels(path) -> tuple[int, int, int]:
    """(width, height, bytes of the decompressed IDAT) of a PNG written by
    utils/image_io.save_png."""
    data = open(path, "rb").read()
    w, h = struct.unpack(">II", data[16:24])
    n = struct.unpack(">I", data[33:37])[0]
    if data[37:41] != b"IDAT":
        raise AssertionError(f"{path}: no IDAT chunk after IHDR")
    return w, h, len(zlib.decompress(data[41:41 + n]))


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
            elif "kpt::reproject" in e.name:
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


# The sharded phases (21-23): 3 tiles of 360 rows, a multiple of the tile
# kernels' 8-row block, so the fused frames run K8's tile mode or K1's row
# mode and K2's tile mode. Their cameras move ~1.5 px in pitch and ~0.8 px
# in yaw a frame, so the reprojection's taps cross the tiles' edges.
TILES = 3


def tile_camera(i: int, device):
    from kylespathtracer_tpu_torch.render.camera import Camera

    return Camera.create(loc=CAM_LOC, orient=(CAM_ORIENT[0] - 1.8e-3 * i, CAM_ORIENT[1] + 1e-3 * i),
                         device=device)


def history_tensors(hist) -> dict:
    """A History as a dict of tensors (torch.save between processes)."""
    return {"d_rgb": hist.diffuse.rgb, "d_cnt": hist.diffuse.cnt, "d_oid": hist.diffuse.oid,
            "s_rgb": hist.specular.rgb, "s_cnt": hist.specular.cnt, "s_oid": hist.specular.oid,
            "loc": hist.camera.loc, "orient": hist.camera.orient}


def history_from(t: dict, device):
    from kylespathtracer_tpu_torch.render.camera import Camera
    from kylespathtracer_tpu_torch.render.passes import Channel
    from kylespathtracer_tpu_torch.render.pipeline import History

    g = {k: v.to(device) for k, v in t.items()}
    return History(Channel(g["d_rgb"], g["d_cnt"], g["d_oid"]), Channel(g["s_rgb"], g["s_cnt"], g["s_oid"]),
                   Camera(loc=g["loc"], orient=g["orient"]))


def stitch(parts: list):
    """The tiles' (image, History) pairs stacked by rows in tile order."""
    from kylespathtracer_tpu_torch.render.passes import Channel
    from kylespathtracer_tpu_torch.render.pipeline import History

    def cat(get):
        return torch.cat([get(p) for p in parts])

    ch = lambda name: Channel(*(cat(lambda p, f=f: getattr(getattr(p[1], name), f)) for f in ("rgb", "cnt", "oid")))
    return cat(lambda p: p[0]), History(ch("diffuse"), ch("specular"), parts[0][1].camera)


def frame_gaps(a, b) -> dict:
    """max |Δ| of two (image, History) results, and whether each part is
    bitwise the other's."""
    pairs = {"image": (a[0], b[0])}
    for name in ("diffuse", "specular"):
        for f in ("rgb", "cnt", "oid"):
            pairs[f"{name}.{f}"] = (getattr(getattr(a[1], name), f), getattr(getattr(b[1], name), f))
    gaps = {k: (x.float() - y.float()).abs().max().item() for k, (x, y) in pairs.items()}
    gaps["bitwise"] = all(torch.equal(x, y) for x, y in pairs.values())
    return gaps


def hold_frame_gaps(gaps: dict, what: str) -> None:
    """The JAX package's bars for a tiled frame against the unsharded one
    (tests/test_sharding.py:90-96): image 1e-5, history 1e-4, oid exact."""
    bar = {"image": 1e-5, "rgb": 1e-4, "cnt": 1e-4, "oid": 0.0}
    bad = [k for k, v in gaps.items() if k != "bitwise" and v > bar[k.split(".")[-1]]]
    if bad:
        raise AssertionError(f"{what}: beyond the bars on {bad}: {gaps}")


def seeded_history(scene, dev):
    """The sharded phases' start: numpy-seeded rgb in [0, 2) and integer
    counts in [0, 16] on the object IDs that K1 sees from tile_camera(0)."""
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.render.passes import Channel
    from kylespathtracer_tpu_torch.render.pipeline import History
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    oid = fk.frame_forward(scene, tile_camera(0, dev), 0, RenderConfig(width=W, height=H, pipeline="fused"))["oid"]

    def channel(seed):
        rng = np.random.default_rng(seed)
        return Channel(rgb=torch.from_numpy(rng.uniform(0, 2, (H, W, 3)).astype(np.float32)).to(dev),
                       cnt=torch.from_numpy(rng.integers(0, 17, (H, W)).astype(np.float32)).to(dev),
                       oid=oid.clone())

    return History(channel(21), channel(22), tile_camera(0, dev))


def render_tiles(scene, cfg_x, hist, i, dev):
    """Frame i in TILES tiles, one after another in this process, each on
    the window tile_window cuts from `hist` → the stitched (image, History)."""
    from kylespathtracer_tpu_torch.parallel import shard

    rows, halo = H // TILES, shard.BLOCK_ROWS
    return stitch([shard._render_row_block(scene, tile_camera(i, dev), shard.tile_window(hist, r * rows, rows, halo),
                                           i, cfg_x, r * rows, rows, buffer_row0=r * rows - halo, halo=halo)
                   for r in range(TILES)])


def tiled_frames(scene, hist0, dev):
    """Frames 1 and 2 of the split and the mono frame in TILES tiles from
    `hist0`, the fallback warning an error, each fusion's launch counts set
    to 0 just before and read just after → ({fusion: (image, History)},
    {fusion: launches})."""
    import warnings

    from kylespathtracer_tpu_torch.ops import frame_hist as fh
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    tiled, launches = {}, {}
    for fusion in ("split", "mono"):
        cfg_x = RenderConfig(width=W, height=H, pipeline="fused", temporal_fusion=fusion)
        hist = hist0
        fk.LAUNCHES = fk.ROW_LAUNCHES = rk.LAUNCHES = rk.TILE_LAUNCHES = fh.LAUNCHES = fh.TILE_LAUNCHES = 0
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="fused tiled path")
            for i in (1, 2):
                img, hist = render_tiles(scene, cfg_x, hist, i, dev)
        torch.cuda.synchronize()
        launches[fusion] = {"frame": fk.LAUNCHES, "frame rows": fk.ROW_LAUNCHES, "reproject": rk.LAUNCHES,
                            "reproject tile": rk.TILE_LAUNCHES, "frame_hist": fh.LAUNCHES,
                            "frame_hist tile": fh.TILE_LAUNCHES}
        tiled[fusion] = (img, hist)
    return tiled, launches


def dim_target(scene, dev):
    """The training target of phases 10 and 22-23: the room under a light
    20% dimmer, frame 3."""
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.render.camera import Camera
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    return inverse.render_once(dataclasses.replace(scene, light_color=scene.light_color * 0.8),
                               Camera.create(loc=CAM_LOC, orient=CAM_ORIENT, device=dev),
                               RenderConfig(width=W, height=H, pipeline="fused"), 3)


def step_optimizer():
    from kylespathtracer_tpu_torch.diff import inverse

    return inverse.ClippedAdam(5e-2, 3, 0.05, clip=1.0)


def tiled_step(params, opt, scn, cam, target, frame, cfg_x, n):
    """The in-process reference of train_step_tiled on n ranks (phase 23
    drives train_step_tiled itself): its per-rank tile_loss_and_grad on
    each of n tiles, one after another, the losses and gradients summed as
    its all-reduce sums them, then the update → (new params, loss)."""
    from kylespathtracer_tpu_torch.parallel import shard

    rows = cfg_x.height // n
    parts = [shard.tile_loss_and_grad(params, scn, cam, target[r * rows:(r + 1) * rows], frame, cfg_x, r * rows, rows)
             for r in range(n)]
    new = opt.update({k: sum(p[1][k] for p in parts) for k in params}, opt.init(params), params)
    return {k: v.clone() for k, v in new.items()}, sum(p[0] for p in parts).item()


def rank_phase(backend: str, hist0, tiled, params, new_params, loss, target, card: str) -> list:
    """TILES ranks of one process group, each a process started here
    through the KPT_* launch contract (the kernels are built: the ranks
    only load them): gloo on this card, or NCCL with a card per rank. They
    render the tiled frames and take the tiled step; held against the
    in-process tiles `tiled` and `new_params` → the ranks' reports."""
    per_rank = "a card per rank" if backend == "nccl" else f"{TILES} ranks share it"
    log(f"phase 23: {TILES} {backend} ranks ({per_rank}) through multihost.initialize_from_env: "
        "render_frame_tiled (split, mono; 2 frames held, 7 timed), the halo exchange, train_step_tiled")
    host = lambda d: {k: v.cpu() for k, v in d.items()}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"hist": host(history_tensors(hist0)),
                    **{f: (tiled[f][0].cpu(), host(history_tensors(tiled[f][1]))) for f in tiled},
                    "params": host(params), "new_params": host(new_params), "target": target.cpu()},
                   f"{tmp}/inputs.pt")
        port = free_port()
        procs = []
        try:
            for r in range(TILES):
                env = dict(os.environ, KPT_COORDINATOR=f"127.0.0.1:{port}", KPT_NUM_PROCESSES=str(TILES),
                           KPT_PROCESS_ID=str(r), GLOO_SOCKET_IFNAME="lo")
                procs.append(subprocess.Popen([sys.executable, __file__, "--rank-worker", tmp, backend], env=env,
                                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            deadline = time.monotonic() + 300
            outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0)) for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            said = "\n".join(f"rank {r}: {out[-1500:]}\n{err[-1500:]}"
                             for r, (out, err) in enumerate(p.communicate() for p in procs))
            raise AssertionError(f"the {backend} ranks did not end within 300 s:\n{said}") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    reports = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"rank {r} failed ({p.returncode}):\n{out[-3000:]}\n{err[-3000:]}")
        reports.append(json.loads(lines[-1][5:]))
    for rep in reports:
        log(f"  rank {rep['rank']} on {rep['device']} ({rep['info']}): split launches {rep['split']['launches']}, "
            f"mono launches {rep['mono']['launches']}, train launches {rep['train']['launches']}; frame ms on this "
            f"rank / until every rank is done: split {rep['split']['frame_ms_rank']:.4f} / "
            f"{rep['split']['frame_ms_all']:.4f}, mono {rep['mono']['frame_ms_rank']:.4f} / "
            f"{rep['mono']['frame_ms_all']:.4f}; halo exchange {rep['exchange_ms']:.4f} ms; train step "
            f"{rep['train']['step_ms_rank']:.4f} / {rep['train']['step_ms_all']:.4f} ms [{card}; {per_rank}]")
        if rep["split"]["launches"] != {"frame": 2, "frame rows": 2, "reproject": 4, "reproject tile": 4,
                                        "frame_hist": 0, "frame_hist tile": 0} or \
                rep["mono"]["launches"]["frame_hist tile"] != 2 or \
                rep["train"]["launches"] != {"frame rows": 1, "backward rows": 1}:
            raise AssertionError(f"rank {rep['rank']} did not run through the tile modes: {rep}")
    rank0 = reports[0]
    for fusion in ("split", "mono"):
        log(f"  {fusion}: the {TILES} ranks' gathered rows vs the in-process tiles, max |d|: {rank0[fusion]['gaps']}")
        hold_frame_gaps(rank0[fusion]["gaps"], f"{TILES} {backend} ranks vs the in-process {fusion} tiles")
    log(f"  train_step_tiled on {TILES} ranks vs the in-process tiles' update, |d|/max|ref|: "
        f"{rank0['train']['update_gap']}; loss {rank0['train']['loss']:.7g} (in process {loss:.7g})")
    if not all(v <= 1e-4 for v in rank0["train"]["update_gap"].values()):
        raise AssertionError(f"train_step_tiled on the {backend} ranks parts from the in-process tiles")
    return reports


def nccl_main() -> int:
    """`chip_smoke.py --nccl`: the sharded path on NCCL, one card per rank
    (needs TILES cards): builds the kernels, renders the in-process tiles
    and takes the tiled step on card 0 as the reference, then phase 23 with
    NCCL."""
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.ops import _build
    from kylespathtracer_tpu_torch.render.camera import Camera
    from kylespathtracer_tpu_torch.scene.scene import default_scene
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    card = card_line()
    count = torch.cuda.device_count()
    log(f"phase 0: {count} cards, {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    if count < TILES:
        sys.exit(f"chip_smoke --nccl: needs {TILES} cards, found {count}")
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"phase 1: built {path.name} in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    scene = default_scene(device=dev)
    hist0 = seeded_history(scene, dev)
    tiled, launches = tiled_frames(scene, hist0, dev)
    log(f"  the reference: {TILES} tiles in one process on {dev}, launches {launches}")
    target = dim_target(scene, dev)
    params = inverse.extract_params(scene, ("spheres", "light_color"))
    new, loss = tiled_step(params, step_optimizer(), scene, Camera.create(loc=CAM_LOC, orient=CAM_ORIENT, device=dev),
                           target, 3, RenderConfig(width=W, height=H, pipeline="fused"), TILES)
    rank_phase("nccl", hist0, tiled, params, new, loss, target, card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": count}}))
    return 0


def rank_worker(tmp: str, backend: str) -> int:
    """One rank of phase 23: joins the group through the KPT_* environment
    (gloo: the ranks share card 0; NCCL: a card per rank), renders phase
    21's two frames of the split and the mono frame with render_frame_tiled
    and takes phase 22's 1080p step with train_step_tiled; rank 0 gathers
    the rows and measures their distance from the in-process tiles. Then
    times frames, the halo exchange and the step. Prints one line,
    RANK <json>."""
    import warnings

    import torch.distributed as dist

    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.ops import frame_grad as fg
    from kylespathtracer_tpu_torch.ops import frame_hist as fh
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
    from kylespathtracer_tpu_torch.parallel import mesh as mesh_mod
    from kylespathtracer_tpu_torch.parallel import multihost, shard
    from kylespathtracer_tpu_torch.render.camera import Camera
    from kylespathtracer_tpu_torch.scene.scene import default_scene
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    if not multihost.initialize_from_env(device="cuda", backend=backend):
        raise SystemExit("rank worker: the environment asks for no process group")
    mesh = multihost.global_mesh(device="cuda:0" if backend == "gloo" else None)
    dev = mesh.device
    data = torch.load(f"{tmp}/inputs.pt")
    scene = default_scene(device=dev)
    rows = H // mesh.size
    report = {"rank": mesh.rank, "size": mesh.size, "rows": rows, "device": str(dev), "info": multihost.process_info()}

    def timed(fn):
        """fn() between barriers → (its result, ms on this rank, ms until
        every rank is done)."""
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dist.barrier()
        return out, (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3

    for fusion in ("split", "mono"):
        cfg = RenderConfig(width=W, height=H, pipeline="fused", temporal_fusion=fusion)
        hist = mesh_mod.shard_image_pytree(history_from(data["hist"], dev), mesh, H)
        fk.LAUNCHES = fk.ROW_LAUNCHES = rk.LAUNCHES = rk.TILE_LAUNCHES = fh.LAUNCHES = fh.TILE_LAUNCHES = 0
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="fused tiled path")
            for i in (1, 2):
                img, hist = shard.render_frame_tiled(scene, tile_camera(i, dev), hist, i, cfg, mesh)
        torch.cuda.synchronize()
        r = {"launches": {"frame": fk.LAUNCHES, "frame rows": fk.ROW_LAUNCHES, "reproject": rk.LAUNCHES,
                          "reproject tile": rk.TILE_LAUNCHES, "frame_hist": fh.LAUNCHES,
                          "frame_hist tile": fh.TILE_LAUNCHES}}
        full = mesh_mod.gather_rows((img, hist), mesh, rows)
        if mesh.rank == 0:
            r["gaps"] = frame_gaps(full, (data[fusion][0].to(dev), history_from(data[fusion][1], dev)))
        times = [timed(lambda i=i: shard.render_frame_tiled(scene, tile_camera(i, dev), hist, i, cfg, mesh))[1:]
                 for i in range(3, 10)]
        r["frame_ms_rank"] = statistics.median(t[0] for t in times)
        r["frame_ms_all"] = statistics.median(t[1] for t in times)
        report[fusion] = r

    report["exchange_ms"] = statistics.median(timed(lambda: shard.exchange_halo(hist, mesh, shard.BLOCK_ROWS))[1]
                                              for _ in range(10))
    cam = Camera.create(loc=CAM_LOC, orient=CAM_ORIENT, device=dev)
    cfg_f = RenderConfig(width=W, height=H, pipeline="fused")
    params = {k: v.to(dev) for k, v in data["params"].items()}
    target = data["target"].to(dev)[mesh.rank * rows:(mesh.rank + 1) * rows]
    opt = step_optimizer()
    fk.LAUNCHES = fk.ROW_LAUNCHES = fg.LAUNCHES = fg.ROW_LAUNCHES = 0
    new, _, loss = shard.train_step_tiled(params, opt.init(params), opt, scene, cam, target, 3, cfg_f, mesh)
    torch.cuda.synchronize()
    report["train"] = {"launches": {"frame rows": fk.ROW_LAUNCHES, "backward rows": fg.ROW_LAUNCHES},
                       "loss": loss.item()}
    if mesh.rank == 0:
        report["train"]["update_gap"] = {
            k: (new[k] - data["new_params"][k].to(dev)).abs().max().item()
            / data["new_params"][k].abs().max().item() for k in new}
    steps = [timed(lambda: shard.train_step_tiled(params, opt.init(params), opt, scene, cam, target, 3, cfg_f,
                                                  mesh))[1:] for _ in range(3)]
    report["train"]["step_ms_rank"] = statistics.median(t[0] for t in steps)
    report["train"]["step_ms_all"] = statistics.median(t[1] for t in steps)
    print("RANK " + json.dumps(report), flush=True)
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this smoke run needs a GPU")

    from kylespathtracer_tpu_torch.app import cli, driver
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.ops import _build
    from kylespathtracer_tpu_torch.ops import frame_grad as fg
    from kylespathtracer_tpu_torch.ops import frame_hist as fh
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.ops import geometry_kernel as geo_k
    from kylespathtracer_tpu_torch.ops import loss_kernel as lk
    from kylespathtracer_tpu_torch.ops import path_kernel as pk
    from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
    from kylespathtracer_tpu_torch.ops import shade_kernel as sk
    from kylespathtracer_tpu_torch.render import gbuffer, mis, passes, pipeline, wavefront
    from kylespathtracer_tpu_torch.render.camera import Camera
    from kylespathtracer_tpu_torch.render.passes import Channel
    from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene
    from kylespathtracer_tpu_torch.scene.types import BSDF
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    dev = torch.device("cuda")

    # Phase 0: the card.
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"phase 0: card {card} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")

    # Phase 1: build the kernels from the sources in the checkout, and K7's
    # census build beside them.
    t0 = time.perf_counter()
    census_build = threading.Thread(target=_build.build, kwargs=pk.CENSUS_BUILD)
    census_build.start()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        path = _build.build(verbose=True)
    census_build.join()
    log(report.getvalue())
    _build.load()
    log(f"phase 1: built {path.name} in {time.perf_counter() - t0:.1f} s")
    ptxas = {label: ptxas_lines(report.getvalue(), source) for label, source in (
        ("K1", "frame_kernel.cu"), ("K3", "geometry_kernel.cu"), ("K7", "path_kernel.cu"), ("K8", "frame_hist.cu"),
        ("K4", "shade_kernel.cu"), ("K5", "frame_grad.cu"), ("K6", "loss_kernel.cu"))}
    for label, line in ptxas.items():
        log(f"  ptxas {label}: {line}")

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
    log(f"  K1 registers, stack, spill: {ptxas['K1']}")
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

    def card_vs_cpu(small):
        """3 pan frames of `small` on the card and on the CPU (plain
        versions), held per plane: median |d| <= 1e-5 and <= 1e-3 of the
        components beyond 1e-3*max(1,|ref|) (after 3 frames the flipped
        decisions of phase 2 have spread through reprojection); oid equal
        on >= 99.9% of the pixels."""
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

    card_vs_cpu(RenderConfig(width=256, height=128, pipeline="fused"))

    # Phase 6: times, CUDA events, medians after warm-up.
    log(f"phase 6: times on {card}")
    split_state = {"hist": history, "i": 8}

    def temporal_frame():
        i = split_state["i"]
        _, split_state["hist"] = pipeline.render_frame(scene, camera(i), split_state["hist"], i, cfg)
        split_state["i"] = i + 1

    frame_ms = cuda_ms(temporal_frame, reps=20, warmup=3)
    k1_ms = cuda_ms(lambda: fk.frame_forward(scene, camera(), 3, cfg), reps=20, warmup=2)
    k1_alone_ms = cuda_ms(fk.frame_launch(scene, camera(), 3, cfg)[0], reps=20, warmup=2)
    truth, start, views = inverse.recovery_scenes(10, 5, device=dev)
    f0 = inverse.SEED_BASE
    c_rec = RenderConfig(width=192, height=128, soft_shadows=0.05, pipeline="fused")
    k1_rec_ms = cuda_ms(lambda: fk.frame_forward(start, views[0], f0, c_rec), reps=50, warmup=5)
    k1_rec_alone_ms = cuda_ms(fk.frame_launch(start, views[0], f0, c_rec)[0], reps=50, warmup=5)
    k1_plain_ms = cuda_ms(lambda: fk.frame_forward_plain(scene, camera(), 3, cfg), reps=3, warmup=1)
    k2_ms = cuda_ms(lambda: rk.reproject_set(ref["oid"], dyrel, dxrel, w4, hist, K), reps=50, warmup=3)
    k2_plain_ms = cuda_ms(
        lambda: rk.reproject_window_plain(ref["oid"], dyrel, dxrel, w4, hist, K), reps=20, warmup=2)
    log(f"  temporal frame {W}x{H}: {frame_ms:.4f} ms, {W * H / frame_ms / 1e3:.2f} "
        f"primary Mrays/s [{card}]")
    log(f"  K1 frame kernel {W}x{H}: {k1_ms:.4f} ms with its wrapper, {k1_alone_ms:.4f} ms alone; plain on the "
        f"card {k1_plain_ms:.4f} ms; at the 192x128 recovery view {k1_rec_ms:.4f} ms with its wrapper, "
        f"{k1_rec_alone_ms:.4f} ms alone [{card}]; {ptxas['K1']}")
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
    log(f"  frame.k1 {split['stages']['frame.k1']:.4f} ms of device time against K1 alone {k1_alone_ms:.4f} ms, "
        f"{k1_ms:.4f} ms with its wrapper (phase 6) [{card}]")
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
    rec_needs = fg.needs_for(("spheres", "alb_const"))
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
    target_1080 = dim_target(scene, dev)
    opt = step_optimizer()
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
    # Random cotangents on all 13 planes, every table, held with the
    # ill-conditioned pixels masked, logged with every pixel.
    g_all = {k: randn(ref[k].shape) for k in fg.OUT_KEYS[:6]}
    k5_err = max(k5_err, k5_masked(scene, camera(), cfg, g_all, bad1080,
                                   f"K5 {W}x{H} random cotangents, 13 planes, every table"))
    k6_err = max(k6_err, k6_check(scene, camera(), 3, cfg, None, "mean", f"K6 {W}x{H} mean, all pixels"))
    k5_ms = cuda_ms(lambda: fg.frame_backward(scene, camera(), 3, g_all, cfg), reps=10)
    k6_ms = cuda_ms(lambda: lk.render_loss_and_grad(scene, camera(), 3, cfg, loss="mean"), reps=10)

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
    # The recovery view's shape, as run_recovery hands it to K6: one view of
    # the perturbed start, spheres and alb_const seeded, the first beta.
    target_rec = inverse.render_once(truth, views[0], c_rec, f0)
    oid_rec = fk.frame_forward(start, views[0], f0, c_rec)["oid"]
    g_rec = {k: randn(tuple(oid_rec.shape) + tuple(v.shape[2:])) for k, v in g_all.items()}
    k5_ms_r = cuda_ms(lambda: fg.frame_backward(start, views[0], f0, g_rec, c_rec, rec_needs), reps=20, warmup=3)
    k6_ms_r = cuda_ms(lambda: lk.render_loss_and_grad(start, views[0], f0, c_rec, target_rec, "mse", rec_needs),
                      reps=20, warmup=3)

    # Phase 13: the raycast (K3) at 1920x1080 against its plain version and
    # the G-buffer module, then its time.
    log(f"phase 13: geometry pass (K3), the raycast at {W}x{H} on the card")
    geo_k.LAUNCHES = 0
    geo = geo_k.geometry_pass(scene, camera(), 0, cfg)
    torch.cuda.synchronize()
    raycast_launches = geo_k.LAUNCHES
    if raycast_launches != 1:
        raise AssertionError(f"the raycast did not run through K3: {raycast_launches} launches")
    geo_plain = geo_k.geometry_pass_plain(scene, camera(), 0, cfg)
    k3_stats = geo_k.check_agreement(geo, geo_plain, f"K3 vs plain {W}x{H}")
    log(f"  K3 vs plain: {k3_stats}")
    gbuf = gbuffer.geometry_pass(scene, camera(), cfg)
    gb_stats = geo_k.check_agreement(
        geo, {"depth": gbuf.depth, "curv": gbuf.curv, "normal": gbuf.normal, "oid": gbuf.obj_id},
        f"K3 vs gbuffer.geometry_pass {W}x{H}")
    log(f"  K3 vs gbuffer.geometry_pass: {gb_stats}; hit share {(geo['oid'] > 0).float().mean().item():.4f}")
    k3_err = max((geo[k] - geo_plain[k]).abs().max().item() for k in ("depth", "curv", "normal"))
    k3_ms = cuda_ms(lambda: geo_k.geometry_pass(scene, camera(), 0, cfg), reps=20, warmup=2)
    k3_plain_ms = cuda_ms(lambda: geo_k.geometry_pass_plain(scene, camera(), 0, cfg), reps=3)
    log(f"  K3 {W}x{H}: {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms; raycast_rays_per_s_1080p "
        f"{W * H / k3_ms * 1e3:.1f} [{card}]")

    # Phase 14: K7 against its plain version on the card.
    log("phase 14: path kernel (K7) vs plain, on the card")
    config3 = sphere_scene(  # bench_configs.py:282-289
        [[-1.5, 1.0, 6.0], [1.5, 1.2, 6.5], [0.0, 0.8, 4.5]], [1.0, 1.2, 0.8],
        [[0.9, 0.9, 0.9], [0.7, 0.8, 0.9], [0.9, 0.6, 0.5]],
        kinds=[BSDF.MIRROR, BSDF.DIELECTRIC, BSDF.DIFFUSE], iors=[1.5, 1.5, 1.5], device=dev,
    )
    cam3 = Camera.create(loc=(0.0, 2.0, -2.0), orient=(-0.1, 0.0), device=dev)
    cfg3 = RenderConfig(width=512, height=512, spp=4, max_depth=6)
    k7_err, k7_images = 0.0, {}
    for label, sc, cm, c in (("default_scene 256x128 spp 2", scene, camera(), RenderConfig(
            width=256, height=128, spp=2, max_depth=6)), ("config 3 512x512 spp 4", config3, cam3, cfg3)):
        pk.LAUNCHES = 0
        img = pk.pathtrace(sc, cm, c, 0)
        torch.cuda.synchronize()
        if pk.LAUNCHES != 1:
            raise AssertionError(f"K7 {label}: {pk.LAUNCHES} launches")
        stats = pk.check_agreement(img, pk.pathtrace_plain(sc, cm, c, 0), f"K7 vs plain, {label}, depth 6")
        tight = stats["median"] < 1e-6 and stats["beyond_1e-3"] < 0.002
        log(f"  {label}, depth 6: {stats}; tests/test_path_kernel.py's bar (median < 1e-6, "
            f"< 0.2% beyond 1e-3) {'met' if tight else 'not met'} (logged)")
        k7_err, k7_images[label] = max(k7_err, stats["max"]), img

    # Phase 15: config 3, K7 against the port's XLA-style integrator.
    log("phase 15: config 3, K7 vs wavefront.pathtrace(path_backend='xla'), 512x512 spp 4 depth 6")
    ref3 = wavefront.pathtrace(config3, cam3, dataclasses.replace(cfg3, path_backend="xla"), 0)
    stats = pk.check_agreement(k7_images["config 3 512x512 spp 4"], ref3, "K7 vs xla, config 3", median=1e-4)
    log(f"  bench_configs.py:306's criterion (finite, median < 1e-4, < 2% beyond 3e-2): {stats}")

    # Phase 16: the slice at full width: bench.py's wavefront cell.
    cfg_pt = RenderConfig(width=W, height=H, spp=4, max_depth=6)
    log(f"phase 16: render_pathtraced and the pathtrace CLI at {W}x{H}, 4 spp, depth 6 (cell: "
        "bench.py's wavefront cell, default scene, camera (3,2,-3) orient (0,0.7), frame 0)")
    pk.LAUNCHES = 0
    img = wavefront.render_pathtraced(scene, camera(), cfg_pt, 0)
    torch.cuda.synchronize()
    path_launches = pk.LAUNCHES
    log(f"  render_pathtraced: launches {path_launches}; image {tuple(img.shape)} range "
        f"[{img.min().item():.4f}, {img.max().item():.4f}], mean {img.mean().item():.4f}")
    if path_launches != 1:
        raise AssertionError(f"render_pathtraced did not run through K7 once: {path_launches}")
    if img.shape != (H, W, 3) or not torch.isfinite(img).all() or img.min() < 0 or img.max() > 1:
        raise AssertionError("render_pathtraced: image not finite in [0, 1] or of the wrong shape")
    with tempfile.TemporaryDirectory() as tmp:
        out_png = f"{tmp}/pathtrace.png"
        pk.LAUNCHES = 0
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            cli.main(["pathtrace", "--width", str(W), "--height", str(H), "--out", out_png])
        cli_launches = pk.LAUNCHES
        rec = json.loads(said.getvalue().strip().splitlines()[-1])
        pw, ph, idat = png_pixels(out_png)
    log(f"  cli pathtrace: launches {cli_launches}; said {rec}; PNG {pw}x{ph}, IDAT {idat} bytes")
    if cli_launches != 1 or (rec["depth"], rec["spp"]) != (6, 4):
        raise AssertionError(f"the pathtrace CLI did not run through K7 at depth 6, 4 spp: {cli_launches}, {rec}")
    if (pw, ph, idat) != (W, H, H * (1 + W * 3)):
        raise AssertionError(f"the pathtrace CLI's PNG is {pw}x{ph} with {idat} IDAT bytes")
    k7_ms = cuda_ms(lambda: pk.pathtrace(scene, camera(), cfg_pt, 0), reps=5)
    k7_alone_ms = cuda_ms(pk.path_launch(scene, camera(), cfg_pt, 0)[0], reps=5)
    k7_plain_ms = cuda_ms(lambda: pk.pathtrace_plain(scene, camera(), cfg_pt, 0), reps=1)
    tally = {}
    ref_pt = pk.pathtrace_plain(scene, camera(), cfg_pt, 0, tally=tally)
    img_pt = pk.pathtrace(scene, camera(), cfg_pt, 0)
    stats = pk.check_agreement(img_pt, ref_pt, f"K7 vs plain {W}x{H}")
    log(f"  K7 vs plain, {W}x{H} 4 spp depth 6: {stats}; bitwise {torch.equal(img_pt, ref_pt)}")
    k7_err = max(k7_err, stats["max"])
    segments = W * H * cfg_pt.spp * cfg_pt.max_depth
    log(f"  K7 {W}x{H} 4 spp depth 6: {k7_ms:.4f} ms with its wrapper, {k7_alone_ms:.4f} ms alone, plain "
        f"{k7_plain_ms:.4f} ms; wavefront_segments_per_s_1080p {segments / k7_ms * 1e3:.1f} [{card}]; "
        f"{ptxas['K7']}")
    log(f"  path work on this data: {tally['traced']} segments traced ({tally['traced'] / segments:.4f} "
        f"of W·H·spp·depth = {segments}), {tally['hits']} vertices shaded")
    for line in pk.census_report(pk.census(scene, camera(), cfg_pt, 0), cfg_pt.max_depth):
        log(f"  K7 census, {line}")

    # Phase 17: K8 against its plain version at 1920x1080.
    log(f"phase 17: mono temporal kernel (K8) vs plain, {W}x{H}, on the card")
    cfg_m = RenderConfig(width=W, height=H, pipeline="fused", temporal_fusion="mono")
    rng = np.random.default_rng(2)
    oid0 = fk.frame_forward(scene, camera(0), 0, cfg_m)["oid"]  # the history's oids, through K1

    def seeded_channel():
        return Channel(rgb=torch.from_numpy(rng.uniform(0, 2, (H, W, 3)).astype(np.float32)).to(dev),
                       cnt=torch.from_numpy(rng.integers(0, 17, (H, W)).astype(np.float32)).to(dev),
                       oid=oid0.clone())

    hd, hs = seeded_channel(), seeded_channel()
    fh.LAUNCHES = 0
    k8 = fh.frame_hist(scene, camera(1), camera(0), hd, hs, 1, cfg_m)
    torch.cuda.synchronize()
    if fh.LAUNCHES != 1:
        raise AssertionError(f"frame_hist did not launch K8 once: {fh.LAUNCHES}")
    k8_ref = fh.frame_hist_plain(scene, camera(1), camera(0), hd, hs, 1, cfg_m)
    k8_stats = fh.check_agreement(k8, k8_ref, f"K8 vs plain {W}x{H}")
    log(f"  K8 vs plain (median |d|, share beyond 1e-3): {k8_stats}; mean reprojected diffuse count "
        f"{k8_ref['d_cnt'].mean().item():.4f}")
    log(f"  K8 registers, stack, spill: {ptxas['K8']}")
    if k8_ref["d_cnt"].mean().item() <= 2.0:
        raise AssertionError("K8 check carried almost no history; the check is vacuous")
    k1_same = fk.frame_forward(scene, camera(1), 1, cfg_m)
    for key in ("alb", "ene", "oid"):
        a, b = k8[key], k1_same[key]
        log(f"  K8 {key} vs K1's on the same frame: bitwise {torch.equal(a, b)}, "
            f"max |d| {(a - b).abs().max().item():.3g}")
    _, split_hist = pipeline.render_frame(scene, camera(1), pipeline.History(hd, hs, camera(0)), 1,
                                          dataclasses.replace(cfg_m, temporal_fusion="split"))
    split_planes = {"d_rgb": split_hist.diffuse.rgb, "d_cnt": split_hist.diffuse.cnt,
                    "s_rgb": split_hist.specular.rgb, "s_cnt": split_hist.specular.cnt,
                    "oid": split_hist.diffuse.oid}
    try:
        stats = fh.check_agreement({k: k8[k] for k in split_planes}, split_planes, "K8 vs split")
        log(f"  K8 vs the split frame (K1 + K2 + tail) on the same inputs, within the bar: {stats}")
    except AssertionError as e:
        log(f"  K8 vs the split frame on the same inputs, beyond the bar (logged, not held): {e}")

    # Phase 18: the mono path, through K8 alone.
    log(f"phase 18: mono path, render_animation 8 frames at {W}x{H} with temporal_fusion='mono'")
    fk.LAUNCHES = rk.LAUNCHES = fh.LAUNCHES = 0
    image_m, hist_m = driver.render_animation(scene, cfg_m, num_frames=8, cameras=stacked)
    torch.cuda.synchronize()
    mono_launches = {"frame_hist": fh.LAUNCHES, "frame": fk.LAUNCHES, "reproject": rk.LAUNCHES}
    mean_cnt_m = hist_m.diffuse.cnt.mean().item()
    log(f"  launches {mono_launches}; image range [{image_m.min().item():.4f}, {image_m.max().item():.4f}]; "
        f"mean diffuse count {mean_cnt_m:.4f}")
    if mono_launches != {"frame_hist": 8, "frame": 0, "reproject": 0}:
        raise AssertionError(f"the mono path did not run through K8 alone: {mono_launches}")
    if image_m.shape != (H, W, 3) or not (torch.isfinite(image_m).all() and image_m.min() >= 0
                                         and image_m.max() <= 1):
        raise AssertionError("mono path image not finite in [0, 1] or of the wrong shape")
    if mean_cnt_m <= 4.0:
        raise AssertionError(f"mono history did not accumulate: mean diffuse count {mean_cnt_m}")
    log("  3 pan frames at 256x128, mono, card vs CPU plain path")
    card_vs_cpu(RenderConfig(width=256, height=128, pipeline="fused", temporal_fusion="mono"))
    state_m = {"hist": hist_m, "i": 8}

    def mono_frame():
        i = state_m["i"]
        _, state_m["hist"] = pipeline.render_frame(scene, camera(i), state_m["hist"], i, cfg_m)
        state_m["i"] = i + 1

    # The two frames in turns (split, mono, mono, split), 20 frames each.
    turns = [(name, cuda_ms(fn, reps=20, warmup=3)) for name, fn in (
        ("split", temporal_frame), ("mono", mono_frame), ("mono", mono_frame), ("split", temporal_frame))]
    mono_ms = statistics.median(t for name, t in turns if name == "mono")
    k8_ms = cuda_ms(lambda: fh.frame_hist(scene, camera(1), camera(0), hd, hs, 1, cfg_m), reps=20, warmup=2)
    k8_alone_ms = cuda_ms(fh.frame_hist_launch(scene, camera(1), camera(0), hd, hs, 1, cfg_m)[0], reps=20, warmup=2)
    k8_plain_ms = cuda_ms(lambda: fh.frame_hist_plain(scene, camera(1), camera(0), hd, hs, 1, cfg_m), reps=3)
    log(f"  temporal frame {W}x{H} in turns, ms: " + ", ".join(f"{name} {t:.4f}" for name, t in turns)
        + f" (split {frame_ms:.4f} ms in phase 6) [{card}]")
    log(f"  K8 {W}x{H}: {k8_ms:.4f} ms with its wrapper, {k8_alone_ms:.4f} ms alone; plain on the card "
        f"{k8_plain_ms:.4f} ms [{card}]; {ptxas['K8']}")
    split_m = stage_split(mono_frame, pipeline.STAGES, frames=10)
    log(f"  mono frame, torch.profiler: device {split_m['device_ms']:.4f} ms in {split_m['launches']:.1f} "
        "launches per frame; by kernel: " + ", ".join(f"{k} {v:.4f}" for k, v in split_m["top"]))

    # Phase 19: K4 against its plain version at 1920x1080, on the G-buffer.
    log(f"phase 19: shade kernel (K4) vs plain, {W}x{H}, on gbuffer.geometry_pass of the default scene")
    cfg_p = RenderConfig(width=W, height=H, pipeline="pass", shade_backend="pallas")
    gbuf_p = gbuffer.geometry_pass(scene, camera(), cfg_p)
    hl_p, seed_p = passes._shade_common(scene, cfg_p, gbuf_p, camera(), 3)
    sk.LAUNCHES = 0
    k4 = sk.dual_mis(scene, gbuf_p, camera(), seed_p, cfg_p)
    torch.cuda.synchronize()
    if sk.LAUNCHES != 1:
        raise AssertionError(f"dual_mis did not launch K4 once: {sk.LAUNCHES}")
    k4_ref = sk.dual_mis_plain(scene, gbuf_p, camera(), seed_p, cfg_p)
    k4_stats = fh.check_agreement({"est_d": k4[0], "est_s": k4[1]}, {"est_d": k4_ref[0], "est_s": k4_ref[1]},
                                  f"K4 vs plain {W}x{H}")
    log(f"  K4 vs plain (median |d|, share beyond 1e-3): {k4_stats}")
    shaded = passes._shaded(scene, gbuf_p.obj_id)[..., None]
    est_x = mis.dual_mis(scene, passes.get_trace(cfg_p), gbuf_p.ray_dir, hl_p, gbuf_p.normal, gbuf_p.obj_id,
                         seed_p, cfg_p)
    try:
        stats = fh.check_agreement({"est_d": k4[0], "est_s": k4[1]},
                                   {"est_d": torch.where(shaded, est_x[0], 0.0),
                                    "est_s": torch.where(shaded, est_x[1], 0.0)}, "K4 vs mis.dual_mis")
        log(f"  K4 vs mis.dual_mis (shade_backend='xla'), within the bar: {stats}")
    except AssertionError as e:
        log(f"  K4 vs mis.dual_mis, beyond the bar (logged, not held): {e}")
    k4_ms = cuda_ms(lambda: sk.dual_mis(scene, gbuf_p, camera(), seed_p, cfg_p), reps=20, warmup=2)
    k4_alone_ms = cuda_ms(sk.dual_mis_launch(scene, gbuf_p, camera(), seed_p, cfg_p)[0], reps=20, warmup=2)
    k4_plain_ms = cuda_ms(lambda: sk.dual_mis_plain(scene, gbuf_p, camera(), seed_p, cfg_p), reps=3)
    log(f"  K4 {W}x{H}: {k4_ms:.4f} ms with its wrapper, {k4_alone_ms:.4f} ms alone; plain on the card "
        f"{k4_plain_ms:.4f} ms [{card}]; {ptxas['K4']}")

    # Phase 20: the pass pipeline and the render CLI at full width.
    log(f"phase 20: pass path, render_animation 4 frames at {W}x{H} (pipeline='pass', shade_backend='pallas')")
    sk.LAUNCHES = fk.LAUNCHES = rk.LAUNCHES = 0
    image_p, hist_p = driver.render_animation(scene, cfg_p, num_frames=4, cameras=stacked)
    torch.cuda.synchronize()
    pass_launches = {"dual_mis": sk.LAUNCHES, "frame": fk.LAUNCHES, "reproject": rk.LAUNCHES}
    log(f"  launches {pass_launches}; image range [{image_p.min().item():.4f}, {image_p.max().item():.4f}]; "
        f"mean diffuse count {hist_p.diffuse.cnt.mean().item():.4f}")
    if pass_launches != {"dual_mis": 4, "frame": 0, "reproject": 0}:
        raise AssertionError(f"the pass path did not run through K4: {pass_launches}")
    if image_p.shape != (H, W, 3) or not (torch.isfinite(image_p).all() and image_p.min() >= 0
                                         and image_p.max() <= 1):
        raise AssertionError("pass path image not finite in [0, 1] or of the wrong shape")
    pass_state = {"hist": hist_p, "i": 4}

    def pass_frame():
        i = pass_state["i"]
        _, pass_state["hist"] = pipeline.render_frame(scene, camera(i), pass_state["hist"], i, cfg_p)
        pass_state["i"] = i + 1

    pass_ms = cuda_ms(pass_frame, reps=5, warmup=1)
    log(f"  pass-pipeline frame (pallas) {W}x{H}: {pass_ms:.4f} ms [{card}]")
    with tempfile.TemporaryDirectory() as tmp:
        fk.LAUNCHES = rk.LAUNCHES = 0
        said = io.StringIO()
        with contextlib.redirect_stderr(said):
            cli.main(["render", "--width", str(W), "--height", str(H), "--frames", "2", "--save-every", "1",
                      "--out", tmp])
        cli_launches = {"frame": fk.LAUNCHES, "reproject": rk.LAUNCHES}
        records = [json.loads(ln) for ln in said.getvalue().splitlines() if ln.startswith("{")]
        pngs = {n: png_pixels(f"{tmp}/{n}") for n in ("frame_00000.png", "frame_00001.png", "final.png")}
        log(f"  cli render {W}x{H} 2 frames: launches {cli_launches}; metrics {records}; PNGs {pngs}")
        if cli_launches != {"frame": 2, "reproject": 4} or len(records) != 2:
            raise AssertionError(f"the render CLI did not run the fused frame twice: {cli_launches}, {records}")
        if any(v != (W, H, H * (1 + W * 3)) for v in pngs.values()):
            raise AssertionError(f"the render CLI's PNGs are malformed: {pngs}")
        with contextlib.redirect_stderr(io.StringIO()):
            cli.main(["render", "--width", "256", "--height", "128", "--frames", "1", "--pipeline", "pass",
                      "--out", f"{tmp}/pass"])
        pw = png_pixels(f"{tmp}/pass/final.png")
        log(f"  cli render --pipeline pass 256x128: PNG {pw}")
        if pw != (256, 128, 128 * (1 + 256 * 3)):
            raise AssertionError(f"the pass CLI's PNG is malformed: {pw}")

    # Phase 21: the sharded renderer's tiles, one at a time in this process,
    # each on the history window tile_window cuts (what a rank's halo
    # exchange assembles): two frames of the split and the mono frame from a
    # seeded history, against the unsharded frame.
    from kylespathtracer_tpu_torch.parallel import shard
    from kylespathtracer_tpu_torch.render.camera import ray_dirs_window

    rows_t, halo_t = H // TILES, shard.BLOCK_ROWS
    log(f"phase 21: sharded renderer, {TILES} tiles of {rows_t} rows at {W}x{H} in this process "
        f"(_render_row_block on {halo_t}-row halo windows, the fallback warning an error), 2 frames each of "
        "split and mono from a seeded history")
    hist0 = seeded_history(scene, dev)
    tiled, tile_launches = tiled_frames(scene, hist0, dev)
    for fusion in ("split", "mono"):
        cfg_x = RenderConfig(width=W, height=H, pipeline="fused", temporal_fusion=fusion)
        img_t = tiled[fusion][0]
        hist_r = hist0
        for i in (1, 2):
            img_r, hist_r = pipeline.render_frame(scene, tile_camera(i, dev), hist_r, i, cfg_x)
        gaps = frame_gaps(tiled[fusion], (img_r, hist_r))
        log(f"  {fusion}: launches {tile_launches[fusion]}; stitched vs unsharded after 2 frames, max |d|: {gaps}; "
            f"mean diffuse count {hist_r.diffuse.cnt.mean().item():.4f}")
        hold_frame_gaps(gaps, f"{TILES} tiles vs the unsharded {fusion} frame")
        if img_t.shape != (H, W, 3) or not torch.isfinite(img_t).all():
            raise AssertionError(f"tiled {fusion} image not finite or of the wrong shape")
    want = {"split": {"frame": 6, "frame rows": 6, "reproject": 12, "reproject tile": 12, "frame_hist": 0,
                      "frame_hist tile": 0},
            "mono": {"frame": 0, "frame rows": 0, "reproject": 0, "reproject tile": 0, "frame_hist": 6,
                     "frame_hist tile": 6}}
    if tile_launches != want:
        raise AssertionError(f"the tiled frames did not run through the tile modes: {tile_launches}")

    # Each tile mode against its plain version on the middle tile (both
    # halos real), frame 1's inputs; then their times.
    r0, cam1 = rows_t, tile_camera(1, dev)
    win = shard.tile_window(hist0, r0, rows_t, halo_t)
    k1r = fk.frame_forward(scene, cam1, 1, cfg, r0, rows_t)
    torch.cuda.synchronize()
    k1r_ref = fk.frame_forward_plain(scene, cam1, 1, cfg, r0, rows_t)
    k1r_stats = frame_agreement(k1r, k1r_ref, f"K1 row mode, rows [{r0}, {r0 + rows_t})")
    hl_t = cam1.loc + ray_dirs_window(cam1, W, H, r0, rows_t, cfg.fov) * k1r_ref["depth"][..., None]
    q_t = rk._queries(hist0.camera, hl_t, k1r_ref["oid"], cfg.fov, H, W, row0=r0)
    k2t_args = (k1r_ref["oid"], *q_t, win.diffuse, K, H, r0, halo_t)
    rgb_kt, cnt_kt = rk.reproject_set(*k2t_args)
    torch.cuda.synchronize()
    rgb_pt, cnt_pt = rk.reproject_window_plain(*k2t_args)
    k2t_err = max((rgb_kt - rgb_pt).abs().max().item(), (cnt_kt - cnt_pt).abs().max().item())
    log(f"  K2 tile mode, rows [{r0}, {r0 + rows_t}) of {H}, {halo_t}-row halo, K={K}: max |d| rgb "
        f"{(rgb_kt - rgb_pt).abs().max().item():.3g}, cnt {(cnt_kt - cnt_pt).abs().max().item():.3g}; mean "
        f"reprojected count {cnt_kt.mean().item():.4f}")
    torch.testing.assert_close(rgb_kt, rgb_pt, atol=1e-5, rtol=0)
    torch.testing.assert_close(cnt_kt, cnt_pt, atol=1e-4, rtol=0)
    tile_kw = dict(block_rows=halo_t, row_base=r0, rows=rows_t, hist_halo=halo_t)
    k8t_args = (scene, cam1, hist0.camera, win.diffuse, win.specular, 1, cfg_m)
    k8t = fh.frame_hist(*k8t_args, **tile_kw)
    torch.cuda.synchronize()
    k8t_ref = fh.frame_hist_plain(*k8t_args, **tile_kw)
    k8t_stats = fh.check_agreement(k8t, k8t_ref, "K8 tile mode vs plain")
    log(f"  K8 tile mode vs plain (median |d|, share beyond 1e-3): {k8t_stats}; mean reprojected diffuse count "
        f"{k8t_ref['d_cnt'].mean().item():.4f}")
    if k8t_ref["d_cnt"].mean().item() <= 2.0 or cnt_kt.mean().item() <= 1.0:
        raise AssertionError("the tile checks carried almost no history; they are vacuous")
    k1r_ms = cuda_ms(lambda: fk.frame_forward(scene, cam1, 1, cfg, r0, rows_t), reps=20, warmup=2)
    k1r_alone_ms = cuda_ms(fk.frame_launch(scene, cam1, 1, cfg, r0, rows_t)[0], reps=20, warmup=2)
    k1r_plain_ms = cuda_ms(lambda: fk.frame_forward_plain(scene, cam1, 1, cfg, r0, rows_t), reps=3)
    k2t_ms = cuda_ms(lambda: rk.reproject_set(*k2t_args), reps=50, warmup=3)
    k2t_plain_ms = cuda_ms(lambda: rk.reproject_window_plain(*k2t_args), reps=20, warmup=2)
    k8t_ms = cuda_ms(lambda: fh.frame_hist(*k8t_args, **tile_kw), reps=20, warmup=2)
    k8t_alone_ms = cuda_ms(fh.frame_hist_launch(*k8t_args, **tile_kw)[0], reps=20, warmup=2)
    k8t_plain_ms = cuda_ms(lambda: fh.frame_hist_plain(*k8t_args, **tile_kw), reps=3)
    log(f"  one tile of {rows_t}x{W}: K1 row mode {k1r_ms:.4f} ms with its wrapper, {k1r_alone_ms:.4f} alone, "
        f"plain {k1r_plain_ms:.4f}; K2 tile mode (one set) {k2t_ms:.4f}, plain {k2t_plain_ms:.4f}; K8 tile mode "
        f"{k8t_ms:.4f} with its wrapper, {k8t_alone_ms:.4f} alone, plain {k8t_plain_ms:.4f} [{card}]")
    tile_state = {f: (3, tiled[f][1]) for f in tiled}

    def tiles_frame(fusion):
        cfg_x = RenderConfig(width=W, height=H, pipeline="fused", temporal_fusion=fusion)

        def run():
            i, h = tile_state[fusion]
            tile_state[fusion] = (i + 1, render_tiles(scene, cfg_x, h, i, dev)[1])
        return run

    turns_t = [(name, cuda_ms(fn, reps=10, warmup=2)) for name, fn in (
        ("unsharded split", temporal_frame), ("3 tiles split", tiles_frame("split")),
        ("3 tiles mono", tiles_frame("mono")), ("unsharded mono", mono_frame))]
    log(f"  {W}x{H} frame in turns, ms: " + ", ".join(f"{n} {t:.4f}" for n, t in turns_t)
        + f" (the tiles one after another in this process) [{card}]")
    for fusion in ("split", "mono"):
        sp = stage_split(tiles_frame(fusion), pipeline.STAGES, frames=5)
        log(f"  3 tiles {fusion}, torch.profiler: device {sp['device_ms']:.4f} ms in {sp['launches']:.1f} launches "
            "per frame; by stage: " + ", ".join(f"{k} {v:.4f}" for k, v in sp["stages"].items())
            + "; by kernel: " + ", ".join(f"{k} {v:.4f}" for k, v in sp["top"]))

    # Phase 22: the tiled training step in this process, the tiles' losses
    # and gradients summed as train_step_tiled's all-reduce sums them.
    log(f"phase 22: tiled training step (K1 + K5 row mode), {TILES} tiles at {W}x{H} and 2 at the 192x128 "
        "recovery view, against the unsharded train_step")

    def hold_step(new, loss, ref, loss_r, what):
        gaps = {k: (new[k] - ref[k]).abs().max().item() / ref[k].abs().max().item() for k in new}
        rel = abs(loss - loss_r) / abs(loss_r)
        log(f"  {what}: loss {loss:.7g} vs unsharded {loss_r:.7g} (rel {rel:.3g}); update |d|/max|ref| {gaps}")
        if not (rel <= 1e-5 and all(v <= 1e-4 for v in gaps.values())):
            raise AssertionError(f"{what}: the tiled step parts from the unsharded one")
        return gaps

    opt_t = step_optimizer()
    params_t = inverse.extract_params(scene, ("spheres", "light_color"))
    fk.LAUNCHES = fk.ROW_LAUNCHES = fg.LAUNCHES = fg.ROW_LAUNCHES = lk.LAUNCHES = 0
    new_t, loss_t = tiled_step(params_t, opt_t, scene, camera(), target_1080, 3, cfg_f, TILES)
    torch.cuda.synchronize()
    step_launches = {"frame": fk.LAUNCHES, "frame rows": fk.ROW_LAUNCHES, "backward": fg.LAUNCHES,
                     "backward rows": fg.ROW_LAUNCHES, "loss": lk.LAUNCHES}
    log(f"  launches {step_launches}")
    if step_launches != {"frame": TILES, "frame rows": TILES, "backward": TILES, "backward rows": TILES,
                         "loss": 0}:
        raise AssertionError(f"the tiled step did not run through K1's and K5's row modes: {step_launches}")
    ref_t, _, loss_rt = inverse.train_step(params_t, opt_t.init(params_t), opt_t, scene, camera(), target_1080, 3,
                                           cfg_f)
    hold_step(new_t, loss_t, {k: v.clone() for k, v in ref_t.items()}, loss_rt.item(), f"{TILES} tiles at {W}x{H}")
    params_r = inverse.extract_params(start)
    new_r, loss_r2 = tiled_step(params_r, opt_t, start, views[0], target_rec, f0, c_rec, 2)
    ref_r, _, loss_rr = inverse.train_step(params_r, opt_t.init(params_r), opt_t, start, views[0], target_rec, f0,
                                           c_rec)
    hold_step(new_r, loss_r2, ref_r, loss_rr.item(), "2 tiles at the 192x128 recovery view")
    # K5's row mode against its plain version on the middle tile: random
    # cotangents on 13 planes, every table, the ill-conditioned pixels
    # masked as in phase 12 (logged with every pixel).
    k1m = fk.frame_forward(scene, camera(), 3, cfg, r0, rows_t)
    bad_t = fk.ill_conditioned(k1m, fk.frame_forward_plain(scene, camera(), 3, cfg, r0, rows_t))
    g_t = {k: randn(k1m[k].shape) for k in fg.OUT_KEYS[:6]}

    def k5_rows(g):
        got = fg.frame_backward(scene, camera(), 3, g, cfg, None, r0, rows_t)
        torch.cuda.synchronize()
        return got, fg.frame_backward_plain(scene, camera(), 3, g, cfg, None, r0, rows_t)

    ti, entry_i, rel_i = worst_entry(*k5_rows(g_t))
    log(f"  K5 row mode, rows [{r0}, {r0 + rows_t}), all pixels: worst {fg.DIFF_NAMES[ti]}[{entry_i}], "
        f"|Δ|/max|ref| {rel_i:.3g} (not held)")
    k5r_err = table_check(*k5_rows(keep_planes(g_t, bad_t)),
                          f"K5 row mode, rows [{r0}, {r0 + rows_t}), random cotangents, every table, "
                          f"{int(bad_t.sum())} ill-conditioned pixels masked")
    k5r_ms = cuda_ms(lambda: fg.frame_backward(scene, camera(), 3, g_t, cfg, None, r0, rows_t), reps=10)
    k5r_plain_ms = cuda_ms(lambda: fg.frame_backward_plain(scene, camera(), 3, g_t, cfg, None, r0, rows_t), reps=1)
    log(f"  one tile of {rows_t}x{W}: K5 row mode, 13 planes, every table {k5r_ms:.4f} ms, plain "
        f"{k5r_plain_ms:.4f} [{card}]")

    # Phase 23: the same frames and step on 3 ranks of one gloo group
    # sharing this card (NCCL refuses two ranks on one card).
    torch.cuda.empty_cache()
    reports = rank_phase("gloo", hist0, tiled, params_t, new_t, loss_t, target_1080, card)
    # The tile modes' launches on the slice's path: render_frame_tiled's
    # two split and two mono frames and train_step_tiled's step, counted
    # on each rank (set to 0 just before, read just after) and summed over
    # the ranks.
    rank_launches = {key: sum(rep[part]["launches"][key] for rep in reports for part in parts)
                     for key, parts in (("frame rows", ("split", "train")), ("reproject tile", ("split",)),
                                        ("frame_hist tile", ("mono",)), ("backward rows", ("train",)))}
    log(f"  tile-mode launches summed over the {TILES} ranks: {rank_launches}")

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
    ops_rec = frame_ops(start, c_rec, oid_rec)
    rec_bytes = sum(t.numel() * t.element_size() for t in fk.pack_tables(start, views[0]))
    k5_bound_r = bound(3 * ops_rec, rec_bytes + sum(v.numel() * 4 for v in g_rec.values()))
    k6_bound_r = bound(3 * (ops_rec + 120 * oid_rec.numel()), rec_bytes + target_rec.numel() * 4)
    for label, ms, bnd, ms_r, bnd_r in (("K5", k5_ms, k5_bound, k5_ms_r, k5_bound_r),
                                        ("K6", k6_ms, k6_bound, k6_ms_r, k6_bound_r)):
        lo, hi = FORWARD_MODE_MS[label]
        log(f"  {label} reverse-mode adjoint: {W}x{H} all tables {ms:.4f} ms, {ms / bnd[0]:.1f}x its bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}), {lo / ms:.1f}-{hi / ms:.1f}x faster than the forward-mode kernel's "
            f"{lo}-{hi} ms; 192x128 recovery view {ms_r:.4f} ms, {ms_r / bnd_r[0]:.1f}x its bound "
            f"{bnd_r[0]:.5f} ms ({bnd_r[1]}) [{card}]")
    ops3 = geometry_ops(scene, W * H)
    k3_bound = bound(ops3, tab_bytes + W * H * (5 * 4 + 4))
    ops7 = path_ops(scene, W * H * cfg_pt.spp, tally)
    k7_bound = bound(ops7, tab_bytes + sum(t.numel() * t.element_size() for t in pk._tables(scene))
                     + W * H * 3 * 4)
    ops8 = frame_ops(scene, cfg_m, k8_ref["oid"]) + W * H * HIST_OPS
    hist_bytes = sum(t.numel() * t.element_size() for ch in (hd, hs) for t in (ch.rgb, ch.cnt, ch.oid))
    out_bytes = sum(t.numel() * t.element_size() for t in k8.values())
    k8_bound = bound(ops8, tab_bytes + 5 * 4 + hist_bytes + out_bytes)
    ops4 = shade_ops(scene, cfg_p, gbuf_p.obj_id, 1) + W * H * 6
    k4_io = (gbuf_p.normal, gbuf_p.obj_id, gbuf_p.depth, gbuf_p.ray_dir, seed_p, *k4)
    k4_bound = bound(ops4, tab_bytes + sum(t.numel() * t.element_size() for t in k4_io))
    # The tile launches (phases 21-22): their share of the frame's work, on
    # the middle tile's data.
    k1r_bound = bound(frame_ops(scene, cfg, k1r_ref["oid"]), tab_bytes + rows_t * W * (13 * 4 + 4))
    k2t_io = (k1r_ref["oid"], *q_t[:2], *q_t[2], win.diffuse.rgb, win.diffuse.cnt, win.diffuse.oid, rgb_kt, cnt_kt)
    k2t_bound = bound(rows_t * W * 4 * 10, sum(t.numel() * t.element_size() for t in k2t_io))
    ops8t = frame_ops(scene, cfg_m, k8t_ref["oid"]) + rows_t * W * HIST_OPS
    win_bytes = sum(t.numel() * t.element_size() for ch in (win.diffuse, win.specular)
                    for t in (ch.rgb, ch.cnt, ch.oid))
    k8t_bound = bound(ops8t, tab_bytes + 5 * 4 + win_bytes + sum(t.numel() * t.element_size() for t in k8t.values()))
    k5r_bound = bound(3 * frame_ops(scene, cfg, k1m["oid"]), tab_bytes + sum(v.numel() * 4 for v in g_t.values()))
    log(f"  bounds of one {rows_t}-row tile: K1 row mode {k1r_bound[0]:.4f} ms ({k1r_bound[1]}), K2 tile mode "
        f"{k2t_bound[0]:.4f} ms ({k2t_bound[1]}), K8 tile mode {k8t_bound[0]:.4f} ms ({k8t_bound[1]}), K5 row mode "
        f"{k5r_bound[0]:.4f} ms ({k5r_bound[1]})")
    # Without FMA (-fmad=false: K3-K8) an f32 lane retires one operation a
    # clock: 132 SMs x 128 lanes x the SM clock.
    no_fma = 132 * 128 * sm_clock_mhz() * 1e6
    log(f"  operations over the rate without FMA ({no_fma / 1e12:.2f} TFLOP/s): K1 {ops1 / no_fma * 1e3:.4f}, "
        f"K8 {ops8 / no_fma * 1e3:.4f}, K4 {ops4 / no_fma * 1e3:.4f}, K3 {ops3 / no_fma * 1e3:.4f}, "
        f"K7 {ops7 / no_fma * 1e3:.4f}, K5 {3 * ops1 / no_fma * 1e3:.4f}, "
        f"K6 {3 * (ops1 + 120 * W * H) / no_fma * 1e3:.4f} ms")
    log(f"  bounds at {W}x{H}: K8 {k8_bound[0]:.4f} ms ({k8_bound[1]}, {ops8 / 1e9:.3f} GFLOP, "
        f"{(hist_bytes + out_bytes) / (W * H):.1f} B/pixel), K4 {k4_bound[0]:.4f} ms ({k4_bound[1]}, "
        f"{ops4 / 1e9:.3f} GFLOP)")
    log(f"  bounds at {W}x{H}: K1 {k1_bound[0]:.4f} ms ({k1_bound[1]}, {ops1 / 1e9:.3f} GFLOP), "
        f"K2 {k2_bound[0]:.4f} ms ({k2_bound[1]}), K5 {k5_bound[0]:.4f} ms ({k5_bound[1]}), "
        f"K6 {k6_bound[0]:.4f} ms ({k6_bound[1]}), K3 {k3_bound[0]:.4f} ms ({k3_bound[1]}, "
        f"{ops3 / 1e9:.3f} GFLOP, {(W * H * 24) / 1e6:.1f} MB out), K7 {k7_bound[0]:.4f} ms "
        f"({k7_bound[1]}, {ops7 / 1e9:.3f} GFLOP on this data's segments)")

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
        entry("geometry_pass", "geometry_kernel.cu", "frame_kernel.py:494", raycast_launches,
              k3_err, k3_ms, k3_plain_ms, k3_bound),
        entry("pathtrace", "path_kernel.cu", "path_kernel.py:469", path_launches,
              k7_err, k7_ms, k7_plain_ms, k7_bound),
        entry("frame_hist", "frame_hist.cu", "frame_hist.py:344", mono_launches["frame_hist"],
              k8_stats["max_abs"], k8_ms, k8_plain_ms, k8_bound),
        entry("dual_mis", "shade_kernel.cu", "shade_kernel.py:836", pass_launches["dual_mis"],
              k4_stats["max_abs"], k4_ms, k4_plain_ms, k4_bound),
        entry("frame_forward (rows)", "frame_kernel.cu", "frame_kernel.py:299", rank_launches["frame rows"],
              k1r_stats["max_abs"], k1r_ms, k1r_plain_ms, k1r_bound),
        entry("reproject_window (tile)", "reproject_kernel.cu", "reproject_kernel.py:211",
              rank_launches["reproject tile"], k2t_err, k2t_ms, k2t_plain_ms, k2t_bound),
        entry("frame_hist (tile)", "frame_hist.cu", "frame_hist.py:241", rank_launches["frame_hist tile"],
              k8t_stats["max_abs"], k8t_ms, k8t_plain_ms, k8t_bound),
        entry("frame_backward (rows)", "frame_grad.cu", "frame_grad.py:117", rank_launches["backward rows"],
              k5r_err, k5r_ms, k5r_plain_ms, k5r_bound),
    ]
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: {idle}")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] in (["--rank-worker"], ["--nccl"]) and not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this smoke run needs a GPU")
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--nccl"]:
        sys.exit(nccl_main())
    sys.exit(main())
