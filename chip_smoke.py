"""GPU smoke run of the PyTorch port (kylespathtracer_tpu_torch): it holds
the kernels and the paths through them to their references; the benchmark
times them.

Builds the CUDA kernels from `kylespathtracer_tpu_torch/csrc`, holds each
kernel against its plain PyTorch version on the card, and drives the port's
paths through the kernels, each with the launch counts set to 0 just before
it and read just after:

- the fused temporal frame (`app.driver.render_animation` at 1920×1080,
  K1 + K2 with its tail; phases 2-5: K1 against its plain version, K2 alone
  and with its tail bitwise its plain route at 1080p, card vs CPU);
- the generic training step (`diff.inverse.train_step` at 1920×1080, K1 +
  the backward kernel K5; phase 10);
- inverse rendering (`diff.inverse.run_recovery`, the JAX package's
  RECOVERY recipe, K1 + the fused loss-and-gradient kernel K6; phase 11),
  held to its error bounds. K5 and K6 are one reverse-mode adjoint pass
  over the pixels each (csrc/frame_adjoint.cuh);
- the primary-visibility raycast (`ops.geometry_kernel.geometry_pass` at
  1920×1080, K3; phase 13: two raycasts, from bench.py's view and from one
  aimed at the rounded box, each held bitwise to its plain version, the
  first also against the G-buffer module);
- the multi-bounce path tracer (`render.wavefront.render_pathtraced` and
  the `pathtrace` CLI at 1920×1080, 4 spp, depth 6, K7 tonemapping in its
  epilogue, its image bitwise the plain tonemap of K7's HDR; phase 16), after
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
  (K1 row mode + K2 tile mode with its tail) and the mono frame (K8 tile
  mode) from a populated history, stitched and held against the unsharded frame, each
  tile launch held against its plain version (phase 21); the tiled training
  step (K1 + K5 row mode) at 1920×1080 in 3 tiles and at the 192×128
  recovery view in 2, held against the unsharded `train_step` (phase 22);
  and 3 gloo ranks sharing this card through `multihost.initialize_from_env`
  (`render_frame_tiled` with its halo exchange, `train_step_tiled` with its
  all-reduce), held against the in-process tiles (phase 23). The `kernels`
  line's launches of the four tile and row modes are phase 23's, counted
  on each rank and summed over the ranks;
- the op-mix probe (`bench_ceiling.sweep`, the entry point of
  `python -m kylespathtracer_tpu_torch.bench_ceiling`, K9): every variant of
  its sweep held bitwise to its plain version at 64×1920, infinities and
  NaN in place (both sides round each IEEE operation on its own), then the
  sweep at 1080×1920 with each variant's output held bitwise to its plain
  version there too (phase 24);
- the sphere trace (scene/sdf.py, plain torch as the JAX march is XLA
  code): `sdf.march` and `sdf.norcurv` on the card against the CPU at
  256×128, and the march G-buffer (`gbuffer.geometry_pass` with
  intersect_mode="march") at 1920×1080 from two views against K3's, oid
  equal on > 99.5% of the pixels and the 99th percentile of |Δt| on equal
  hits that do not graze under 1e-2 (phase 25); the sphere-traced pass
  frame (`render_animation`, 2 frames at 1920×1080) and `render --march`
  (phase 26); the pass pipeline's gradient at 1920×1080
  (`inverse.value_and_grad` through the intersectors' implicit-function
  backward) against K1 + K5 (KPT_FUSED_LOSS=0) and K6 on the same loss,
  2e-3·max per table; the march's gradient against finite differences;
  three `fit` steps with a default (pass) config and the pass route's tiled
  step in 2 tiles (phase 27). These paths launch no kernel; phases 25 and
  27 count the witnesses' launches;
- checkpoint and resume (utils/checkpoint.py): `render_animation` at
  1920×1080 (split frame, K1 + K2) checkpointed at frame 3 and resumed,
  bitwise the uninterrupted 8 frames, and `render --checkpoint-every 3
  --resume` through the CLI (phase 28); `run_recovery` (RECOVERY recipe,
  K6) killed after 2 β phases and resumed by `cli invert --ckpt-dir D
  --resume` in a subprocess, held to the RECOVERY bounds and to the
  sidecar's trace, the state's round trip on the card bitwise, a torn pair
  falling back to phase 1 (phase 29); the tiled step (`train_step_tiled`,
  K1 + K5) checkpointed after step 1 and resumed in fresh objects (phase
  22);
- the fly-cam (app/fly.py): 18 frames of key bytes through `parse_keys`
  and `fly_step` at 1920×1080 (K1 + K2), bitwise the same input frames
  through `playback_cameras` and `render_animation`, the controller on the
  card against the CPU's, and `cli fly` without a terminal (phase 30);
  `cli info`, the native library (its march against `sdf.march`, its PNGs
  against zlib's), `metrics.profiler_trace` of a frame holding K1, `Timer`
  and `time_fn` against CUDA events (phase 31);
- the benches as a user runs them (phase 32): `python -m
  kylespathtracer_tpu_torch.bench`, `.bench_configs` and `.bench_profile`,
  each a subprocess with `--out` in a new temporary path: every bench.py
  metric name (less scaling_*) on its own line and the headline last, the
  kernels one step of each measurement launches (K1 + K2, K6, K1 + K5,
  K3, K7), every configuration of BASELINE.json within its JAX bar (config 5
  with the sharded witness on 8 gloo ranks sharing the card), the profile's
  device time per frame within 1.05 × the bench's slope, and the card named
  in every record.

Gradient tables are held to max|Δ| <= 1e-4·max|ref| of their plain
versions: K5 and K6 at 256×128 with every pixel (phases 8-9), K6 (mean) at
1920×1080 (phase 12); K5 at 96×64 (phase 8), K6 on one view of the recovery
scene (phase 9) and K5 on train_step's own cotangent at 1920×1080 (phase 12)
without the ill-conditioned pixels (rays that graze a surface, sampling
decisions on a rounding boundary: frame_kernel.ill_conditioned), with the
comparison over every pixel logged beside; so is K5 on random cotangents at
1920×1080 with every table (phase 12; tools/gradient_witness.py shows the
pixels behind the unmasked distance). Phase 1 logs the registers, stack and
spill of each kernel's build. Any failed check raises, so the script exits
non-zero; it needs one CUDA device and fails without one. Times come from
the benchmark (kpt_bench/), and a kernel's time alone from
`python -m kylespathtracer_tpu_torch.ops.adjoint_variants`.

    python3 chip_smoke.py

(`python3 chip_smoke.py --rank-worker DIR` is one rank of phase 23, which
starts it.) The second-to-last line of stdout is a JSON object naming every
kernel of the path with its source, launches and largest error against its
plain version; the last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
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


# The camera's move between the previous history and K2's tail in phases 3
# and 21: |v| ~ 0.017, so the velocity clamp's limit is T - 4, under many of
# the histories' counts (0-16).
TAIL_MOVE = (0.01, -0.01, 0.01)


def tail_plain(scene, cam, prev_cam, out, prev_d, prev_s, config, image_height=None, row_base=0, hist_halo=0):
    """K2 with its tail as the plain route, on the tensors' device: the rays
    and anchors (`reprojection_anchors`), `reproject_frame_plain`,
    `accumulate` for each set against the camera's speed, `composite_from` →
    (image, diffuse, specular), as `reproject_tail` returns them."""
    from kylespathtracer_tpu_torch.core import gmath
    from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
    from kylespathtracer_tpu_torch.render import passes
    from kylespathtracer_tpu_torch.render.composite import composite_from

    ho = out["oid"]
    H = ho.shape[0] if image_height is None else image_height
    K = min(config.reproject_window, rk.MAX_WINDOW)
    hl, sl = passes.reprojection_anchors(scene, cam, out, config.fov, H, row_base)
    (rgb_d, cnt_d), (rgb_s, cnt_s) = rk.reproject_frame_plain(prev_cam, hl, sl, ho, prev_d, prev_s, config.fov,
                                                              K, H, row_base, hist_halo)
    vv = gmath.length(cam.loc - prev_cam.loc)
    d = passes.accumulate(rgb_d, cnt_d, out["add_d"], vv, ho, config)
    s = passes.accumulate(rgb_s, cnt_s, out["add_s"], vv, ho, config)
    return composite_from(out["alb"], out["ene"], d, s, config), d, s


def hold_tail(got, want, label: str) -> float:
    """K2 with its tail against `tail_plain` on the same inputs: the new
    history (rgb and count of both sets) and the image bitwise, the new
    channels' oid K1's own tensor → the max |d| (0), logged; raises if not."""
    pairs = {"image": (got[0], want[0])}
    for name, g, w in (("diffuse", got[1], want[1]), ("specular", got[2], want[2])):
        pairs[f"{name} rgb"], pairs[f"{name} cnt"] = (g.rgb, w.rgb), (g.cnt, w.cnt)
    gaps = {k: (a - b).abs().max().item() for k, (a, b) in pairs.items()}
    differ = [k for k, (a, b) in pairs.items() if not torch.equal(a, b)]
    log(f"  {label}: max |d| {max(gaps.values()):.3g}; planes not bitwise: {differ}")
    if differ or got[1].oid is not want[1].oid or got[2].oid is not want[2].oid:
        raise AssertionError(f"{label}: K2 with its tail parts from the plain route on {differ} ({gaps})")
    return max(gaps.values())


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
        fk.LAUNCHES = fk.ROW_LAUNCHES = rk.LAUNCHES = rk.TILE_LAUNCHES = rk.TAIL_LAUNCHES = 0
        fh.LAUNCHES = fh.TILE_LAUNCHES = 0
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="fused tiled path")
            for i in (1, 2):
                img, hist = render_tiles(scene, cfg_x, hist, i, dev)
        torch.cuda.synchronize()
        launches[fusion] = {"frame": fk.LAUNCHES, "frame rows": fk.ROW_LAUNCHES, "reproject": rk.LAUNCHES,
                            "reproject tile": rk.TILE_LAUNCHES, "reproject tail": rk.TAIL_LAUNCHES,
                            "frame_hist": fh.LAUNCHES, "frame_hist tile": fh.TILE_LAUNCHES}
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


def hold_step(new, loss, ref, loss_r, what):
    """A tiled step against the unsharded one: the loss within rel 1e-5 and
    each parameter's update within 1e-4·max|ref|."""
    gaps = {k: (new[k] - ref[k]).abs().max().item() / ref[k].abs().max().item() for k in new}
    rel = abs(loss - loss_r) / abs(loss_r)
    log(f"  {what}: loss {loss:.7g} vs unsharded {loss_r:.7g} (rel {rel:.3g}); update |d|/max|ref| {gaps}")
    if not (rel <= 1e-5 and all(v <= 1e-4 for v in gaps.values())):
        raise AssertionError(f"{what}: the tiled step parts from the unsharded one")
    return gaps


def state_gaps(a, b) -> list:
    """The entries where two AdamStates (or their trees) differ: the
    parameters, Adam's per-parameter step and moments, and the schedule's
    counts, each compared bitwise."""
    from kylespathtracer_tpu_torch.utils.checkpoint import as_tree

    ta, tb = as_tree(a), as_tree(b)
    out = [k for k in ta["params"] if not torch.equal(ta["params"][k].cpu(), tb["params"][k].cpu())]
    for i, sa in ta["adam"]["state"].items():
        out += [f"adam {i} {k}" for k, v in sa.items() if not torch.equal(v.cpu(), tb["adam"]["state"][i][k].cpu())]
    out += [f"schedule {k}" for k in ("last_epoch", "_step_count") if ta["schedule"][k] != tb["schedule"][k]]
    return out


def sharded_resume(scene, cam, target, cfg, opt, dev) -> dict:
    """Phase 22, resume: `train_step_tiled` on a one-rank mesh (K1 + K5, the
    whole image its one tile), its (params, opt_state) checkpointed after
    step 1 and restored into fresh objects, held bitwise. Step 2's update
    from the restored state is held bitwise to the uninterrupted one on one
    gradient; the full step through `train_step_tiled` from a second restore
    is held to hold_step's bar and logged bitwise or not (K5 adds its
    gradient with float atomics, whose order may vary from run to run) →
    the launches."""
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.ops import frame_grad as fg
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.parallel import shard
    from kylespathtracer_tpu_torch.parallel.mesh import Mesh
    from kylespathtracer_tpu_torch.utils import checkpoint as ckpt_mod

    keys = ("spheres", "light_color")
    one = Mesh(rank=0, size=1, device=dev)
    fk.LAUNCHES = fg.LAUNCHES = 0
    p0 = inverse.extract_params(scene, keys)
    p1, st, _ = shard.train_step_tiled(p0, opt.init(p0), opt, scene, cam, target, 3, cfg, one)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_mod.save(tmp, 1, {"params": p1, "opt_state": st})

        def restored():
            fresh = inverse.extract_params(scene, keys)
            return ckpt_mod.restore(tmp, like={"params": fresh, "opt_state": opt.init(fresh)})[1]

        back, back_full = restored(), restored()
    gaps = state_gaps(st, back["opt_state"]) + [k for k in keys if not torch.equal(back["params"][k], p1[k])]
    loss2, g2 = shard.tile_loss_and_grad(p1, scene, cam, target, 4, cfg, 0, cfg.height)
    _, g2_again = shard.tile_loss_and_grad(p1, scene, cam, target, 4, cfg, 0, cfg.height)
    repeats = all(torch.equal(g2[k], g2_again[k]) for k in keys)
    upd_r = {k: v.clone() for k, v in opt.update(g2, back["opt_state"], back["params"]).items()}
    upd_u = {k: v.clone() for k, v in opt.update(g2, st, p1).items()}
    gaps += [f"step 2 {k}" for k in keys if not torch.equal(upd_r[k], upd_u[k])]
    gaps += [f"after step 2: {g}" for g in state_gaps(st, back["opt_state"])]
    full, _, loss_f = shard.train_step_tiled(back_full["params"], back_full["opt_state"], opt, scene, cam, target, 4,
                                             cfg, one)
    torch.cuda.synchronize()
    launches = {"frame": fk.LAUNCHES, "backward": fg.LAUNCHES}
    bitwise = all(torch.equal(full[k], upd_u[k]) for k in keys)
    log(f"  resume of train_step_tiled (one rank, {cfg.width}x{cfg.height}): launches {launches}; state restored "
        f"and step 2's update on one gradient bitwise: {not gaps} {gaps}; K5's gradient repeats bitwise: {repeats}; "
        f"the full step 2 from a second restore bitwise the uninterrupted update: {bitwise}")
    if gaps:
        raise AssertionError(f"phase 22: the resumed tiled step parts from the uninterrupted one: {gaps}")
    hold_step(full, loss_f.item(), upd_u, loss2.item(), "the full step 2 from the restored state")
    return launches


def rank_phase(backend: str, hist0, tiled, params, new_params, loss, target, card: str) -> list:
    """TILES ranks of one process group, each a process started here
    through the KPT_* launch contract (the kernels are built: the ranks
    only load them): gloo on this card, or NCCL with a card per rank. They
    render the tiled frames and take the tiled step; held against the
    in-process tiles `tiled` and `new_params` → the ranks' reports."""
    per_rank = "a card per rank" if backend == "nccl" else f"{TILES} ranks share it"
    log(f"phase 23: {TILES} {backend} ranks ({per_rank}) through multihost.initialize_from_env: "
        "render_frame_tiled (split, mono; 2 frames) with its halo exchange, train_step_tiled")
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
            f"mono launches {rep['mono']['launches']}, train launches {rep['train']['launches']} [{card}; {per_rank}]")
        if rep["split"]["launches"] != {"frame": 2, "frame rows": 2, "reproject": 2, "reproject tile": 2,
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
    from kylespathtracer_tpu_torch.utils.metrics import card_line

    card = card_line()
    count = torch.cuda.device_count()
    log(f"phase 0: {count} cards, {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    if count < TILES:
        sys.exit(f"chip_smoke --nccl: needs {TILES} cards, found {count}")
    path = _build.build()
    _build.load()
    log(f"phase 1: built {path.name}")
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
    the rows and measures their distance from the in-process tiles. Prints
    one line, RANK <json>."""
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
        report[fusion] = r

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
    print("RANK " + json.dumps(report), flush=True)
    dist.destroy_process_group()
    return 0


# Phase 27: the scene tables whose gradients it holds.
GRAD_KEYS = ("spheres", "planes", "alb_const", "light_color")


def counted_modules() -> dict:
    """The kernel modules whose launches phases 25-27 count, by name."""
    from kylespathtracer_tpu_torch.ops import frame_grad as fg
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.ops import geometry_kernel as geo_k
    from kylespathtracer_tpu_torch.ops import loss_kernel as lk
    from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
    from kylespathtracer_tpu_torch.ops import shade_kernel as sk

    return {"frame": fk, "reproject": rk, "geometry": geo_k, "dual_mis": sk, "backward": fg, "loss": lk}


def kernel_counts() -> dict:
    return {name: m.LAUNCHES for name, m in counted_modules().items()}


def zero_counts() -> None:
    """Every counted kernel's launches, and the march's steps and syncs, to 0."""
    from kylespathtracer_tpu_torch.scene import sdf

    for m in counted_modules().values():
        m.LAUNCHES = 0
    sdf.STEPS = sdf.SYNCS = 0


def check_holds(failed: list, phase: str) -> None:
    """Raise, at the end of a phase, naming every hold of it that failed."""
    if failed:
        raise AssertionError(f"{phase}: {'; '.join(failed)}")


def march_phases(dev, card: str) -> dict:
    """Phases 25-27: the sphere trace (scene/sdf.py) and the gradients through
    the intersectors' implicit-function backward, on the card. Each phase
    logs every hold, then raises if one failed. The paths themselves launch
    no kernel (they are plain torch, as the JAX march and its backward are
    XLA code); K3 (phase 25) and K1 + K5 and K6 (phase 27) are their
    witnesses → the witnesses' launches."""
    from kylespathtracer_tpu_torch.app import cli, driver
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.ops import geometry_kernel as geo_k
    from kylespathtracer_tpu_torch.ops.adjoint_variants import BOX_AIMED
    from kylespathtracer_tpu_torch.render import gbuffer, pipeline
    from kylespathtracer_tpu_torch.render.camera import Camera, ray_dirs
    from kylespathtracer_tpu_torch.scene import sdf
    from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    scene = default_scene(device=dev)
    cam_a = Camera.create(loc=CAM_LOC, orient=CAM_ORIENT, device=dev)
    cam_b = Camera.create(loc=CAM_LOC, orient=BOX_AIMED, device=dev)
    witnesses = {}

    # Phase 25: the march and the tetrahedron normals, card against CPU at
    # 256x128 from the box-aimed view; then the march G-buffer at 1080p
    # against K3's from both views (tests/test_scene.py:146-178's bars).
    log(f"phase 25: sdf.march and sdf.norcurv, card vs CPU at 256x128; the march G-buffer at {W}x{H} vs K3 "
        f"[{card}]")
    failed = []
    rd = ray_dirs(cam_b, 256, 128, 1.5)
    ro = cam_b.loc.expand(rd.shape)
    t_c, id_c = sdf.march(scene, ro, rd)
    n_c, c_c = sdf.norcurv(scene, ro + rd * t_c[..., None])
    cpu = default_scene(device="cpu")
    t_h, id_h = sdf.march(cpu, ro.cpu(), rd.cpu())
    n_h, c_h = sdf.norcurv(cpu, ro.cpu() + rd.cpu() * t_h[..., None])
    same = id_c.cpu() == id_h
    hit = same & (id_h > 0)
    gaps = {"oid differ": 1.0 - same.float().mean().item(),
            "t": (t_c.cpu() - t_h)[same].abs().max().item(),
            "normal": (n_c.cpu() - n_h)[hit].abs().max().item(),
            "curv": (c_c.cpu() - c_h)[hit].abs().max().item()}
    log(f"  256x128 card vs CPU: {gaps}; hits {hit.float().mean().item():.4f}, box "
        f"{(id_h == 4).float().mean().item():.4f}")
    # t to a few ulps; the stencil scales a distance's ulp by up to ~10^3
    # (tests/test_torch_geometry.py holds the port to JAX's stencil so too).
    if not (gaps["oid differ"] <= 1e-3 and gaps["t"] <= 1e-5 and gaps["normal"] <= 1e-4 and gaps["curv"] <= 1e-4):
        failed.append(f"the card's march or norcurv parts from the CPU's: {gaps}")
    cfg_k3, cfg_m = RenderConfig(width=W, height=H), RenderConfig(width=W, height=H, intersect_mode="march")
    witnesses["geometry"] = 0
    for key, cam in (("a", cam_a), ("b", cam_b)):
        zero_counts()
        geo = geo_k.geometry_pass(scene, cam, 0, cfg_k3)
        torch.cuda.synchronize()
        witnesses["geometry"] += geo_k.LAUNCHES
        zero_counts()
        gm = gbuffer.geometry_pass(scene, cam, cfg_m)
        torch.cuda.synchronize()
        counts, steps, syncs = kernel_counts(), sdf.STEPS, sdf.SYNCS
        # The march stops within eps of a surface, which a ray at angle θ to
        # its normal reaches eps/|cos θ| later: the bar's tangent grazers
        # (|n·d| < 0.1) are left out of the t percentile, and logged.
        eq = gm.obj_id == geo["oid"]
        both = eq & (geo["oid"] > 0)
        graze = (geo["normal"] * gm.ray_dir).sum(-1).abs() < 0.1
        dt = (gm.depth - geo["depth"]).abs()
        p99 = torch.quantile(dt[both & ~graze], 0.99).item()
        p99_all = torch.quantile(dt[both], 0.99).item()
        share = eq.float().mean().item()
        log(f"  view ({key}) march G-buffer vs K3: oid equal on {share:.6f}, p99 |dt| on equal hits {p99:.3g} "
            f"without the {(both & graze).float().mean().item():.4f} of pixels that graze ({p99_all:.3g} with them), "
            f"box {torch.isin(gm.obj_id, scene.box_ids).float().mean().item():.4f}; {steps} steps, {syncs} syncs "
            f"(CHECK_EVERY {sdf.CHECK_EVERY}); launches {counts} [{card}]")
        if any(counts.values()):
            failed.append(f"the march G-buffer launched kernels: {counts}")
        if not (share > 0.995 and p99 < 1e-2):
            failed.append(f"view ({key}): the march G-buffer parts from K3's (oid {share}, p99 {p99})")
    check_holds(failed, "phase 25")

    # Phase 26: the sphere-traced pass frame at full width, and the CLI.
    log(f"phase 26: render_animation 2 frames at {W}x{H}, pipeline='pass', intersect_mode='march'")
    failed = []
    cams = [Camera.create(loc=CAM_LOC, orient=(CAM_ORIENT[0], CAM_ORIENT[1] + PAN * i), device=dev)
            for i in range(2)]
    stacked = Camera(loc=torch.stack([c.loc for c in cams]), orient=torch.stack([c.orient for c in cams]))
    cfg_pm = RenderConfig(width=W, height=H, pipeline="pass", intersect_mode="march")
    zero_counts()
    image, hist = driver.render_animation(scene, cfg_pm, num_frames=2, cameras=stacked)
    torch.cuda.synchronize()
    counts, steps, syncs = kernel_counts(), sdf.STEPS, sdf.SYNCS
    log(f"  {steps} march steps, {syncs} syncs in the 2 frames; launches {counts}; image range "
        f"[{image.min().item():.4f}, {image.max().item():.4f}], mean diffuse count "
        f"{hist.diffuse.cnt.mean().item():.4f} [{card}]")
    if any(counts.values()):
        failed.append(f"the march pass frames launched kernels: {counts}")
    if image.shape != (H, W, 3) or not (torch.isfinite(image).all() and image.min() >= 0 and image.max() <= 1):
        failed.append("the march pass image is not finite in [0, 1] or of the wrong shape")
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stderr(io.StringIO()):
            cli.main(["render", "--width", "256", "--height", "128", "--frames", "1", "--march", "--pipeline",
                      "pass", "--out", tmp])
        pw = png_pixels(f"{tmp}/final.png")
    log(f"  cli render --march --pipeline pass 256x128: PNG {pw}")
    if pw != (256, 128, 128 * (1 + 256 * 3)):
        failed.append(f"the --march CLI's PNG is malformed: {pw}")
    check_holds(failed, "phase 26")

    # Phase 27: the pass pipeline's gradient at 1080p against the fused
    # routes' on the same loss, the march's IFT gradient against finite
    # differences, fit with a default config and the pass route's tiled step.
    log(f"phase 27: the pass pipeline's gradient at {W}x{H} (shade_backend='xla', no_history, soft_shadows=0.05) "
        "vs K1 + K5 (KPT_FUSED_LOSS=0) and K6")
    failed = []
    cfg_g = RenderConfig(width=W, height=H, pipeline="pass", no_history=True, soft_shadows=0.05)
    cfg_f = dataclasses.replace(cfg_g, pipeline="fused")
    target = dim_target(scene, dev)
    params = inverse.extract_params(scene, GRAD_KEYS)
    # Ill-conditioned pixels: where K1 and its plain version part, and where
    # the pass and the fused frames do; each route's target there is its own
    # image, so those pixels give the loss and its gradient nothing.
    zero_counts()
    k1 = fk.frame_forward(scene, cam_a, 3, cfg_f)
    torch.cuda.synchronize()
    witnesses["frame"] = fk.LAUNCHES
    ill = fk.ill_conditioned(k1, fk.frame_forward_plain(scene, cam_a, 3, cfg_f))
    with torch.no_grad():
        img_p = inverse.render_once(scene, cam_a, cfg_g, 3)
        img_f = inverse.render_once(scene, cam_a, cfg_f, 3)
    parted = (img_p - img_f).abs().amax(-1) > 1e-4
    bad = (ill | parted)[..., None]
    log(f"  masked: {int(ill.sum())} ill-conditioned pixels, {int(parted.sum())} where the pass and fused images "
        f"part by more than 1e-4, {int(bad.sum())} in all, of {W * H}; max |pass - fused| image "
        f"{(img_p - img_f).abs().max().item():.3g}")
    target_p, target_f = torch.where(bad, img_p, target), torch.where(bad, img_f, target)
    del img_p, img_f, k1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_counts()
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = inverse.loss_fn(p, scene, cam_a, target_p, 3, cfg_g)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    torch.cuda.synchronize()
    counts = kernel_counts()
    log(f"  pass route (loss_fn and autograd): launches {counts}")
    if any(counts.values()):
        failed.append(f"the pass gradient launched kernels: {counts}")
    loss_p, grads_p = inverse.value_and_grad(params, scene, cam_a, target_p, 3, cfg_g)
    same = max((grads_p[k] - grads[k]).abs().max().item() for k in grads)
    log(f"  value_and_grad (pass): loss {loss_p.item():.7g}, max |d| from loss_fn's autograd {same:.3g}")
    routes = {}
    old = os.environ.get("KPT_FUSED_LOSS")
    try:
        for route, flag in (("K1 + K5", "0"), ("K6", "1")):
            os.environ["KPT_FUSED_LOSS"] = flag
            zero_counts()
            routes[route] = inverse.value_and_grad(params, scene, cam_a, target_f, 3, cfg_f)
            torch.cuda.synchronize()
            counts = kernel_counts()
            log(f"  {route} (KPT_FUSED_LOSS={flag}): loss {routes[route][0].item():.7g}, launches {counts}")
            want = {"frame": 1, "backward": 1, "loss": 0} if flag == "0" else {"frame": 0, "backward": 0, "loss": 1}
            if {k: counts[k] for k in want} != want:
                failed.append(f"{route} did not run through its kernels: {counts}")
            for k in ("backward", "loss"):
                witnesses[k] = witnesses.get(k, 0) + counts[k]
    finally:
        if old is None:
            del os.environ["KPT_FUSED_LOSS"]
        else:
            os.environ["KPT_FUSED_LOSS"] = old
    for route, (loss_r, grads_r) in routes.items():
        rel = {k: (grads_r[k] - grads_p[k]).abs().max().item() / grads_p[k].abs().max().item() for k in GRAD_KEYS}
        lrel = abs(loss_r.item() - loss_p.item()) / abs(loss_p.item())
        log(f"  {route} vs pass: loss rel {lrel:.3g}; max |d|/max|pass| per table {rel}")
        if not (lrel <= 1e-4 and all(v <= 2e-3 for v in rel.values())):
            failed.append(f"{route}'s gradient parts from the pass pipeline's: {rel}, loss {lrel}")
    del grads, grads_p, routes, p, loss
    torch.cuda.empty_cache()

    # The march's IFT gradient: a ray straight at a unit sphere.
    sph = sphere_scene([[0.0, 1.0, 5.0]], [1.0], [[0.5, 0.5, 0.5]], with_floor=False, device=dev)
    ro1, rd1 = torch.tensor([[0.0, 1.0, 0.0]], device=dev), torch.tensor([[0.0, 0.0, 1.0]], device=dev)
    for column, want in ((2, 1.0), (3, -1.0)):
        def hit_t(delta, column=column):
            spheres = sph.spheres.clone()
            spheres[1, column] = spheres[1, column] + delta
            return sdf.march(dataclasses.replace(sph, spheres=spheres), ro1, rd1)[0][0]

        x = torch.tensor(0.0, device=dev, requires_grad=True)
        (g,) = torch.autograd.grad(hit_t(x), x)
        with torch.no_grad():
            fd = ((hit_t(1e-3) - hit_t(-1e-3)) / 2e-3).item()
        what = "dt/dz" if column == 2 else "dt/dr"
        log(f"  march IFT {what}: {g.item():.6f}, central difference {fd:.6f}, exact {want}")
        if not (abs(g.item() - want) < 5e-2 and abs(g.item() - fd) < 5e-2):
            failed.append(f"the march's {what} parts from its finite difference")

    # fit at the recovery view with a default config (the pass pipeline).
    truth, start, views = inverse.recovery_scenes(10, 5, device=dev)
    c_def = RenderConfig(width=192, height=128)
    with torch.no_grad():
        target_r = inverse.render_once(truth, views[0], c_def, 0)
    inverse.fit(start, target_r, views[0], c_def, steps=1)
    zero_counts()
    fitted, losses = inverse.fit(start, target_r, views[0], c_def, steps=3)
    torch.cuda.synchronize()
    counts = kernel_counts()
    moved = (fitted.spheres - start.spheres).abs().max().item()
    log(f"  fit, 3 steps at 192x128 with a default config: losses {losses}, spheres moved by up to {moved:.4g}; "
        f"launches {counts}")
    if any(counts.values()) or not (np.isfinite(losses).all() and moved > 0):
        failed.append(f"fit with the pass pipeline: losses {losses}, moved {moved}, launches {counts}")

    # The pass route's tiled step, 2 tiles in this process.
    c_pass = RenderConfig(width=192, height=128, soft_shadows=0.05)
    opt = step_optimizer()
    params_r = inverse.extract_params(start)
    f0 = inverse.SEED_BASE
    with torch.no_grad():
        target_t = inverse.render_once(truth, views[0], c_pass, f0)
    zero_counts()
    new_r, loss_r2 = tiled_step(params_r, opt, start, views[0], target_t, f0, c_pass, 2)
    ref_r, _, loss_rr = inverse.train_step(params_r, opt.init(params_r), opt, start, views[0], target_t, f0, c_pass)
    counts = kernel_counts()
    log(f"  tiled step on the pass pipeline: launches {counts}")
    if any(counts.values()):
        failed.append(f"the pass route's tiled step launched kernels: {counts}")
    check_holds(failed, "phase 27")
    hold_step(new_r, loss_r2, ref_r, loss_rr.item(), "pass pipeline, 2 tiles at the 192x128 recovery view")
    return witnesses


# Phase 30's key script: every byte a frame of the fly loop reads (w, wd,
# space, c, the four arrows, frames with no key).
FLY_KEYS = (b"w", b"w", b"wd", b"wd", b" ", b" ", b"c", b"\x1b[A", b"\x1b[B", b"w\x1b[C", b"\x1b[C", b"\x1b[D", b"",
            b"", b"s", b"a", b"wd \x1b[A", b"\x1b[D\x1b[D")
# The RECOVERY recipe (bench_configs.py:454-464), as phase 11 runs it.
RECOVERY = dict(num_spheres=10, steps=800, width=192, height=128, views=5, betas=(0.05, 0.02, 0.008, 0.003))


def png_rgb(path) -> np.ndarray:
    """The u8[H, W, 3] pixels of an 8-bit RGB PNG with filter-0 rows, its
    chunks' CRCs checked."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: no PNG signature")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise AssertionError(f"{path}: bad CRC in {tag}")
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return rows[:, 1:].reshape(h, w, 3)


def histories_equal(a, b) -> list:
    """The planes where two histories differ bitwise."""
    return [f"{name}.{k}" for name in ("diffuse", "specular") for k in ("rgb", "cnt", "oid")
            if not torch.equal(getattr(getattr(a, name), k), getattr(getattr(b, name), k))] + [
        f"camera.{k}" for k in ("loc", "orient") if not torch.equal(getattr(a.camera, k), getattr(b.camera, k))]


def cli_run(args: list, **kw) -> subprocess.CompletedProcess:
    """`python -m kylespathtracer_tpu_torch.app.cli ARGS` from the repo root."""
    return subprocess.run([sys.executable, "-m", "kylespathtracer_tpu_torch.app.cli", *args], capture_output=True,
                          text=True, cwd=os.path.dirname(os.path.abspath(__file__)), **kw)


def app_phases(dev, card: str, rec_ref: dict) -> dict:
    """Phases 28-31: checkpoint and resume of render_animation and of
    run_recovery (the `invert` CLI), the fly-cam, and the rest of the app
    (`info`, the native library, the profiler trace and the timers), on the
    card. Each phase logs every hold, then raises if one failed → the
    launches of K1, K2 and K6 on these paths."""
    from unittest import mock

    from torch.autograd import DeviceType

    from kylespathtracer_tpu_torch.app import cli, driver, fly
    from kylespathtracer_tpu_torch.app.controller import ControllerState, InputFrame, update_controller
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.ops import loss_kernel as lk
    from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
    from kylespathtracer_tpu_torch.render import pipeline
    from kylespathtracer_tpu_torch.render.camera import Camera
    from kylespathtracer_tpu_torch.scene import sdf
    from kylespathtracer_tpu_torch.scene.scene import default_scene
    from kylespathtracer_tpu_torch.utils import checkpoint as ckpt_mod
    from kylespathtracer_tpu_torch.utils import image_io, metrics, native
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    scene = default_scene(device=dev)
    cfg = RenderConfig(width=W, height=H, pipeline="fused")
    counts = {"frame": 0, "reproject": 0, "loss": 0}

    # Phase 28: render_animation's checkpoint and resume.
    log(f"phase 28: render_animation checkpoint/resume at {W}x{H} (split frame: K1 + K2): 8 frames straight, "
        "5 with checkpoint_every=3 then resume=True")
    failed = []
    ref_img, ref_hist = driver.render_animation(scene, cfg, num_frames=8)
    with tempfile.TemporaryDirectory() as tmp:
        driver.render_animation(scene, cfg, num_frames=5, checkpoint_dir=tmp, checkpoint_every=3)
        saved = ckpt_mod.steps(tmp)
        fk.LAUNCHES = rk.LAUNCHES = 0
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            img, hist = driver.render_animation(scene, cfg, num_frames=8, checkpoint_dir=tmp, resume=True)
        torch.cuda.synchronize()
        launches = {"frame": fk.LAUNCHES, "reproject": rk.LAUNCHES}
    for k in counts:
        counts[k] += launches.get(k, 0)
    gaps = histories_equal(hist, ref_hist)
    diff = (img - ref_img).abs().max().item()
    log(f"  checkpoints {saved}; {said.getvalue().strip()!r}; launches of the resumed run {launches}; image "
        f"bitwise the uninterrupted run's: {torch.equal(img, ref_img)} (max |d| {diff:.3g}); history planes that "
        f"differ: {gaps}")
    if saved != [3] or "resumed from checkpoint step 3" not in said.getvalue():
        failed.append(f"checkpoints {saved}, not [3], or the run did not resume from step 3")
    if launches != {"frame": 4, "reproject": 4}:
        failed.append(f"the resumed frames 4-7 did not run through K1 and K2: {launches}")
    if not torch.equal(img, ref_img) or gaps:
        failed.append(f"the resumed run is not bitwise the uninterrupted one (image max |d| {diff}, {gaps})")
    with tempfile.TemporaryDirectory() as tmp:
        base = ["render", "--width", str(W), "--height", str(H), "--out", f"{tmp}/out", "--checkpoint-dir",
                f"{tmp}/ck", "--checkpoint-every", "3", "--metrics", f"{tmp}/m.jsonl"]
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            cli.main(base + ["--frames", "5"])
            cli.main(base + ["--frames", "8", "--resume"])
        steps = ckpt_mod.steps(f"{tmp}/ck")
        pw = png_pixels(f"{tmp}/out/final.png")
        frames = [json.loads(line)["frame"] for line in open(f"{tmp}/m.jsonl")]
    log(f"  cli render --checkpoint-every 3, then --resume: {said.getvalue().strip()!r}; checkpoints {steps}; "
        f"frames {frames}; final.png {pw}")
    if steps != [3, 6] or frames != [0, 1, 2, 3, 4, 4, 5, 6, 7] or pw != (W, H, H * (1 + 3 * W)):
        failed.append(f"the render CLI's resume: checkpoints {steps}, frames {frames}, final.png {pw}")
    check_holds(failed, "phase 28")

    # Phase 29: invert with a kill and a resume.
    log("phase 29: run_recovery (RECOVERY recipe) for 2 beta phases with ckpt_dir, then `cli invert --ckpt-dir D "
        "--resume` in a subprocess")
    failed = []
    w = np.linspace(1.0, 1.6, len(RECOVERY["betas"]))
    phase_steps = [max(1, int(RECOVERY["steps"] * wi / w.sum())) for wi in w]
    _, start, _ = inverse.recovery_scenes(RECOVERY["num_spheres"], RECOVERY["views"], device=dev)

    def like_state():
        p = inverse.extract_params(start)
        return {"params": p, "opt_state": inverse.ClippedAdam(2e-2, sum(phase_steps), 0.03, clip=1.0).init(p)}

    with tempfile.TemporaryDirectory() as ck:
        fk.LAUNCHES = lk.LAUNCHES = 0
        part = inverse.run_recovery(**RECOVERY, ckpt_dir=ck, max_phases=2, device=dev)
        torch.cuda.synchronize()
        part_launches = {"frame": fk.LAUNCHES, "loss": lk.LAUNCHES}
        # The state's round trip on the card: the file's tree against its
        # restore onto the card, and that against a save and restore of it.
        _, tree = ckpt_mod.restore(ck, 2)
        _, on_card = ckpt_mod.restore(ck, 2, like=like_state())
        gaps = state_gaps(tree["opt_state"], on_card["opt_state"])
        gaps += [k for k in tree["params"] if not torch.equal(tree["params"][k], on_card["params"][k].cpu())]
        with tempfile.TemporaryDirectory() as again:
            ckpt_mod.save(again, 2, on_card)
            _, twice = ckpt_mod.restore(again, 2, like=like_state())
        gaps += [f"second round trip: {g}" for g in state_gaps(on_card["opt_state"], twice["opt_state"])]
        # A torn pair: phase 2's step without its sidecar falls back to phase 1.
        with tempfile.TemporaryDirectory() as torn:
            for name in os.listdir(ck):
                with open(f"{ck}/{name}", "rb") as src, open(f"{torn}/{name}", "wb") as dst:
                    dst.write(src.read())
            os.remove(f"{torn}/meta_2.json")
            lk.LAUNCHES = 0
            fell = inverse.run_recovery(**RECOVERY, ckpt_dir=torn, resume=True, max_phases=2, device=dev)
            torn_loss = lk.LAUNCHES
        meta1 = json.load(open(f"{ck}/meta_1.json"))
        meta2 = json.load(open(f"{ck}/meta_2.json"))
        proc = cli_run(["invert", "--ckpt-dir", ck, "--resume", "--log-every", "1"], timeout=900)
    counts["frame"] += part_launches["frame"]
    counts["loss"] += part_launches["loss"] + torn_loss
    log(f"  2 phases, {sum(phase_steps[:2])} steps: launches {part_launches}; trace {part['phases']}")
    log(f"  restore(save(state)) of the parameters and the Adam state (moments, step), on the card: entries that "
        f"differ {gaps}")
    log(f"  torn pair (meta_2.json deleted): completed {fell['completed_phases']}, K6 launches {torn_loss} "
        f"(phase 1 alone: {RECOVERY['views'] * phase_steps[1]})")
    if proc.returncode != 0:
        failed.append(f"cli invert --resume exited {proc.returncode}: {proc.stderr[-2000:]}")
        res = {}
    else:
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        log("  cli invert --resume: " + " | ".join(proc.stdout.strip().splitlines()[:-1]))
        log(f"  resumed: loss {res['loss_initial']:.6g} -> {res['loss_final']:.6g}; " + ", ".join(
            f"{k} {res[k]:.6g} (phase 11 straight {rec_ref[k]:.6g}, gap {res[k] - rec_ref[k]:.3g})"
            for k in ("err_position", "err_radius", "err_albedo")))
        if res["completed_phases"] != 4:
            failed.append(f"the resumed run completed {res['completed_phases']} phases, not 4")
        if not (res["err_position"] < 0.01 and res["err_radius"] < 0.005 and res["err_albedo"] < 0.01):
            failed.append(f"the resumed recovery missed its bounds: {res}")
        if res["phases"][:2] != meta2["trace"][:2]:
            failed.append("the resumed trace's first two phases are not the sidecar's")
    if gaps:
        failed.append(f"the checkpoint's round trip on the card is not bitwise: {gaps}")
    if part["completed_phases"] != 2 or part["phases"] != meta2["trace"] or part_launches["loss"] == 0:
        failed.append(f"the killed run: {part['completed_phases']} phases, launches {part_launches}")
    if (fell["completed_phases"] != 2 or torn_loss != RECOVERY["views"] * phase_steps[1]
            or fell["phases"][0] != meta1["trace"][0]):
        failed.append("the torn pair did not fall back to phase 1")
    check_holds(failed, "phase 29")

    # Phase 30: the fly-cam, its steps against playback.
    log(f"phase 30: fly_step over {len(FLY_KEYS)} frames of key bytes at {W}x{H} (split frame), against "
        "playback_cameras + render_animation on the same input frames")
    failed = []
    state0 = ControllerState.create(device=dev)
    step = fly.fly_step(cfg)

    def fly_loop(device, render: bool):
        """The fly loop's controller (and frames) over FLY_KEYS on `device`
        → (states, images, input frames as numpy, looking flags)."""
        st = ControllerState.create(device=device)
        hist = pipeline.init_history(cfg, st.camera)
        states, images, script, looking = [], [], [], []
        for i, keys in enumerate(FLY_KEYS):
            move, look, quit_ = fly.parse_keys(keys)
            if quit_:
                raise AssertionError(f"{keys!r} quits")
            down = bool(look[0] or look[1])
            inp = InputFrame.create(move=move, mouse_delta=look, mouse_down=down, device=device)
            if down:
                st = st.replace(was_down=torch.tensor(True, device=device))
            if render:
                st, img, hist = step(scene, st, inp, hist, i)
                images.append(img)
            else:
                st = update_controller(st, inp)
            states.append(st)
            script.append((move, look))
            looking.append(down)
        return states, images, script, looking

    fk.LAUNCHES = rk.LAUNCHES = 0
    states, images, script, looking = fly_loop(dev, render=True)
    torch.cuda.synchronize()
    fly_launches = {"frame": fk.LAUNCHES, "reproject": rk.LAUNCHES}
    # fly's pre-arm of was_down on a look frame is, in playback, the button
    # held on the frame before (whose drag is zero) or in the start state.
    T = len(FLY_KEYS)
    held = [looking[i] or (i + 1 < T and looking[i + 1]) for i in range(T)]
    inputs = InputFrame(move=torch.tensor([m for m, _ in script], dtype=torch.float32, device=dev),
                        mouse_delta=torch.tensor([d for _, d in script], dtype=torch.float32, device=dev),
                        mouse_down=torch.tensor(held, device=dev))
    fk.LAUNCHES = rk.LAUNCHES = 0
    cams = driver.playback_cameras(state0.replace(was_down=torch.tensor(looking[0], device=dev)), inputs)
    hist = pipeline.init_history(cfg, state0.camera)
    differ = []
    for i in range(T):
        img, hist = driver.render_animation(scene, cfg, num_frames=1, cameras=cams, history=hist, start_frame=i)
        if not (torch.equal(img, images[i]) and torch.equal(cams.loc[i], states[i].loc)
                and torch.equal(cams.orient[i], states[i].orient)):
            differ.append(i)
    torch.cuda.synchronize()
    play_launches = {"frame": fk.LAUNCHES, "reproject": rk.LAUNCHES}
    for k in ("frame", "reproject"):
        counts[k] += fly_launches[k] + play_launches[k]
    cpu_states = fly_loop(torch.device("cpu"), render=False)[0]
    worst = max(max((getattr(a, k).cpu() - getattr(b, k)).abs().max().item() for k in ("loc", "vel", "orient"))
                for a, b in zip(states, cpu_states))
    accel = np.float32(0.01)
    speeds = [float(torch.linalg.norm(s.vel)) for s in states]
    log(f"  launches: fly {fly_launches}, playback {play_launches}; frames whose image or camera differ from "
        f"playback's: {differ}; loc {[round(v, 4) for v in states[-1].loc.tolist()]}, orient "
        f"{[round(v, 4) for v in states[-1].orient.tolist()]}; speeds {[round(v, 5) for v in speeds]}")
    log(f"  controller on the card vs the CPU, max |d| over the {T} states: {worst:.3g}; first step's speed "
        f"{(speeds[0] - float(accel)) / np.spacing(accel):+.1f} ulps from ACCEL_SPEED (the dead stop's knife edge)")
    if fly_launches != {"frame": T, "reproject": T} or play_launches != fly_launches:
        failed.append(f"fly or playback did not run through K1 and K2: {fly_launches}, {play_launches}")
    if differ:
        failed.append(f"fly and playback part on frames {differ}")
    if worst > 1e-6:
        failed.append(f"the controller on the card parts from the CPU's by {worst}")
    if not (images[-1].shape == (H, W, 3) and torch.isfinite(images[-1]).all()):
        failed.append("the fly image is not finite or of the wrong shape")
    proc = cli_run(["fly"], stdin=subprocess.DEVNULL, timeout=300)
    log(f"  cli fly, stdin not a tty: exit {proc.returncode}, stderr {proc.stderr.strip()[-200:]!r}")
    if proc.returncode != 0 or "stdin is not a tty" not in proc.stderr:
        failed.append("cli fly without a tty did not return with its message")
    check_holds(failed, "phase 30")

    # Phase 31: info, the native library, the profiler trace and the timers.
    log("phase 31: cli info, the native library, metrics.profiler_trace, Timer and time_fn")
    failed = []
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        cli.main(["info"])
    info = json.loads(said.getvalue())
    log(f"  cli info: {info}")
    if info["backend"] != "cuda" or torch.cuda.get_device_name(0) not in info["devices"]:
        failed.append(f"cli info does not name the card: {info}")
    if not native.available():
        log(f"  native library not built: {native.build_error()}")
    else:
        log(f"  native library built from native/; make said: {native.BUILD_LOG.get('output', '').strip()!r}")
        rng = np.random.default_rng(3)
        n = 2000
        ro = np.stack([rng.uniform(-5, 9.5, n), rng.uniform(0.2, 9.5, n), rng.uniform(-9.5, 5, n)],
                      axis=-1).astype(np.float32)
        rd = rng.normal(size=(n, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        t_c, id_c = native.march(scene, ro, rd, -1, 255)
        t_p, id_p = sdf.march(scene, torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev), -1, 255)
        t_p, id_p = t_p.cpu().numpy(), id_p.cpu().numpy()
        same = (id_c == id_p).mean()
        p99 = float(np.quantile(np.abs(t_c[id_c == id_p] - t_p[id_c == id_p]), 0.99))
        log(f"  native march vs sdf.march on the card, {n} rays: ids equal {same:.4f}, p99 |dt| {p99:.3g}")
        if not (same > 0.995 and p99 < 5e-3):
            failed.append(f"the native march parts from the port's: ids {same}, p99 {p99}")
        with tempfile.TemporaryDirectory() as tmp:
            image_io.save_png(f"{tmp}/native.png", images[-1])
            with mock.patch.object(native, "available", lambda: False):
                image_io.save_png(f"{tmp}/zlib.png", images[-1])
            a, b = png_rgb(f"{tmp}/native.png"), png_rgb(f"{tmp}/zlib.png")
        log(f"  save_png of a {W}x{H} frame, native encoder vs Python zlib: pixels equal {np.array_equal(a, b)}")
        if not (np.array_equal(a, b) and np.array_equal(a, image_io._to_u8(images[-1]))):
            failed.append("the native and zlib PNGs decode to different pixels")
    cam = Camera.create(loc=CAM_LOC, orient=CAM_ORIENT, device=dev)

    def frame():
        return pipeline.render_frame(scene, cam, ref_hist, 9, cfg)

    frame()
    with tempfile.TemporaryDirectory() as tmp:
        with metrics.profiler_trace(tmp) as prof:
            frame()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        in_file = "kpt::frame_kernel" in open(f"{tmp}/trace.json").read()
    k1 = sum("kpt::frame_kernel" in n for n in names)
    log(f"  profiler_trace of one split frame: {len(names)} device events, K1 {k1} in them, in trace.json {in_file}")
    if k1 != 1 or not in_file:
        failed.append("the profiler trace holds no K1 kernel")
    with metrics.Timer() as timer:
        frame()
    per_call = metrics.time_fn(frame, iters=20, warmup=3) * 1e3
    events_ms = metrics.cuda_ms(frame, reps=20, warmup=3)
    if not 0.5 < per_call / events_ms < 2.0 or timer.elapsed * 1e3 < 0.5 * events_ms:
        failed.append(f"Timer ({timer.elapsed * 1e3} ms) or time_fn ({per_call} ms a call) parts from the CUDA "
                      f"events ({events_ms} ms)")
    check_holds(failed, "phase 31")
    return counts


# Phase 32: the benches through their entry points. bench.py's metric names
# (less scaling_*), and the kernels one step of each measurement launches.
BENCH_METRICS = ("host_device_roundtrip_ms", "fwd_frame_ms_1080p", "traced_rays_per_s_1080p",
                 "fwd_bwd_rays_per_s_1080p", "fwd_bwd_generic_rays_per_s_1080p", "raycast_rays_per_s_1080p",
                 "wavefront_segments_per_s_1080p")
BENCH_LAUNCHES = {"fwd_fused": {"frame_forward": 1, "reproject_window": 1},
                  "fwd_bwd_fused_loss": {"render_loss_and_grad": 1},
                  "fwd_bwd": {"frame_forward": 1, "frame_backward": 1},
                  "raycast": {"geometry_pass": 1}, "wavefront": {"pathtrace": 1}}


def bench_run(module: str, args: list, timeout: float) -> subprocess.CompletedProcess:
    """`python -m kylespathtracer_tpu_torch.<module> ARGS` from the repo root
    → the finished process; raises unless it exits 0."""
    try:
        proc = subprocess.run([sys.executable, "-m", f"kylespathtracer_tpu_torch.{module}", *args],
                              capture_output=True, text=True, timeout=timeout,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"phase 32: {module} did not end within {timeout} s:\n{e.stdout}\n{e.stderr}") \
            from None
    if proc.returncode != 0:
        raise AssertionError(f"phase 32: {module} exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-6000:]}")
    return proc


def json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def bench_phase(card: str) -> None:
    """Phase 32: bench, bench_configs and bench_profile as a user runs them,
    each a subprocess writing into a new --out path under a temporary
    directory; holds every bench.py metric name (less scaling_*) on its own
    line, the launches of each measurement's step, every configuration's
    bar, the profile's device time within the bench's slope × 1.05, and the
    card named in every record."""
    failed = []
    log("phase 32: python -m kylespathtracer_tpu_torch.bench, .bench_configs and .bench_profile, each with --out "
        "in a new temporary path")
    with tempfile.TemporaryDirectory() as tmp:
        proc = bench_run("bench", ["--out", f"{tmp}/bench.jsonl"], 300)
        lines = json_lines(proc.stderr)
        headline = json.loads(proc.stdout.strip().splitlines()[-1])
        recorded = open(f"{tmp}/bench.jsonl").read().splitlines()
        metrics = {r["metric"]: r for r in lines}
        log(f"  bench: headline {headline.get('metric')}; metrics {sorted(metrics)}")
        if headline.get("metric") != "primary_rays_per_s_fwd_1080p" or not headline.get("value", 0) > 0:
            failed.append(f"bench's last stdout line is not the headline: {headline}")
        missing = [m for m in BENCH_METRICS + tuple(f"{t}_timing_detail" for t in BENCH_LAUNCHES) if m not in metrics]
        if missing:
            failed.append(f"bench printed no line for {missing}")
        for tag, want in BENCH_LAUNCHES.items():
            got = metrics.get(f"{tag}_timing_detail", {}).get("launches_per_step")
            if got != want:
                failed.append(f"bench's {tag} step launched {got}, not {want}")
        if any(r.get("device") != card for r in lines + [headline]):
            failed.append("a bench record does not name the card")
        if [json.loads(ln) for ln in recorded] != lines + [headline]:
            failed.append("bench's --out record differs from its output")

        bench_run("bench_configs", ["--out", f"{tmp}/configs"], 600)
        configs = json.load(open(f"{tmp}/configs/configs.json"))
        recovery = json.load(open(f"{tmp}/configs/recovery.json"))
        log(f"  bench_configs: all_passed {configs['all_passed']} [{configs['device']}]")
        for r in configs["configs"]:
            log(f"  {json.dumps({k: r[k] for k in ('name', 'passed', 'errors') if k in r})}")
            if not r.get("passed") or r.get("device") != card:
                failed.append(f"configuration {r['name']} did not pass or does not name the card")
        log(f"  recovery.json: errors {[recovery[k] for k in ('err_position', 'err_radius', 'err_albedo')]}, "
            f"{recovery['steps']} steps")
        if not configs["all_passed"] or configs["device"] != card:
            failed.append("bench_configs: not all passed, or the record does not name the card")

        bench_run("bench_profile", ["--out", f"{tmp}/profile"], 300)
        prof = json.load(open(f"{tmp}/profile/profile.json"))
        log(f"  bench_profile: {prof['device_events']} device events, device time within the slope "
            f"{prof['device_within_slope']} [{prof['device']}]")
        fwd_ms = metrics.get("fwd_frame_ms_1080p", {}).get("value", 0.0)
        if not (prof["device_within_slope"] and prof["device_per_frame_ms"] <= fwd_ms * 1.05):
            failed.append(f"the profile's device time {prof['device_per_frame_ms']} ms exceeds 1.05x the slope "
                          f"(its own {prof['fwd_frame_ms_1080p']}, bench's {fwd_ms})")
        if prof["device"] != card:
            failed.append("the profile does not name the card")
    check_holds(failed, "phase 32")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this smoke run needs a GPU")

    from kylespathtracer_tpu_torch import bench_ceiling, bench_configs
    from kylespathtracer_tpu_torch.app import cli, driver
    from kylespathtracer_tpu_torch.core import color, gmath
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.ops import _build
    from kylespathtracer_tpu_torch.ops.adjoint_variants import BOX_AIMED
    from kylespathtracer_tpu_torch.ops import ceiling_kernel as ck
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
    from kylespathtracer_tpu_torch.utils.config import RenderConfig
    from kylespathtracer_tpu_torch.utils.metrics import card_line

    dev = torch.device("cuda")

    # Phase 0: the card.
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"phase 0: card {card} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")

    # Phase 1: build the kernels from the sources in the checkout.
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        path = _build.build(verbose=True)
    log(report.getvalue())
    _build.load()
    log(f"phase 1: built {path.name}")
    ptxas = {label: ptxas_lines(report.getvalue(), source) for label, source in (
        ("K1", "frame_kernel.cu"), ("K2", "reproject_kernel.cu"), ("K3", "geometry_kernel.cu"),
        ("K7", "path_kernel.cu"), ("K8", "frame_hist.cu"),
        ("K4", "shade_kernel.cu"), ("K5", "frame_grad.cu"), ("K6", "loss_kernel.cu"))}
    for label, line in ptxas.items():
        log(f"  ptxas {label}: {line}")
    k9_resources = bench_ceiling.ptxas_by_variant(report.getvalue())
    for variant in ck.KERNEL_VARIANTS:
        log(f"  ptxas K9 {variant}: {k9_resources[variant]}")

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

    # Phase 3: K2 (both channel sets, query heads included) against its plain
    # version (`_queries` + `reproject_window_plain`) on the card at 1920x1080,
    # alone and with its tail.
    log("phase 3: reprojection kernel (K2) vs plain, on the card")
    rng = np.random.default_rng(0)

    def random_channel():
        return Channel(
            rgb=torch.from_numpy(rng.uniform(0, 2, (H, W, 3)).astype(np.float32)).to(dev),
            cnt=torch.from_numpy(rng.integers(0, 17, (H, W)).astype(np.float32)).to(dev),
            oid=ref["oid"].clone(),
        )

    hl, sl = passes.reprojection_anchors(scene, camera(1), ref, cfg.fov, H)
    hist, hist_s = random_channel(), random_channel()
    K = min(cfg.reproject_window, rk.MAX_WINDOW)
    k2_args = (camera(0), hl, sl, ref["oid"], hist, hist_s, cfg.fov)
    before = rk.LAUNCHES
    k2_out = rk.reproject_window(*k2_args, window=K)
    torch.cuda.synchronize()
    k2_launches = rk.LAUNCHES - before
    k2_ref = rk.reproject_frame_plain(*k2_args, K, H)
    k2_err = max((a - b).abs().max().item() for got, want in zip(k2_out, k2_ref) for a, b in zip(got, want))
    k2_bitwise = all(torch.equal(a, b) for got, want in zip(k2_out, k2_ref) for a, b in zip(got, want))
    rgb_k, cnt_k = k2_out[0]
    log(f"  {W}x{H} K={K}, both sets in {k2_launches} launch: max |d| {k2_err:.3g}, bitwise {k2_bitwise}; mean "
        f"reprojected count diffuse {cnt_k.mean().item():.4f}, specular {k2_out[1][1].mean().item():.4f}")
    for got, want in zip(k2_out, k2_ref):
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)
    if k2_launches != 1:
        raise AssertionError(f"reproject_window launched K2 {k2_launches} times, not once")
    if cnt_k.mean().item() <= 1.0:
        raise AssertionError("K2 check carried almost no history; the check is vacuous")

    # K2 with its tail (`reproject_tail`), the launch the main path makes: the
    # rays and anchors built in the kernel from K1's planes, the same
    # histories, the camera moved by TAIL_MOVE so the velocity clamp cuts
    # counts, against `tail_plain` on the card.
    cam_t = Camera(loc=camera(1).loc + torch.tensor(TAIL_MOVE, device=dev), orient=camera(1).orient)
    tail_args = (scene, cam_t, camera(0), ref, hist, hist_s, cfg)
    before = (rk.LAUNCHES, rk.TAIL_LAUNCHES)
    tail_out = rk.reproject_tail(*tail_args)
    torch.cuda.synchronize()
    tail_launches = (rk.LAUNCHES - before[0], rk.TAIL_LAUNCHES - before[1])
    tail_err = hold_tail(tail_out, tail_plain(*tail_args), f"{W}x{H} K={K}, K2 with its tail in {tail_launches[0]} "
                         "launch vs reproject_frame_plain + accumulate x2 + composite_from")
    vv = gmath.length(cam_t.loc - camera(0).loc)
    floor = passes.count_floor(k2_ref[0][1])
    cut = (passes._temporal_clamp(k2_ref[0][0], floor, vv, cfg)[1] < floor).sum().item()
    vv = vv.item()
    log(f"  camera speed {vv:.4g}; diffuse counts the clamp cut {cut} of {W * H}; mean new diffuse count "
        f"{tail_out[1].cnt.mean().item():.4f}")
    if tail_launches != (1, 1):
        raise AssertionError(f"reproject_tail launched K2 {tail_launches[0]} times, {tail_launches[1]} with its "
                             "tail, not once")
    if vv <= 0.0 or cut == 0:
        raise AssertionError("K2's tail check cut no count; the clamp went untested")

    # Phase 4: the main path, through the kernels.
    log(f"phase 4: main path, render_animation 8 frames at {W}x{H} on the card")
    cams = [camera(i) for i in range(8)]
    stacked = Camera(loc=torch.stack([c.loc for c in cams]),
                     orient=torch.stack([c.orient for c in cams]))
    fk.LAUNCHES = 0
    rk.LAUNCHES = rk.TAIL_LAUNCHES = 0
    image, history = driver.render_animation(scene, cfg, num_frames=8, cameras=stacked)
    torch.cuda.synchronize()
    launches = {"frame": fk.LAUNCHES, "reproject": rk.LAUNCHES, "reproject tail": rk.TAIL_LAUNCHES}
    mean_cnt = history.diffuse.cnt.mean().item()
    log(f"  launches {launches}; image {tuple(image.shape)} range "
        f"[{image.min().item():.4f}, {image.max().item():.4f}]; mean diffuse count {mean_cnt:.4f}")
    if not (torch.isfinite(image).all() and image.min() >= 0.0 and image.max() <= 1.0):
        raise AssertionError("main path image not finite in [0, 1]")
    if image.shape != (H, W, 3):
        raise AssertionError(f"main path image shape {tuple(image.shape)}")
    if launches != {"frame": 8, "reproject": 8, "reproject tail": 8}:
        raise AssertionError(f"main path did not run through K1 and K2 with its tail: {launches}")
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
    f0 = inverse.SEED_BASE
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
    res = inverse.run_recovery(num_spheres=10, steps=800, width=192, height=128, views=5,
                               betas=(0.05, 0.02, 0.008, 0.003), log_every=1)
    torch.cuda.synchronize()
    rec_launches = {"frame": fk.LAUNCHES, "backward": fg.LAUNCHES, "loss": lk.LAUNCHES}
    log(f"  {res['steps']} steps; launches {rec_launches}")
    log(f"  loss {res['loss_initial']:.6g} -> {res['loss_final']:.6g}; err_position "
        f"{res['err_position']:.6g}, err_radius {res['err_radius']:.6g}, err_albedo "
        f"{res['err_albedo']:.6g}")
    if rec_launches["frame"] == 0 or rec_launches["loss"] == 0:
        raise AssertionError(f"run_recovery did not run through K1 and K6: {rec_launches}")
    if not (res["err_position"] < 0.01 and res["err_radius"] < 0.005
            and res["err_albedo"] < 0.01 and res["loss_final"] < res["loss_initial"]):
        raise AssertionError(f"recovery missed its bounds: {res}")

    # Phase 12: the gradient kernels at 1920x1080, all tables, against their
    # plain versions.
    log(f"phase 12: gradient kernels at {W}x{H} vs plain [{card}]")
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
    # The recovery view's target, as run_recovery hands it to K6 (phase 22's
    # tiled step at that view).
    c_rec = RenderConfig(width=192, height=128, soft_shadows=0.05, pipeline="fused")
    target_rec = inverse.render_once(truth, views[0], c_rec, f0)

    # Phase 13: the raycast (K3) at 1920x1080 from two views, (a) bench.py's
    # (CAM_ORIENT; the box is the nearest hit nowhere) and (b) one aimed at
    # the rounded box (BOX_AIMED), each held bitwise to its plain version
    # (check_agreement's stats logged beside), (a) also against the G-buffer
    # module at check_agreement's bars.
    log(f"phase 13: geometry pass (K3), the raycast at {W}x{H} on the card, views (a) orient {CAM_ORIENT} and "
        f"(b) orient {BOX_AIMED}")
    raycast_launches, k3_err = 0, 0.0
    for key, cam_v in (("a", camera()), ("b", Camera.create(loc=CAM_LOC, orient=BOX_AIMED, device=dev))):
        geo_k.LAUNCHES = 0
        geo = geo_k.geometry_pass(scene, cam_v, 0, cfg)
        torch.cuda.synchronize()
        if geo_k.LAUNCHES != 1:
            raise AssertionError(f"the raycast from view ({key}) did not run through K3 once: "
                                 f"{geo_k.LAUNCHES} launches")
        raycast_launches += geo_k.LAUNCHES
        geo_plain = geo_k.geometry_pass_plain(scene, cam_v, 0, cfg)
        stats = geo_k.check_agreement(geo, geo_plain, f"K3 vs plain {W}x{H} view ({key})")
        err = max((geo[k] - geo_plain[k]).abs().max().item() for k in ("depth", "curv", "normal"))
        k3_err = max(k3_err, err)
        log(f"  view ({key}) K3 vs plain: {stats}; largest |diff| {err}; hit share "
            f"{(geo['oid'] > 0).float().mean().item():.4f}, box share "
            f"{torch.isin(geo['oid'], scene.box_ids).float().mean().item():.4f}")
        unequal = [k for k in geo if not torch.equal(geo[k], geo_plain[k])]
        if unequal:
            raise AssertionError(f"K3 vs plain {W}x{H} view ({key}): not bitwise on {unequal}")
        if key == "a":
            gbuf = gbuffer.geometry_pass(scene, cam_v, cfg)
            gb_stats = geo_k.check_agreement(
                geo, {"depth": gbuf.depth, "curv": gbuf.curv, "normal": gbuf.normal, "oid": gbuf.obj_id},
                f"K3 vs gbuffer.geometry_pass {W}x{H}")
            log(f"  view (a) K3 vs gbuffer.geometry_pass: {gb_stats}")

    # Phase 14: K7 against its plain version on the card.
    log("phase 14: path kernel (K7) vs plain, on the card")
    config3, cam3, cfg3 = bench_configs.config3_case(dev)
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
    pk.LAUNCHES = pk.TONEMAP_LAUNCHES = 0
    img = wavefront.render_pathtraced(scene, camera(), cfg_pt, 0)
    torch.cuda.synchronize()
    path_launches = pk.LAUNCHES
    log(f"  render_pathtraced: launches {path_launches}, tonemapped {pk.TONEMAP_LAUNCHES}; image "
        f"{tuple(img.shape)} range [{img.min().item():.4f}, {img.max().item():.4f}], mean {img.mean().item():.4f}")
    if (path_launches, pk.TONEMAP_LAUNCHES) != (1, 1):
        raise AssertionError(f"render_pathtraced did not run through K7's tonemap once: {path_launches}, "
                             f"{pk.TONEMAP_LAUNCHES}")
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
    ref_pt = pk.pathtrace_plain(scene, camera(), cfg_pt, 0)
    img_pt = pk.pathtrace(scene, camera(), cfg_pt, 0)
    stats = pk.check_agreement(img_pt, ref_pt, f"K7 vs plain {W}x{H}")
    log(f"  K7 vs plain, {W}x{H} 4 spp depth 6: {stats}; bitwise {torch.equal(img_pt, ref_pt)}")
    tonemapped = color.linear_srgb(color.aces_fitted(img_pt * cfg_pt.brightness))
    log(f"  render_pathtraced vs the plain tonemap of K7's HDR: largest |diff| "
        f"{(img - tonemapped).abs().max().item()}")
    if not torch.equal(img, tonemapped):
        raise AssertionError("render_pathtraced: K7's tonemap is not bitwise the plain chain")
    k7_err = max(k7_err, stats["max"])

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
        log(f"  K8 vs the split frame (K1 + K2 with its tail) on the same inputs, within the bar: {stats}")
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
        if cli_launches != {"frame": 2, "reproject": 2} or len(records) != 2:
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
    want = {"split": {"frame": 6, "frame rows": 6, "reproject": 6, "reproject tile": 6, "reproject tail": 6,
                      "frame_hist": 0, "frame_hist tile": 0},
            "mono": {"frame": 0, "frame rows": 0, "reproject": 0, "reproject tile": 0, "reproject tail": 0,
                     "frame_hist": 6, "frame_hist tile": 6}}
    if tile_launches != want:
        raise AssertionError(f"the tiled frames did not run through the tile modes: {tile_launches}")

    # Each tile mode against its plain version on the middle tile (both
    # halos real), frame 1's inputs.
    r0, cam1 = rows_t, tile_camera(1, dev)
    win = shard.tile_window(hist0, r0, rows_t, halo_t)
    k1r = fk.frame_forward(scene, cam1, 1, cfg, r0, rows_t)
    torch.cuda.synchronize()
    k1r_ref = fk.frame_forward_plain(scene, cam1, 1, cfg, r0, rows_t)
    k1r_stats = frame_agreement(k1r, k1r_ref, f"K1 row mode, rows [{r0}, {r0 + rows_t})")
    hl_t, sl_t = passes.reprojection_anchors(scene, cam1, k1r_ref, cfg.fov, H, r0)
    k2t_args = (hist0.camera, hl_t, sl_t, k1r_ref["oid"], win.diffuse, win.specular, cfg.fov)
    before = rk.TILE_LAUNCHES
    k2t_out = rk.reproject_window(*k2t_args, window=K, image_height=H, row_base=r0, hist_halo=halo_t)
    torch.cuda.synchronize()
    k2t_launches = rk.TILE_LAUNCHES - before
    k2t_ref = rk.reproject_frame_plain(*k2t_args, K, H, r0, halo_t)
    k2t_err = max((a - b).abs().max().item() for got, want in zip(k2t_out, k2t_ref) for a, b in zip(got, want))
    k2t_bitwise = all(torch.equal(a, b) for got, want in zip(k2t_out, k2t_ref) for a, b in zip(got, want))
    cnt_kt = k2t_out[0][1]
    log(f"  K2 tile mode, rows [{r0}, {r0 + rows_t}) of {H}, {halo_t}-row halo, K={K}, both sets: max |d| "
        f"{k2t_err:.3g}, bitwise {k2t_bitwise}; mean reprojected count {cnt_kt.mean().item():.4f}")
    for got, want in zip(k2t_out, k2t_ref):
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)
    # K2 tile mode with its tail, the sharded split frame's launch, the
    # camera moved by TAIL_MOVE.
    cam1_t = Camera(loc=cam1.loc + torch.tensor(TAIL_MOVE, device=dev), orient=cam1.orient)
    tail_t_args = (scene, cam1_t, hist0.camera, k1r_ref, win.diffuse, win.specular, cfg)
    tail_t_kw = dict(image_height=H, row_base=r0, hist_halo=halo_t)
    before = (rk.LAUNCHES, rk.TILE_LAUNCHES, rk.TAIL_LAUNCHES)
    tail_t_out = rk.reproject_tail(*tail_t_args, **tail_t_kw)
    torch.cuda.synchronize()
    tail_t_launches = tuple(n - b for n, b in zip((rk.LAUNCHES, rk.TILE_LAUNCHES, rk.TAIL_LAUNCHES), before))
    tail_t_err = hold_tail(tail_t_out, tail_plain(*tail_t_args, **tail_t_kw),
                           f"K2 tile mode with its tail, rows [{r0}, {r0 + rows_t}), launches (all, tile, tail) "
                           f"{tail_t_launches}")
    if tail_t_launches != (1, 1, 1):
        raise AssertionError(f"reproject_tail in tile mode launched {tail_t_launches}, not one tile launch with "
                             "its tail")
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

    # Phase 22: the tiled training step in this process, the tiles' losses
    # and gradients summed as train_step_tiled's all-reduce sums them.
    log(f"phase 22: tiled training step (K1 + K5 row mode), {TILES} tiles at {W}x{H} and 2 at the 192x128 "
        "recovery view, against the unsharded train_step")

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
    resume_launches = sharded_resume(scene, camera(), target_1080, cfg_f, opt_t, dev)
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

    # Phase 24: the op-mix probe (K9), every variant against its plain
    # version at 64x1920, then its sweep at 1080x1920 through bench_ceiling,
    # each variant's output held to its plain version there too.
    log("phase 24: op-mix probe (K9) vs plain at 64x1920 for every variant, bitwise, on the probe's planes and on "
        f"numpy-seeded planes in [-2, 2), then the sweep at {ck.W}x{ck.H}, each output bitwise its plain version")
    rng9 = np.random.default_rng(9)
    planes9 = {"probe's planes": bench_ceiling.inputs(dev, 64, W),
               "seeded planes": [torch.from_numpy(rng9.uniform(-2, 2, (64, W)).astype(np.float32)).to(dev)
                                 for _ in range(2)]}
    for variant in ck.KERNEL_VARIANTS:
        for what, (x_s, y_s) in planes9.items():
            got, ref9 = ck.mix(x_s, y_s, *variant), ck.mix_plain(x_s, y_s, *variant)
            torch.cuda.synchronize()
            off = ck.differing(got, ref9)
            finite = torch.isfinite(ref9)
            log(f"  K9 {variant}, {what}: {off} of {ref9.numel()} differ (NaN equal to NaN); "
                f"{finite.float().mean().item():.4f} finite, {torch.isnan(ref9).float().mean().item():.4f} NaN, "
                f"range [{ref9.min().item():.4g}, {ref9.max().item():.4g}]")
            if off:
                raise AssertionError(f"K9 {variant} is not bitwise its plain version on the {what}: {off} differ")
    x_f, y_f = bench_ceiling.inputs(dev)
    ck.LAUNCHES = 0
    k9_sweep, k9_outs = bench_ceiling.sweep(dev, planes=(x_f, y_f))
    torch.cuda.synchronize()
    k9_launches = ck.LAUNCHES
    k9_err = bench_ceiling.check(k9_outs, (x_f, y_f))
    del k9_outs
    log(f"  the sweep's {len(k9_sweep)} outputs at {ck.W}x{ck.H} bitwise their plain versions (max |diff| over the "
        f"finite elements {k9_err})")

    # Phases 25-27: the sphere trace and the gradients through the
    # intersectors, with K3, K1 + K5 and K6 as witnesses.
    witnesses = march_phases(dev, card)
    log(f"  witness launches in phases 25-27: {witnesses}")

    # Phases 28-31: checkpoint and resume, the invert CLI, the fly-cam, info,
    # the native library and the metrics helpers.
    app_counts = app_phases(dev, card, res)
    log(f"  launches in phases 28-30: {app_counts}; phase 22's resume: {resume_launches}")

    # Phase 32: the three benches as a user runs them.
    torch.cuda.empty_cache()
    bench_phase(card)

    def entry(name, source, replaces, launches, err):
        return {"name": name, "route": "cuda", "source": f"kylespathtracer_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err}

    # K2's two routes: the main path's split frames (phases 4, 28-30; the
    # sharded tiles of phase 23) run it with its tail; the tap sums alone
    # (`reproject_window`) launch here in phases 3 and 21, and in bench.py.
    jax_ops = "kylespathtracer_tpu/ops/"
    kernels = [
        entry("frame_forward", "frame_kernel.cu", jax_ops + "frame_kernel.py:381",
              launches["frame"] + app_counts["frame"] + resume_launches["frame"], k1_stats["max_abs"]),
        entry("reproject_window", "reproject_kernel.cu", jax_ops + "reproject_kernel.py:290", k2_launches, k2_err),
        entry("reproject_tail", "reproject_kernel.cu", jax_ops + "reproject_kernel.py:290",
              launches["reproject tail"] + app_counts["reproject"], tail_err),
        entry("frame_backward", "frame_grad.cu", jax_ops + "frame_grad.py:189",
              train_launches["backward"] + resume_launches["backward"], k5_err),
        entry("render_loss_and_grad", "loss_kernel.cu", jax_ops + "loss_kernel.py:216",
              rec_launches["loss"] + app_counts["loss"], k6_err),
        entry("geometry_pass", "geometry_kernel.cu", jax_ops + "frame_kernel.py:494", raycast_launches, k3_err),
        entry("pathtrace", "path_kernel.cu", jax_ops + "path_kernel.py:469", path_launches, k7_err),
        entry("frame_hist", "frame_hist.cu", jax_ops + "frame_hist.py:344", mono_launches["frame_hist"],
              k8_stats["max_abs"]),
        entry("dual_mis", "shade_kernel.cu", jax_ops + "shade_kernel.py:836", pass_launches["dual_mis"],
              k4_stats["max_abs"]),
        entry("frame_forward (rows)", "frame_kernel.cu", jax_ops + "frame_kernel.py:299",
              rank_launches["frame rows"], k1r_stats["max_abs"]),
        entry("reproject_window (tile)", "reproject_kernel.cu", jax_ops + "reproject_kernel.py:211",
              k2t_launches, k2t_err),
        entry("reproject_tail (tile)", "reproject_kernel.cu", jax_ops + "reproject_kernel.py:211",
              rank_launches["reproject tile"], tail_t_err),
        entry("frame_hist (tile)", "frame_hist.cu", jax_ops + "frame_hist.py:241", rank_launches["frame_hist tile"],
              k8t_stats["max_abs"]),
        entry("frame_backward (rows)", "frame_grad.cu", jax_ops + "frame_grad.py:117", rank_launches["backward rows"],
              k5r_err),
        entry("mix_ceiling", "ceiling_kernel.cu", "bench_ceiling.py:194", k9_launches, k9_err),
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
