"""BASELINE.json's configuration matrix on the card.

    python -m kylespathtracer_tpu_torch.bench_configs [round] [--out DIR]

The port's counterpart of bench_configs.py: the five named configurations
as BASELINE.json specifies them, each held to the JAX file's correctness
bar, with its time where the JAX file times it:

  1. One diffuse sphere on a ground plane, 1 spp, 256×256, direct light
     only, the pass pipeline — against a NumPy re-execution of the GLSL
     math (`oracle_direct_light`, on cpu_reference/glslref.py). Bars:
     median |Δ| < 1e-5, under 1% of the components beyond 3e-2.
  2. A Cornell-style sphere scene with full MIS, 4 samples in every
     strategy, 512×512 — the fused frame (K1) against the pass pipeline
     (plain; shade_backend "xla" as in JAX), the fused frame timed. Bars:
     < 1e-5, < 2%.
  3. Mirror, dielectric and diffuse spheres, 4 spp, depth 6, 512×512 — the
     path kernel (K7) against the XLA-style integrator
     (path_backend="xla"), K7 timed. Bars: < 1e-4, < 2%.
  4. The reference's pose spline, 8 frames of diffuse and specular
     temporal accumulation at 1920×1080 — the fused frame (K1 + K2)
     against the pass pipeline; every pixel beyond 3e-2 classified
     (`classify_flips`) against object-ID, checker-cell and history-count
     edges (the G-buffers from K3) dilated by 2 px. Bars: under 0.5% of
     the components beyond 3e-2, 2 < mean history count ≤ 16, the
     classification's `boundary_ok`; the fused frame timed.
  5. Inverse rendering: `run_recovery` (the RECOVERY recipe: 10 spheres, 800
     steps, 192×128, 5 views, β 0.05 → 0.003; K6) held to err_position <
     0.01, err_radius < 0.005, err_albedo < 0.01, and the sharded witness
     (`dryrun.dryrun_multichip`) on 8 ranks.

Times are bench.py's event slope (bench.event_slope) over the JAX file's
K values. One JSON line per configuration on stdout, then the summary
(round, the card, all_passed). Exits non-zero unless every configuration
passed (a configuration that raises is recorded with its error), and
without a CUDA device. `--out DIR` writes configs.json and recovery.json
into DIR, a new directory (refused if it exists); nothing is written
without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from kylespathtracer_tpu_torch import bench
from kylespathtracer_tpu_torch.cpu_reference import glslref as ref
from kylespathtracer_tpu_torch.render.camera import Camera, camera_pose_spline, ray_dirs
from kylespathtracer_tpu_torch.render.pipeline import init_history, render_frame
from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene
from kylespathtracer_tpu_torch.scene.types import BSDF
from kylespathtracer_tpu_torch.utils.config import RenderConfig
from kylespathtracer_tpu_torch.utils.metrics import card_line

# Object IDs of the default scene whose checker cells config 4 classifies:
# the box (4³ cells per unit) and the floor and ceiling (unit cells;
# common.glsl:244,250).
BOX_ID, CHECKER_PLANE_IDS = 4, (2, 7)
# The sharded witness's ranks (the JAX file's 8 virtual devices).
WITNESS_RANKS = 8


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def img_diff(a, b) -> dict:
    d = np.abs(_np(a) - _np(b))
    return {
        "median_abs": float(np.median(d)),
        "frac_gt_3e-2": float((d > 3e-2).mean()),
        "finite": bool(np.isfinite(_np(a)).all()),
    }


def step_ms(step, ks, tag: str, device, reps: int = 2) -> tuple[float, dict]:
    """Milliseconds of one step(i) by bench.event_slope (each step from the
    same inputs, as the JAX file's scans are)."""
    return bench.event_slope(lambda _, i: step(i), None, ks, tag, device, reps=reps)


# ---------------------------------------------------------------- config 1

def oracle_direct_light(scene, cam, W, H, frame=0) -> np.ndarray:
    """NumPy re-execution of the GLSL math for the direct-light-only frame
    on a sphere(+floor) scene (bench_configs.py:_oracle_direct_light):
    raygen (geometry.frag:38-39,67), analytic nearest hit, per-pixel Weyl
    seed (common.glsl:39-41), cone light sample + solid-angle pdf
    (common.glsl:300-305), biased light contribution (common.glsl:348-353),
    Lambert/Phong weights, composite + ACES + sRGB (passthrough.frag:29-47).
    Reads the port's scene and camera as numpy."""
    planes = _np(scene.planes)
    plane_ids = _np(scene.plane_ids)
    spheres = _np(scene.spheres)
    sphere_ids = _np(scene.sphere_ids)
    light = spheres[int(scene.light_index)]
    light_color = _np(scene.light_color)
    mats = {f.name: _np(getattr(scene.materials, f.name)) for f in dataclasses.fields(scene.materials)}
    light_id = int(sphere_ids[int(scene.light_index)])

    asp = W / H
    px = np.arange(W, dtype=np.float32)[None, :] + 0.5
    py = np.arange(H, dtype=np.float32)[:, None] + 0.5
    x = (2 * px / W - 1) * asp + np.zeros((H, W), np.float32)
    y = (2 * py / H - 1) + np.zeros((H, W), np.float32)
    z = np.full((H, W), ref.FOV, np.float32)
    d = np.stack([x, y, z], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rd = ref.rotate_xy(d.astype(np.float32), _np(cam.orient))
    ro = _np(cam.loc)

    def nearest(o, dirs, excl):
        best_t = np.full(dirs.shape[:-1], 1e9, np.float32)
        best_id = np.zeros(dirs.shape[:-1], np.int32)

        def consider(t, oid, valid):
            nonlocal best_t, best_id
            v = valid & (t > 0) & (oid != excl) & (t < best_t)
            best_t = np.where(v, t, best_t)
            best_id = np.where(v, oid, best_id)

        for p in range(planes.shape[0]):
            n = planes[p, :3]
            w = planes[p, 3]
            denom = dirs @ n
            sd0 = (o * n).sum(-1) + w
            t = -sd0 / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
            consider(t.astype(np.float32), plane_ids[p], denom < -1e-7)
        for s in range(spheres.shape[0]):
            oc = o - spheres[s, :3]
            b = (oc * dirs).sum(-1)
            c2 = (oc * oc).sum(-1) - spheres[s, 3] ** 2
            disc = b * b - c2
            t = (-b - np.sqrt(np.maximum(disc, 1e-12))).astype(np.float32)
            consider(t, sphere_ids[s], disc > 0)
        t = best_t - ref.EPS
        miss = (t > ref.ZFAR) | (best_id == 0)
        return np.where(miss, ref.ZFAR, t), np.where(miss, 0, best_id)

    t, oid = nearest(ro, rd, -1)
    hl = ro + rd * t[..., None]
    hit = oid > 0
    hn = np.zeros_like(hl)
    for p in range(planes.shape[0]):
        hn = np.where((oid == plane_ids[p])[..., None], planes[p, :3], hn)
    for s in range(spheres.shape[0]):
        dv = hl - spheres[s, :3]
        nv = dv / np.maximum(np.linalg.norm(dv, axis=-1, keepdims=True), 1e-12)
        hn = np.where((oid == sphere_ids[s])[..., None], nv, hn)
    hn = np.where(hit[..., None], hn, 0.0)

    # Per-pixel Weyl seed + cone sample toward the light.
    pxi = np.arange(W, dtype=np.int64)[None, :] + np.zeros((H, W), np.int64)
    pyi = np.arange(H, dtype=np.int64)[:, None] + np.zeros((H, W), np.int64)
    seed = ref.gen_seed(frame, pxi, pyi, W, H)
    lv = (light[:3] - hl).astype(np.float32)
    dl = ref.uniform_cone_dir(lv, light[3], seed).astype(np.float32)
    pdf = ref.solid_angle((lv * lv).sum(-1), light[3] ** 2).astype(np.float32)
    _, vid = nearest(hl, dl, oid)
    base = np.where((vid == light_id)[..., None], light_color, 0.0)

    lam = np.maximum(ref.EPS, (dl * hn).sum(-1))
    refl = rd - 2 * (rd * hn).sum(-1, keepdims=True) * hn
    pho = np.maximum(ref.EPS, (dl * refl).sum(-1)) ** 5.0

    # Materials (scene/materials.surface semantics).
    def surface(o_ids, pts):
        alb = np.zeros(pts.shape, np.float32)
        emi = np.zeros(pts.shape, np.float32)
        ene = np.zeros(pts.shape[:-1] + (2,), np.float32)
        for k in range(mats["s0"].shape[0]):
            sel = o_ids == k
            fq = mats["freq"][k]
            sv = (np.floor(pts[..., 0] * fq) + np.floor(pts[..., 1] * fq)
                  + np.floor(pts[..., 2] * fq))
            checker = np.abs(np.mod(sv, 2.0))
            sval = mats["s0"][k] + mats["s1"][k] * checker
            alb = np.where(sel[..., None], mats["alb_const"][k] + mats["alb_scale"][k] * sval[..., None], alb)
            emi = np.where(sel[..., None], mats["emission"][k], emi)
            ene = np.where(sel[..., None], mats["en_const"][k] + mats["en_scale"][k] * sval[..., None], ene)
        return alb, emi, ene

    alb, emi, ene = surface(oid, hl)
    shade = hit & (oid != light_id)
    est_d = emi + np.where(shade[..., None], base * (pdf * lam)[..., None], 0.0)
    est_s = emi + np.where(shade[..., None], base * (pdf * pho)[..., None], 0.0)

    pos = alb > 0
    alb_sqrt = np.where(pos, np.sqrt(np.where(pos, alb, 1.0)), 0.0)
    img = est_d * alb * ene[..., 0:1] + est_s * alb_sqrt * ene[..., 1:2]
    img = ref.aces_fitted((img * np.float32(10.0)).astype(np.float32))
    return ref.linear_srgb(img).astype(np.float32)


def config1_case(device, size: int = 256):
    """(scene, camera, config) of config 1 at size × size."""
    scene = sphere_scene(centers=[[0.0, 1.0, 6.0]], radii=[1.0], albedos=[[0.7, 0.3, 0.2]], device=device)
    cam = Camera.create(loc=(0.0, 2.0, -2.0), orient=(-0.15, 0.0), device=device)
    cfg = RenderConfig(
        width=size, height=size, no_history=True, pipeline="pass",
        smp_direct_lambert=1, smp_lambert_surface_lambert=0,
        smp_lambert_surface_phong=0, smp_direct_phong=1,
        smp_phong_surface_lambert=0, smp_phong_surface_phong=0,
    )
    return scene, cam, cfg


def config1(device, size: int = 256) -> dict:
    scene, cam, cfg = config1_case(device, size)
    t0 = time.perf_counter()
    img, _ = render_frame(scene, cam, init_history(cfg, cam, device=device), 0, cfg)
    img = _np(img)
    first_s = time.perf_counter() - t0
    diff = img_diff(img, oracle_direct_light(scene, cam, size, size))
    ok = diff["finite"] and diff["median_abs"] < 1e-5 and diff["frac_gt_3e-2"] < 0.01
    return {
        "name": f"direct-light-sphere-plane-{size}",
        "spec": f"1 diffuse sphere + ground plane, 1spp, {size}x{size}, direct light only, vs CPU GLSL-math "
                "re-execution",
        "passed": bool(ok), "diff": diff, "first_frame_s": first_s,
    }


# ---------------------------------------------------------------- config 2

def config2(device) -> dict:
    W = H = 512
    rng = np.random.default_rng(7)
    scene = sphere_scene(
        centers=np.stack([rng.uniform(-4, 4, 6), rng.uniform(0.7, 3.5, 6), rng.uniform(4, 10, 6)], axis=-1),
        radii=rng.uniform(0.5, 1.0, 6),
        albedos=rng.uniform(0.2, 0.9, (6, 3)),
        device=device,
    )
    cam = Camera.create(loc=(0.0, 3.0, -4.0), orient=(-0.15, 0.0), device=device)
    smp4 = {f"smp_{k}": 4 for k in (
        "direct_lambert", "lambert_surface_lambert", "lambert_surface_phong",
        "direct_phong", "phong_surface_lambert", "phong_surface_phong")}
    cfgs = {pipe: RenderConfig(width=W, height=H, no_history=True, pipeline=pipe, **smp4) for pipe in ("fused", "pass")}
    hist = init_history(cfgs["fused"], cam, device=device)
    imgs = {pipe: render_frame(scene, cam, hist, 0, cfg)[0] for pipe, cfg in cfgs.items()}
    diff = img_diff(imgs["fused"], imgs["pass"])
    ms, timing = step_ms(lambda i: render_frame(scene, cam, hist, i, cfgs["fused"]), (2, 8, 14), "config2_fused",
                         device)
    ok = diff["finite"] and diff["median_abs"] < 1e-5 and diff["frac_gt_3e-2"] < 0.02
    return {
        "name": "cornell-mis-4spp-512",
        "spec": "Cornell-style sphere scene, full MIS (BSDF+light), 4spp, 512x512, fused vs pass",
        "passed": bool(ok), "diff": diff,
        "frame_ms": ms, "rays_per_s": W * H * 4 / (ms * 1e-3), "timing": timing,
    }


# ---------------------------------------------------------------- config 3

def config3_case(device):
    """(scene, camera, config) of config 3: a mirror, a dielectric and a
    diffuse sphere on a floor (bench_configs.py:282-289), 512×512, 4 spp,
    depth 6."""
    scene = sphere_scene(
        centers=[[-1.5, 1.0, 6.0], [1.5, 1.2, 6.5], [0.0, 0.8, 4.5]],
        radii=[1.0, 1.2, 0.8],
        albedos=[[0.9, 0.9, 0.9], [0.7, 0.8, 0.9], [0.9, 0.6, 0.5]],
        kinds=[BSDF.MIRROR, BSDF.DIELECTRIC, BSDF.DIFFUSE],
        iors=[1.5, 1.5, 1.5],
        device=device,
    )
    cam = Camera.create(loc=(0.0, 2.0, -2.0), orient=(-0.1, 0.0), device=device)
    return scene, cam, RenderConfig(width=512, height=512, spp=4, max_depth=6)


def config3(device) -> dict:
    from kylespathtracer_tpu_torch.render import wavefront as wf

    scene, cam, cfg = config3_case(device)
    spp, depth = cfg.spp, cfg.max_depth
    imgs = {backend: wf.render_pathtraced(scene, cam, dataclasses.replace(cfg, path_backend=backend), 0)
            for backend in ("auto", "xla")}
    diff = img_diff(imgs["auto"], imgs["xla"])
    ms, timing = step_ms(lambda i: wf.render_pathtraced(scene, cam, cfg, i), (1, 4, 7), "config3_path", device)
    ok = diff["finite"] and diff["median_abs"] < 1e-4 and diff["frac_gt_3e-2"] < 0.02
    return {
        "name": "dielectric-depth6",
        "spec": "specular/dielectric BSDFs, PCG+R2 sampler, 4spp, depth 6, 512x512, path kernel vs scan integrator",
        "passed": bool(ok), "diff": diff,
        "frame_ms": ms, "segments_per_s": cfg.width * cfg.height * spp * depth / (ms * 1e-3), "timing": timing,
    }


# ---------------------------------------------------------------- config 4

def _edges(a: np.ndarray) -> np.ndarray:
    """bool[H,W]: pixels that differ from a 4-neighbour (np.roll: the image
    wraps), over a trailing channel axis when `a` has one more."""
    out = np.zeros(a.shape[:2], bool)
    for ax, s in ((0, 1), (0, -1), (1, 1), (1, -1)):
        ne = np.roll(a, s, axis=ax) != a
        out |= ne.any(axis=-1) if ne.ndim == 3 else ne
    return out


def classify_flips(d_img: np.ndarray, gbuffers, counts) -> dict:
    """Classify the pixels where two renders part by more than 3e-2
    (bench_configs.py:368-419). Every such pixel must lie on the union of
    (a) geometric decision boundaries — object-ID edges and checker-cell
    edges (4³ cells on the box, unit cells on the floor and ceiling), where
    a half-ulp difference in the hit flips the shaded object or the checker
    colour — and (b) history-state edges: pixels whose accumulated count
    differs from a 4-neighbour in any frame, where the bilinear history taps
    sit on a knife edge; the union dilated by 2 px for flips carried
    through the history. Interior pixels must agree essentially exactly.

    d_img: |Δ| f32[H,W,3]; gbuffers: per frame (oid i32[H,W], hit point
    f32[H,W,3]); counts: per frame (diffuse cnt, specular cnt) f32[H,W].
    → the JAX file's `boundary_classification` dict plus `boundary_ok`:
    interior share beyond 1e-3 under 1e-4 and, from 50 flagged pixels on
    (below that the on-mask ratio is counting noise), ≥ 95% of them on the
    mask."""
    flagged = (d_img > 3e-2).any(axis=-1)
    mask = np.zeros(flagged.shape, bool)
    for oid, hl in gbuffers:
        cell = np.zeros(hl.shape, np.int64)
        box = oid == BOX_ID
        plane = np.isin(oid, CHECKER_PLANE_IDS)
        cell[box] = np.floor(4 * hl[box]).astype(np.int64)
        cell[plane] = np.floor(hl[plane]).astype(np.int64)
        mask |= _edges(oid) | _edges(cell)
    for cd, cs in counts:
        mask |= _edges(cd) | _edges(cs)
    for _ in range(2):
        mask = mask | np.roll(mask, 1, 0) | np.roll(mask, -1, 0) | np.roll(mask, 1, 1) | np.roll(mask, -1, 1)
    interior = ~mask
    on_mask = float((flagged & mask).sum() / max(flagged.sum(), 1))
    # An empty interior (the mask covering every pixel) agrees vacuously.
    interior_bad = float((d_img[interior] > 1e-3).mean()) if interior.any() else 0.0
    return {
        "flagged_px_frac": float(flagged.mean()),
        "mask_frac": float(mask.mean()),
        "flagged_on_mask_frac": on_mask,
        "interior_frac_gt_1e-3": interior_bad,
        "interior_max_abs": float(d_img[interior].max()) if interior.any() else 0.0,
        "boundary_ok": bool(interior_bad < 1e-4 and (flagged.sum() < 50 or on_mask >= 0.95)),
    }


def spline_camera(i: int, device) -> Camera:
    """Frame i's camera on the reference's pose spline at t = 0.05·i (f32)."""
    loc, ori = camera_pose_spline(torch.tensor(float(i), dtype=torch.float32) * 0.05)
    return Camera(loc=loc.to(device), orient=ori.to(device))


def config4(device, frames: int = 8) -> dict:
    from kylespathtracer_tpu_torch.ops import geometry_kernel as geo_k

    W, H = 1920, 1080
    scene = default_scene(device=device)
    cams = [spline_camera(i, device) for i in range(frames)]

    def animated(pipe: str, keep_cnt: bool = False):
        cfg = RenderConfig(width=W, height=H, pipeline=pipe)
        hist = init_history(cfg, Camera.create(device=device), device=device)
        counts = []
        for i, cam in enumerate(cams):
            img, hist = render_frame(scene, cam, hist, i, cfg)
            if keep_cnt:
                counts.append((_np(hist.diffuse.cnt), _np(hist.specular.cnt)))
        return _np(img), hist, counts

    img_f, hist_f, _ = animated("fused")
    img_p, _, counts = animated("pass", keep_cnt=True)
    diff = img_diff(img_f, img_p)
    cnt_mean = hist_f.diffuse.cnt.mean().item()
    # Accumulation must build history under the slow pan.
    accum_ok = 2.0 < cnt_mean <= 16.0

    gcfg = RenderConfig(width=W, height=H)
    gbuffers = []
    for i, cam in enumerate(cams):
        g = geo_k.geometry_pass(scene, cam, i, gcfg)
        rd = _np(ray_dirs(cam, W, H, gcfg.fov))
        gbuffers.append((_np(g["oid"]), _np(cam.loc) + rd * _np(g["depth"])[..., None]))
    boundary = classify_flips(np.abs(img_f - img_p), gbuffers, counts)
    del gbuffers, counts

    cfg = RenderConfig(width=W, height=H, pipeline="fused")
    hist0 = init_history(cfg, Camera.create(device=device), device=device)
    ks = (2, 8, 14)
    path = [spline_camera(i, device) for i in range(max(ks))]
    ms, timing = step_ms(lambda i: render_frame(scene, path[i], hist0, i, cfg), ks, "config4_fused", device)
    ok = diff["finite"] and diff["frac_gt_3e-2"] < 0.005 and accum_ok and boundary["boundary_ok"]
    return {
        "name": "temporal-1080p",
        "spec": "animated camera (reference pose spline), diffuse+specular temporal accumulation, 1080p, fused vs "
                "pass after 8 frames; differing pixels classified as decision-boundary flips",
        "passed": bool(ok), "diff": diff,
        "boundary_classification": boundary,
        "history_cnt_mean": cnt_mean, "accum_ok": bool(accum_ok),
        "frame_ms": ms, "rays_per_s": W * H / (ms * 1e-3), "timing": timing,
    }


# ---------------------------------------------------------------- config 5

def config5(device, ranks: int = WITNESS_RANKS) -> dict:
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    result = inverse.run_recovery(num_spheres=10, steps=800, width=192, height=128, views=5,
                                  betas=(0.05, 0.02, 0.008, 0.003), device=device)
    wall = time.perf_counter() - t0
    errs = {k: result[k] for k in ("err_position", "err_radius", "err_albedo")}
    single_ok = errs["err_position"] < 0.01 and errs["err_radius"] < 0.005 and errs["err_albedo"] < 0.01
    try:
        witness = dryrun_multichip(ranks, device)
        sharded = {"ok": witness["ok"], "summary": witness["summary"], "checks": witness["checks"]}
    except (RuntimeError, StopIteration) as e:
        sharded = {"ok": False, "error": str(e)[-2000:]}
    return {
        "name": "inverse-10sphere-multihost",
        "spec": f"gradient recovery of 10-sphere scene (pos/radius/albedo) from 5-view seed-paired targets + "
                f"sharded train step == single-device on {ranks} ranks",
        "passed": bool(single_ok and sharded["ok"]),
        "errors": errs,
        "sharded_train_step_ok": bool(sharded["ok"]),
        "sharded": sharded,
        "wall_s": wall,
        "ms_per_step": wall / result["steps"] * 1e3,
        "recovery": result,
    }


CONFIGS = (config1, config2, config3, config4, config5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("round", nargs="?", help="a label for the record (bench_configs.py's round)")
    ap.add_argument("--out", type=Path, help="write configs.json and recovery.json into this new directory")
    args = ap.parse_args(argv)
    if args.out is not None and args.out.exists():
        sys.exit(f"bench_configs: {args.out} exists; give a new directory")
    if not torch.cuda.is_available():
        sys.exit("bench_configs: needs a CUDA device")
    device = torch.device("cuda")
    card = card_line()
    results = []
    for fn in CONFIGS:
        t0 = time.perf_counter()
        try:
            r = fn(device)
        except Exception as e:  # recorded and failed: the exit code says so
            r = {"name": fn.__name__, "passed": False, "error": f"{type(e).__name__}: {e}"[:2000],
                 "traceback": traceback.format_exc()[-4000:]}
        r["config_wall_s"] = time.perf_counter() - t0
        r["device"] = card
        results.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "recovery"}), flush=True)
    out = {
        "round": args.round,
        "device": card,
        "device_name": torch.cuda.get_device_name(0),
        "all_passed": all(r.get("passed") for r in results),
        "configs": results,
    }
    if args.out is not None:
        args.out.mkdir(parents=True)
        (args.out / "configs.json").write_text(json.dumps(out, indent=1))
        recovery = next((r.get("recovery") for r in results if r["name"] == "inverse-10sphere-multihost"), None)
        if recovery is not None:
            (args.out / "recovery.json").write_text(json.dumps(recovery, indent=1))
    print(json.dumps({"metric": "bench_configs", "round": args.round, "all_passed": out["all_passed"],
                      "device": card}), flush=True)
    return 0 if out["all_passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
