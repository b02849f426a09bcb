"""PyTorch port on the card: the CUDA kernels against their plain versions
on the same CUDA tensors, and the frame on the card against the CPU.

Marked `cuda`; each test skips without a CUDA device (decided in the
fixture, never at import). Run on a GPU machine with
`python -m pytest tests/test_torch_cuda.py -q --noconftest` (tests/conftest.py
imports jax, which a GPU machine need not have).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from kylespathtracer_tpu_torch import bench_ceiling
from kylespathtracer_tpu_torch.core import color
from kylespathtracer_tpu_torch.diff import inverse
from kylespathtracer_tpu_torch.ops import ceiling_kernel as ck
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import frame_hist as fh
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import geometry_kernel as gk
from kylespathtracer_tpu_torch.ops import loss_kernel as lk
from kylespathtracer_tpu_torch.ops import path_kernel as pk
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.ops import shade_kernel as sk
from kylespathtracer_tpu_torch.ops.adjoint_variants import BOX_AIMED, THREE_BOXES, VIEW_LOC
from kylespathtracer_tpu_torch.render import gbuffer, passes, pipeline, wavefront
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.render.passes import Channel
from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene
from kylespathtracer_tpu_torch.scene.types import BSDF, OBJ
from kylespathtracer_tpu_torch.utils.config import RenderConfig

pytestmark = pytest.mark.cuda

SMP2 = {k: 2 for k in (
    "smp_direct_lambert", "smp_lambert_surface_lambert",
    "smp_lambert_surface_phong", "smp_direct_phong",
    "smp_phong_surface_lambert", "smp_phong_surface_phong",
)}


# torch.profiler places each kernel on the host's clock from the device's,
# and on an H100 that mapping at times put kernels up to 4.6 ms before
# their launch; a kernel placed before the session's start is left out of
# its trace (tools/profiler_sessions.py: 65 of 18,402 sessions missed the
# kernel of a call made as the session opened, about every 10 s; with 10 ms
# of margin none of 3,819 did). The profiler tests wait this long on the
# host after a session starts and before it stops.
PROFILER_MARGIN_S = 0.02


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _spheres(device, with_floor=True):
    return sphere_scene(
        [[5.5, 1.0, 0.0], [4.0, 0.5, 1.0], [6.0, 2.5, -1.5]], [1.0, 0.5, 0.7],
        [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]],
        with_floor=with_floor, device=device,
    )


@pytest.mark.parametrize(
    "case",
    ["default", "unbiased", "smp2_decorrelate", "spheres_soft", "tile",
     "no_planes_unbiased"],
)
def test_frame_kernel_matches_plain(dev, case):
    scene = {
        "spheres_soft": lambda: _spheres(dev),
        "no_planes_unbiased": lambda: _spheres(dev, with_floor=False),
    }.get(case, lambda: default_scene(device=dev))()
    kw = {
        "default": {}, "unbiased": dict(biased=False),
        "smp2_decorrelate": dict(decorrelate_samples=True, **SMP2),
        "spheres_soft": dict(soft_shadows=0.05), "tile": {},
        "no_planes_unbiased": dict(biased=False),
    }[case]
    cfg = RenderConfig(width=160, height=96, **kw)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    rows = dict(row_base=24, rows=40) if case == "tile" else {}
    before = fk.LAUNCHES
    out = fk.frame_forward(scene, cam, 3, cfg, **rows)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == before + 1
    ref = fk.frame_forward_plain(scene, cam, 3, cfg, **rows)
    fk.check_agreement(out, ref, case)


def _reproject_case(dev, H, W, row0, rows, halo, seed):
    """K2's arguments (reproject_window's first seven) on the card: anchors
    at random depths along the rays of a camera near the previous one, so
    most reproject within the window; random object IDs and histories
    (rows + 2·halo rows from image row row0 - halo)."""
    from kylespathtracer_tpu_torch.render.camera import ray_dirs_window

    rng = np.random.default_rng(seed)
    prev = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.01, 0.69), device=dev)
    cam = Camera.create(loc=(3.002, 1.999, -3.001), orient=(0.0, 0.7), device=dev)
    depth = torch.from_numpy(rng.uniform(2.0, 8.0, (rows, W, 2)).astype(np.float32)).to(dev)
    rd = ray_dirs_window(cam, W, H, row0, rows, 1.5)
    hl = cam.loc + rd * depth[..., :1]
    sl = cam.loc + rd * depth[..., 1:]
    ho = torch.from_numpy(rng.integers(0, 4, (rows, W)).astype(np.int32)).to(dev)

    def channel():
        n = rows + 2 * halo
        return Channel(rgb=torch.from_numpy(rng.uniform(0.0, 2.0, (n, W, 3)).astype(np.float32)).to(dev),
                       cnt=torch.from_numpy(rng.integers(0, 17, (n, W)).astype(np.float32)).to(dev),
                       oid=torch.from_numpy(rng.integers(0, 4, (n, W)).astype(np.int32)).to(dev))

    return prev, hl, sl, ho, channel(), channel(), 1.5


def _k2_agrees(got, want):
    """K2 against its plain version: rgb within 1e-5 and the count within
    1e-4, and all four outputs of a pixel bitwise on >= 99.99% of pixels
    (a tap of the other side of a rounding boundary moves a pixel's sum by
    a whole history texel's share, far past those bars)."""
    same = torch.ones(got[0][1].shape, dtype=torch.bool, device=got[0][1].device)
    for (rgb, cnt), (rgb_p, cnt_p) in zip(got, want):
        torch.testing.assert_close(rgb, rgb_p, atol=1e-5, rtol=0)
        torch.testing.assert_close(cnt, cnt_p, atol=1e-4, rtol=0)
        same &= (rgb == rgb_p).all(-1) & (cnt == cnt_p)
    assert same.float().mean().item() >= 0.9999
    assert got[0][1].mean().item() > 0.5 and got[1][1].mean().item() > 0.5, "no history carried; vacuous"


def test_reproject_kernel_matches_plain_bitwise(dev):
    """One launch of K2 (both channel sets, query heads included) against
    the plain route on the card, `_queries` + `reproject_window_plain`."""
    H, W = 360, 640
    args = _reproject_case(dev, H, W, 0, H, 0, 0)
    before = rk.LAUNCHES
    got = rk.reproject_window(*args, window=4)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == before + 1
    _k2_agrees(got, rk.reproject_frame_plain(*args, 4, H))


def test_temporal_frame_on_card_matches_cpu(dev):
    cfg = RenderConfig(width=128, height=64, pipeline="fused")
    hists, imgs = {}, {}
    for d in (dev, torch.device("cpu")):
        scene = default_scene(device=d)
        cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=d)
        hist = pipeline.init_history(cfg, cam)
        for i in range(3):
            cam = Camera(loc=cam.loc, orient=cam.orient + torch.tensor([0.0, 1e-3], device=d))
            img, hist = pipeline.render_frame(scene, cam, hist, i, cfg)
        imgs[d.type], hists[d.type] = img, hist.to("cpu")
    img_c = imgs["cuda"].cpu()
    assert torch.isfinite(img_c).all()
    d = (img_c - imgs["cpu"]).abs()
    assert d.median().item() <= 1e-5
    assert (d > 1e-3).float().mean().item() <= 1e-3
    assert (hists["cuda"].diffuse.oid == hists["cpu"].diffuse.oid).float().mean() >= 0.999


# The gradient kernels against their plain versions, as chip_smoke.py phases
# 8-9 hold them: at 256×128 with every pixel, and at 96×64 with the
# ill-conditioned pixels (frame_kernel.ill_conditioned) left out. At 96×64 the
# sphere case has a pixel whose ray grazes a sphere: there the kernel and its
# plain version round the ray direction an ulp or two apart, which moves the
# hit, and that pixel's share of one table, past 1e-4·max.
GRAD_CASES = {
    "default_hard": ({}, False),
    "spheres_soft_smp2": (dict(soft_shadows=0.05, **SMP2), True),
    "unbiased": (dict(biased=False), False),
}


def _grad_case(dev, case, width=256, height=128):
    kw, spheres = GRAD_CASES[case]
    scene = _spheres(dev) if spheres else default_scene(device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    return scene, cam, RenderConfig(width=width, height=height, **kw)


def _randn(shape, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(tuple(shape), generator=g, device=dev)


def _tables_agree(got, ref):
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=max(1e-4 * b.abs().max().item(), 1e-10))


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_backward_kernel_matches_plain(dev, case):
    scene, cam, cfg = _grad_case(dev, case)
    out = fk.frame_forward(scene, cam, 3, cfg)
    g = {k: _randn(out[k].shape, dev, i) for i, k in enumerate(fg.OUT_KEYS[:6])}
    before = fg.LAUNCHES
    got = fg.frame_backward(scene, cam, 3, g, cfg)
    torch.cuda.synchronize()
    assert fg.LAUNCHES == before + 1
    _tables_agree(got, fg.frame_backward_plain(scene, cam, 3, g, cfg))


@pytest.mark.parametrize("loss", ["mse", "mean"])
@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_kernel_matches_plain(dev, case, loss):
    scene, cam, cfg = _grad_case(dev, case)
    target = _randn((cfg.height, cfg.width, 3), dev).sigmoid()
    before = lk.LAUNCHES
    la, got = lk.render_loss_and_grad(scene, cam, 3, cfg, target, loss)
    torch.cuda.synchronize()
    assert lk.LAUNCHES == before + 1
    lb, ref = lk.render_loss_and_grad_plain(scene, cam, 3, cfg, target, loss)
    torch.testing.assert_close(la, lb, rtol=1e-5, atol=0)
    _tables_agree(got, ref)


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_gradient_kernels_match_plain_on_well_conditioned_pixels(dev, case):
    """At 96×64: K5 with no cotangent on the ill-conditioned pixels, and K6
    (mse) with the plain image as the target there, which zeroes their
    residual, match their plain versions."""
    scene, cam, cfg = _grad_case(dev, case, 96, 64)
    out, ref = fk.frame_forward(scene, cam, 3, cfg), fk.frame_forward_plain(scene, cam, 3, cfg)
    bad = fk.ill_conditioned(out, ref)
    keep = (~bad).float()
    g = {k: _randn(out[k].shape, dev, i) * (keep[..., None] if out[k].ndim == 3 else keep)
         for i, k in enumerate(fg.OUT_KEYS[:6])}
    _tables_agree(fg.frame_backward(scene, cam, 3, g, cfg), fg.frame_backward_plain(scene, cam, 3, g, cfg))
    image = torch.stack(lk._composite_planes(
        [ref["alb"][..., c] for c in range(3)], [ref["ene"][..., c] for c in range(2)],
        [ref["add_d"][..., c] for c in range(3)], [ref["add_s"][..., c] for c in range(3)],
        float(cfg.brightness)), dim=-1)
    target = torch.where(bad[..., None], image, _randn((cfg.height, cfg.width, 3), dev).sigmoid())
    la, got = lk.render_loss_and_grad(scene, cam, 3, cfg, target, "mse")
    lb, want = lk.render_loss_and_grad_plain(scene, cam, 3, cfg, target, "mse")
    torch.testing.assert_close(la, lb, rtol=1e-5, atol=0)
    _tables_agree(got, want)


# Where the reverse sweep of K5 and K6 (csrc/frame_adjoint.cuh) branches: a
# close view of the rounded box (faces, edge cylinders and corner spheres
# win the primary trace), cotangents on depth and curv alone, subsets of the
# tables, decorrelated samples, the unbiased estimators and a scene with no
# plane. Each case: (scene, camera, config, K5's cotangent planes, tables).
BOX_VIEW = ((6.0, 1.8, -6.2), (-0.5, 2.2))
ADJOINT_CASES = {
    "box_close": ("default", BOX_VIEW, {}, fg.OUT_KEYS[:6], None),
    "box_close_soft": ("default", BOX_VIEW, dict(soft_shadows=0.05), fg.OUT_KEYS[:6], None),
    "depth_curv": ("default", None, {}, ("depth", "curv"), None),
    "spheres_only": ("spheres", None, dict(soft_shadows=0.05), fg.OUT_KEYS[:6], ("spheres",)),
    "materials_only": ("spheres", None, {}, ("add_d", "add_s", "alb", "ene"),
                       ("s0", "s1", "alb_const", "alb_scale", "emission", "en_const", "en_scale")),
    "smp2_decorrelate": ("spheres", None, dict(decorrelate_samples=True, **SMP2), fg.OUT_KEYS[:6], None),
    "unbiased_smp2": ("default", None, dict(biased=False, **SMP2), fg.OUT_KEYS[:6], None),
    "no_planes_unbiased": ("no_planes", None, dict(biased=False), fg.OUT_KEYS[:6], None),
}


@pytest.mark.parametrize("case", list(ADJOINT_CASES))
def test_gradient_kernels_match_plain_where_the_adjoint_branches(dev, case):
    """K5 (one launch, the case's cotangent planes) and K6 (mse, one
    launch) against their plain versions at 160×96, the ill-conditioned
    pixels given no cotangent (K6: the plain image as their target)."""
    which, view, kw, keys, names = ADJOINT_CASES[case]
    scene = {"default": lambda: default_scene(device=dev), "spheres": lambda: _spheres(dev),
             "no_planes": lambda: _spheres(dev, with_floor=False)}[which]()
    loc, orient = view or ((3.0, 2.0, -3.0), (0.0, 0.7))
    cam = Camera.create(loc=loc, orient=orient, device=dev)
    cfg = RenderConfig(width=160, height=96, **kw)
    needs = fg.needs_for(names)
    out, ref = fk.frame_forward(scene, cam, 3, cfg), fk.frame_forward_plain(scene, cam, 3, cfg)
    if view is not None:  # edge cylinders and corner spheres have curvature, faces none
        box = ref["oid"] == int(scene.box_ids[0])
        assert (box & (ref["curv"] > 0)).any() and (box & (ref["curv"] == 0)).any()
    bad = fk.ill_conditioned(out, ref)
    keep = (~bad).float()
    g = {k: _randn(out[k].shape, dev, i) * (keep[..., None] if out[k].ndim == 3 else keep)
         for i, k in enumerate(keys)}
    before = fg.LAUNCHES
    got = fg.frame_backward(scene, cam, 3, g, cfg, needs)
    torch.cuda.synchronize()
    assert fg.LAUNCHES == before + 1
    want = fg.frame_backward_plain(scene, cam, 3, g, cfg, needs)
    assert any(w is not None and w.abs().max() > 0 for w in want)
    _tables_agree(got, want)
    image = torch.stack(lk._composite_planes(
        [ref["alb"][..., c] for c in range(3)], [ref["ene"][..., c] for c in range(2)],
        [ref["add_d"][..., c] for c in range(3)], [ref["add_s"][..., c] for c in range(3)],
        float(cfg.brightness)), dim=-1)
    target = torch.where(bad[..., None], image, _randn((cfg.height, cfg.width, 3), dev).sigmoid())
    before = lk.LAUNCHES
    la, got = lk.render_loss_and_grad(scene, cam, 3, cfg, target, "mse", needs)
    torch.cuda.synchronize()
    assert lk.LAUNCHES == before + 1
    lb, want = lk.render_loss_and_grad_plain(scene, cam, 3, cfg, target, "mse", needs)
    torch.testing.assert_close(la, lb, rtol=1e-5, atol=0)
    _tables_agree(got, want)


def test_generic_and_fused_gradients_agree(dev):
    """Autograd through the differentiable frame (K1, K5) and the fused
    step (K6) give the same loss and gradients."""
    scene, cam, cfg = _grad_case(dev, "spheres_soft_smp2")
    cfg = dataclasses.replace(cfg, pipeline="fused")
    target = _randn((cfg.height, cfg.width, 3), dev).sigmoid()
    params = {k: v.clone().requires_grad_() for k, v in inverse.extract_params(scene).items()}
    before = (fk.LAUNCHES, fg.LAUNCHES)
    loss = inverse.loss_fn(params, scene, cam, target, 3, cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert (fk.LAUNCHES, fg.LAUNCHES) == (before[0] + 1, before[1] + 1)
    lf, (d_scene, _) = lk.loss_and_grad(scene, cam, 3, cfg, target=target, keys=tuple(params))
    torch.testing.assert_close(lf, loss.detach(), rtol=1e-5, atol=0)
    for k, g in zip(params, grads):
        torch.testing.assert_close(d_scene[k], g, rtol=0, atol=1e-4 * g.abs().max().item())


@pytest.mark.parametrize("case", ["default", "spheres"])
def test_geometry_kernel_matches_plain(dev, case):
    """K3 against its plain version (chip_smoke.py phase 13's bars): oid on
    >= 99.9% of the pixels; on equal oid depth and curv relative 1e-4, the
    normal 1e-5; misses bitwise; the G-buffer module's hits agree."""
    scene = _spheres(dev) if case == "spheres" else default_scene(device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cfg = RenderConfig(width=160, height=96)
    before = gk.LAUNCHES
    out = gk.geometry_pass(scene, cam, 0, cfg)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == before + 1
    gk.check_agreement(out, gk.geometry_pass_plain(scene, cam, 0, cfg), case)
    g = gbuffer.geometry_pass(scene, cam, cfg)
    assert (g.obj_id == out["oid"]).float().mean().item() >= 0.999


# K3 from a view aimed at the rounded box (its rays reach the box's
# candidates through the lane cull), with two more boxes, at a size that is
# no multiple of the kernel's 32x4 tiles, and from above the room looking up
# (every ray misses): bitwise its plain version, where a ray whose box the
# bounding-sphere test or the cull dropped would show on the box's outline.
@pytest.mark.parametrize("case", ["box_aimed", "three_boxes", "ragged_150x90", "all_miss"])
def test_geometry_kernel_cases_match_plain(dev, case):
    scene = default_scene(device=dev)
    if case == "three_boxes":
        scene = _with_boxes(scene, THREE_BOXES)
    loc, orient = ((20.0, 20.0, -20.0), (1.2, 0.0)) if case == "all_miss" else (VIEW_LOC, BOX_AIMED)
    cam = Camera.create(loc=loc, orient=orient, device=dev)
    cfg = RenderConfig(width=150, height=90) if case == "ragged_150x90" else RenderConfig(width=160, height=96)
    before = gk.LAUNCHES
    out = gk.geometry_pass(scene, cam, 0, cfg)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == before + 1
    assert out["normal"].shape == (cfg.height, cfg.width, 3) and out["normal"].is_contiguous()
    ref = gk.geometry_pass_plain(scene, cam, 0, cfg)
    assert all(torch.equal(out[k], ref[k]) for k in ref), gk.disagreement(out, ref)
    if case == "all_miss":
        assert (out["oid"] == 0).all()
    else:
        assert torch.isin(out["oid"], scene.box_ids).any(), "the view sees no box"


def test_geometry_pass_launches_its_kernel_alone(dev):
    """K3's wrapper hands the kernel the scene's own tensors and gets the
    dict's layouts back: one call launches K3 and no other kernel, and
    neither concatenates nor stacks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scene = default_scene(device=dev)
    cam = Camera.create(loc=VIEW_LOC, orient=BOX_AIMED, device=dev)
    cfg = RenderConfig(width=64, height=32)
    gk.geometry_pass(scene, cam, 0, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_MARGIN_S)
        gk.geometry_pass(scene, cam, 0, cfg)
        torch.cuda.synchronize()
        time.sleep(PROFILER_MARGIN_S)
    on_card = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert on_card and all("geometry_kernel" in n for n in on_card), on_card
    host = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    assert not any(n in ("aten::cat", "aten::stack") for n in host), host


def _config3(dev):
    """bench_configs.py:282-289: mirror, dielectric and diffuse spheres."""
    scene = sphere_scene(
        [[-1.5, 1.0, 6.0], [1.5, 1.2, 6.5], [0.0, 0.8, 4.5]], [1.0, 1.2, 0.8],
        [[0.9, 0.9, 0.9], [0.7, 0.8, 0.9], [0.9, 0.6, 0.5]],
        kinds=[BSDF.MIRROR, BSDF.DIELECTRIC, BSDF.DIFFUSE], iors=[1.5, 1.5, 1.5], device=dev,
    )
    return scene, Camera.create(loc=(0.0, 2.0, -2.0), orient=(-0.1, 0.0), device=dev)


def _glossy(dev):
    """The dielectric scene of tests/test_path_kernel.py with a glossy,
    a mirror and a dielectric sphere."""
    scene = sphere_scene(
        [[0.0, 1.0, 6.0], [2.0, 1.2, 7.0], [-2.0, 1.0, 6.5]], [1.0, 0.8, 0.9],
        [[0.7, 0.3, 0.2], [0.9, 0.9, 0.9], [0.95, 0.95, 0.95]],
        kinds=[BSDF.GLOSSY, BSDF.MIRROR, BSDF.DIELECTRIC], device=dev,
    )
    return scene, Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0), device=dev)


def _with_boxes(scene, boxes, kind=BSDF.DIFFUSE):
    """`scene` with its rounded boxes replaced by `boxes` ([B,7]), each with
    an object ID of its own past the scene's and the default box's material,
    of BSDF `kind` (ior 1.5)."""
    m = scene.materials
    k0 = m.num_ids
    rows = torch.full((len(boxes),), OBJ.BOX, dtype=torch.long, device=scene.device)
    grown = {f.name: torch.cat([getattr(m, f.name), getattr(m, f.name)[rows]])
             for f in dataclasses.fields(m) if getattr(m, f.name) is not None}
    grown["bsdf"][k0:] = int(kind)
    grown["ior"][k0:] = 1.5
    ids = torch.arange(k0, k0 + len(boxes), dtype=torch.int32, device=scene.device)
    return dataclasses.replace(scene, boxes=torch.tensor(boxes, dtype=torch.float32, device=scene.device),
                               box_ids=ids, materials=dataclasses.replace(m, **grown))


@pytest.mark.parametrize("case", ["default", "config3", "glossy", "three_boxes", "dielectric_box"])
def test_path_kernel_matches_plain(dev, case):
    """K7 against its plain version at tests/test_pallas_small.py:340-341's
    bar (finite, median |Δ| < 1e-5, under 2% beyond 3e-2): also with three
    boxes (the block's box lists hold rays of several boxes) and with the
    default room's box dielectric (rays inside a box)."""
    if case == "config3":
        scene, cam = _config3(dev)
    elif case == "glossy":
        scene, cam = _glossy(dev)
    elif case in ("three_boxes", "dielectric_box"):
        base = default_scene(device=dev)
        boxes = THREE_BOXES if case == "three_boxes" else THREE_BOXES[:1]
        scene = _with_boxes(base, boxes, BSDF.DIFFUSE if case == "three_boxes" else BSDF.DIELECTRIC)
        cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    else:
        scene = default_scene(device=dev)
        cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cfg = RenderConfig(width=96, height=64, spp=2, max_depth=6)
    before = pk.LAUNCHES
    img = wavefront.pathtrace(scene, cam, cfg, 1)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == before + 1
    pk.check_agreement(img, pk.pathtrace_plain(scene, cam, cfg, 1), case)
    for backend in ("auto", "pallas"):
        wavefront.pathtrace(scene, cam, dataclasses.replace(cfg, path_backend=backend), 1)
    assert pk.LAUNCHES == before + 3


def test_path_kernel_on_config3_at_1080p_matches_the_benchmark_reference(dev):
    """render_pathtraced on BASELINE config 3 at 1920×1080, 4 spp, depth 6
    (the benchmark's cell pathtrace.spp4_1080): one K7 launch, within the
    limits of the cell's check against its plain reference
    (kpt_bench/reference/path.py)."""
    from kpt_bench import harness
    from kpt_bench.kinds import pathtrace as loop
    from kpt_bench.reference import frame as rf
    from kpt_bench.reference import path as rp

    cell = harness.load_cell("pathtrace.spp4_1080")
    scene, cam = _config3(dev)
    before = pk.LAUNCHES
    img = wavefront.render_pathtraced(scene, cam, RenderConfig(width=1920, height=1080, spp=4, max_depth=6), 4242)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == before + 1
    tree = loop.scene_tree(cell.config["scene"])
    kinds, iors = rp.material_tables(tree, dev)
    rc = dict(cell.render, width=1920, height=1080, spp=4, max_depth=6)
    ref = rp.render(rf.scene_tables(tree, dev), kinds, iors, cam.loc, cam.orient, 4242, rc, 270)
    got, lim = loop.compare(img, ref), cell.traffic["limits"]
    assert all(got[k] <= float(lim[k]) for k in loop.CHECKS), (got, lim)




@pytest.mark.parametrize("size", [(320, 180), (1920, 1080)])
def test_render_pathtraced_tonemaps_in_k7(dev, size):
    """On the card render_pathtraced is one K7 launch that writes the sRGB
    image (LAUNCHES and TONEMAP_LAUNCHES each rise by 1), bitwise the plain
    tonemap (core/color.py) of K7's HDR image on config 3 at 4 spp, depth 6;
    without a brightness K7 still writes the HDR image, bitwise its plain
    version."""
    W, H = size
    scene, cam = _config3(dev)
    cfg = RenderConfig(width=W, height=H, spp=4, max_depth=6)
    before = (pk.LAUNCHES, pk.TONEMAP_LAUNCHES)
    img = wavefront.render_pathtraced(scene, cam, cfg, 7)
    torch.cuda.synchronize()
    assert (pk.LAUNCHES, pk.TONEMAP_LAUNCHES) == (before[0] + 1, before[1] + 1)
    hdr = pk.pathtrace(scene, cam, cfg, 7)
    torch.cuda.synchronize()
    assert (pk.LAUNCHES, pk.TONEMAP_LAUNCHES) == (before[0] + 2, before[1] + 1)
    plain = color.linear_srgb(color.aces_fitted(hdr * cfg.brightness))
    assert torch.equal(img, plain), (img - plain).abs().max().item()
    assert torch.equal(hdr, pk.pathtrace_plain(scene, cam, cfg, 7))
    # Not vacuous: black, mid-tone and near-white components, HDR beyond 1.
    assert (img == 0).any() and ((img > 0.1) & (img < 0.9)).float().mean() > 0.02 and img.max() > 0.95
    assert hdr.max() > 1


def test_path_traced_image_is_k7_alone_under_the_profiler(dev):
    """Under the profiler each render_pathtraced `pathtrace` span holds
    `pathtrace.paths` alone (no `pathtrace.tonemap`), and the only kernel on
    the card is K7."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scene, cam = _config3(dev)
    cfg = RenderConfig(width=320, height=180, spp=4, max_depth=6)
    wavefront.render_pathtraced(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_MARGIN_S)
        for i in range(3):
            wavefront.render_pathtraced(scene, cam, cfg, i)
        torch.cuda.synchronize()
        time.sleep(PROFILER_MARGIN_S)
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [e for e in host if e.name == "pathtrace"]
    assert len(spans) == 3
    for e in spans:
        assert [c.name for c in e.cpu_children if c.name.startswith("pathtrace")] == ["pathtrace.paths"]
    assert not any(e.name == "pathtrace.tonemap" for e in prof.events())
    # The spans' own events on the device's timeline left out; the session's
    # first kernel is at times left out of the trace (see PROFILER_MARGIN_S).
    names = ("pathtrace", *wavefront.STAGES)
    on_card = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in names]
    assert 2 <= len(on_card) <= 3 and all(n.startswith("kpt::path_kernel(") for n in on_card), on_card


def _seeded_history(oid, seed):
    rng = np.random.default_rng(seed)
    H, W = oid.shape
    return Channel(
        rgb=torch.from_numpy(rng.uniform(0.0, 2.0, (H, W, 3)).astype(np.float32)).to(oid.device),
        cnt=torch.from_numpy(rng.integers(0, 17, (H, W)).astype(np.float32)).to(oid.device),
        oid=oid.clone(),
    )


@pytest.mark.parametrize("case", ["default", "spheres_soft_smp2"])
def test_mono_kernel_matches_plain(dev, case):
    """K8 against its plain version (chip_smoke.py phase 17's classifier,
    frame_hist.check_agreement), history on the previous camera's oids."""
    spheres = case != "default"
    scene = _spheres(dev) if spheres else default_scene(device=dev)
    kw = dict(soft_shadows=0.05, **SMP2) if spheres else {}
    cfg = RenderConfig(width=160, height=96, pipeline="fused", temporal_fusion="mono", **kw)
    prev = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cam = Camera.create(loc=(3.001, 1.999, -3.0), orient=(-0.01, 0.702), device=dev)
    oid = fk.frame_forward(scene, prev, 0, cfg)["oid"]
    hd, hs = _seeded_history(oid, 1), _seeded_history(oid, 2)
    before = fh.LAUNCHES
    out = fh.frame_hist(scene, cam, prev, hd, hs, 1, cfg)
    torch.cuda.synchronize()
    assert fh.LAUNCHES == before + 1
    ref = fh.frame_hist_plain(scene, cam, prev, hd, hs, 1, cfg)
    fh.check_agreement(out, ref, case)
    assert ref["d_cnt"].mean().item() > 2.0, "no history carried; the check is vacuous"


# The cases the frame body of K1 and K8 (csrc/frame_body.cuh) branches on:
# a ragged image (tiles cut by the edge), two boxes (the cull per box),
# eight planes (MAX_PLANES strategy weights per slot), four decorrelated
# samples (the sample loop over the slots), the unbiased estimators, K1's
# row mode at a ragged row base, and the recovery view (192×128: the 8×4
# tiles of small images). Each kernel against its plain version, with its
# launch count and an exact oid.
BODY_CASES = ("ragged_150x90", "two_boxes", "eight_planes", "smp4_decorrelate", "unbiased", "rows_ragged",
              "recovery_192x128")


def _body_case(dev, case):
    scene = default_scene(device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    prev = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.699), device=dev)
    kw, size, frame = {}, (160, 96), 3
    if case in ("ragged_150x90", "rows_ragged"):
        size = (150, 90)
    elif case == "two_boxes":
        box = torch.tensor([[4.0, 0.6, -2.0, 0.5, 0.6, 0.4, 0.15]], device=dev)
        scene = dataclasses.replace(scene, boxes=torch.cat([scene.boxes, box]),
                                    box_ids=torch.cat([scene.box_ids, scene.box_ids]))
    elif case == "eight_planes":
        extra = torch.tensor([[1.0, 0.0, 0.0, 10.0], [0.0, 0.0, -1.0, 10.0], [0.0, 1.0, 0.0, 12.0],
                              [0.6, 0.0, 0.8, 14.0]], device=dev)
        scene = dataclasses.replace(scene, planes=torch.cat([scene.planes, extra]),
                                    plane_ids=torch.cat([scene.plane_ids, scene.plane_ids[2:4].repeat(2)]))
        assert scene.planes.shape[0] == fk.MAX_PLANES
    elif case == "smp4_decorrelate":
        kw = dict(decorrelate_samples=True, **{k: 4 for k in SMP2})
    elif case == "unbiased":
        kw = dict(biased=False)
    elif case == "recovery_192x128":
        _, scene, views = inverse.recovery_scenes(10, 5, device=dev)
        cam, prev, size, frame = views[0], views[1], (192, 128), inverse.SEED_BASE
        kw = dict(soft_shadows=0.05)
    cfg = RenderConfig(width=size[0], height=size[1], pipeline="fused", temporal_fusion="mono", **kw)
    return scene, cam, prev, cfg, frame


@pytest.mark.parametrize("case", BODY_CASES)
def test_frame_body_kernels_match_plain(dev, case):
    scene, cam, prev, cfg, frame = _body_case(dev, case)
    rows = dict(row_base=37, rows=29) if case == "rows_ragged" else {}
    before = fk.LAUNCHES
    out = fk.frame_forward(scene, cam, frame, cfg, **rows)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == before + 1
    ref = fk.frame_forward_plain(scene, cam, frame, cfg, **rows)
    fk.check_agreement(out, ref, f"K1 {case}")
    assert torch.equal(out["oid"], ref["oid"])
    if rows:
        return
    oid = fk.frame_forward_plain(scene, prev, frame - 1, cfg)["oid"]
    hd, hs = _seeded_history(oid, 1), _seeded_history(oid, 2)
    before = fh.LAUNCHES
    out = fh.frame_hist(scene, cam, prev, hd, hs, frame, cfg)
    torch.cuda.synchronize()
    assert fh.LAUNCHES == before + 1
    ref = fh.frame_hist_plain(scene, cam, prev, hd, hs, frame, cfg)
    fh.check_agreement(out, ref, f"K8 {case}")
    assert torch.equal(out["oid"], ref["oid"])


def test_mono_frame_on_card_matches_cpu(dev):
    cfg = RenderConfig(width=128, height=64, pipeline="fused", temporal_fusion="mono")
    hists, imgs = {}, {}
    for d in (dev, torch.device("cpu")):
        scene = default_scene(device=d)
        cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=d)
        hist = pipeline.init_history(cfg, cam)
        for i in range(3):
            cam = Camera(loc=cam.loc, orient=cam.orient + torch.tensor([0.0, 1e-3], device=d))
            img, hist = pipeline.render_frame(scene, cam, hist, i, cfg)
        imgs[d.type], hists[d.type] = img, hist.to("cpu")
    d = (imgs["cuda"].cpu() - imgs["cpu"]).abs()
    assert torch.isfinite(imgs["cuda"]).all()
    assert d.median().item() <= 1e-5
    assert (d > 1e-3).float().mean().item() <= 1e-3
    assert (hists["cuda"].diffuse.oid == hists["cpu"].diffuse.oid).float().mean() >= 0.999


@pytest.mark.parametrize("case", ["default", "spheres_soft", "three_boxes"])
def test_shade_kernel_matches_plain(dev, case):
    """K4 against its plain version on the G-buffer (chip_smoke.py phase
    19's classifier); misses and the light are exactly zero."""
    scene = {"spheres_soft": lambda: _spheres(dev),
             "three_boxes": lambda: _with_boxes(default_scene(device=dev), THREE_BOXES)}.get(
        case, lambda: default_scene(device=dev))()
    kw = dict(soft_shadows=0.05) if case == "spheres_soft" else {}
    cfg = RenderConfig(width=160, height=96, pipeline="pass", shade_backend="pallas", **kw)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    gb = gbuffer.geometry_pass(scene, cam, cfg)
    _, seed = passes._shade_common(scene, cfg, gb, cam, 3)
    before = sk.LAUNCHES
    est = sk.dual_mis(scene, gb, cam, seed, cfg)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 1
    ref = sk.dual_mis_plain(scene, gb, cam, seed, cfg)
    fh.check_agreement({"est_d": est[0], "est_s": est[1]}, {"est_d": ref[0], "est_s": ref[1]}, case)
    off = ~passes._shaded(scene, gb.obj_id)
    assert off.any() and (est[0][off] == 0).all() and (est[1][off] == 0).all()


def test_pass_pipeline_on_card_runs_the_shade_kernel(dev):
    cfg = RenderConfig(width=128, height=64, pipeline="pass", shade_backend="pallas")
    scene = default_scene(device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    hist = pipeline.init_history(cfg, cam)
    before = sk.LAUNCHES
    for i in range(2):
        img, hist = pipeline.render_frame(scene, cam, hist, i, cfg)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 2
    assert torch.isfinite(img).all() and img.min() >= 0 and img.max() <= 1


def test_path_and_shade_wrappers_pack_no_tables(dev):
    """The wrappers of K7, K4, K5 and K6 hand the kernels the scene's own
    tensors (frame_kernel.table_parts): one call of each launches its
    kernel and concatenates none of those tensors; K7's and K4's
    concatenate nothing at all (K5's and K6's join their seed list, and
    K5's its cotangent planes)."""
    from torch.autograd import DeviceType
    from torch.overrides import TorchFunctionMode
    from torch.profiler import ProfilerActivity, profile

    class Joins(TorchFunctionMode):
        """The tensor lists handed to torch.cat and torch.stack."""

        def __init__(self):
            super().__init__()
            self.lists = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.cat, torch.concat, torch.stack):
                self.lists.append(list(args[0]))
            return func(*args, **(kwargs or {}))

    scene = default_scene(device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cfg = RenderConfig(width=64, height=32)
    cfg_p = dataclasses.replace(cfg, pipeline="pass", shade_backend="pallas")
    gb = gbuffer.geometry_pass(scene, cam, cfg_p)
    _, seed = passes._shade_common(scene, cfg_p, gb, cam, 3)
    cot = {"add_d": torch.ones((32, 64, 3), device=dev)}
    calls = {"path_kernel": lambda: pk.pathtrace(scene, cam, dataclasses.replace(cfg, spp=1), 0),
             "shade_kernel": lambda: sk.dual_mis(scene, gb, cam, seed, cfg_p),
             "frame_grad_kernel": lambda: fg.frame_backward(scene, cam, 3, cot, cfg),
             "loss_grad_kernel": lambda: lk.render_loss_and_grad(scene, cam, 3, cfg, loss="mean")}
    tables = {t.data_ptr() for ts in fk.table_parts(scene, cam) for t in ts}
    for kernel, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_MARGIN_S)
            with Joins() as joins:
                call()
            torch.cuda.synchronize()
            time.sleep(PROFILER_MARGIN_S)
        names = [(e.device_type, e.name) for e in prof.events()]
        assert any(t == DeviceType.CUDA and kernel in n for t, n in names), f"{kernel} did not launch"
        assert not any(t.data_ptr() in tables for ts in joins.lists for t in ts), f"{kernel}'s wrapper packs tables"
        if kernel in ("path_kernel", "shade_kernel"):
            assert not any("cat" in n for t, n in names if t == DeviceType.CPU), f"{kernel}'s wrapper packs tables"


def _two_step(dev, kernel):
    """One kernel's two-step route at 64×32 → (launch, its outputs, the
    tensors made here that it reads), as lists of tensors."""
    scene = default_scene(device=dev)
    cam = Camera.create(loc=VIEW_LOC, orient=BOX_AIMED, device=dev)
    cfg = RenderConfig(width=64, height=32)
    inputs = []
    if kernel == "frame_forward":
        launch, out = fk.frame_launch(scene, cam, 3, cfg)
    elif kernel == "geometry_pass":
        launch, out = gk.geometry_launch(scene, cam, 0, cfg)
    elif kernel == "pathtrace":
        launch, out = pk.path_launch(scene, cam, dataclasses.replace(cfg, spp=1), 0)
    elif kernel == "dual_mis":
        cfg_p = dataclasses.replace(cfg, pipeline="pass", shade_backend="pallas")
        gb = gbuffer.geometry_pass(scene, cam, cfg_p)
        _, seed = passes._shade_common(scene, cfg_p, gb, cam, 3)
        launch, out = sk.dual_mis_launch(scene, gb, cam, seed, cfg_p)
        inputs = [gb.normal, gb.depth, gb.ray_dir, gb.obj_id, seed]
    else:
        inputs = [torch.rand((32, 64), device=dev) for _ in range(2)]
        launch, out = ck.mix_launch(*inputs, *ck.KERNEL_VARIANTS[0])
    out = list(out.values()) if isinstance(out, dict) else list(out) if isinstance(out, tuple) else [out]
    return launch, out, inputs


# The two-step routes that ops/adjoint_variants.py times by their launch
# alone: launch() keeps alive every tensor whose address it
# hands the kernel, so with the caller's references dropped none is freed,
# and tensors allocated next (which the caching allocator would give the
# freed blocks) keep what was written into them.
@pytest.mark.parametrize("kernel", ["frame_forward", "geometry_pass", "pathtrace", "dual_mis", "mix"])
def test_launch_keeps_its_tensors_alive(dev, kernel):
    import gc
    import weakref

    launch, out, inputs = _two_step(dev, kernel)
    refs = [weakref.ref(t) for t in out + inputs]
    shapes = [(t.shape, t.dtype) for t in out]
    del out, inputs
    gc.collect()
    torch.cuda.synchronize()
    assert all(r() is not None for r in refs), f"{kernel}'s launch does not hold its tensors"
    fresh = [torch.full(shape, 7, dtype=dtype, device=dev) for shape, dtype in shapes]
    launch()
    torch.cuda.synchronize()
    assert all((t == 7).all() for t in fresh), f"{kernel}'s launch wrote into a freed block"


# The tile modes that the sharded renderer and trainer run (parallel/shard.py):
# K2's and K8's over image rows [32, 64) of a 160×96 image against an 8-row
# history halo, K5's over rows [40, 88) of 256×128; each against its plain
# version, with its launch counted as a tile launch.
def _halo_window(ch: Channel, row0: int, rows: int, halo: int) -> Channel:
    from kylespathtracer_tpu_torch.parallel import shard

    return shard.tile_window(pipeline.History(ch, ch, None), row0, rows, halo).diffuse


def test_reproject_tile_kernel_matches_plain(dev):
    """K2's tile mode, rows [64, 128) of 360 with an 8-row halo, against the
    plain route on the card, and counted as one tile launch."""
    H, W, row0, rows, halo = 360, 640, 64, 64, 8
    args = _reproject_case(dev, H, W, row0, rows, halo, 1)
    tile = dict(image_height=H, row_base=row0, hist_halo=halo)
    before = (rk.LAUNCHES, rk.TILE_LAUNCHES)
    got = rk.reproject_window(*args, window=8, **tile)
    torch.cuda.synchronize()
    assert (rk.LAUNCHES, rk.TILE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _k2_agrees(got, rk.reproject_frame_plain(*args, 8, H, row0, halo))


def test_split_frame_reprojects_in_one_launch_without_a_sync(dev):
    """A split temporal frame launches K2 once, and the reprojection stage
    (reproject_window on the frame's own anchors) waits on nothing: no host
    copy, no synchronize."""
    scene = default_scene(device=dev)
    cfg = RenderConfig(width=160, height=96, pipeline="fused")
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    hist = pipeline.init_history(cfg, cam)
    for i in range(2):
        cam = Camera(loc=cam.loc, orient=cam.orient + torch.tensor([0.0, 1e-3], device=dev))
        before = rk.LAUNCHES
        _, hist = pipeline.render_frame(scene, cam, hist, i, cfg)
        torch.cuda.synchronize()
        assert rk.LAUNCHES == before + 1
    cam = Camera(loc=cam.loc, orient=cam.orient + torch.tensor([0.0, 1e-3], device=dev))
    out = fk.frame_forward(scene, cam, 2, cfg)
    hl, sl = passes.reprojection_anchors(scene, cam, out, cfg.fov, cfg.height)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rk.reproject_window(hist.camera, hl, sl, out["oid"], hist.diffuse, hist.specular, cfg.fov,
                                  window=cfg.reproject_window)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert got[0][1].max().item() > 0


def _tail_operands(dev, rows, W, seed):
    """K1's planes that K2 with its tail reads, on the card: the object IDs,
    depth and curvature, shaped as K1 writes them (an eighth of the pixels
    misses: ID 0, depth ZFAR − EPS, curvature 0; of the hits a third lie on
    planes, curvature 0, the rest on spheres of radius 0.3-3, whose 1e-3/r
    lies on both sides of EPS, where the clamp to EPS engages or not), the
    estimates, albedo (a sixth of it zero, where the composite's sqrt is
    masked) and energies."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    miss = rng.random((rows, W)) < 1 / 8
    oid = np.where(miss, 0, rng.integers(1, 4, (rows, W)))
    depth = np.where(miss, np.float32(50.0) - np.float32(1e-3), rng.uniform(2.0, 8.0, (rows, W)))
    curv = np.where(miss | (rng.random((rows, W)) < 1 / 3), 0.0, 1e-3 / rng.uniform(0.3, 3.0, (rows, W)))
    alb = np.where(rng.random((rows, W, 3)) < 1 / 6, 0.0, rng.uniform(0.0, 1.0, (rows, W, 3)))
    return {"oid": torch.from_numpy(oid.astype(np.int32)).to(dev), "depth": f(depth), "curv": f(curv),
            "add_d": f(rng.uniform(0.0, 2.0, (rows, W, 3))), "add_s": f(rng.uniform(0.0, 2.0, (rows, W, 3))),
            "alb": f(alb), "ene": f(rng.uniform(0.0, 1.5, (rows, W, 2)))}


def _ulps(a, b):
    """How many f32 steps apart a and b lie, element by element (equal
    values, ±0 among them, lie 0 apart)."""
    key = lambda t: (lambda i: torch.where(i < 0, -(i & 0x7FFFFFFF), i))(t.view(torch.int32).long())
    return torch.where(a == b, 0, (key(a) - key(b)).abs())


# K2 with its tail: image rows (row0, rows) of 360×640 with a history halo,
# and whether the camera stands still (vv = 0: the clamp's limit is T).
TAIL_CASES = {"frame": (0, 360, 0, False), "tile": (64, 64, 8, False), "still": (0, 360, 0, True)}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_reproject_tail_kernel_matches_plain_bitwise(dev, case):
    """One launch of K2 with its tail (the primary rays and both anchors
    built from K1's depth and curvature, both sets' query heads and tap
    sums, count floor, velocity clamp, accumulate, the ACES composite)
    against the plain route on the card: `reprojection_anchors` (the rays of
    `ray_dirs_window`, then the anchors), `reproject_frame_plain`,
    `accumulate` for each set, `composite_from`. The new history and the image are bitwise, on a
    moving camera whose clamp engages and on a still one; in tile mode
    counted as a tile launch."""
    from kylespathtracer_tpu_torch.core import gmath
    from kylespathtracer_tpu_torch.render.composite import composite_from

    H, W = 360, 640
    row0, rows, halo, still = TAIL_CASES[case]
    scene = default_scene(device=dev)
    prev, _, _, _, pd, ps, fov = _reproject_case(dev, H, W, row0, rows, halo, 2)
    loc = prev.loc.clone() if still else prev.loc + torch.tensor([0.02, -0.01, 0.015], device=dev)
    cam = Camera(loc=loc, orient=torch.tensor([0.0, 0.7], device=dev))
    # TEMPORALSMOOTHING 8: half the carried counts lie past the still
    # camera's limit T.
    cfg = RenderConfig(width=W, height=H, pipeline="fused", fov=fov, reproject_window=8 if halo else 4, temporal=8)
    out = _tail_operands(dev, rows, W, 3)
    ho = out["oid"]
    tile = dict(image_height=H, row_base=row0, hist_halo=halo) if halo else {}
    before = (rk.LAUNCHES, rk.TILE_LAUNCHES, rk.TAIL_LAUNCHES)
    image, d, s = rk.reproject_tail(scene, cam, prev, out, pd, ps, cfg, **tile)
    torch.cuda.synchronize()
    assert (rk.LAUNCHES, rk.TILE_LAUNCHES, rk.TAIL_LAUNCHES) == (before[0] + 1, before[1] + bool(halo),
                                                                 before[2] + 1)
    hl, sl = passes.reprojection_anchors(scene, cam, out, fov, H, row0)
    (rgb_d, cnt_d), (rgb_s, cnt_s) = rk.reproject_frame_plain(prev, hl, sl, ho, pd, ps, fov, cfg.reproject_window,
                                                              H, row0, halo)
    vv = gmath.length(loc - prev.loc)
    wd = passes.accumulate(rgb_d, cnt_d, out["add_d"], vv, ho, cfg)
    ws = passes.accumulate(rgb_s, cnt_s, out["add_s"], vv, ho, cfg)
    want = composite_from(out["alb"], out["ene"], wd, ws, cfg)
    for name, got, ref in (("diffuse", d, wd), ("specular", s, ws)):
        assert torch.equal(got.rgb, ref.rgb), f"{name} rgb: {_ulps(got.rgb, ref.rgb).max().item()} ulps at most"
        assert torch.equal(got.cnt, ref.cnt), f"{name} cnt: {_ulps(got.cnt, ref.cnt).max().item()} ulps at most"
        assert got.oid is ho
    assert image.shape == (rows, W, 3) and torch.isfinite(image).all()
    assert torch.equal(image, want), f"image: {_ulps(image, want).max().item()} ulps at most"
    # Moving, the clamp cuts counts under T; still, its limit is T itself,
    # so it cuts exactly the counts past T.
    floor = passes.count_floor(cnt_d)
    _, clamped = passes._temporal_clamp(rgb_d, floor, vv, cfg)
    cut = clamped < floor
    if still:
        assert vv.item() == 0 and cut.any() and torch.equal(cut, floor > cfg.temporal)
    else:
        assert vv.item() > 0 and (cut & (floor <= cfg.temporal)).any()
    assert cnt_d.mean().item() > 0.5 and cnt_s.mean().item() > 0.5, "no history carried; vacuous"


def test_split_frame_runs_its_tail_in_k2_without_a_sync(dev):
    """A split temporal frame is two launches, K1 and K2 (counted by
    LAUNCHES of both and K2's TAIL_LAUNCHES), and no other CUDA kernel in a
    profiler trace of three frames; from K1's launch to the image and the
    new history nothing waits on the device: no host copy, no synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scene = default_scene(device=dev)
    cfg = RenderConfig(width=160, height=96, pipeline="fused")
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    hist = pipeline.init_history(cfg, cam)
    step = lambda c: Camera(loc=c.loc + torch.tensor([2e-3, 0.0, -1e-3], device=dev),
                            orient=c.orient + torch.tensor([0.0, 1e-3], device=dev))
    counts = lambda: (fk.LAUNCHES, rk.LAUNCHES, rk.TAIL_LAUNCHES)
    for i in range(2):
        cam = step(cam)
        before = counts()
        _, hist = pipeline.render_frame(scene, cam, hist, i, cfg)
        torch.cuda.synchronize()
        assert counts() == tuple(n + 1 for n in before)
    cams = []
    for _ in range(3):
        cam = step(cam)
        cams.append(cam)
    torch.cuda.synchronize()
    before = counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_MARGIN_S)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i, c in enumerate(cams, start=2):
                image, hist = pipeline.render_frame(scene, c, hist, i, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        time.sleep(PROFILER_MARGIN_S)
    assert counts() == tuple(n + 3 for n in before)
    # The spans' own events on the device's timeline left out. The session's
    # first kernel is at times placed before the session opens and left out
    # of the trace (see PROFILER_MARGIN_S), so each kernel shows 2 or 3 times.
    spans = ("frame", *pipeline.STAGES)
    on_card = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in spans]
    k1 = sum("kpt::frame_kernel(" in n for n in on_card)
    k2 = sum("kpt::reproject_kernel(" in n for n in on_card)
    assert k1 + k2 == len(on_card) and 2 <= k1 <= 3 and 2 <= k2 <= 3, on_card
    assert image.shape == (96, 160, 3) and torch.isfinite(image).all()
    assert hist.diffuse.cnt.max().item() > 2, "history not carried"


def test_mono_tile_kernel_matches_plain(dev):
    """K8's tile mode against its plain version (frame_hist.check_agreement),
    and bitwise the full-frame kernel's rows on the same history."""
    scene = default_scene(device=dev)
    cfg = RenderConfig(width=160, height=96, pipeline="fused", temporal_fusion="mono")
    prev = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cam = Camera.create(loc=(3.001, 1.999, -3.0), orient=(-0.01, 0.702), device=dev)
    oid = fk.frame_forward(scene, prev, 0, cfg)["oid"]
    hd, hs = _seeded_history(oid, 1), _seeded_history(oid, 2)
    wd, ws = _halo_window(hd, 32, 32, 8), _halo_window(hs, 32, 32, 8)
    tile = dict(block_rows=8, row_base=32, rows=32, hist_halo=8)
    before = (fh.LAUNCHES, fh.TILE_LAUNCHES)
    out = fh.frame_hist(scene, cam, prev, wd, ws, 1, cfg, **tile)
    torch.cuda.synchronize()
    assert (fh.LAUNCHES, fh.TILE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    fh.check_agreement(out, fh.frame_hist_plain(scene, cam, prev, wd, ws, 1, cfg, **tile), "K8 tile")
    full = fh.frame_hist(scene, cam, prev, hd, hs, 1, cfg, block_rows=8)
    for k, v in out.items():
        assert torch.equal(v, full[k][32:64]), k


def test_backward_rows_kernel_matches_plain(dev):
    scene, cam, cfg = _grad_case(dev, "default_hard")
    out = fk.frame_forward(scene, cam, 3, cfg, row_base=40, rows=48)
    g = {k: _randn(out[k].shape, dev, i) for i, k in enumerate(fg.OUT_KEYS[:6])}
    before = (fg.LAUNCHES, fg.ROW_LAUNCHES)
    got = fg.frame_backward(scene, cam, 3, g, cfg, row_base=40, rows=48)
    torch.cuda.synchronize()
    assert (fg.LAUNCHES, fg.ROW_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _tables_agree(got, fg.frame_backward_plain(scene, cam, 3, g, cfg, row_base=40, rows=48))


@pytest.mark.parametrize("fusion", ["split", "mono"])
def test_tiles_on_card_match_unsharded_frame(dev, fusion):
    """Four 16-row tiles of `_render_row_block` on the card (K1 row + K2
    tile, or K8 tile), stitched, against `render_frame` on the card over two
    pan frames: bitwise expected, held at the JAX package's bars."""
    import warnings

    from _torch_helpers import render_tiles

    scene = default_scene(device=dev)
    cfg = RenderConfig(width=128, height=64, pipeline="fused", temporal_fusion=fusion)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    hist_r = hist_t = pipeline.init_history(cfg, cam)
    for i in range(2):
        cam = Camera(loc=cam.loc, orient=cam.orient + torch.tensor([-0.01, 2e-3], device=dev))
        img_r, hist_r = pipeline.render_frame(scene, cam, hist_r, i, cfg)
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="fused tiled path")
            img_t, hist_t = render_tiles(scene, cam, hist_t, i, cfg, 4)
        torch.testing.assert_close(img_t, img_r, atol=1e-5, rtol=0)
        torch.testing.assert_close(hist_t.diffuse.cnt, hist_r.diffuse.cnt, atol=1e-4, rtol=0)
        torch.testing.assert_close(hist_t.specular.rgb, hist_r.specular.rgb, atol=1e-4, rtol=0)
        assert torch.equal(hist_t.diffuse.oid, hist_r.diffuse.oid)


def test_train_tiles_on_card_match_unsharded(dev):
    """Two tiles' loss and gradient on the card (K1 and K5 in row mode)
    against `inverse.loss_fn`'s through the whole frame (K1, K5)."""
    from kylespathtracer_tpu_torch.parallel import shard

    scene, cam, cfg = _grad_case(dev, "spheres_soft_smp2", 128, 64)
    cfg = dataclasses.replace(cfg, pipeline="fused")
    target = _randn((64, 128, 3), dev).sigmoid()
    params = inverse.extract_params(scene)
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = inverse.loss_fn(p, scene, cam, target, 3, cfg)
    grads = torch.autograd.grad(loss, list(p.values()))
    before = fg.ROW_LAUNCHES
    tiles = [shard.tile_loss_and_grad(params, scene, cam, target[r:r + 32], 3, cfg, r, 32) for r in (0, 32)]
    assert fg.ROW_LAUNCHES == before + 2
    torch.testing.assert_close(tiles[0][0] + tiles[1][0], loss.detach(), rtol=1e-5, atol=0)
    for k, gk in zip(p, grads):
        torch.testing.assert_close(tiles[0][1][k] + tiles[1][1][k], gk, rtol=0,
                                   atol=1e-4 * gk.abs().max().item())


@pytest.mark.parametrize("variant", ck.KERNEL_VARIANTS, ids=lambda v: "-".join(map(str, v)))
def test_ceiling_kernel_matches_plain_bitwise(dev, variant):
    """K9 against its plain version on the card at 16x1920 on the probe's
    planes, and on numpy-seeded planes in [-2, 2): bit for bit, infinities
    and NaN in place (both round each IEEE operation on its own)."""
    rng = np.random.default_rng(9)
    planes = [bench_ceiling.inputs(dev, 16, 1920),
              [torch.from_numpy(rng.uniform(-2, 2, (16, 1920)).astype(np.float32)).to(dev) for _ in range(2)]]
    for x, y in planes:
        before = ck.LAUNCHES
        out = ck.mix(x, y, *variant)
        torch.cuda.synchronize()
        assert ck.LAUNCHES == before + 1
        assert ck.differing(out, ck.mix_plain(x, y, *variant)) == 0


# ------------------------------------------- the sphere trace and its gradient
# chip_smoke.py phases 25 and 27 at smaller sizes.

def test_march_on_card_matches_cpu(dev):
    """sdf.march and sdf.norcurv on the card against the CPU, 128×64 from
    the box-aimed view: oid on >= 99.9% of the rays, t within 1e-5 on equal
    oid; the normal and the curvature within 1e-4 on equal hits (each
    side's stencil at its own hit; chip_smoke.py phase 25's bars)."""
    from kylespathtracer_tpu_torch.render.camera import ray_dirs
    from kylespathtracer_tpu_torch.scene import sdf

    cam = Camera.create(loc=VIEW_LOC, orient=BOX_AIMED, device=dev)
    rd = ray_dirs(cam, 128, 64, 1.5)
    ro = cam.loc.expand(rd.shape)
    t_c, id_c = sdf.march(default_scene(device=dev), ro, rd)
    cpu = default_scene(device="cpu")
    t_h, id_h = sdf.march(cpu, ro.cpu(), rd.cpu())
    same = id_c.cpu() == id_h
    hit = same & (id_h > 0)
    assert same.float().mean() >= 0.999 and torch.isin(id_h, cpu.box_ids).any()
    assert (t_c.cpu() - t_h)[same].abs().max() <= 1e-5
    n_c, c_c = sdf.norcurv(default_scene(device=dev), ro + rd * t_c[..., None])
    n_h, c_h = sdf.norcurv(cpu, ro.cpu() + rd.cpu() * t_h[..., None])
    assert (n_c.cpu() - n_h)[hit].abs().max() <= 1e-4
    assert (c_c.cpu() - c_h)[hit].abs().max() <= 1e-4


@pytest.mark.parametrize("view", ["raycast", "box_aimed"])
def test_march_gbuffer_matches_geometry_kernel(dev, view):
    """The march G-buffer against K3's at 320×180: oid equal on > 99.5% of
    the pixels, the 99th percentile of |Δt| on equal hits that do not graze
    (|n·d| >= 0.1) under 1e-2 (tests/test_scene.py:146-178's bars); no
    kernel launched by the march."""
    scene = default_scene(device=dev)
    cam = Camera.create(loc=VIEW_LOC, orient=BOX_AIMED if view == "box_aimed" else (0.0, 0.7), device=dev)
    geo = gk.geometry_pass(scene, cam, 0, RenderConfig(width=320, height=180))
    before = (gk.LAUNCHES, fk.LAUNCHES)
    gm = gbuffer.geometry_pass(scene, cam, RenderConfig(width=320, height=180, intersect_mode="march"))
    torch.cuda.synchronize()
    assert (gk.LAUNCHES, fk.LAUNCHES) == before
    eq = gm.obj_id == geo["oid"]
    keep = eq & (geo["oid"] > 0) & ((geo["normal"] * gm.ray_dir).sum(-1).abs() >= 0.1)
    assert eq.float().mean() > 0.995
    assert torch.quantile((gm.depth - geo["depth"])[keep].abs(), 0.99) < 1e-2


def test_pass_gradient_on_card_matches_fused_routes(dev, monkeypatch):
    """The pass pipeline's gradient (through the intersectors' implicit-
    function backward) against K1 + K5 (`KPT_FUSED_LOSS=0`) and K6 on the
    same loss at 192×108, every table within 2e-3·max; each route's target
    is its own image where K1 and its plain version part or the two
    pipelines' images do (chip_smoke.py phase 27)."""
    scene = default_scene(device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cfg = RenderConfig(width=192, height=108, pipeline="pass", no_history=True, soft_shadows=0.05)
    fused = dataclasses.replace(cfg, pipeline="fused")
    params = inverse.extract_params(scene, ("spheres", "planes", "alb_const", "light_color"))
    target = _randn((cfg.height, cfg.width, 3), dev).sigmoid()
    ill = fk.ill_conditioned(fk.frame_forward(scene, cam, 3, fused), fk.frame_forward_plain(scene, cam, 3, fused))
    with torch.no_grad():
        img_p, img_f = (inverse.render_once(scene, cam, c, 3) for c in (cfg, fused))
    bad = (ill | ((img_p - img_f).abs().amax(-1) > 1e-4))[..., None]
    before = {m: m.LAUNCHES for m in (fk, fg, lk, sk, gk)}
    loss_p, grads_p = inverse.value_and_grad(params, scene, cam, torch.where(bad, img_p, target), 3, cfg)
    assert {m: m.LAUNCHES for m in before} == before
    for flag in ("0", "1"):
        monkeypatch.setenv("KPT_FUSED_LOSS", flag)
        launches = (fk.LAUNCHES, fg.LAUNCHES, lk.LAUNCHES)
        loss, grads = inverse.value_and_grad(params, scene, cam, torch.where(bad, img_f, target), 3, fused)
        torch.cuda.synchronize()
        ran = tuple(b - a for a, b in zip(launches, (fk.LAUNCHES, fg.LAUNCHES, lk.LAUNCHES)))
        assert ran == ((1, 1, 0) if flag == "0" else (0, 0, 1))
        torch.testing.assert_close(loss, loss_p, rtol=1e-4, atol=0)
        for k, g in grads_p.items():
            assert g.abs().max() > 0, k
            torch.testing.assert_close(grads[k], g, rtol=0, atol=2e-3 * g.abs().max().item())


@pytest.mark.parametrize("column,want", [(2, 1.0), (3, -1.0)], ids=["translation", "radius"])
def test_march_ift_gradient_on_card(dev, column, want):
    """The march's t gradient on the card in a sphere's z and radius:
    within 5e-2 of the exact ±1 and of the central difference
    (tests/test_scene.py:86-123)."""
    from kylespathtracer_tpu_torch.scene import sdf

    sph = sphere_scene([[0.0, 1.0, 5.0]], [1.0], [[0.5, 0.5, 0.5]], with_floor=False, device=dev)
    ro, rd = torch.tensor([[0.0, 1.0, 0.0]], device=dev), torch.tensor([[0.0, 0.0, 1.0]], device=dev)

    def hit_t(delta):
        spheres = sph.spheres.clone()
        spheres[1, column] = spheres[1, column] + delta
        return sdf.march(dataclasses.replace(sph, spheres=spheres), ro, rd)[0][0]

    x = torch.tensor(0.0, device=dev, requires_grad=True)
    (g,) = torch.autograd.grad(hit_t(x), x)
    with torch.no_grad():
        fd = (hit_t(1e-3) - hit_t(-1e-3)) / 2e-3
    assert abs(g.item() - want) < 5e-2 and abs(g.item() - fd.item()) < 5e-2
