"""PyTorch port on the card: the CUDA kernels against their plain versions
on the same CUDA tensors, and the frame on the card against the CPU.

Marked `cuda`; each test skips without a CUDA device (decided in the
fixture, never at import). Run on a GPU machine with
`python -m pytest tests/test_torch_cuda.py -q --noconftest` (tests/conftest.py
imports jax, which a GPU machine need not have).
"""

import dataclasses

import numpy as np
import pytest
import torch

from kylespathtracer_tpu_torch.diff import inverse
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import frame_hist as fh
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import geometry_kernel as gk
from kylespathtracer_tpu_torch.ops import loss_kernel as lk
from kylespathtracer_tpu_torch.ops import path_kernel as pk
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.ops import shade_kernel as sk
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


def test_reproject_kernel_matches_plain_bitwise(dev):
    H, W = 96, 160
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    ho = torch.from_numpy(rng.integers(0, 4, (H, W)).astype(np.int32)).to(dev)
    dy = torch.from_numpy(rng.integers(-6, 6, (H, W)).astype(np.int32)).to(dev)
    dx = torch.from_numpy(rng.integers(-6, 6, (H, W)).astype(np.int32)).to(dev)
    w4 = tuple((torch.rand((H, W), generator=g) * 1.6 - 0.3).to(dev) for _ in range(4))
    prev = Channel(
        rgb=torch.rand((H, W, 3), generator=g).to(dev),
        cnt=torch.randint(0, 17, (H, W), generator=g).float().to(dev),
        oid=torch.from_numpy(rng.integers(0, 4, (H, W)).astype(np.int32)).to(dev),
    )
    before = rk.LAUNCHES
    rgb, cnt = rk.reproject_set(ho, dy, dx, w4, prev, 4)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == before + 1
    rgb_p, cnt_p = rk.reproject_window_plain(ho, dy, dx, w4, prev, 4)
    torch.testing.assert_close(rgb, rgb_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(cnt, cnt_p, atol=1e-4, rtol=0)


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


# The default room's box and two more (tests/test_torch_frame_body.py:BOXES).
THREE_BOXES = [[7.5, 0.93, -7.5, 0.8, 0.8, 0.8, 0.1], [2.0, 1.0, 3.0, 0.3, 1.2, 0.5, 0.25],
               [-4.0, 2.5, 0.5, 1.5, 0.2, 0.9, 0.02]]


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
    """K7's and K4's wrappers hand the kernels the scene's own tensors
    (frame_kernel.table_parts): one call of each launches its kernel and
    no concatenation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scene = default_scene(device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cfg_p = RenderConfig(width=64, height=32, pipeline="pass", shade_backend="pallas")
    gb = gbuffer.geometry_pass(scene, cam, cfg_p)
    _, seed = passes._shade_common(scene, cfg_p, gb, cam, 3)
    calls = {"path_kernel": lambda: pk.pathtrace(scene, cam, RenderConfig(width=64, height=32, spp=1), 0),
             "shade_kernel": lambda: sk.dual_mis(scene, gb, cam, seed, cfg_p)}
    for kernel, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [(e.device_type, e.name) for e in prof.events()]
        assert any(t == DeviceType.CUDA and kernel in n for t, n in names), f"{kernel} did not launch"
        assert not any("cat" in n for t, n in names if t == DeviceType.CPU), f"{kernel}'s wrapper packs tables"


# The tile modes that the sharded renderer and trainer run (parallel/shard.py):
# K2's and K8's over image rows [32, 64) of a 160×96 image against an 8-row
# history halo, K5's over rows [40, 88) of 256×128; each against its plain
# version, with its launch counted as a tile launch.
def _halo_window(ch: Channel, row0: int, rows: int, halo: int) -> Channel:
    from kylespathtracer_tpu_torch.parallel import shard

    return shard.tile_window(pipeline.History(ch, ch, None), row0, rows, halo).diffuse


def test_reproject_tile_kernel_matches_plain(dev):
    H, W, row0, rows, halo = 96, 160, 32, 32, 8
    g = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    ho = torch.from_numpy(rng.integers(0, 4, (rows, W)).astype(np.int32)).to(dev)
    dy = torch.from_numpy(rng.integers(-5, 5, (rows, W)).astype(np.int32)).to(dev)
    dx = torch.from_numpy(rng.integers(-5, 5, (rows, W)).astype(np.int32)).to(dev)
    w4 = tuple((torch.rand((rows, W), generator=g) * 1.6 - 0.3).to(dev) for _ in range(4))
    prev = _halo_window(Channel(
        rgb=torch.rand((H, W, 3), generator=g).to(dev),
        cnt=torch.randint(0, 17, (H, W), generator=g).float().to(dev),
        oid=torch.from_numpy(rng.integers(0, 4, (H, W)).astype(np.int32)).to(dev)), row0, rows, halo)
    before = (rk.LAUNCHES, rk.TILE_LAUNCHES)
    rgb, cnt = rk.reproject_set(ho, dy, dx, w4, prev, 4, H, row0, halo)
    torch.cuda.synchronize()
    assert (rk.LAUNCHES, rk.TILE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    rgb_p, cnt_p = rk.reproject_window_plain(ho, dy, dx, w4, prev, 4, H, row0, halo)
    torch.testing.assert_close(rgb, rgb_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(cnt, cnt_p, atol=1e-4, rtol=0)
    assert cnt.max() > 0


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
