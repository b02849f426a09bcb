"""PyTorch port on the card: the CUDA kernels against their plain versions
on the same CUDA tensors, and the frame on the card against the CPU.

Marked `cuda`; each test skips without a CUDA device (decided in the
fixture, never at import). Run on a GPU machine with
`python -m pytest tests/test_torch_cuda.py -q --noconftest` (tests/conftest.py
imports jax, which a GPU machine need not have).
"""

import numpy as np
import pytest
import torch

from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.render import pipeline
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.render.passes import Channel
from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene
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
