"""PyTorch port, the slice as a whole: the fused temporal frame
(`render_frame`, pipeline="fused", window reprojection, split tail) against
the JAX package's own composition of `split_temporal_frame`, frame by frame
over a 3-frame pan with populated history.

The JAX side stands `frame_forward_jnp` in for the frame kernel and the
exact gather `reproject` in for the windowed kernel; the coverage asserts
prove every live tap lies inside ±K, where the two agree (the
`_frame_hist_oracle` pattern of tests/test_pallas_small.py). The pan
crosses 8-row blocks and produces negative bilinear fractions. Tolerance:
the JAX package's temporal-frame bar, atol 2e-4 (rtol 1e-5); `oid` exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (
    np_, to_torch_camera, to_torch_config, to_torch_history, to_torch_scene,
)
from kylespathtracer_tpu.core import gmath as jgmath
from kylespathtracer_tpu.ops import frame_kernel as jfk
from kylespathtracer_tpu.render import composite as jcomp
from kylespathtracer_tpu.render import reproject as jrep
from kylespathtracer_tpu.render.camera import Camera, ray_dirs
from kylespathtracer_tpu.render.passes import Channel, _temporal_clamp, count_floor
from kylespathtracer_tpu.render.pipeline import History
from kylespathtracer_tpu.scene import default_scene
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.app import driver
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.render import pipeline

W, H = 64, 32
CFG = RenderConfig(width=W, height=H, pipeline="fused")
CAM0 = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
# Per frame: ~1.5 px up, ~0.5 px sideways, plus a small translation so the
# velocity clamp engages.
D_ORIENT = jnp.asarray([-0.03, 0.004], jnp.float32)
D_LOC = jnp.asarray([0.001, -0.0015, 0.001], jnp.float32)
TOL = dict(atol=2e-4, rtol=1e-5)


def _pan(n):
    cams = [CAM0]
    for _ in range(n):
        c = cams[-1]
        cams.append(c.replace(orient=c.orient + D_ORIENT, loc=c.loc + D_LOC))
    return cams


def _jax_frame(scene, cam, hist, frame, cfg):
    """split_temporal_frame's composition with the plain stand-ins; also
    returns both anchor sets for the coverage asserts."""
    out = jfk.frame_forward_jnp(scene, cam, jnp.int32(frame), cfg)
    rd = ray_dirs(cam, cfg.width, cfg.height, cfg.fov)
    hl = cam.loc + rd * out["depth"][..., None]
    light_dist = jgmath.length(hl - scene.light[:3])
    fac = jgmath.EPS / jnp.sqrt(jnp.maximum(jgmath.EPS, out["curv"]))
    sl = hl + rd * (light_dist * fac)[..., None]
    vv = jgmath.length(cam.loc - hist.camera.loc)
    prev = hist.camera

    def accum(ch, anchor, add):
        rgb, cnt = jrep.reproject(prev.loc, prev.orient, anchor, out["oid"],
                                  ch.rgb, ch.cnt, ch.oid, cfg.fov)
        rgb, cnt = _temporal_clamp(rgb, count_floor(cnt), vv, cfg)
        return Channel(rgb=rgb + add, cnt=cnt + 1.0, oid=out["oid"])

    d = accum(hist.diffuse, hl, out["add_d"])
    s = accum(hist.specular, sl, out["add_s"])
    image = jcomp.composite_from(out["alb"], out["ene"], d, s, cfg)
    return image, History(diffuse=d, specular=s, camera=cam), (hl, sl)


def _assert_coverage(prev_cam, anchors, K):
    """Every live tap inside ±K (so window == exact gather), taps crossing
    8-row blocks, and negative bilinear fractions somewhere."""
    py = np.arange(H)[:, None] + np.zeros((H, W), np.int64)
    px = np.arange(W)[None, :] + np.zeros((H, W), np.int64)
    crosses = negative = False
    for anchor in anchors:
        iuv, duv, inside = jrep.reproject_query(
            prev_cam.loc, prev_cam.orient, anchor, CFG.fov, (H, W))
        iv, iu = np.asarray(iuv[..., 1]), np.asarray(iuv[..., 0])
        live = np.asarray(inside) & (iv >= -1) & (iv < H) & (iu >= -1) & (iu < W)
        dy, dx = (iv - py)[live], (iu - px)[live]
        assert dy.min() >= -K and dy.max() <= K - 1, "taps beyond K; fix the pan"
        assert dx.min() >= -K and dx.max() <= K - 1, "taps beyond K; fix the pan"
        crosses |= bool(((iv // 8 != py // 8) & live).any())
        negative |= bool((np.asarray(duv)[live] < 0).any())
    assert crosses, "pan no longer crosses a row block; fix the test"
    assert negative, "no negative bilinear fractions; fix the test"


def _populated_history(scene, cam):
    prev_oid = jfk.frame_forward_jnp(scene, cam, jnp.int32(0), CFG)["oid"]

    def channel(seed):
        r = np.random.default_rng(seed)
        return Channel(
            rgb=jnp.asarray(r.uniform(0.0, 2.0, (H, W, 3)), jnp.float32),
            cnt=jnp.asarray(r.integers(0, 17, (H, W)).astype(np.float32)),
            oid=prev_oid,
        )

    return History(diffuse=channel(1), specular=channel(2), camera=cam)


def test_temporal_pan_matches_jax_frame_by_frame():
    scene = default_scene()
    cams = _pan(3)
    hist_j = _populated_history(scene, cams[0])
    scene_t, cfg_t = to_torch_scene(scene), to_torch_config(CFG)
    hist_t = to_torch_history(hist_j)
    for i, cam in enumerate(cams[1:], start=1):
        img_j, new_j, anchors = _jax_frame(scene, cam, hist_j, i, CFG)
        _assert_coverage(hist_j.camera, anchors, CFG.reproject_window)
        img_t, hist_t = pipeline.render_frame(scene_t, to_torch_camera(cam), hist_t, i, cfg_t)
        assert img_t.shape == (H, W, 3) and torch.isfinite(img_t).all()
        np.testing.assert_allclose(np_(img_t), np.asarray(img_j), err_msg=f"image {i}", **TOL)
        for name in ("diffuse", "specular"):
            a, b = getattr(hist_t, name), getattr(new_j, name)
            np.testing.assert_allclose(np_(a.rgb), np.asarray(b.rgb), err_msg=f"{name} rgb {i}", **TOL)
            np.testing.assert_allclose(np_(a.cnt), np.asarray(b.cnt), err_msg=f"{name} cnt {i}", **TOL)
            np.testing.assert_array_equal(np_(a.oid), np.asarray(b.oid))
        assert np_(hist_t.diffuse.cnt).max() > 2, "history not carried"
        hist_j = new_j


def test_render_sequence_and_animation_equal_the_frame_loop():
    scene_t, cfg_t = to_torch_scene(default_scene()), to_torch_config(CFG)
    cams = [to_torch_camera(c) for c in _pan(2)]
    stacked = pipeline.Camera(loc=torch.stack([c.loc for c in cams]),
                              orient=torch.stack([c.orient for c in cams]))
    hist = pipeline.init_history(cfg_t, cams[0])
    h = hist
    frames = []
    for i, c in enumerate(cams):
        img, h = pipeline.render_frame(scene_t, c, h, i, cfg_t)
        frames.append(img)
    seq, h_seq = pipeline.render_sequence(scene_t, stacked, hist, cfg_t)
    assert torch.equal(seq, torch.stack(frames))
    assert torch.equal(h_seq.diffuse.rgb, h.diffuse.rgb)
    last, h_anim = driver.render_animation(scene_t, cfg_t, num_frames=3, cameras=stacked)
    assert torch.equal(last, frames[-1])
    assert torch.equal(h_anim.specular.cnt, h.specular.cnt)
    before = (fk.LAUNCHES, rk.LAUNCHES)
    pipeline.render_image(scene_t, cams[0], cfg_t, frames=2)
    assert (fk.LAUNCHES, rk.LAUNCHES) == before  # CPU: the plain versions


@pytest.mark.parametrize(
    "kw,item",
    [
        (dict(pipeline="pass"), "#11"),
        (dict(pipeline="fused", no_history=True), "#9"),
        (dict(pipeline="fused", reproject_backend="xla"), "#9"),
        (dict(pipeline="fused", temporal_fusion="mono"), "#12"),
        (dict(pipeline="pass", intersect_mode="march"), "#11"),
        (dict(pipeline="pass", normal_mode="tetra"), "#11"),
    ],
)
def test_unported_branches_raise(kw, item):
    """The branches of render_frame the port did not serve at first now
    render (the pass pipeline, #11, and the mono frame, #12: held to JAX in
    tests/test_torch_passes.py and tests/test_torch_mono.py; the #9
    branches in tests/test_torch_frame_grad.py); the sphere trace and the
    tetrahedron normals still raise, naming ROADMAP Queue 1 #11."""
    cfg = to_torch_config(RenderConfig(width=8, height=8, **kw))
    scene_t = to_torch_scene(default_scene())
    cam = to_torch_camera(CAM0)
    hist = pipeline.init_history(cfg, cam)
    if cfg.intersect_mode == "march" or cfg.normal_mode == "tetra":
        with pytest.raises(NotImplementedError, match=item):
            pipeline.render_frame(scene_t, cam, hist, 0, cfg)
        return
    img, _ = pipeline.render_frame(scene_t, cam, hist, 0, cfg)
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()


def test_driver_unported_options_raise():
    cfg = to_torch_config(CFG)
    with pytest.raises(NotImplementedError, match="checkpoint_dir"):
        driver.render_animation(to_torch_scene(default_scene()), cfg, num_frames=1,
                                checkpoint_dir="ckpt")
