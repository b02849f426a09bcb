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
    np_, pass_pan_matches_jax, to_torch_camera, to_torch_config, to_torch_history, to_torch_scene,
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
    """The branches of render_frame the port did not serve at first (`item`:
    the number their queue item once had) all render: the pass pipeline and
    the mono frame (held to JAX in tests/test_torch_passes.py and
    tests/test_torch_mono.py), the differentiable fused frames (in
    tests/test_torch_frame_grad.py), and the sphere trace and the
    tetrahedron normals, held here to JAX's pass frames over a 3-frame pan
    from a populated history (`pass_pan_matches_jax`: atol 2e-4, oid
    exact)."""
    cfg = to_torch_config(RenderConfig(width=8, height=8, **kw))
    if cfg.intersect_mode == "march" or cfg.normal_mode == "tetra":
        pass_pan_matches_jax({k: v for k, v in kw.items() if k != "pipeline"})
        return
    scene_t = to_torch_scene(default_scene())
    cam = to_torch_camera(CAM0)
    hist = pipeline.init_history(cfg, cam)
    img, _ = pipeline.render_frame(scene_t, cam, hist, 0, cfg)
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()


def test_driver_unported_options_raise(tmp_path, capsys):
    """The options that raised before their port (checkpoint_dir,
    checkpoint_every, preview, resume) now run: a checkpoint at frame 1,
    a resume from it that previews the frames after it."""
    cfg = to_torch_config(CFG)
    scene = to_torch_scene(default_scene())
    driver.render_animation(scene, cfg, num_frames=2, checkpoint_dir=tmp_path, checkpoint_every=1)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_1"]
    img, _ = driver.render_animation(scene, cfg, num_frames=3, checkpoint_dir=tmp_path, resume=True,
                                     preview=True)
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 1" in out and "frame 2" in out and "frame 1 " not in out
    assert img.shape == (cfg.height, cfg.width, 3) and torch.isfinite(img).all()


# The split frame on the CPU: image rows (row0, rows) with a history halo,
# and whether the camera only turns (vv = 0: the clamp's limit is T).
SPLIT_CASES = {"frame": (0, H, 0, False), "tile": (8, 16, 8, False), "still": (0, H, 0, True)}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_frame_on_cpu_runs_the_plain_tail_after_k1(case):
    """On CPU tensors the split frame counts no K2 launch, with or without
    its tail, and its image and history are exactly K1's plain frame, the
    rays and anchors (`reprojection_anchors`),
    `reproject_window`, `accumulate` for each set and `composite_from`, as
    the frame was composed before K2 took the rays, the anchors and the
    tail: the full frame through render_frame on a camera that moved (the
    velocity clamp cuts counts), the sharded renderer's middle tile on its
    history window, and a camera that only turns (the clamp's limit is T)."""
    from kylespathtracer_tpu_torch.core import gmath
    from kylespathtracer_tpu_torch.parallel.shard import tile_window
    from kylespathtracer_tpu_torch.render.camera import Camera as TCamera
    from kylespathtracer_tpu_torch.render.composite import composite_from
    from kylespathtracer_tpu_torch.render.passes import _temporal_clamp as t_clamp
    from kylespathtracer_tpu_torch.render.passes import accumulate, reprojection_anchors
    from kylespathtracer_tpu_torch.render.passes import count_floor as t_floor

    row0, rows, halo, still = SPLIT_CASES[case]
    scene_t, cfg_t = to_torch_scene(default_scene()), to_torch_config(CFG)
    cams = _pan(2)
    hist = to_torch_history(_populated_history(default_scene(), cams[0]))
    cam = to_torch_camera(cams[1])
    # Moving, the camera stands ~0.017 from where the history was rendered:
    # the clamp's limit is T - 4, under most carried counts.
    step = torch.zeros(3) if still else torch.tensor([0.01, -0.01, 0.01])
    cam = TCamera(loc=hist.camera.loc + step, orient=cam.orient)
    before = (rk.LAUNCHES, rk.TILE_LAUNCHES, rk.TAIL_LAUNCHES)
    if halo:
        hist = tile_window(hist, row0, rows, halo)
        img, new = pipeline.split_temporal_frame(scene_t, cam, hist, 1, cfg_t, row_base=row0, rows=rows,
                                                 hist_halo=halo)
        out = fk.frame_forward(scene_t, cam, 1, cfg_t, row0, rows)
        tile = dict(image_height=H, row_base=row0, hist_halo=halo)
    else:
        img, new = pipeline.render_frame(scene_t, cam, hist, 1, cfg_t)
        out = fk.frame_forward(scene_t, cam, 1, cfg_t)
        tile = {}
    assert (rk.LAUNCHES, rk.TILE_LAUNCHES, rk.TAIL_LAUNCHES) == before

    hl, sl = reprojection_anchors(scene_t, cam, out, cfg_t.fov, H, row0)
    (rgb_d, cnt_d), (rgb_s, cnt_s) = rk.reproject_window(hist.camera, hl, sl, out["oid"], hist.diffuse,
                                                         hist.specular, cfg_t.fov, window=cfg_t.reproject_window,
                                                         **tile)
    vv = gmath.length(cam.loc - hist.camera.loc)
    d = accumulate(rgb_d, cnt_d, out["add_d"], vv, out["oid"], cfg_t)
    s = accumulate(rgb_s, cnt_s, out["add_s"], vv, out["oid"], cfg_t)
    assert img.shape == (rows, W, 3)
    assert torch.equal(img, composite_from(out["alb"], out["ene"], d, s, cfg_t))
    for a, b in ((new.diffuse, d), (new.specular, s)):
        assert torch.equal(a.rgb, b.rgb) and torch.equal(a.cnt, b.cnt) and torch.equal(a.oid, b.oid)
    assert new.diffuse.cnt.max().item() > 2, "history not carried"
    # Not vacuous: moving, the clamp cuts counts under T; still, exactly
    # those past T.
    floor = t_floor(cnt_d)
    cut = t_clamp(rgb_d, floor, vv, cfg_t)[1] < floor
    if still:
        assert vv.item() == 0 and torch.equal(cut, floor > cfg_t.temporal)
    else:
        assert vv.item() > 0 and (cut & (floor <= cfg_t.temporal)).any()
