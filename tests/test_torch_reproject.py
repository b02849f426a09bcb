"""PyTorch port, reprojection kernel module (K2): the windowed tap sum's
plain version against the JAX package's `reproject_pallas` (interpret mode)
and against the exact gather inside the window. Tolerances: the JAX
package's own reprojection bar, rgb atol 1e-5 and cnt atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import np_, to_torch_camera, to_torch_channel
from kylespathtracer_tpu.ops import frame_kernel as jfk
from kylespathtracer_tpu.ops import reproject_kernel as jrk
from kylespathtracer_tpu.render import reproject as jrep
from kylespathtracer_tpu.render.camera import Camera, ray_dirs
from kylespathtracer_tpu.render.passes import Channel
from kylespathtracer_tpu.scene import default_scene
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.render import reproject as rep

CAM = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_reproject_window_matches_pallas_interpret():
    """Real hit geometry, a sub-window camera move, populated history, two
    8-row blocks: both channel sets equal the TPU kernel's."""
    W, H = 64, 16
    cfg = RenderConfig(width=W, height=H)
    gb = jfk.frame_forward_jnp(default_scene(), CAM, jnp.int32(0), cfg)
    rd = ray_dirs(CAM, W, H, cfg.fov)
    hl = CAM.loc + rd * gb["depth"][..., None]
    sl = hl + rd * 0.05
    ho = gb["oid"]
    rng = np.random.default_rng(0)

    def channel():
        return Channel(
            rgb=jnp.asarray(rng.uniform(0, 1, (H, W, 3)), jnp.float32),
            cnt=jnp.asarray(rng.integers(1, 5, (H, W)).astype(np.float32)),
            oid=ho,
        )

    pd, ps = channel(), channel()
    prev = CAM.replace(
        loc=CAM.loc + jnp.asarray([0.002, -0.001, 0.001], jnp.float32),
        orient=CAM.orient + jnp.asarray([-0.02, 2e-3], jnp.float32),
    )
    ref = jrk.reproject_pallas(prev, hl, sl, ho, pd, ps, cfg.fov, window=4,
                               block_rows=8, interpret=True)
    out = rk.reproject_window(
        to_torch_camera(prev), _t(hl), _t(sl), _t(ho),
        to_torch_channel(pd), to_torch_channel(ps), cfg.fov, window=4,
    )
    for (rgb_t, cnt_t), (rgb_j, cnt_j) in zip(out, ref):
        np.testing.assert_allclose(np_(rgb_t), np.asarray(rgb_j), atol=1e-5)
        np.testing.assert_allclose(np_(cnt_t), np.asarray(cnt_j), atol=1e-4)
    assert np_(out[0][1]).max() > 0, "no history carried; the test is vacuous"


H, W = 32, 48


def _channels(rng):
    return Channel(
        rgb=jnp.asarray(rng.random((H, W, 3), np.float32)),
        cnt=jnp.asarray(rng.integers(0, 16, (H, W)).astype(np.float32)),
        oid=jnp.asarray(rng.integers(0, 4, (H, W)).astype(np.int32)),
    )


@pytest.mark.parametrize("K", [4, 8])
def test_windowed_matches_exact_gather_within_window(K):
    """Random anchors, some reprojecting nearby (covered), some far
    (dropped): equal to the exact gather where the 2x2 taps lie inside
    ±K, zero history beyond."""
    rng = np.random.default_rng(0)
    prev_cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    hl = (rng.normal(0, 2, (H, W, 3)) + np.array([0, 0, 5])).astype(np.float32)
    ho = rng.integers(0, 4, (H, W)).astype(np.int32)
    pd, ps = _channels(rng), _channels(rng)

    (rgb_w, cnt_w), _ = rk.reproject_window(
        to_torch_camera(prev_cam), _t(hl), _t(hl + 0.1), _t(ho),
        to_torch_channel(pd), to_torch_channel(ps), 1.5, window=K,
    )
    rgb_x, cnt_x = jrep.reproject(
        prev_cam.loc, prev_cam.orient, jnp.asarray(hl), jnp.asarray(ho),
        pd.rgb, pd.cnt, pd.oid, 1.5,
    )
    iuv, _, _ = jrep.reproject_query(prev_cam.loc, prev_cam.orient,
                                     jnp.asarray(hl), 1.5, (H, W))
    dy = np.asarray(iuv[..., 1]) - np.arange(H)[:, None]
    dx = np.asarray(iuv[..., 0]) - np.arange(W)[None, :]
    full = (dy >= -K) & (dy <= K - 1) & (dx >= -K) & (dx <= K - 1)
    beyond = (np.abs(dy) > K + 1) | (np.abs(dx) > K + 1)
    assert full.any() and beyond.any()
    np.testing.assert_allclose(np_(rgb_w)[full], np.asarray(rgb_x)[full], atol=1e-5)
    np.testing.assert_allclose(np_(cnt_w)[full], np.asarray(cnt_x)[full], atol=1e-4)
    assert np.abs(np_(cnt_w)[beyond]).max() == 0.0
    assert np.abs(np_(rgb_w)[beyond]).max() == 0.0


def test_window_above_eight_clamps_with_warning():
    """K = min(window, MAX_WINDOW=8), as the TPU kernel clamps: window 12
    warns and gives exactly the window-8 result."""
    rng = np.random.default_rng(3)
    cam = to_torch_camera(Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7)))
    hl = _t((rng.normal(0, 2, (H, W, 3)) + np.array([0, 0, 5])).astype(np.float32))
    ho = _t(rng.integers(0, 4, (H, W)).astype(np.int32))
    pd, ps = to_torch_channel(_channels(rng)), to_torch_channel(_channels(rng))
    with pytest.warns(UserWarning, match="clamping to 8"):
        wide = rk.reproject_window(cam, hl, hl, ho, pd, ps, 1.5, window=12)
    eight = rk.reproject_window(cam, hl, hl, ho, pd, ps, 1.5, window=8)
    for a, b in zip(wide, eight):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_queries_match_jax():
    rng = np.random.default_rng(9)
    prev = Camera.create(loc=(3.1, 2.0, -3.0), orient=(0.01, 0.69))
    hl = (rng.normal(0, 2, (H, W, 3)) + np.array([0, 0, 5])).astype(np.float32)
    ho = rng.integers(0, 4, (H, W)).astype(np.int32)
    dyr, dxr, w4 = rk._queries(to_torch_camera(prev), _t(hl), _t(ho), 1.5, H, W)
    jdyr, jdxr, jw4 = jrk._queries(prev, jnp.asarray(hl), jnp.asarray(ho), 1.5, H, W)
    live = np.asarray(jw4[2]) != 0
    np.testing.assert_array_equal(np_(dyr)[live], np.asarray(jdyr)[live])
    np.testing.assert_array_equal(np_(dxr)[live], np.asarray(jdxr)[live])
    for a, b in zip(w4, jw4):
        np.testing.assert_allclose(np_(a), np.asarray(b), atol=2e-5)
    iuv, duv, inside = rep.reproject_query(
        to_torch_camera(prev).loc, to_torch_camera(prev).orient, _t(hl), 1.5, (H, W))
    assert iuv.dtype == torch.int32 and inside.dtype == torch.bool


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(1)
    ho = _t(rng.integers(0, 4, (H, W)).astype(np.int32))
    zeros = torch.zeros((H, W), dtype=torch.int32)
    w4 = tuple(torch.full((H, W), 0.5) for _ in range(4))
    prev = to_torch_channel(_channels(rng))
    before = rk.LAUNCHES
    a = rk.reproject_set(ho, zeros, zeros, w4, prev, 4)
    b = rk.reproject_window_plain(ho, zeros, zeros, w4, prev, 4)
    assert rk.LAUNCHES == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # Zero motion, all weights 0.5: each matching tap adds 0.25 of itself.
    match = (prev.oid == ho)
    assert torch.all(a[1][match] >= 0.25 * prev.cnt[match] - 1e-6)
