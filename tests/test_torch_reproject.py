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
    """On CPU tensors reproject_window launches nothing and is, for each
    channel set, the query head `_queries` then the tap sum
    `reproject_window_plain`."""
    rng = np.random.default_rng(1)
    cam = to_torch_camera(Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7)))
    hl = _t((rng.normal(0, 2, (H, W, 3)) + np.array([0, 0, 5])).astype(np.float32))
    sl = hl + 0.05
    ho = _t(rng.integers(0, 4, (H, W)).astype(np.int32))
    pd, ps = to_torch_channel(_channels(rng)), to_torch_channel(_channels(rng))
    before = rk.LAUNCHES
    got = rk.reproject_window(cam, hl, sl, ho, pd, ps, 1.5, window=4)
    assert rk.LAUNCHES == before
    for anchor, prev, (rgb, cnt) in zip((hl, sl), (pd, ps), got):
        dyrel, dxrel, w4 = rk._queries(cam, anchor, ho, 1.5, H, W)
        rgb_p, cnt_p = rk.reproject_window_plain(ho, dyrel, dxrel, w4, prev, 4)
        assert torch.equal(rgb, rgb_p) and torch.equal(cnt, cnt_p)
    assert got[0][1].max() > 0, "no history carried; the test is vacuous"


def _window_case(H, W, row0, rows, halo, seed):
    """`reproject_window`'s arguments on the CPU: anchors at random depths
    along the rays of a camera that moved from the previous one, object IDs
    mostly one object's, and histories of rows + 2·halo rows from image row
    row0 - halo."""
    from kylespathtracer_tpu_torch.render.camera import Camera as TCamera
    from kylespathtracer_tpu_torch.render.camera import ray_dirs_window
    from kylespathtracer_tpu_torch.render.passes import Channel as TChannel

    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    prev = TCamera.create(loc=(3.0, 2.0, -3.0), orient=(0.01, 0.69), device="cpu")
    cam = TCamera.create(loc=(3.008, 1.996, -3.006), orient=(0.0, 0.7), device="cpu")
    depth = f(rng.uniform(2.0, 8.0, (rows, W, 2)))
    rd = ray_dirs_window(cam, W, H, row0, rows, 1.5)
    hl, sl = cam.loc + rd * depth[..., :1], cam.loc + rd * depth[..., 1:]
    ids = lambda n: torch.from_numpy(rng.choice(np.array([1, 2], np.int32), (n, W), p=[0.9, 0.1]))
    ho = ids(rows)

    def channel():
        n = rows + 2 * halo
        return TChannel(rgb=f(rng.uniform(0.0, 2.0, (n, W, 3))), cnt=f(rng.integers(8, 17, (n, W))), oid=ids(n))

    return prev, hl, sl, ho, channel(), channel()


WINDOW_TILES = {"frame": (32, 48, 0, 32, 0), "tile": (48, 40, 16, 16, 8)}


@pytest.mark.parametrize("case", list(WINDOW_TILES))
def test_reproject_window_without_a_tail_returns_the_tap_sums(case):
    """`reproject_window` keeps its four outputs: for each channel set the
    query head and the tap sum, nothing accumulated, full frame and tile."""
    Hi, Wi, row0, rows, halo = WINDOW_TILES[case]
    prev, hl, sl, ho, pd, ps = _window_case(Hi, Wi, row0, rows, halo, 6)
    tile = dict(image_height=Hi, row_base=row0, hist_halo=halo) if halo else {}
    got = rk.reproject_window(prev, hl, sl, ho, pd, ps, 1.5, window=8, **tile)
    want = rk.reproject_frame_plain(prev, hl, sl, ho, pd, ps, 1.5, 8, Hi, row0, halo)
    assert len(got) == 2
    for (rgb, cnt), (rgb_p, cnt_p) in zip(got, want):
        assert rgb.shape == (rows, Wi, 3) and cnt.shape == (rows, Wi)
        assert torch.equal(rgb, rgb_p) and torch.equal(cnt, cnt_p)
    assert got[0][1].max().item() > 0, "no history carried; the test is vacuous"


# The image rows (row0, rows) of a 48×24 frame whose anchors K2's twin builds.
ANCHOR_ROWS = {"frame": (0, 24), "tile": (8, 8)}


@pytest.mark.parametrize("case", list(ANCHOR_ROWS))
def test_twin_anchors_are_the_rays_and_specular_anchor_computed_apart(case):
    """The anchors that K2 with its tail builds in its head, as its CPU twin
    builds them from K1's planes (`reprojection_anchors`), are exactly the
    primary rays of `ray_dirs_window` (those rows of `ray_dirs`), the hit
    point loc + rd·depth and `specular_anchor`, computed one after another
    here, on a view of spheres with misses, curvature 0 and under EPS
    (where the clamp to EPS engages) and over it."""
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.render.camera import ray_dirs as t_ray_dirs
    from kylespathtracer_tpu_torch.render.camera import ray_dirs_window
    from kylespathtracer_tpu_torch.render.passes import reprojection_anchors, specular_anchor
    from kylespathtracer_tpu_torch.scene.scene import sphere_scene

    W, H = 48, 24
    row0, rows = ANCHOR_ROWS[case]
    scene = sphere_scene([[5.5, 1.0, 0.0], [4.0, 0.5, 1.0], [6.0, 2.5, -1.5]], [1.0, 0.5, 0.7],
                         [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]], device="cpu")
    cam = to_torch_camera(CAM)
    cfg = RenderConfig(width=W, height=H)
    out = fk.frame_forward(scene, cam, 1, cfg, row0, rows)
    hl, sl = reprojection_anchors(scene, cam, out, cfg.fov, H, row0)
    rd = ray_dirs_window(cam, W, H, row0, rows, cfg.fov)
    assert torch.equal(rd, t_ray_dirs(cam, W, H, cfg.fov)[row0:row0 + rows])
    want_hl = cam.loc + rd * out["depth"][..., None]
    assert hl.shape == (rows, W, 3)
    assert torch.equal(hl, want_hl)
    assert torch.equal(sl, specular_anchor(scene, want_hl, rd, out["curv"]))
    curv = out["curv"]
    assert (out["oid"] == 0).any() and (out["oid"] > 0).any(), "no miss or no hit; vacuous"
    assert (curv == 0).any() and ((curv > 0) & (curv < 1e-3)).any() and (curv > 1e-3).any(), "a curvature untested"
