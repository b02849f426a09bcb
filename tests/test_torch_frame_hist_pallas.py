"""PyTorch port, the mono temporal frame (K8, ops/frame_hist.py): its plain
version (`frame_hist_plain`, which the wrapper `frame_hist` runs on CPU
tensors) against the JAX kernel `frame_hist_pallas(..., block_rows=8,
interpret=True)`, K's clamp to the block height, and the tile mode's
rows against the full frame's; tests/test_torch_mono.py holds `render_frame` with
`temporal_fusion="mono"` against the JAX package's.

The kernel case follows tests/test_pallas_small.py's
`test_frame_hist_kernel_pallas_call`: a populated history (numpy-seeded
rgb and counts on the previous camera's object IDs), a ~1.5 px pan that
crosses the 8-row blocks and gives negative bilinear fractions, and a small
translation that engages the velocity clamp (`_torch_helpers.pan_cameras`);
the coverage asserts prove all three. The scene is three spheres over the
floor (`_torch_helpers.sphere_case`). Tolerance: the temporal-frame bar, atol 2e-4 (rtol 1e-5); `oid` exact."""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_helpers import (history_at, np_, pan_cameras, sphere_case, to_torch_camera,
                            to_torch_channel, to_torch_config, to_torch_history, to_torch_scene)
from kylespathtracer_tpu.core import gmath as jgmath
from kylespathtracer_tpu.ops import frame_hist as jfh
from kylespathtracer_tpu.ops import frame_kernel as jfk
from kylespathtracer_tpu.render.camera import ray_dirs
from kylespathtracer_tpu.render.reproject import reproject_query
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.ops import frame_hist as fh

W, H = 64, 32
TOL = dict(atol=2e-4, rtol=1e-5)
KEYS = ("d_rgb", "d_cnt", "s_rgb", "s_cnt", "alb", "ene")


def _assert_coverage(scene, cam, prev_cam, cfg, K):
    """Every live tap inside ±K, taps crossing 8-row blocks, negative
    bilinear fractions (tests/test_pallas_small.py:254-271), for both
    anchors."""
    out = jfk.frame_forward_jnp(scene, cam, jnp.int32(1), cfg)
    rd = ray_dirs(cam, W, H, cfg.fov)
    hl = cam.loc + rd * out["depth"][..., None]
    fac = jgmath.EPS / jnp.sqrt(jnp.maximum(jgmath.EPS, out["curv"]))
    sl = hl + rd * (jgmath.length(hl - scene.light[:3]) * fac)[..., None]
    py = np.arange(H)[:, None] + np.zeros((H, W), np.int64)
    px = np.arange(W)[None, :] + np.zeros((H, W), np.int64)
    crosses = negative = False
    for anchor in (hl, sl):
        iuv, duv, inside = reproject_query(prev_cam.loc, prev_cam.orient, anchor, cfg.fov, (H, W))
        iv, iu = np.asarray(iuv[..., 1]), np.asarray(iuv[..., 0])
        live = np.asarray(inside) & (iv >= -1) & (iv < H) & (iu >= -1) & (iu < W)
        dy, dx = (iv - py)[live], (iu - px)[live]
        assert dy.min() >= -K and dy.max() <= K - 1, "taps beyond K; fix the pan"
        assert dx.min() >= -K and dx.max() <= K - 1, "taps beyond K; fix the pan"
        crosses |= bool(((iv // 8 != py // 8) & live).any())
        negative |= bool((np.asarray(duv)[live] < 0).any())
    assert crosses, "pan no longer crosses a block halo; fix the test"
    assert negative, "no negative bilinear fractions; fix the test"


def test_frame_hist_plain_matches_interpreted_pallas():
    scene = sphere_case()
    cfg = RenderConfig(width=W, height=H, pipeline="fused", temporal_fusion="mono",
                       reproject_window=2)
    prev_cam, cam = pan_cameras(1)
    hist = history_at(scene, prev_cam, cfg)
    _assert_coverage(scene, cam, prev_cam, cfg, cfg.reproject_window)
    kernel = jax.jit(functools.partial(jfh.frame_hist_pallas, block_rows=8, interpret=True),
                     static_argnames=("config",))
    ref = kernel(scene, cam, prev_cam, hist.diffuse, hist.specular, jnp.int32(1), config=cfg)

    args = (to_torch_scene(scene), to_torch_camera(cam), to_torch_camera(prev_cam),
            to_torch_channel(hist.diffuse), to_torch_channel(hist.specular), 1, to_torch_config(cfg))
    before = fh.LAUNCHES
    out = fh.frame_hist(*args, block_rows=8)
    assert fh.LAUNCHES == before  # CPU tensors: the plain version
    for k in KEYS:
        assert np.isfinite(np_(out[k])).all(), k
        np.testing.assert_allclose(np_(out[k]), np.asarray(ref[k]), err_msg=k, **TOL)
    np.testing.assert_array_equal(np_(out["oid"]), np.asarray(ref["oid"]))
    assert np_(out["d_cnt"]).max() > 2, "history not carried"
    assert np_(out["d_cnt"]).max() <= cfg.temporal + 1.0


def test_window_clamps_to_the_block_height():
    """K = min(reproject_window, block_rows) with the JAX kernel's auto
    block_rows: 32 rows at 64 wide, 8 at 1920 wide; a wider window warns and
    renders exactly as the clamped one."""
    cfg = RenderConfig(width=W, height=H, reproject_window=40)
    with pytest.warns(UserWarning, match=r"block_rows=32\); clamping to 32"):
        assert fh.window_k(cfg) == 32
    with pytest.warns(UserWarning, match=r"block_rows=8\); clamping to 8"):
        assert fh.window_k(dataclasses.replace(cfg, width=1920, height=1080)) == 8
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert fh.window_k(dataclasses.replace(cfg, reproject_window=4)) == 4
        assert fh.window_k(cfg, block_rows=64) == 40

    scene = sphere_case()
    prev_cam, cam = pan_cameras(1)
    hist = history_at(scene, prev_cam, cfg)
    args = (to_torch_scene(scene), to_torch_camera(cam), to_torch_camera(prev_cam),
            to_torch_channel(hist.diffuse), to_torch_channel(hist.specular), 1)
    with pytest.warns(UserWarning, match="clamping to 32"):
        wide = fh.frame_hist_plain(*args, to_torch_config(cfg))
    clamped = fh.frame_hist_plain(*args, to_torch_config(dataclasses.replace(cfg, reproject_window=32)))
    for k in KEYS + ("oid",):
        np.testing.assert_array_equal(np_(wide[k]), np_(clamped[k]), err_msg=k)


def test_tile_mode_waits_for_sharding():
    """The tile mode that the sharded renderer runs (it waited for
    parallel/shard.py, which now drives it): rows [8, 16) against an 8-row
    history halo cut from the whole history are bitwise the full frame's
    rows; tests/test_torch_shard_kernels.py holds it against the JAX
    kernel's tile mode."""
    from kylespathtracer_tpu_torch.parallel import shard

    scene = sphere_case()
    cfg = to_torch_config(RenderConfig(width=W, height=H))
    prev_cam, cam = pan_cameras(1)
    h = to_torch_history(history_at(scene, prev_cam, RenderConfig(width=W, height=H)))
    args = (to_torch_scene(scene), to_torch_camera(cam), h.camera)
    win = shard.tile_window(h, 8, 8, 8)
    tile = fh.frame_hist(*args, win.diffuse, win.specular, 1, cfg, block_rows=8, row_base=8, rows=8,
                         hist_halo=8)
    full = fh.frame_hist(*args, h.diffuse, h.specular, 1, cfg, block_rows=8)
    for k in KEYS + ("oid",):
        np.testing.assert_array_equal(np_(tile[k]), np_(full[k])[8:16], err_msg=k)
