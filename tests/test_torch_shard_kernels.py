"""PyTorch port, the tile modes of the reprojection kernel K2 and the mono
temporal kernel K8 that the sharded renderer (parallel/shard.py) runs:
their plain versions (which the wrappers run on CPU tensors) against the
JAX kernels in tile mode, interpreted, on 16-row tiles of a 64×32 image
with an 8-row history halo cut from the whole history (the edge tiles'
halos zeros, as the halo exchange leaves them):

- K2 (`reproject_window` with `image_height`/`row_base`/`hist_halo`)
  against `reproject_pallas` in tile mode: rgb atol 1e-5, count 1e-4, and
  bitwise the full-frame plain version's rows;
- K8 (`frame_hist` with `row_base`/`rows`/`hist_halo`) against
  `frame_hist_pallas` in tile mode on the sphere scene (no rounded box: its
  26 candidates take the interpreted compile to minutes) after a ~1.5 px pan
  from a populated history: the temporal-frame bar, atol 2e-4 (rtol 1e-5),
  oid exact; and the stitched tiles bitwise the full-frame plain version.
tests/test_torch_shard.py holds K5's row mode, the tiles of the renderer
and the trainer, and the argument checks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (frame_anchors, history_at, jax_channel, np_, pan_cameras, seeded_channel,
                            sphere_case, to_torch_camera, to_torch_config, to_torch_history, to_torch_scene)
from kylespathtracer_tpu.ops import frame_hist as jfh
from kylespathtracer_tpu.ops import reproject_kernel as jrk
from kylespathtracer_tpu.render import camera as jcam
from kylespathtracer_tpu.utils.config import RenderConfig as JConfig
from kylespathtracer_tpu_torch.ops import frame_hist as fh
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.parallel import shard
from kylespathtracer_tpu_torch.render.pipeline import History

W, H = 64, 32
JCAM = jcam.Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
PREV = jcam.Camera.create(loc=(3.01, 1.99, -3.0), orient=(-0.03, 0.704))


def _anchors(row0: int, rows: int):
    return frame_anchors(JCAM, W, H, row0, rows)


@pytest.mark.parametrize("row0", [0, 8, 16])
def test_reproject_tile_plain_matches_pallas(row0):
    """K2's tile mode (plain version) against `reproject_pallas` in tile
    mode, interpreted: 16 query rows, an 8-row halo window cut from the
    whole history, the edge tiles' halos zeros; also the rows of the
    full-frame plain version (the taps reach at most K = 4 < 8 rows)."""
    rows, halo = 16, 8
    hl, oid = _anchors(row0, rows)
    sl = hl + 0.01
    d_full, s_full = seeded_channel(_anchors(0, H)[1], 1), seeded_channel(_anchors(0, H)[1], 2)
    prev = to_torch_camera(PREV)
    hist = shard.tile_window(History(d_full, s_full, prev), row0, rows, halo)
    got = rk.reproject_window(prev, hl, sl, oid, hist.diffuse, hist.specular, 1.5, window=4,
                              image_height=H, row_base=row0, hist_halo=halo)
    want = jrep_tile(np_(hl), np_(sl), np_(oid), hist, row0, halo)
    for (rgb_t, cnt_t), (rgb_j, cnt_j) in zip(got, want):
        np.testing.assert_allclose(np_(rgb_t), np.asarray(rgb_j), atol=1e-5)
        np.testing.assert_allclose(np_(cnt_t), np.asarray(cnt_j), atol=1e-4)
    assert np_(got[0][1]).max() > 2, "no history carried; the check is vacuous"
    hl_f, oid_f = _anchors(0, H)
    full = rk.reproject_window(prev, hl_f, hl_f + 0.01, oid_f, d_full, s_full, 1.5, window=4)
    for (rgb_t, cnt_t), (rgb_f, cnt_f) in zip(got, full):
        assert torch.equal(rgb_t, rgb_f[row0:row0 + rows]) and torch.equal(cnt_t, cnt_f[row0:row0 + rows])


def jrep_tile(hl, sl, oid, hist: History, row0: int, halo: int):
    """The JAX kernel in tile mode, eagerly: under jit XLA fuses the query
    head's multiply-adds, and the bilinear weights then part from the
    eager ones by an ulp."""
    return jrk.reproject_pallas(
        PREV, jnp.asarray(hl), jnp.asarray(sl), jnp.asarray(oid), jax_channel(hist.diffuse),
        jax_channel(hist.specular), 1.5, window=4, block_rows=8, interpret=True, image_height=H,
        row_base=row0, hist_halo=halo)


# ------------------------------------------------------------- K8 tile mode

def test_frame_hist_tile_plain_matches_pallas():
    """K8's tile mode (plain version) against `frame_hist_pallas` in tile
    mode, interpreted, for both 16-row tiles of the sphere scene after a
    ~1.5 px pan from a populated history; and the stitched tiles against
    the full-frame plain version, bitwise."""
    scene = sphere_case()
    cfg = JConfig(width=W, height=H, pipeline="fused", temporal_fusion="mono")
    prev_cam, cam = pan_cameras(1)
    hist_t = to_torch_history(history_at(scene, prev_cam, cfg))
    kernel = jax.jit(functools.partial(jfh.frame_hist_pallas, block_rows=8, interpret=True, rows=16,
                                       hist_halo=8), static_argnames=("config",))
    args = (to_torch_scene(scene), to_torch_camera(cam), hist_t.camera)
    tiles = []
    for row0 in (0, 16):
        win = shard.tile_window(hist_t, row0, 16, 8)
        ref = kernel(scene, cam, prev_cam, jax_channel(win.diffuse), jax_channel(win.specular), jnp.int32(1),
                     config=cfg, row_base=jnp.int32(row0))
        before = fh.LAUNCHES
        out = fh.frame_hist(*args, win.diffuse, win.specular, 1, to_torch_config(cfg), block_rows=8,
                            row_base=row0, rows=16, hist_halo=8)
        assert fh.LAUNCHES == before  # CPU tensors: the plain version
        for k in ("d_rgb", "d_cnt", "s_rgb", "s_cnt", "alb", "ene"):
            np.testing.assert_allclose(np_(out[k]), np.asarray(ref[k]), atol=2e-4, rtol=1e-5, err_msg=k)
        np.testing.assert_array_equal(np_(out["oid"]), np.asarray(ref["oid"]))
        tiles.append(out)
    full = fh.frame_hist_plain(*args, hist_t.diffuse, hist_t.specular, 1, to_torch_config(cfg))
    for k, v in full.items():
        assert torch.equal(torch.cat([t[k] for t in tiles]), v), k
    assert full["d_cnt"].max() > 2, "history not carried"
