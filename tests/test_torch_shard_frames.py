"""PyTorch port, the sharded renderer's tiles against the JAX package's
unsharded frame: two 8-row tiles of `parallel.shard._render_row_block`,
rendered one at a time in one process on the windows `shard.tile_window`
cuts from the whole history (what the halo exchange assembles) and
stitched, against JAX's `render_frame` on the same inputs, for the split,
mono and pass frames (tests/test_torch_shard.py holds the same tiles
against the port's own unsharded frame). The fused frames' fallback warning
is an error here, so the tile kernels' modes run (their plain versions).
The scene is three spheres over the floor (`_torch_helpers.sphere_case`:
the JAX kernels' interpreted compile of the rounded box takes minutes)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_helpers import (history_at, np_, pan_cameras, render_tiles, sphere_case, to_torch_camera,
                            to_torch_config, to_torch_history, to_torch_scene)
from kylespathtracer_tpu.render import pipeline as jpl
from kylespathtracer_tpu.utils.config import RenderConfig as JConfig

TOL = dict(atol=2e-4, rtol=1e-5)
FRAMES = {"split": dict(pipeline="fused"), "mono": dict(pipeline="fused", temporal_fusion="mono"),
          "pass": dict(pipeline="pass")}


@pytest.mark.parametrize("kind", list(FRAMES))
def test_tiles_match_jax_unsharded_frame(kind):
    """Two 8-row tiles of a 32×16 frame on the sphere scene against JAX's
    unsharded `render_frame` (interpreted kernels for the fused frames) on
    the same populated history and ~1.5 px pan, at the bar the port's
    frames meet against JAX (tests/test_torch_pipeline.py): the
    temporal-frame bar, atol 2e-4 (rtol 1e-5), oid exact."""
    w, h = 32, 16
    scene_j = sphere_case()
    cfg = JConfig(width=w, height=h, **FRAMES[kind])
    prev_cam, cam = pan_cameras(1)
    hist_j = history_at(scene_j, prev_cam, cfg)
    img_j, new_j = jax.jit(jpl.render_frame, static_argnames=("config",))(scene_j, cam, hist_j, jnp.int32(1),
                                                                          config=cfg)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="fused tiled path")
        img_t, new_t = render_tiles(to_torch_scene(scene_j), to_torch_camera(cam), to_torch_history(hist_j), 1,
                                    to_torch_config(cfg), 2)
    np.testing.assert_allclose(np_(img_t), np.asarray(img_j), **TOL)
    for name in ("diffuse", "specular"):
        a, b = getattr(new_t, name), getattr(new_j, name)
        np.testing.assert_allclose(np_(a.rgb), np.asarray(b.rgb), err_msg=f"{name} rgb", **TOL)
        np.testing.assert_allclose(np_(a.cnt), np.asarray(b.cnt), err_msg=f"{name} cnt", **TOL)
        np.testing.assert_array_equal(np_(a.oid), np.asarray(b.oid))
    assert np_(new_t.diffuse.cnt).max() > 2, "history not carried"
