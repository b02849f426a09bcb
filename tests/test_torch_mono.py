"""PyTorch port, the mono temporal frame as the pipeline runs it:
`render_frame` (fused, window reprojection, temporal_fusion="mono": K8's
plain version on CPU tensors, then the composite) against the JAX
package's (`frame_hist_pallas` in interpret mode) over a 3-frame pan from
a populated history, on the sphere scene of
tests/test_torch_frame_hist_pallas.py (`_torch_helpers.sphere_case`). Tolerance: the temporal-frame bar,
atol 2e-4 (rtol 1e-5), on all but the knife-edge pixels of
`_knife_edges`; `oid` exact everywhere."""

import jax
import jax.numpy as jnp
import numpy as np

from _torch_helpers import (history_at, np_, pan_cameras, sphere_case, to_torch_camera,
                            to_torch_config, to_torch_history, to_torch_scene)
from kylespathtracer_tpu.render import pipeline as jpl
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.ops import frame_hist as fh
from kylespathtracer_tpu_torch.render import pipeline

TOL = dict(atol=2e-4, rtol=1e-5)


def _knife_edges(scene_t, cam_t, hist_t, frame, cfg_t):
    """bool[H,W]: pixels whose reprojected count (either channel set) sits
    within 8e-5 of a floor boundary after the +1e-4 guard. There the floor
    follows f32 rounding: XLA's CPU rsqrt parts from torch's by ulps (the
    previous camera's basis) and XLA contracts multiply-adds under jit; a
    border tap with counts 3, 10, 16, 13 turns that into 5.5e-5 of count,
    and the floored count differs by one. Exact counts stay 1e-4 above
    their integer and are not flagged."""
    K = fh.window_k(cfg_t)
    _, sums, _ = fh._tap_sums(scene_t, cam_t, hist_t.camera, hist_t.diffuse, hist_t.specular,
                              frame, cfg_t, K)
    edge = np.zeros((cfg_t.height, cfg_t.width), bool)
    for _, cnt in sums:
        c = np_(cnt) + np.float32(1e-4)
        edge |= np.abs(c - np.round(c)) < 8e-5
    return edge


def test_mono_pan_matches_jax():
    """`render_frame` (fused, window reprojection, temporal_fusion="mono")
    against the JAX package's over a 3-frame pan; JAX's block_rows is its
    auto value (32 rows at this width). Each frame starts both from the JAX
    history of the frame before, and pixels whose count floor sits on a
    rounding boundary (`_knife_edges`, at most 0.5% of them) are left out of
    the float holds; oid is held everywhere."""
    scene = sphere_case()
    cfg = RenderConfig(width=64, height=32, pipeline="fused", temporal_fusion="mono")
    jframe = jax.jit(jpl.render_frame, static_argnames=("config",))
    cams = pan_cameras(3)
    hist_j = history_at(scene, cams[0], cfg)
    scene_t, cfg_t = to_torch_scene(scene), to_torch_config(cfg)
    for i, cam in enumerate(cams[1:], start=1):
        hist_t, cam_t = to_torch_history(hist_j), to_torch_camera(cam)
        keep = ~_knife_edges(scene_t, cam_t, hist_t, i, cfg_t)
        assert keep.mean() >= 0.995
        img_j, hist_j = jframe(scene, cam, hist_j, jnp.int32(i), config=cfg)
        img_t, hist_t = pipeline.render_frame(scene_t, cam_t, hist_t, i, cfg_t)
        pairs = {"image": (img_t, img_j)}
        for name in ("diffuse", "specular"):
            a, b = getattr(hist_t, name), getattr(hist_j, name)
            pairs.update({f"{name} rgb": (a.rgb, b.rgb), f"{name} cnt": (a.cnt, b.cnt)})
            np.testing.assert_array_equal(np_(a.oid), np.asarray(b.oid))
        for what, (a, b) in pairs.items():
            np.testing.assert_allclose(np_(a)[keep], np.asarray(b)[keep], err_msg=f"{what} {i}", **TOL)
    assert np_(hist_t.diffuse.cnt).max() > 2, "history not carried"


