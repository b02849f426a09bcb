"""PyTorch port, the pass pipeline's shade kernel (K4): its plain version
(`ops/shade_kernel.dual_mis_plain`, which the wrapper `dual_mis` runs on CPU
tensors) against the JAX kernel `dual_mis_pallas` run in interpret mode,
on the same G-buffer and seed image: the default scene and a sphere scene
(and a box) with soft shadows. Both kernels take one sample on the raw
seed whatever the smp counts: the plain version at smp=2 is held to the
JAX kernel's output at smp=1 (its code has no smp). Tolerance: the frame
planes' bar, atol 2e-5 (rtol 1e-5)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import np_, to_torch_camera, to_torch_config, to_torch_scene
from kylespathtracer_tpu.ops import shade_kernel as jsk
from kylespathtracer_tpu.render import gbuffer as jgb
from kylespathtracer_tpu.render import passes as jpasses
from kylespathtracer_tpu.render.camera import Camera
from kylespathtracer_tpu.scene import default_scene
from kylespathtracer_tpu.scene.scene import sphere_scene
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.ops import shade_kernel as sk
from kylespathtracer_tpu_torch.render.gbuffer import GBuffer

W, H = 32, 16
CAM = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
SMP2 = {k: 2 for k in (
    "smp_direct_lambert", "smp_lambert_surface_lambert", "smp_lambert_surface_phong",
    "smp_direct_phong", "smp_phong_surface_lambert", "smp_phong_surface_phong")}


def _spheres():
    """Three spheres, the floor and a rounded box in place of a fourth
    sphere (the JAX kernel needs a row in every table)."""
    scene = sphere_scene(
        [[5.5, 1.0, 0.0], [4.0, 0.5, 1.0], [6.0, 2.5, -1.5], [0.0, 0.0, 0.0]], [1.0, 0.5, 0.7, 1.0],
        [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8], [0.7, 0.7, 0.7]])
    return scene.replace(
        spheres=scene.spheres[:-1], sphere_ids=scene.sphere_ids[:-1],
        boxes=jnp.asarray([[3.0, 0.6, 2.5, 0.5, 0.6, 0.5, 0.1]], jnp.float32),
        box_ids=scene.sphere_ids[-1:])


CASES = {
    "default": (default_scene, {}),
    "spheres_soft": (_spheres, dict(soft_shadows=0.05)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_shade_kernel_plain_matches_interpreted_pallas(case):
    make, kw = CASES[case]
    scene = make()
    cfg = RenderConfig(width=W, height=H, pipeline="pass", shade_backend="pallas", **kw)
    gb = jgb.geometry_pass(scene, CAM, cfg)
    _, seed = jpasses._shade_common(scene, cfg, gb, CAM, jnp.int32(3))
    ref_d, ref_s = jsk.dual_mis_pallas(scene, gb, CAM, seed, cfg, interpret=True)

    gb_t = GBuffer(**{k: torch.from_numpy(np.array(getattr(gb, k)))
                      for k in ("normal", "obj_id", "depth", "ray_dir", "curv")})
    before = sk.LAUNCHES
    est_d, est_s = sk.dual_mis(to_torch_scene(scene), gb_t, to_torch_camera(CAM),
                               torch.from_numpy(np.array(seed)), to_torch_config(cfg))
    assert sk.LAUNCHES == before  # CPU tensors: the plain version
    assert est_d.shape == (H, W, 3) and np.isfinite(np_(est_d)).all()
    assert np_(est_d).max() > 0.1, "no light reached the shaded pixels"
    for got, ref, what in ((est_d, ref_d, "est_d"), (est_s, ref_s, "est_s")):
        np.testing.assert_allclose(np_(got), np.asarray(ref), atol=2e-5, rtol=1e-5, err_msg=what)
    unshaded = np.asarray((gb.obj_id == scene.light_id) | (gb.obj_id <= 0))
    assert unshaded.any() and (np_(est_d)[unshaded] == 0).all()
    one_sample = sk.dual_mis(to_torch_scene(scene), gb_t, to_torch_camera(CAM),
                             torch.from_numpy(np.array(seed)),
                             dataclasses.replace(to_torch_config(cfg), **SMP2))
    for got, ref in zip(one_sample, (ref_d, ref_s)):
        np.testing.assert_allclose(np_(got), np.asarray(ref), atol=2e-5, rtol=1e-5)
