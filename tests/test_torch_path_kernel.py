"""PyTorch port, path kernel module (K7's, ops/path_kernel.py): the plain
version against the JAX package's `pathtrace_jnp` (the Pallas kernel's body
as plain jnp), at tests/test_path_kernel.py's bar: finite, median |Δ| <
1e-6, under 0.2% of the components beyond 1e-3. Cases: the default scene
(64×48, spp 2, depth 3) and the dielectric sphere scene of
tests/test_path_kernel.py:49-56 (48×32, spp 2, depth 4)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (PATH_CASES, assert_path_bar, np_, to_torch_camera, to_torch_config,
                            to_torch_scene)
from kylespathtracer_tpu.ops import path_kernel as jpk
from kylespathtracer_tpu_torch.ops import path_kernel as pk


@pytest.mark.parametrize("case", list(PATH_CASES))
def test_pathtrace_plain_matches_pathtrace_jnp(case):
    scene, cam, cfg = PATH_CASES[case]()
    ref = np.asarray(jpk.pathtrace_jnp(scene, cam, cfg, jnp.asarray(0, jnp.int32)))
    before = pk.LAUNCHES
    img = np_(pk.pathtrace(to_torch_scene(scene), to_torch_camera(cam), to_torch_config(cfg), 0))
    assert pk.LAUNCHES == before  # a CPU tensor runs the plain version
    assert img.shape == (cfg.height, cfg.width, 3)
    assert_path_bar(img, ref)


def test_pathtrace_plain_later_frame_and_glossy():
    """Frame 5 (another R2 sample index) and a glossy lobe, against
    `pathtrace_jnp`."""
    scene, cam, cfg = PATH_CASES["dielectric"]()
    scene = scene.replace(materials=scene.materials.replace(
        bsdf=jnp.asarray([0, 0, 0, 1, 2, 3], jnp.int32)))
    cfg = dataclasses.replace(cfg, width=32, height=16, spp=1, gloss=8.0)
    ref = np.asarray(jpk.pathtrace_jnp(scene, cam, cfg, jnp.asarray(5, jnp.int32)))
    img = np_(pk.pathtrace_plain(to_torch_scene(scene), to_torch_camera(cam), to_torch_config(cfg), 5))
    assert_path_bar(img, ref)


def test_pathtrace_with_a_brightness_is_render_pathtraceds_image():
    """Given an exposure, `pathtrace` returns render_pathtraced's sRGB image
    bit for bit (on the CPU: the plain version, then core/color.py's chain),
    and without one the HDR image; a CPU tensor counts no kernel launch."""
    from kylespathtracer_tpu_torch.render import wavefront

    scene, cam, cfg = PATH_CASES["dielectric"]()
    scene, cam, cfg = to_torch_scene(scene), to_torch_camera(cam), to_torch_config(cfg)
    before = (pk.LAUNCHES, pk.TONEMAP_LAUNCHES)
    img = pk.pathtrace(scene, cam, cfg, 2, brightness=cfg.brightness)
    assert (pk.LAUNCHES, pk.TONEMAP_LAUNCHES) == before
    assert torch.equal(img, wavefront.render_pathtraced(scene, cam, cfg, 2))
    hdr = pk.pathtrace(scene, cam, cfg, 2)
    assert torch.equal(hdr, pk.pathtrace_plain(scene, cam, cfg, 2)) and hdr.max() > 1
    assert img.min() >= 0 and img.max() <= 1 and not torch.equal(img, hdr)
