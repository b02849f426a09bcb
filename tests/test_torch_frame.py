"""PyTorch port, frame kernel module (K1): `frame_forward_plain` against the
JAX package's `frame_forward_jnp` (the plain-jnp body of the Pallas kernel)
on the same scenes and cameras. Tolerance: the JAX package's own bar for
the same frame math compiled two ways (tests/test_pallas_small.py, the
column-block test), atol 2e-5 and rtol 1e-5: XLA's and torch's CPU
transcendentals differ by an ulp or two, which the roulette boost
amplifies on a few sphere pixels. `oid` exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import np_, to_torch_camera, to_torch_config, to_torch_scene
from kylespathtracer_tpu.ops import frame_kernel as jfk
from kylespathtracer_tpu.render.camera import Camera
from kylespathtracer_tpu.scene import default_scene
from kylespathtracer_tpu.scene.scene import sphere_scene
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.ops import frame_kernel as fk

CAM = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
SPHERES = sphere_scene(
    [[5.5, 1.0, 0.0], [4.0, 0.5, 1.0], [6.0, 2.5, -1.5]], [1.0, 0.5, 0.7],
    [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]],
)
NO_PLANES = sphere_scene(
    [[5.5, 1.0, 0.0], [4.0, 0.5, 1.0]], [1.0, 0.5],
    [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2]], with_floor=False,
)
SMP2 = {k: 2 for k in (
    "smp_direct_lambert", "smp_lambert_surface_lambert",
    "smp_lambert_surface_phong", "smp_direct_phong",
    "smp_phong_surface_lambert", "smp_phong_surface_phong",
)}
KEYS = ("add_d", "add_s", "alb", "ene", "depth", "curv")

CASES = {
    "default": (default_scene, dict(width=64, height=32)),
    "unbiased": (default_scene, dict(width=64, height=32, biased=False)),
    "smp2": (default_scene, dict(width=64, height=32, **SMP2)),
    "smp2_decorrelate": (default_scene, dict(width=64, height=32,
                                             decorrelate_samples=True, **SMP2)),
    "unbiased_smp2_decorrelate": (default_scene, dict(
        width=48, height=16, biased=False, decorrelate_samples=True, **SMP2)),
    "spheres_no_boxes": (lambda: SPHERES, dict(width=64, height=32)),
    "spheres_soft_shadows": (lambda: SPHERES, dict(width=64, height=32,
                                                   soft_shadows=0.05)),
    "width_not_640_multiple": (default_scene, dict(width=48, height=20)),
    "spheres_no_planes_unbiased": (lambda: NO_PLANES, dict(width=48, height=16,
                                                            biased=False)),
}


def _compare(out, ref, rows=slice(None)):
    assert (np_(out["oid"]) == np.asarray(ref["oid"])[rows]).all()
    for k in KEYS:
        np.testing.assert_allclose(
            np_(out[k]), np.asarray(ref[k])[rows], atol=2e-5, rtol=1e-5, err_msg=k
        )


@pytest.mark.parametrize("case", list(CASES))
def test_frame_forward_plain_matches_jnp(case):
    build, kw = CASES[case]
    scene, cfg = build(), RenderConfig(**kw)
    ref = jfk.frame_forward_jnp(scene, CAM, jnp.int32(3), cfg)
    out = fk.frame_forward_plain(
        to_torch_scene(scene), to_torch_camera(CAM), 3, to_torch_config(cfg)
    )
    _compare(out, ref)
    assert out["oid"].shape == (cfg.height, cfg.width)
    assert out["add_d"].shape == (cfg.height, cfg.width, 3)
    assert out["ene"].shape == (cfg.height, cfg.width, 2)


def test_soft_shadows_change_the_sphere_frame():
    """The soft-shadow case above would be vacuous if the softened sphere
    occlusion never applied: it must move the diffuse estimate."""
    cfg = RenderConfig(width=64, height=32)
    scene, cam = to_torch_scene(SPHERES), to_torch_camera(CAM)
    hard = fk.frame_forward_plain(scene, cam, 3, to_torch_config(cfg))
    soft = fk.frame_forward_plain(
        scene, cam, 3, to_torch_config(RenderConfig(width=64, height=32, soft_shadows=0.05))
    )
    assert (hard["add_d"] - soft["add_d"]).abs().max() > 1e-3


@pytest.mark.parametrize("row_base,rows", [(8, 8), (13, 11)])
def test_row_tile_is_rows_of_the_full_frame(row_base, rows):
    """`row_base`/`rows` render a row window with the full image's NDC and
    seeds: the JAX full frame's rows, to the same tolerance."""
    cfg = RenderConfig(width=64, height=32)
    ref = jfk.frame_forward_jnp(default_scene(), CAM, jnp.int32(5), cfg)
    out = fk.frame_forward(
        to_torch_scene(default_scene()), to_torch_camera(CAM), 5,
        to_torch_config(cfg), row_base=row_base, rows=rows,
    )
    _compare(out, ref, slice(row_base, row_base + rows))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches nothing."""
    cfg = to_torch_config(RenderConfig(width=32, height=8))
    scene, cam = to_torch_scene(default_scene()), to_torch_camera(CAM)
    before = fk.LAUNCHES
    a = fk.frame_forward(scene, cam, 1, cfg)
    b = fk.frame_forward_plain(scene, cam, 1, cfg)
    assert fk.LAUNCHES == before
    for k in KEYS + ("oid",):
        assert (a[k] == b[k]).all(), k


def test_table_parts_layout():
    """The flat tables the kernels gather from `table_parts` hold every
    scene table in the documented order."""
    scene, cam = to_torch_scene(default_scene()), to_torch_camera(CAM)
    f, i = (torch.cat([t.reshape(-1) for t in ts]) for ts in fk.table_parts(scene, cam))
    P, S, B, K = 4, 1, 1, 8
    assert f.numel() == P * 4 + S * 4 + B * 7 + 3 + 4 + K * 16 + 5
    assert i.numel() == P + S + B + 1
    assert np.array_equal(np_(f[:16]), np_(scene.planes).ravel())
    assert np.array_equal(np_(f[-5:]), np.r_[np_(cam.loc), np_(cam.orient)])
    assert int(i[-1]) == int(scene.light_id)


def test_biased_frame_without_planes_raises():
    """The plane-strategy roulettes need a plane, as in the JAX code."""
    cfg = to_torch_config(RenderConfig(width=8, height=8))
    with pytest.raises(ValueError, match="plane"):
        fk.frame_forward(to_torch_scene(NO_PLANES), to_torch_camera(CAM), 0, cfg)


def test_unequal_smp_counts_raise():
    cfg = to_torch_config(RenderConfig(width=8, height=8, smp_direct_phong=2))
    with pytest.raises(ValueError, match="smp"):
        fk.frame_forward(to_torch_scene(default_scene()), to_torch_camera(CAM), 0, cfg)


@pytest.mark.parametrize("fault", ["none", "curv_zero", "one_object_albedo"])
def test_agreement_check_catches_one_wrong_plane(fault):
    """The kernel-vs-plain gate holds each plane on its own: zeroing curv, or
    one albedo channel 5% off on the smallest object in view, fails it; an
    equal frame passes."""
    cfg = to_torch_config(RenderConfig(width=64, height=32))
    ref = fk.frame_forward_plain(to_torch_scene(SPHERES), to_torch_camera(CAM), 3, cfg)
    out = {k: v.clone() for k, v in ref.items()}
    if fault == "curv_zero":
        assert (ref["curv"] > 0).float().mean() > 0.01
        out["curv"].zero_()
    elif fault == "one_object_albedo":
        ids, counts = torch.unique(ref["oid"][ref["oid"] > 0], return_counts=True)
        obj = ref["oid"] == ids[counts.argmin()]
        assert obj.float().mean() < 0.05
        out["alb"][..., 1][obj] *= 1.05
    if fault == "none":
        stats = fk.check_agreement(out, ref, fault)
        assert stats["median"] == 0.0 and stats["oid"] == 0.0
    else:
        plane = {"curv_zero": "curv", "one_object_albedo": "alb.1"}[fault]
        with pytest.raises(AssertionError, match=plane):
            fk.check_agreement(out, ref, fault)
