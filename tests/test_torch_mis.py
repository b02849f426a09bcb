"""PyTorch port, the MIS estimators (render/mis.py) and the helpers they
need against the JAX package: `gmath`'s shading terms and `sampler`'s
direction samplers on random inputs made with numpy, `softvis`, and
`dual_mis`, `dmis`, `smis` and the unbiased pair on the JAX G-buffer of a
32×16 frame, fed the same shading points, normals, IDs and seeds.

Tolerances: the Weyl draws bit for bit; the helpers atol 1e-6 and rtol
1e-6 (XLA's CPU sqrt, log, cos and sin part from torch's by an ulp); the
estimators
atol 2e-5 and rtol 1e-5 on the shaded pixels (hits other than the light,
the only ones the passes keep), the frame planes' bar."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import np_, to_torch_camera, to_torch_config, to_torch_scene
from kylespathtracer_tpu.core import gmath as jgmath
from kylespathtracer_tpu.core import sampler as jsampler
from kylespathtracer_tpu.diff import softvis as jsoftvis
from kylespathtracer_tpu.render import gbuffer as jgb
from kylespathtracer_tpu.render import mis as jmis
from kylespathtracer_tpu.render import passes as jpasses
from kylespathtracer_tpu.render.camera import Camera
from kylespathtracer_tpu.scene import default_scene
from kylespathtracer_tpu.scene.scene import sphere_scene
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.core import gmath, sampler
from kylespathtracer_tpu_torch.diff import softvis
from kylespathtracer_tpu_torch.render import mis
from kylespathtracer_tpu_torch.render import passes

W, H = 32, 16
CAM = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
SMP2 = {k: 2 for k in (
    "smp_direct_lambert", "smp_lambert_surface_lambert", "smp_lambert_surface_phong",
    "smp_direct_phong", "smp_phong_surface_lambert", "smp_phong_surface_phong")}
EST = dict(atol=2e-5, rtol=1e-5)
HELP = dict(atol=1e-6, rtol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_gmath_shading_terms_match_jax():
    rng = np.random.default_rng(0)
    a, b = _unit(rng, 256), _unit(rng, 256)
    d = rng.uniform(0.0, 5.0, 256).astype(np.float32)
    r = rng.uniform(0.0, 2.0, 256).astype(np.float32)
    d[:4] = 0.0  # the guarded degenerate distances
    vn = rng.uniform(-1.0, 1.0, 256).astype(np.float32)
    pairs = [
        (gmath.dot_k(_t(a), _t(b)), jgmath.dot_k(a, b)),
        (gmath.linear_angle(_t(d), _t(r)), jgmath.linear_angle(d, r)),
        (gmath.tan_linear_angle(_t(d), _t(r)), jgmath.tan_linear_angle(d, r)),
        (gmath.solid_angle(_t(d * d), _t(r * r)), jgmath.solid_angle(d * d, r * r)),
        (gmath.schlick(1.0, 3.0, _t(vn)), jgmath.schlick(1.0, 3.0, vn)),
        (gmath.lambertian(_t(a), _t(b)), jgmath.lambertian(a, b)),
    ]
    nlv = _unit(rng, 256)
    pairs.append((gmath.phong(_t(a), _t(b), _t(nlv), 5.0), jgmath.phong(a, b, nlv, 5.0)))
    for i, (got, ref) in enumerate(pairs):
        np.testing.assert_allclose(np_(got), np.asarray(ref), **HELP, err_msg=str(i))


def test_samplers_match_jax():
    """The Weyl draws and cone_pre's roulette draw u3 bit for bit; the
    transcendental draws and the directions to 1e-6."""
    rng = np.random.default_rng(1)
    seed = rng.integers(-2**31, 2**31 - 1, 512, dtype=np.int64).astype(np.int32)
    hn = _unit(rng, 512)
    lv = rng.normal(size=(512, 3)).astype(np.float32) * 3.0
    lv[:3] = 0.0  # a sample toward the point itself stays finite
    lr = rng.uniform(0.05, 1.0, 512).astype(np.float32)
    pre_t, pre_j = sampler.cone_pre(_t(seed)), jsampler.cone_pre(seed)
    assert np.array_equal(np_(sampler.weyl3(_t(seed))), np.asarray(jsampler.weyl3(seed)))
    assert np.array_equal(np_(pre_t[3]), np.asarray(pre_j[3]))
    for k in (0, 1, 2):
        np.testing.assert_allclose(np_(pre_t[k]), np.asarray(pre_j[k]), **HELP)
    pairs = {
        "logit3": (sampler.logit3(sampler.weyl3(_t(seed))), jsampler.logit3(jsampler.weyl3(seed))),
        "uniform_sphere": (sampler.uniform_sphere(_t(seed)), jsampler.uniform_sphere(seed)),
        "uniform_dir": (sampler.uniform_dir(_t(seed)), jsampler.uniform_dir(seed)),
        "uniform_hemi_dir": (sampler.uniform_hemi_dir(_t(hn), _t(seed)), jsampler.uniform_hemi_dir(hn, seed)),
        "cos_hemi_dir": (sampler.cos_hemi_dir(_t(hn), _t(seed)), jsampler.cos_hemi_dir(hn, seed)),
        "uniform_cone_dir": (sampler.uniform_cone_dir(_t(lv), _t(lr), _t(seed)),
                             jsampler.uniform_cone_dir(lv, lr, seed)),
        "uniform_cone_dir pre": (sampler.uniform_cone_dir(_t(lv), _t(lr), pre=pre_t),
                                 jsampler.uniform_cone_dir(lv, lr, pre=pre_j)),
    }
    for name, (got, ref) in pairs.items():
        assert np.isfinite(np_(got)).all(), name
        np.testing.assert_allclose(np_(got), np.asarray(ref), **HELP, err_msg=name)


def _gbuffer_case(scene, cfg, frame=2):
    """The JAX G-buffer's shading inputs (hl, hn, ho, rd, seed), as JAX
    arrays and as torch tensors, plus the shaded-pixel mask."""
    gb = jgb.geometry_pass(scene, CAM, cfg)
    hl, seed = jpasses._shade_common(scene, cfg, gb, CAM, jnp.int32(frame))
    j = dict(hl=hl, hn=gb.normal, ho=gb.obj_id, rd=gb.ray_dir, seed=seed)
    t = {k: _t(v) for k, v in j.items()}
    shaded = np.asarray((gb.obj_id != scene.light_id) & (gb.obj_id > 0))
    assert shaded.mean() > 0.5
    return j, t, shaded


def _spheres():
    return sphere_scene([[5.5, 1.0, 0.0], [4.0, 0.5, 1.0], [6.0, 2.5, -1.5]], [1.0, 0.5, 0.7],
                        [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]])


def test_soft_visibility_matches_jax():
    scene = _spheres()
    cfg = RenderConfig(width=W, height=H)
    j, t, shaded = _gbuffer_case(scene, cfg)
    scene_t = to_torch_scene(scene)
    lv = scene.light[:3] - j["hl"]
    dist = jgmath.length(lv)
    ndir = lv / dist[..., None]
    tmax = jnp.maximum(dist - scene.light[3], 1e-3)
    got = softvis.sphere_soft_transmittance(scene_t, t["hl"], _t(ndir), _t(tmax), t["ho"], 0.05)
    ref = jsoftvis.sphere_soft_transmittance(scene, j["hl"], ndir, tmax, j["ho"], 0.05)
    assert 0.0 < np_(got).min() < 0.5, "no pixel in a soft shadow"
    np.testing.assert_allclose(np_(got), np.asarray(ref), **HELP)
    got = softvis.soft_direct_light(scene_t, t["hl"], t["hn"], t["ho"], 0.05)
    ref = jsoftvis.soft_direct_light(scene, j["hl"], j["hn"], j["ho"], 0.05)
    np.testing.assert_allclose(np_(got)[shaded], np.asarray(ref)[shaded], **EST)


CASES = {
    "default": (default_scene, {}),
    "smp2_decorrelate": (default_scene, dict(decorrelate_samples=True, **SMP2)),
    "spheres_soft": (_spheres, dict(soft_shadows=0.05)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_estimators_match_jax(case):
    """dual_mis (DMIS and SMIS fused), dmis, smis and the unbiased pair."""
    make, kw = CASES[case]
    scene = make()
    cfg = RenderConfig(width=W, height=H, **kw)
    j, t, shaded = _gbuffer_case(scene, cfg)
    scene_t, cfg_t = to_torch_scene(scene), to_torch_config(cfg)
    jtrace, trace = jpasses.get_trace(cfg), passes.get_trace(cfg_t)

    def hold(got, ref, what):
        got, ref = np_(got)[shaded], np.asarray(ref)[shaded]
        assert np.isfinite(got).all(), what
        np.testing.assert_allclose(got, ref, err_msg=what, **EST)

    ed, es = mis.dual_mis(scene_t, trace, t["rd"], t["hl"], t["hn"], t["ho"], t["seed"], cfg_t)
    rd_, rs_ = jmis.dual_mis(scene, jtrace, j["rd"], j["hl"], j["hn"], j["ho"], j["seed"], cfg)
    hold(ed, rd_, "dual_mis diffuse")
    hold(es, rs_, "dual_mis specular")
    assert np_(ed)[shaded].max() > 0.1, "no light reached the shaded pixels"
    hold(mis.dmis(scene_t, trace, t["hl"], t["hn"], t["ho"], t["seed"], cfg_t),
         jmis.dmis(scene, jtrace, j["hl"], j["hn"], j["ho"], j["seed"], cfg), "dmis")
    hold(mis.smis(scene_t, trace, t["rd"], t["hl"], t["hn"], t["ho"], t["seed"], cfg_t),
         jmis.smis(scene, jtrace, j["rd"], j["hl"], j["hn"], j["ho"], j["seed"], cfg), "smis")
    if case == "default":
        hold(mis.unbiased_lambertian(scene_t, trace, t["hl"], t["hn"], t["ho"], t["seed"], cfg_t),
             jmis.unbiased_lambertian(scene, jtrace, j["hl"], j["hn"], j["ho"], j["seed"], cfg),
             "unbiased_lambertian")
        hold(mis.unbiased_phong(scene_t, trace, t["rd"], t["hl"], t["hn"], t["ho"], t["seed"], cfg_t),
             jmis.unbiased_phong(scene, jtrace, j["rd"], j["hl"], j["hn"], j["ho"], j["seed"], cfg),
             "unbiased_phong")
        for got, ref in zip(mis.brdf_lambertian(t["hl"], t["hn"], t["seed"]),
                            jmis.brdf_lambertian(j["hl"], j["hn"], j["seed"])):
            np.testing.assert_allclose(np_(got), np.asarray(ref), **HELP)
        for got, ref in zip(mis.brdf_phong(t["rd"], t["hl"], t["hn"]),
                            jmis.brdf_phong(j["rd"], j["hl"], j["hn"])):
            np.testing.assert_allclose(np_(got), np.asarray(ref), **HELP)


def test_dual_mis_refuses_unequal_counts():
    cfg = to_torch_config(RenderConfig(width=W, height=H, smp_direct_phong=2))
    z = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="equal sample counts"):
        mis.dual_mis(None, None, z, z, z, torch.zeros(2, dtype=torch.int32),
                     torch.zeros(2, dtype=torch.int32), cfg)


def test_shade_kernel_takes_one_sample_at_smp2():
    """The shade kernel's plain version (K4, ops/shade_kernel.dual_mis_plain)
    takes one sample on the raw seed whatever the smp counts, as the JAX
    kernel does (shade_kernel.py:655-725): at smp=2 it is dual_mis at
    smp=1, not the two-sample average."""
    from kylespathtracer_tpu_torch.ops import shade_kernel as sk
    from kylespathtracer_tpu_torch.render import gbuffer

    scene_t = to_torch_scene(default_scene())
    cam_t = to_torch_camera(CAM)
    cfg1 = to_torch_config(RenderConfig(width=W, height=H))
    cfg2 = dataclasses.replace(cfg1, **SMP2)
    gb = gbuffer.geometry_pass(scene_t, cam_t, cfg1)
    hl, seed = passes._shade_common(scene_t, cfg1, gb, cam_t, 2)
    shaded = passes._shaded(scene_t, gb.obj_id)[..., None]
    k2 = sk.dual_mis_plain(scene_t, gb, cam_t, seed, cfg2)
    trace = passes.get_trace(cfg1)
    for cfg, same in ((cfg1, True), (cfg2, False)):
        est = mis.dual_mis(scene_t, trace, gb.ray_dir, hl, gb.normal, gb.obj_id, seed, cfg)
        for a, b in zip(k2, est):
            b = torch.where(shaded, b, 0.0)
            close = torch.allclose(a, b, atol=2e-5, rtol=1e-5)
            assert close == same, (cfg.smp_direct_lambert, (a - b).abs().max().item())
