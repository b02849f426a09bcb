"""PyTorch port, the wavefront path tracer's modules against the JAX
package: the R2/PCG sampler (bit for bit), the BSDFs, materials, normals and
the analytic intersector on random inputs made with numpy, the XLA-style
integrator (`render/wavefront.py`, path_backend="xla") on two scenes at
tests/test_path_kernel.py's bar, `render_pathtraced`, and the `pathtrace`
CLI."""

import dataclasses
import json
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (PATH_CASES, assert_path_bar, np_, to_torch_camera, to_torch_config,
                            to_torch_scene)
from kylespathtracer_tpu.core import sampler as jsampler
from kylespathtracer_tpu.render import bsdf as jbsdf
from kylespathtracer_tpu.render import wavefront as jwf
from kylespathtracer_tpu.scene import default_scene
from kylespathtracer_tpu.scene import intersect as jisect
from kylespathtracer_tpu.scene import materials as jmat
from kylespathtracer_tpu.scene import normals as jnrm
from kylespathtracer_tpu_torch.app import cli
from kylespathtracer_tpu_torch.core import sampler
from kylespathtracer_tpu_torch.render import bsdf
from kylespathtracer_tpu_torch.render import wavefront as wf
from kylespathtracer_tpu_torch.scene import intersect as isect
from kylespathtracer_tpu_torch.scene import materials as mat
from kylespathtracer_tpu_torch.scene import normals as nrm
from kylespathtracer_tpu_torch.utils import image_io

U32 = 2**32


def _u32(rng, n):
    """n uint32 values: random, plus the edges 0, 1, 2^31±1 and 2^32-1..-3."""
    edges = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, U32 - 3, U32 - 2, U32 - 1], np.uint64)
    return np.concatenate([edges, rng.integers(0, U32, n, dtype=np.uint64)]).astype(np.uint32)


def _t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_sampler_bit_for_bit():
    rng = np.random.default_rng(0)
    x, n, s = _u32(rng, 4000), _u32(rng, 4000), _u32(rng, 4000)
    want = np.asarray(jsampler.pcg_hash(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(sampler.pcg_hash(_t64(x)).numpy(), want)
    for got, ref in zip(sampler.r2_pair(_t64(n), _t64(s)), jsampler.r2_pair(jnp.asarray(n), jnp.asarray(s))):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    px = rng.integers(0, 1920, 4000).astype(np.int32)
    py = rng.integers(0, 1080, 4000).astype(np.int32)
    for width, pair in ((1920, 0), (1920, 17), (65537, 2**31 + 5)):
        ref = jsampler.pixel_stream(jnp.asarray(px), jnp.asarray(py), width, jnp.uint32(pair))
        got = sampler.pixel_stream(torch.from_numpy(px), torch.from_numpy(py), width, pair)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _bsdf_inputs(rng, n=2048):
    nrm_ = _unit(rng, n)
    wo = _unit(rng, n)
    wo = np.where((nrm_ * wo).sum(-1, keepdims=True) < 0, -wo, wo)  # wo faces n
    return dict(
        kind=rng.integers(0, 4, n).astype(np.int32),
        rho_d=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        rho_s=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        n=nrm_, wo=wo, wi=_unit(rng, n),
        ior=rng.uniform(0.6, 1.7, n).astype(np.float32),
        u=rng.uniform(0, 1, (3, n)).astype(np.float32),
    )


@pytest.mark.parametrize("gloss", [5.0, 12.0])
def test_bsdf_eval_and_sample_match_jax(gloss):
    a = _bsdf_inputs(np.random.default_rng(1))
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    f, pdf = bsdf.eval_pdf(t["kind"], t["rho_d"], t["rho_s"], t["n"], t["wo"], t["wi"], gloss)
    jf, jpdf = jbsdf.eval_pdf(j["kind"], j["rho_d"], j["rho_s"], j["n"], j["wo"], j["wi"], gloss)
    np.testing.assert_allclose(np_(f), np.asarray(jf), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np_(pdf), np.asarray(jpdf), atol=1e-6, rtol=0)
    got = bsdf.sample(t["kind"], t["rho_d"], t["rho_s"], t["ior"], t["n"], t["wo"], gloss, *t["u"])
    ref = jbsdf.sample(j["kind"], j["rho_d"], j["rho_s"], j["ior"], j["n"], j["wo"], gloss, *j["u"])
    for name, g, r in zip(("wi", "weight", "pdf"), got[:3], ref[:3]):
        np.testing.assert_allclose(np_(g), np.asarray(r), atol=1e-6, rtol=0, err_msg=name)
    for name, g, r in zip(("is_delta", "transmit"), got[3:], ref[3:]):
        np.testing.assert_array_equal(np_(g), np.asarray(r), err_msg=name)
    assert np_(got[4]).any() and np_(got[3]).any()  # both refraction and delta lobes ran


def _rays(rng, n, lo, hi):
    ro = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    return ro, _unit(rng, n)


def _dielectric_scene():
    return PATH_CASES["dielectric"]()[0]


@pytest.mark.parametrize("inside_hits", [False, True])
@pytest.mark.parametrize("scene_fn,lo,hi", [
    (default_scene, (0.5, 0.2, -9.5), (9.5, 9.5, -0.5)),
    (_dielectric_scene, (-3.0, 0.2, 4.5), (3.0, 2.5, 8.5)),
], ids=["default", "dielectric"])
def test_intersect_materials_normals_match_jax(scene_fn, lo, hi, inside_hits):
    """intersect (t atol 1e-5 where oid agrees, oid equal on >= 99.9%),
    then normal_curv and surface at the JAX hits."""
    rng = np.random.default_rng(2)
    scene = scene_fn()
    ts = to_torch_scene(scene)
    ro, rd = _rays(rng, 4096, lo, hi)
    excl = rng.integers(-1, 6, 4096).astype(np.int32)
    t_j, oid_j = jisect.intersect(scene, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(excl),
                                  inside_hits=inside_hits)
    t_t, oid_t = isect.intersect(ts, torch.from_numpy(ro), torch.from_numpy(rd),
                                 torch.from_numpy(excl), inside_hits=inside_hits)
    t_j, oid_j = np.array(t_j), np.array(oid_j)
    same = np_(oid_t) == oid_j
    assert same.mean() >= 0.999
    assert (oid_j > 0).mean() > 0.3
    np.testing.assert_allclose(np_(t_t)[same], t_j[same], atol=1e-5, rtol=0)

    hl = ro + rd * t_j[:, None]
    n_j, c_j = jnrm.normal_curv(scene, jnp.asarray(hl), jnp.asarray(oid_j))
    n_t, c_t = nrm.normal_curv(ts, torch.from_numpy(hl), torch.from_numpy(oid_j))
    np.testing.assert_allclose(np_(n_t), np.asarray(n_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np_(c_t), np.asarray(c_j), atol=1e-6, rtol=0)
    ids = np.concatenate([oid_j, rng.integers(-2, 12, 512).astype(np.int32)])
    pts = np.concatenate([hl, rng.uniform(-3, 3, (512, 3)).astype(np.float32)])
    for g, r in zip(mat.surface(ts.materials, torch.from_numpy(ids), torch.from_numpy(pts)),
                    jmat.surface(scene.materials, jnp.asarray(ids), jnp.asarray(pts))):
        np.testing.assert_allclose(np_(g), np.asarray(r), atol=1e-6, rtol=0)


def test_intersect_is_forward_only():
    """`intersect` differentiates (it was forward only): the gradient of a
    seeded weighting of t in the scene's tables, ro and rd against
    `jax.vjp` of the JAX intersect, 1e-4·max per table, with and without
    `inside_hits` (rays from the room and from inside the light sphere)."""
    scene = default_scene()
    rng = np.random.default_rng(11)
    ro = np.concatenate([rng.uniform([-5, 0.5, -9], [9, 9, 5], (96, 3)),
                         np.asarray(scene.spheres[0, :3]) + rng.uniform(-0.4, 0.4, (32, 3))]).astype(np.float32)
    rd = rng.standard_normal((128, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    g = rng.standard_normal(128).astype(np.float32)
    for inside in (False, True):
        (t_j, _), vjp = jax.vjp(
            lambda pl, sp, bx, o, d: jisect.intersect(scene.replace(planes=pl, spheres=sp, boxes=bx), o, d,
                                                      inside_hits=inside),
            scene.planes, scene.spheres, scene.boxes, jnp.asarray(ro), jnp.asarray(rd))
        ref = vjp((jnp.asarray(g), np.zeros(128, jax.dtypes.float0)))
        ts = to_torch_scene(scene)
        leaves = [x.clone().requires_grad_() for x in (ts.planes, ts.spheres, ts.boxes, torch.from_numpy(ro),
                                                       torch.from_numpy(rd))]
        sc = dataclasses.replace(ts, planes=leaves[0], spheres=leaves[1], boxes=leaves[2])
        t_t, _ = isect.intersect(sc, leaves[3], leaves[4], inside_hits=inside)
        np.testing.assert_allclose(np_(t_t), np.asarray(t_j), atol=1e-5, rtol=0)
        got = torch.autograd.grad((t_t * torch.from_numpy(g)).sum(), leaves, allow_unused=True)
        for name, a, b in zip(("planes", "spheres", "boxes", "ro", "rd"), ref, got):
            a = np.asarray(a)
            assert np.abs(a).max() > 0, name
            np.testing.assert_allclose(np_(b), a, rtol=0, atol=1e-4 * np.abs(a).max(), err_msg=f"{name} {inside}")


@pytest.mark.parametrize("case", list(PATH_CASES))
def test_wavefront_xla_matches_jax(case):
    scene, cam, cfg = PATH_CASES[case]()
    cfg = dataclasses.replace(cfg, path_backend="xla")
    ref = np.asarray(jwf.pathtrace(scene, cam, cfg, jnp.asarray(0, jnp.int32)))
    img = np_(wf.pathtrace(to_torch_scene(scene), to_torch_camera(cam), to_torch_config(cfg), 0))
    assert_path_bar(img, ref)


def test_render_pathtraced_matches_jax():
    """The tonemapped image through the default backend (the path kernel's
    plain version on the CPU) against JAX's XLA integrator, tonemapped."""
    scene, cam, cfg = PATH_CASES["default"]()
    cfg = dataclasses.replace(cfg, width=32, height=24)
    ref = np.asarray(jwf.render_pathtraced(scene, cam, dataclasses.replace(cfg, path_backend="xla"),
                                           jnp.asarray(0, jnp.int32)))
    img = np_(wf.render_pathtraced(to_torch_scene(scene), to_torch_camera(cam), to_torch_config(cfg), 0))
    assert img.min() >= 0.0 and img.max() <= 1.0
    assert_path_bar(img, ref)


def test_wavefront_unsupported_options_raise():
    scene, cam, cfg = PATH_CASES["default"]()
    ts, tc, tcfg = to_torch_scene(scene), to_torch_camera(cam), to_torch_config(cfg)
    with pytest.raises(ValueError, match="path_backend"):
        wf.pathtrace(ts, tc, dataclasses.replace(tcfg, path_backend="scan"))
    # normal_mode="tetra" (once refused): the sdf-gradient normals of the
    # XLA-style integrator against JAX's, at test_path_kernel.py's bar.
    cfg_t = dataclasses.replace(cfg, width=32, height=24, path_backend="xla", normal_mode="tetra")
    ref = np.asarray(jwf.pathtrace(scene, cam, cfg_t, jnp.asarray(0, jnp.int32)))
    assert_path_bar(np_(wf.pathtrace(ts, tc, to_torch_config(cfg_t), 0)), ref)


def test_cli_pathtrace_writes_json_and_png(tmp_path, capsys):
    out = tmp_path / "pt.png"
    cli.main(["pathtrace", "--device", "cpu", "--width", "16", "--height", "8",
              "--depth", "2", "--spp", "1", "--out", str(out)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"wall_s", "depth", "spp", "path_segments"}
    assert (rec["depth"], rec["spp"], rec["path_segments"]) == (2, 1, 16 * 8 * 2)
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (16, 8)
    idat_len = struct.unpack(">I", data[33:37])[0]
    assert data[37:41] == b"IDAT"
    assert len(zlib.decompress(data[41:41 + idat_len])) == h * (1 + w * 3)


def test_image_export_matches_jax(tmp_path):
    """PPM bytes equal to the JAX package's; the PNG holds the same rows
    (bottom-up render rows flipped to top-down file rows)."""
    from kylespathtracer_tpu.utils import image_io as jimage_io

    img = np.random.default_rng(3).uniform(-0.1, 1.1, (6, 5, 3)).astype(np.float32)
    image_io.save_image(tmp_path / "t.ppm", torch.from_numpy(img))
    jimage_io.save_ppm(tmp_path / "j.ppm", img)
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()
    image_io.save_image(tmp_path / "t.png", torch.from_numpy(img))
    data = (tmp_path / "t.png").read_bytes()
    n = struct.unpack(">I", data[33:37])[0]
    rows = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8).reshape(6, 1 + 5 * 3)
    assert (rows[:, 0] == 0).all()
    want = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)[::-1]
    np.testing.assert_array_equal(rows[:, 1:].reshape(6, 5, 3), want)

