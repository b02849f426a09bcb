"""PyTorch port, the differentiable frame (ops/frame_grad.py): the backward
kernel's plain version (`frame_backward` on CPU tensors) and the autograd
Function `FrameForward` against `jax.vjp` of the JAX package's
`frame_forward_jnp`, the plain body of its Pallas kernels, on the same
scenes, cameras and cotangents (made with numpy).

Tolerance: per gradient table, max|Δ| ≤ 1e-4·max|ref|, the JAX package's
bar for loss gradients (tests/test_frame_grad.py:190-198; both sides sum
over pixels in another order). The JAX references are computed once per
case, eagerly (no jit).

Ill-conditioned pixels get no cotangent (`ill_conditioned`): where the two
f32 forwards already differ by more than 4e-6·(1+|ref|) on some plane, a
sample sits on a rounding boundary (the hit point's distance to its own
plane, in the phong plane strategy, is a difference of two numbers ~1e3
times larger), and its derivative differs by far more than the bar between
any two f32 programs, float64 included. One pixel of 512 in the default
scene and in the sphere scene; none in the unbiased case."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (
    np_, to_torch_camera, to_torch_config, to_torch_history, to_torch_scene,
)
from kylespathtracer_tpu.core import gmath as jgmath
from kylespathtracer_tpu.ops import frame_kernel as jfk
from kylespathtracer_tpu.render import composite as jcomp
from kylespathtracer_tpu.render import reproject as jrep
from kylespathtracer_tpu.render.camera import Camera, ray_dirs
from kylespathtracer_tpu.render.passes import Channel, _temporal_clamp, count_floor
from kylespathtracer_tpu.render.pipeline import History
from kylespathtracer_tpu.scene import default_scene
from kylespathtracer_tpu.scene.scene import sphere_scene
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.render import pipeline
from kylespathtracer_tpu_torch.render.camera import Camera as Camera_t

W, H = 32, 16
FRAME = 3
CAM = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
SMP2 = {k: 2 for k in (
    "smp_direct_lambert", "smp_lambert_surface_lambert",
    "smp_lambert_surface_phong", "smp_direct_phong",
    "smp_phong_surface_lambert", "smp_phong_surface_phong",
)}


def _spheres():
    return sphere_scene(
        [[5.5, 1.0, 0.0], [4.0, 0.5, 1.0], [6.0, 2.5, -1.5]], [1.0, 0.5, 0.7],
        [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]],
    )


# The production inverse config is soft shadows with smp=2
# (tests/test_loss_kernel.py:109).
CASES = {
    "default_hard": (default_scene, {}),
    "spheres_soft_smp2": (_spheres, dict(soft_shadows=0.05, **SMP2)),
    "unbiased": (default_scene, dict(biased=False)),
}
# Which output planes carry a cotangent.
PLANE_SETS = {"all": fg.OUT_KEYS[:6], "image": ("add_d", "add_s", "alb", "ene")}
MATERIALS = ("s0", "s1", "alb_const", "alb_scale", "emission", "en_const", "en_scale")


def ill_conditioned(out, scene, cfg, cam=CAM, frame=FRAME) -> np.ndarray:
    """bool[H,W]: frame_kernel.ill_conditioned of the port's plain frame
    against JAX's frame outputs `out` (they part by more than
    frame_kernel.ILL·(1+|ref|) on some float plane, or on oid)."""
    port = fk.frame_forward_plain(to_torch_scene(scene), to_torch_camera(cam), frame,
                                  to_torch_config(cfg))
    return np_(fk.ill_conditioned(port, {k: torch.tensor(np.asarray(v)) for k, v in out.items()}))


def _cotangents(case: str, keys, bad) -> dict:
    """Random cotangents on the planes `keys`, zero on the pixels `bad`."""
    rng = np.random.default_rng(len(case))
    shapes = {"add_d": (H, W, 3), "add_s": (H, W, 3), "alb": (H, W, 3),
              "ene": (H, W, 2), "depth": (H, W), "curv": (H, W)}
    cots = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    keep = (~bad).astype(np.float32)
    return {k: cots[k] * (keep[..., None] if cots[k].ndim == 3 else keep) for k in keys}


def _jax_grads(d_scene, d_cam) -> dict:
    out = {k: np.asarray(getattr(d_scene, k))
           for k in ("planes", "spheres", "boxes", "light_color")}
    out.update({k: np.asarray(getattr(d_scene.materials, k)) for k in MATERIALS})
    out["loc"], out["orient"] = np.asarray(d_cam.loc), np.asarray(d_cam.orient)
    return out


@functools.lru_cache(maxsize=None)
def _reference(case: str):
    """(JAX scene, config, ill-conditioned pixels, {plane set: JAX gradients
    by name}) for `case`."""
    build, kw = CASES[case]
    scene, cfg = build(), RenderConfig(width=W, height=H, **kw)
    out, vjp = jax.vjp(
        lambda s, c: jfk.frame_forward_jnp(s, c, jnp.int32(FRAME), cfg), scene, CAM)
    bad = ill_conditioned(out, scene, cfg)
    assert bad.sum() <= 2, f"{bad.sum()} ill-conditioned pixels"
    refs = {}
    for which, keys in PLANE_SETS.items():
        cots = _cotangents(case, keys, bad)
        ct = {k: (np.zeros(v.shape, jax.dtypes.float0) if k == "oid"
                  else jnp.asarray(cots[k]) if k in cots else jnp.zeros_like(v))
              for k, v in out.items()}
        refs[which] = _jax_grads(*vjp(ct))
    return scene, cfg, bad, refs


def _port(case: str):
    scene, cfg, bad, refs = _reference(case)
    return to_torch_scene(scene), to_torch_camera(CAM), to_torch_config(cfg), bad, refs


def _assert_tables(got: dict, ref: dict, names):
    for name in names:
        a, b = np_(got[name]), ref[name]
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = float(np.abs(b).max()) if b.size else 0.0
        # 1e-10: the floor for a table JAX gives as exactly zero.
        np.testing.assert_allclose(a, b, rtol=0, atol=max(1e-4 * scale, 1e-10), err_msg=name)


@pytest.mark.parametrize("planes", list(PLANE_SETS))
@pytest.mark.parametrize("case", list(CASES))
def test_frame_backward_matches_jax_vjp(case, planes):
    scene, cam, cfg, bad, refs = _port(case)
    g = {k: torch.from_numpy(v) for k, v in _cotangents(case, PLANE_SETS[planes], bad).items()}
    tables = fg.frame_backward(scene, cam, FRAME, g, cfg)
    assert fg.LAUNCHES == 0  # CPU tensors: the plain version
    d_scene, d_cam = fg.assemble_grads(scene, cam, tables, scene.light_index)
    _assert_tables({**d_scene, **d_cam}, refs[planes], fg.GRAD_NAMES)


@pytest.mark.parametrize("case", list(CASES))
def test_frame_forward_autograd_matches_jax_vjp(case):
    """FrameForward end to end: torch.autograd.grad of the outputs against
    the same cotangents; the gradient of `light`, a view of spheres, folds
    back by itself."""
    scene, cam, cfg, bad, refs = _port(case)
    leaves = dict(zip(fg.GRAD_NAMES, (t.clone().requires_grad_()
                                     for t in fg._inputs(scene, cam))))
    mats = dataclasses.replace(scene.materials, **{k: leaves[k] for k in MATERIALS})
    sc = dataclasses.replace(scene, materials=mats, **{
        k: leaves[k] for k in ("planes", "spheres", "boxes", "light_color")})
    cm = Camera_t(loc=leaves["loc"], orient=leaves["orient"])
    out = fg.frame_forward(sc, cm, FRAME, cfg)
    cots = _cotangents(case, PLANE_SETS["all"], bad)
    grads = torch.autograd.grad([out[k] for k in cots], list(leaves.values()),
                                [torch.from_numpy(v) for v in cots.values()], allow_unused=True)
    got = {k: (torch.zeros_like(leaves[k]) if d is None else d) for k, d in zip(leaves, grads)}
    _assert_tables(got, refs["all"], fg.GRAD_NAMES)


def test_frame_forward_equals_the_frame_kernel_and_skips_absent_planes():
    scene, cam, cfg, _, _ = _port("default_hard")
    out = fg.frame_forward(scene, cam, FRAME, cfg)
    ref = fk.frame_forward(scene, cam, FRAME, cfg)
    assert set(out) == set(ref)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
    # Only the planes a loss touched are read; none touched → zero gradients.
    tables = fg.frame_backward(scene, cam, FRAME, {"depth": None}, cfg)
    assert all(t is not None and not t.any() for t in tables)


@pytest.mark.parametrize("case", ["default_hard", "spheres_soft_smp2"])
def test_frame_backward_computes_only_the_tables_asked_for(case):
    scene, cam, cfg, bad, _ = _port(case)
    g = {k: torch.from_numpy(v) for k, v in _cotangents(case, PLANE_SETS["image"], bad).items()}
    needs = fg.needs_for(("spheres", "alb_const"))
    assert sum(needs) == 3  # spheres, light (a view of spheres), alb_const
    some = fg.frame_backward(scene, cam, FRAME, g, cfg, needs=needs)
    full = fg.frame_backward(scene, cam, FRAME, g, cfg)
    for need, a, b in zip(needs, some, full):
        assert (a is None) != need
        if need:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="no gradient"):
        fg.needs_for(("freq",))


@pytest.mark.parametrize("case", list(CASES))
def test_seed_indices_address_the_packed_tables(case):
    """The kernels' tangent seeds index the flat f32 table that they gather
    from `table_parts`: the seeded entries, in order, are the DIFF_IDX
    operands' values."""
    scene, cam, _, _, _ = _port(case)
    flat = torch.cat([t.reshape(-1) for t in fk.table_parts(scene, cam)[0]])
    seeds = fg.seed_indices(scene, fg.needs_for(None), "cpu")
    ops = fk.small_operands(scene, cam, FRAME)
    counts = dict(zip((0, 2, 4), fk._counts(scene)))
    want = torch.cat([ops[k][:counts.get(k, ops[k].shape[0])].reshape(-1)
                      for k in fg.DIFF_IDX])
    assert torch.equal(flat[seeds.long()], want)
    tables = fg.unpack_grads(scene, fg.needs_for(None), torch.arange(seeds.numel(), dtype=torch.float32))
    assert [tuple(t.shape) for t in tables] == [tuple(ops[k].shape) for k in fg.DIFF_IDX]


def test_assemble_grads_folds_light_and_crops_padding():
    scene, cam, _, _, _ = _port("spheres_soft_smp2")  # no boxes: one padded row
    tables = [torch.ones(o.shape) for o in
              (fk.small_operands(scene, cam, FRAME)[k] for k in fg.DIFF_IDX)]
    d_scene, d_cam = fg.assemble_grads(scene, cam, tables, scene.light_index)
    assert d_scene["boxes"].shape == (0, 7)
    expect = torch.ones_like(scene.spheres)
    expect[scene.light_index] += 1.0
    assert torch.equal(d_scene["spheres"], expect)
    assert d_scene["light_color"].shape == (3,) and d_cam["orient"].shape == (2,)


# ---------------------------------------------- sparsity of the gradient
# The reverse sweep of K5 and K6 (csrc/frame_adjoint.cuh) reaches a table row
# only through the branch a pixel took: the nearest hit's winning candidate,
# the normal of the object hit, and, with hard shadows, no occluding sphere.
# These hold the plain version (the CPU route of K5) and JAX's vjp to the
# zeros that design relies on.

BOX_CAM = Camera.create(loc=(6.0, 1.8, -6.2), orient=(-0.5, 2.2))  # a close view of the rounded box


@functools.lru_cache(maxsize=None)
def _sparsity_vjp(which: str):
    """(JAX scene, camera, config, frame outputs, vjp) of `which`."""
    scene, cam, kw = {
        "box": (default_scene(), BOX_CAM, {}),
        "spheres_hard": (_spheres(), CAM, {}),
        "spheres_soft": (_spheres(), CAM, dict(soft_shadows=0.05)),
    }[which]
    cfg = RenderConfig(width=W, height=H, **kw)
    out, vjp = jax.vjp(lambda s, c: jfk.frame_forward_jnp(s, c, jnp.int32(FRAME), cfg), scene, cam)
    return scene, cam, cfg, {k: np.asarray(v) for k, v in out.items()}, vjp


def _both_grads(which: str, cots: dict):
    """(the port's plain K5, JAX's vjp) gradients by name for cotangent
    planes `cots` (numpy, by frame-dict key)."""
    scene, cam, cfg, out, vjp = _sparsity_vjp(which)
    ct = {k: (np.zeros(v.shape, jax.dtypes.float0) if k == "oid"
              else jnp.asarray(cots[k]) if k in cots else jnp.zeros_like(v))
          for k, v in out.items()}
    ref = _jax_grads(*vjp(ct))
    sc, cm = to_torch_scene(scene), to_torch_camera(cam)
    tables = fg.frame_backward(sc, cm, FRAME, {k: torch.from_numpy(v) for k, v in cots.items()},
                               to_torch_config(cfg))
    d_scene, d_cam = fg.assemble_grads(sc, cm, tables, sc.light_index)
    return {k: np_(v) for k, v in {**d_scene, **d_cam}.items()}, ref


def _one_hot_depth(which: str, oid: int) -> tuple:
    """A depth cotangent of 1 at the first well-conditioned pixel whose
    object ID is `oid` → both gradients by name."""
    scene, cam, cfg, out, _ = _sparsity_vjp(which)
    bad = ill_conditioned(out, scene, cfg, cam=cam)
    ys, xs = np.nonzero((out["oid"] == oid) & ~bad)
    assert ys.size, f"no pixel of object {oid} in view"
    depth = np.zeros((H, W), np.float32)
    depth[ys[0], xs[0]] = 1.0
    return _both_grads(which, {"depth": depth})


def _assert_only(grads: dict, nonzero) -> None:
    """Exactly zero outside `nonzero` (names); something non-zero in each."""
    for name in fg.GRAD_NAMES:
        g = grads[name]
        if name in nonzero:
            assert np.abs(g).max() > 0, name
        else:
            assert not np.any(g), f"{name} should be exactly zero: {g}"


def test_depth_at_a_box_pixel_reaches_only_the_box_and_the_camera():
    got, ref = _one_hot_depth("box", int(default_scene().box_ids[0]))
    for grads in (got, ref):
        _assert_only(grads, ("boxes", "loc", "orient"))
    _assert_tables(got, ref, fg.GRAD_NAMES)


def test_depth_at_a_sphere_pixel_reaches_only_that_sphere_and_the_camera():
    scene = _spheres()
    hit = 2  # the second of the three spheres after the light
    got, ref = _one_hot_depth("spheres_hard", int(scene.sphere_ids[hit]))
    for grads in (got, ref):
        _assert_only(grads, ("spheres", "loc", "orient"))
        rows = np.abs(grads["spheres"]).max(axis=1)
        assert rows[hit] > 0 and not np.delete(rows, hit).any(), rows
    _assert_tables(got, ref, fg.GRAD_NAMES)


def _off_the_spheres() -> np.ndarray:
    """bool[H,W]: pixels that hit no sphere, whose shading no sphere other
    than the light changes (the spheres shrunk to a point leave their
    planes bitwise equal) and that are well conditioned."""
    scene, cam, cfg, out, _ = _sparsity_vjp("spheres_hard")
    sc = to_torch_scene(scene)
    shrunk = sc.spheres.clone()
    shrunk[1:, 3] = 1e-6
    gone = fk.frame_forward_plain(dataclasses.replace(sc, spheres=shrunk), to_torch_camera(cam), FRAME,
                                  to_torch_config(cfg))
    same = np.all(np_(gone["add_d"]) == out["add_d"], -1) & np.all(np_(gone["add_s"]) == out["add_s"], -1)
    keep = same & ~np.isin(out["oid"], np.asarray(scene.sphere_ids)) & ~ill_conditioned(out, scene, cfg)
    assert keep.mean() > 0.5
    return keep


@pytest.mark.parametrize("shadows", ["hard", "soft"])
def test_spheres_other_than_the_light_and_the_shading_cotangent(shadows):
    """Cotangents on add_d/add_s at pixels that hit neither a sphere nor its
    shadow: with hard shadows a sphere that is not the light gets exactly
    zero (an occlusion test carries no derivative); with soft shadows its
    smooth transmittance reaches it."""
    keep = _off_the_spheres()[..., None].astype(np.float32)
    rng = np.random.default_rng(5)
    cots = {k: (rng.normal(size=(H, W, 3)) * keep).astype(np.float32) for k in ("add_d", "add_s")}
    got, ref = _both_grads(f"spheres_{shadows}", cots)
    for grads in (got, ref):
        others = grads["spheres"][1:]  # row 0 is the light
        if shadows == "hard":
            assert not np.any(others), others
        else:
            assert np.abs(others).max() > 1e-3 * np.abs(grads["spheres"]).max(), others
    _assert_tables(got, ref, fg.GRAD_NAMES)


# ------------------------------------------------ the differentiable frame

FRAME_CFGS = {
    "no_history": RenderConfig(width=W, height=H, pipeline="fused", no_history=True),
    "xla": RenderConfig(width=W, height=H, pipeline="fused", reproject_backend="xla"),
}
PREV = Camera.create(loc=(3.02, 1.99, -3.01), orient=(0.01, 0.69))


def _history(cfg):
    """A populated history from PREV, its object IDs the port's plain frame's
    at CAM (so most taps are live)."""
    oid = np_(fk.frame_forward_plain(to_torch_scene(default_scene()), to_torch_camera(CAM),
                                     FRAME, to_torch_config(cfg))["oid"])

    def channel(seed):
        r = np.random.default_rng(seed)
        return Channel(rgb=jnp.asarray(r.uniform(0.0, 2.0, (H, W, 3)), jnp.float32),
                       cnt=jnp.asarray(r.integers(0, 17, (H, W)).astype(np.float32)),
                       oid=jnp.asarray(oid))

    return History(diffuse=channel(1), specular=channel(2), camera=PREV)


def _jax_render_frame(scene, cam, hist, cfg):
    """JAX render_frame's differentiable branches (pipeline.py:129-171) with
    `frame_forward_jnp` standing in for the Pallas frame → (image, frame)."""
    out = jfk.frame_forward_jnp(scene, cam, jnp.int32(FRAME), cfg)
    ho = out["oid"]
    if cfg.no_history:
        ones = jnp.ones(ho.shape, jnp.float32)
        d = Channel(rgb=out["add_d"], cnt=ones, oid=ho)
        s = Channel(rgb=out["add_s"], cnt=ones, oid=ho)
    else:
        rd = ray_dirs(cam, cfg.width, cfg.height, cfg.fov)
        hl = cam.loc + rd * out["depth"][..., None]
        light_dist = jgmath.length(hl - scene.light[:3])
        fac = jgmath.EPS / jnp.sqrt(jnp.maximum(jgmath.EPS, out["curv"]))
        sl = hl + rd * (light_dist * fac)[..., None]
        vv = jgmath.length(cam.loc - hist.camera.loc)
        prev = hist.camera

        def accum(ch, anchor, add):
            rgb, cnt = jrep.reproject(prev.loc, prev.orient, anchor, ho, ch.rgb, ch.cnt,
                                      ch.oid, cfg.fov)
            rgb, cnt = _temporal_clamp(rgb, count_floor(cnt), vv, cfg)
            return Channel(rgb=rgb + add, cnt=cnt + 1.0, oid=ho)

        d = accum(hist.diffuse, hl, out["add_d"])
        s = accum(hist.specular, sl, out["add_s"])
    return jcomp.composite_from(out["alb"], out["ene"], d, s, cfg), out


@functools.lru_cache(maxsize=None)
def _frame_reference(which: str):
    """(image cotangent, JAX image, JAX gradients by name) for `which`."""
    cfg, scene = FRAME_CFGS[which], default_scene()
    hist = _history(cfg)
    (img, out), vjp = jax.vjp(lambda s, c: _jax_render_frame(s, c, hist, cfg), scene, CAM)
    bad = ill_conditioned(out, scene, cfg)
    assert bad.sum() <= 2, f"{bad.sum()} ill-conditioned pixels"
    rng = np.random.default_rng(11)
    cot = (rng.normal(size=(H, W, 3)) * ~bad[..., None]).astype(np.float32)
    zeros = {k: (np.zeros(v.shape, jax.dtypes.float0) if k == "oid" else jnp.zeros_like(v))
             for k, v in out.items()}
    return cot, np.asarray(img), _jax_grads(*vjp((jnp.asarray(cot), zeros)))


@pytest.mark.parametrize("which", list(FRAME_CFGS))
def test_render_frame_differentiable_branches_match_jax(which):
    """render_frame with no_history and with reproject_backend="xla": the
    image to the temporal-frame bar (atol 2e-4), and autograd of the image
    through FrameForward and the exact gather to 1e-4·max per table."""
    cot, img_ref, ref = _frame_reference(which)
    cfg = to_torch_config(FRAME_CFGS[which])
    scene, cam = to_torch_scene(default_scene()), to_torch_camera(CAM)
    leaves = dict(zip(fg.GRAD_NAMES, (t.clone().requires_grad_()
                                     for t in fg._inputs(scene, cam))))
    mats = dataclasses.replace(scene.materials, **{k: leaves[k] for k in MATERIALS})
    sc = dataclasses.replace(scene, materials=mats, **{
        k: leaves[k] for k in ("planes", "spheres", "boxes", "light_color")})
    cm = Camera_t(loc=leaves["loc"], orient=leaves["orient"])
    hist = to_torch_history(_history(FRAME_CFGS[which]))
    img, new = pipeline.render_frame(sc, cm, hist, FRAME, cfg)
    np.testing.assert_allclose(np_(img), img_ref, atol=2e-4, rtol=0)
    assert new.camera is cm
    grads = torch.autograd.grad(img, list(leaves.values()), torch.from_numpy(cot),
                                allow_unused=True)
    got = {k: (torch.zeros_like(leaves[k]) if d is None else d) for k, d in zip(leaves, grads)}
    _assert_tables(got, ref, fg.GRAD_NAMES)
