"""PyTorch port, the fused loss-and-gradient step (ops/loss_kernel.py): the
kernel's plain version (`render_loss_and_grad` on CPU tensors) and its
assembly (`loss_and_grad`) against `jax.vjp` of the JAX package's own
plain reference, `frame_forward_jnp` → `_composite_planes` → the loss
(the construction of tests/test_loss_kernel.py:63-100), on the same scenes,
cameras and targets (made with numpy).

Tolerance: the loss to rtol 1e-5; per gradient table max|Δ| ≤
1e-4·max|ref| (tests/test_frame_grad.py:190-198). The image mean gives
every pixel a cotangent, so the camera here sees no ill-conditioned pixel
(`ill_conditioned`, tests/test_torch_frame_grad.py; asserted); the MSE
target, a render of a perturbed scene, would equal the port's own image on
such pixels, which zeroes their residual. The JAX references are computed
once per case, eagerly (no jit)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import np_, to_torch_camera, to_torch_config, to_torch_scene
from kylespathtracer_tpu.ops import frame_kernel as jfk
from kylespathtracer_tpu.ops import loss_kernel as jlk
from kylespathtracer_tpu.render import composite as jcomp
from kylespathtracer_tpu.render.camera import Camera
from kylespathtracer_tpu.render.passes import Channel
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import loss_kernel as lk
from test_torch_frame_grad import (
    CASES, FRAME, H, W, _assert_tables, _jax_grads, ill_conditioned,
)

CAM = Camera.create(loc=(3.0, 2.0, -3.0), orient=(-0.05, 0.75))


def _jax_composite(cfg):
    """The JAX package's component-plane composite as a function of the
    frame's float planes → image [H,W,3]."""
    def f(p):
        img = jlk._composite_planes(
            tuple(p["alb"][..., c] for c in range(3)),
            tuple(p["ene"][..., c] for c in range(2)),
            tuple(p["add_d"][..., c] for c in range(3)),
            tuple(p["add_s"][..., c] for c in range(3)),
            cfg.brightness,
        )
        return jnp.stack(img, axis=-1)
    return f


def _port_image(scene, cfg) -> np.ndarray:
    """The port's plain frame and composite of the JAX scene `scene`."""
    out = fk.frame_forward_plain(to_torch_scene(scene), to_torch_camera(CAM), FRAME,
                                 to_torch_config(cfg))
    img = lk._composite_planes([out["alb"][..., c] for c in range(3)],
                               [out["ene"][..., c] for c in range(2)],
                               [out["add_d"][..., c] for c in range(3)],
                               [out["add_s"][..., c] for c in range(3)], cfg.brightness)
    return np_(torch.stack(img, dim=-1))


def _perturbed(scene):
    """The target scene: every sphere moved and resized a little."""
    rng = np.random.default_rng(7)
    sp = np.asarray(scene.spheres).copy()
    sp += rng.normal(0.0, 0.05, sp.shape).astype(np.float32)
    return scene.replace(spheres=jnp.asarray(sp))


@functools.lru_cache(maxsize=None)
def _reference(case: str):
    """(JAX scene, config, target, {loss: (value, JAX gradients by name)}):
    jax.vjp of frame_forward_jnp, then of the composite, then the loss."""
    build, kw = CASES[case]
    scene, cfg = build(), RenderConfig(width=W, height=H, **kw)
    out, vjp_frame = jax.vjp(
        lambda s, c: jfk.frame_forward_jnp(s, c, jnp.int32(FRAME), cfg), scene, CAM)
    bad = ill_conditioned(out, scene, cfg, cam=CAM)
    assert not bad.any(), f"{bad.sum()} ill-conditioned pixels; the mean loss reads them"
    img, vjp_img = jax.vjp(_jax_composite(cfg), {k: out[k] for k in fg.OUT_KEYS[:6]})
    target = np.where(bad[..., None], _port_image(scene, cfg),
                      _port_image(_perturbed(scene), cfg)).astype(np.float32)
    n = float(H * W * 3)
    cots = {
        "mse": (float(jnp.sum((img - target) ** 2)) / n, 2.0 * (img - target) / n),
        "mean": (float(jnp.sum(img)) / n, jnp.full(img.shape, 1.0 / n, jnp.float32)),
    }
    refs = {}
    for loss, (value, cot) in cots.items():
        (d_planes,) = vjp_img(cot)
        ct = {**d_planes, "oid": np.zeros(out["oid"].shape, jax.dtypes.float0)}
        refs[loss] = (value, _jax_grads(*vjp_frame(ct)))
    return scene, cfg, target, refs


def test_composite_planes_matches_composite_from():
    """The kernels' component-plane composite reproduces the JAX package's
    composite_from for the fresh-history frame (both counts 1)."""
    rng = np.random.default_rng(0)
    alb = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    alb[0] = 0.0  # the miss material row: the sqrt guard
    ene = rng.uniform(0, 1, (H, W, 2)).astype(np.float32)
    add_d = rng.uniform(0, 3, (H, W, 3)).astype(np.float32)
    add_s = rng.uniform(0, 3, (H, W, 3)).astype(np.float32)
    cfg = RenderConfig(width=W, height=H)
    ones, oid = jnp.ones((H, W), jnp.float32), jnp.ones((H, W), jnp.int32)
    ref = jcomp.composite_from(jnp.asarray(alb), jnp.asarray(ene),
                               Channel(rgb=jnp.asarray(add_d), cnt=ones, oid=oid),
                               Channel(rgb=jnp.asarray(add_s), cnt=ones, oid=oid), cfg)
    t = torch.from_numpy
    got = lk._composite_planes([t(alb[..., c]) for c in range(3)], [t(ene[..., c]) for c in range(2)],
                               [t(add_d[..., c]) for c in range(3)], [t(add_s[..., c]) for c in range(3)],
                               cfg.brightness)
    np.testing.assert_allclose(np_(torch.stack(got, dim=-1)), np.asarray(ref), atol=2e-6, rtol=0)


@pytest.mark.parametrize("loss", ["mse", "mean"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grad_matches_jax(case, loss):
    scene, cfg, target, refs = _reference(case)
    value, ref = refs[loss]
    sc, cam, cfg_t = to_torch_scene(scene), to_torch_camera(CAM), to_torch_config(cfg)
    tgt = torch.from_numpy(target) if loss == "mse" else None
    lval, (d_scene, d_cam) = lk.loss_and_grad(sc, cam, FRAME, cfg_t, target=tgt, loss=loss)
    assert lk.LAUNCHES == 0  # CPU tensors: the plain version
    np.testing.assert_allclose(float(lval), value, rtol=1e-5)
    _assert_tables({**d_scene, **d_cam}, ref, fg.GRAD_NAMES)


@pytest.mark.parametrize("case", ["default_hard", "spheres_soft_smp2"])
def test_render_loss_and_grad_computes_only_the_tables_asked_for(case):
    scene, cfg, target, _ = _reference(case)
    sc, cam, cfg_t = to_torch_scene(scene), to_torch_camera(CAM), to_torch_config(cfg)
    tgt = torch.from_numpy(target)
    needs = fg.needs_for(("spheres", "alb_const"))
    l1, some = lk.render_loss_and_grad(sc, cam, FRAME, cfg_t, tgt, "mse", needs=needs)
    l2, full = lk.render_loss_and_grad(sc, cam, FRAME, cfg_t, tgt, "mse")
    assert float(l1) == float(l2)
    for need, a, b in zip(needs, some, full):
        assert (a is None) != need
        if need:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_the_loss_is_the_image_loss_of_the_differentiable_frame():
    """The fused step equals autograd through the generic differentiable
    frame (K1 + K5 on the card) and the image MSE: the two routes the
    inverse-rendering step can take."""
    from kylespathtracer_tpu_torch.diff import inverse

    scene, cfg, target, _ = _reference("spheres_soft_smp2")
    sc, cam = to_torch_scene(scene), to_torch_camera(CAM)
    cfg_t = to_torch_config(dataclasses.replace(cfg, pipeline="fused"))
    tgt = torch.from_numpy(target)
    params = {k: v.clone().requires_grad_() for k, v in inverse.extract_params(sc).items()}
    loss = inverse.loss_fn(params, sc, cam, tgt, FRAME, cfg_t)
    grads = torch.autograd.grad(loss, list(params.values()))
    lval, (d_scene, _) = lk.loss_and_grad(sc, cam, FRAME, cfg_t, target=tgt, keys=tuple(params))
    np.testing.assert_allclose(float(lval), float(loss.detach()), rtol=1e-6)
    for k, g in zip(params, grads):
        scale = float(g.abs().max())
        torch.testing.assert_close(d_scene[k], g, rtol=0, atol=1e-5 * scale)


def test_bad_arguments_raise():
    scene, cfg, _, _ = _reference("unbiased")
    sc, cam, cfg_t = to_torch_scene(scene), to_torch_camera(CAM), to_torch_config(cfg)
    with pytest.raises(ValueError, match="unknown loss"):
        lk.render_loss_and_grad(sc, cam, FRAME, cfg_t, loss="l1")
    with pytest.raises(ValueError, match="needs a target"):
        lk.render_loss_and_grad(sc, cam, FRAME, cfg_t, loss="mse")
    with pytest.raises(ValueError, match="target must be"):
        lk.render_loss_and_grad(sc, cam, FRAME, cfg_t, torch.zeros(H, W), loss="mse")
    with pytest.raises(ValueError, match="integral gloss"):
        fk.kernel_args(sc, cam, to_torch_config(RenderConfig(width=W, height=H, gloss=2.5)))
