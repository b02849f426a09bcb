"""PyTorch port, gradients through `intersect` and the march (the
implicit-function backward of scene/sdf.py) on the CPU:

- the JAX package's finite-difference checks in torch, at their bars:
  tests/test_grad.py (position, albedo, all finite, the albedo fit) through
  `render_once` with a default `RenderConfig` (the pass pipeline),
  tests/test_silhouette.py (the soft-shadow gradient; zero under hard
  visibility) and tests/test_wavefront.py:306 (`path_backend="xla"`);
- the pass pipeline's gradient against `jax.grad(loss_fn)` (the sphere
  scene at 48×32, one JAX gradient for the module), 2e-3·max per table;
- the pass gradient against the fused routes' plain versions (K1 + K5
  through `KPT_FUSED_LOSS=0`, and K6) on the default scene at 32×16,
  2e-3·max per table, and the switch's route;
- `run_recovery`'s pass route (the CPU's) against the JAX package's: the
  losses and the errors of the final tables within rtol 1e-4 (the float
  sums run in other orders; measured ~3e-6);
- the forward-only kernels (K3, K4, K7) refusing an input that requires
  grad."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import np_
from kylespathtracer_tpu.diff import inverse as jinv
from kylespathtracer_tpu.render.camera import Camera as JCamera
from kylespathtracer_tpu.scene.scene import sphere_scene as jsphere_scene
from kylespathtracer_tpu.utils.config import RenderConfig as JConfig
from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.diff import inverse, softvis
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import geometry_kernel as gk
from kylespathtracer_tpu_torch.ops import loss_kernel as lk
from kylespathtracer_tpu_torch.ops import path_kernel as pk
from kylespathtracer_tpu_torch.ops import shade_kernel as sk
from kylespathtracer_tpu_torch.render import gbuffer, passes, wavefront
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.scene import intersect as isect
from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene
from kylespathtracer_tpu_torch.utils.config import RenderConfig

CPU = torch.device("cpu")
CFG = RenderConfig(width=48, height=32)
CAM = Camera.create(loc=(0.0, 2.0, -2.0), orient=(-0.15, 0.0), device=CPU)
CENTERS = [[0.0, 1.2, 4.0], [1.6, 0.8, 5.0]]
RADII = [1.0, 0.8]
ALBEDOS = [[0.6, 0.3, 0.2], [0.2, 0.5, 0.6]]


def _base():
    return sphere_scene(CENTERS, RADII, ALBEDOS, device=CPU)


def _scene(dx=0.0, dr=0.0, da=0.0):
    """tests/test_grad.py's `make_scene`: the base scene with the second
    sphere moved by dx, grown by dr, and its albedo's red raised by da
    (each a float or a tensor that autograd tracks)."""
    base = _base()
    spheres = base.spheres.clone()
    spheres[2, 0] = spheres[2, 0] + dx
    spheres[2, 3] = spheres[2, 3] + dr
    alb = base.materials.alb_const.clone()
    alb[3, 0] = alb[3, 0] + da
    return dataclasses.replace(base, spheres=spheres,
                               materials=dataclasses.replace(base.materials, alb_const=alb))


def _render_mean(scene, cfg=CFG):
    return inverse.render_once(scene, CAM, cfg, 0).mean()


def _grad_and_fd(make, h):
    x = torch.tensor(0.0, requires_grad=True)
    (g,) = torch.autograd.grad(_render_mean(make(x)), x)
    with torch.no_grad():
        fd = (_render_mean(make(h)) - _render_mean(make(-h))) / (2 * h)
    return float(g), float(fd)


def test_grad_matches_finite_difference_position():
    g, fd = _grad_and_fd(lambda x: _scene(dx=x), 2e-3)
    assert np.isfinite(g) and np.isfinite(fd)
    # Visibility edges make the difference noisy: sign and rough scale.
    assert abs(g - fd) < max(0.35 * abs(fd), 5e-3), (g, fd)


def test_grad_matches_finite_difference_albedo():
    g, fd = _grad_and_fd(lambda x: _scene(da=x), 1e-2)
    assert np.isfinite(g) and np.isfinite(fd)
    assert abs(g - fd) < max(0.15 * abs(fd), 1e-3), (g, fd)


def test_grads_finite_everywhere():
    scene = _scene()
    params = inverse.extract_params(scene)
    loss, grads = inverse.value_and_grad(params, scene, CAM, torch.zeros((CFG.height, CFG.width, 3)), 0, CFG)
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert grads["spheres"].abs().max() > 0


def test_inverse_rendering_recovers_albedo():
    """`fit` with a default config (the pass pipeline) moves a wrong albedo
    at least halfway back toward the target's in 40 steps."""
    cfg = RenderConfig(width=32, height=24)
    target_scene = _scene()
    with torch.no_grad():
        target = inverse.render_once(target_scene, CAM, cfg, 0)
    fitted, losses = inverse.fit(_scene(da=-0.35), target, CAM, cfg, keys=("alb_const",), steps=40, lr=5e-2,
                                 vary_seed=False)
    assert losses[-1] < losses[0] * 0.5, losses[:3] + losses[-3:]
    got = float(fitted.materials.alb_const[3, 0])
    want = float(target_scene.materials.alb_const[3, 0])
    assert abs(got - want) < 0.35 * 0.5, (got, want)


# ------------------------------------------------ tests/test_silhouette.py

def _shadow_setup():
    """Floor points in the shadow of an occluder near (0, 2, 5) under the
    default light (tests/test_silhouette.py:_setup)."""
    scene = sphere_scene([[0.0, 2.0, 5.0]], [0.6], [[0.5, 0.5, 0.5]], device=CPU)
    gx, gz = torch.meshgrid(torch.linspace(-7.0, 0.0, 36), torch.linspace(8.0, 14.0, 24), indexing="ij")
    hl = torch.stack([gx, torch.zeros_like(gx), gz], dim=-1).reshape(-1, 3)
    hn = torch.tensor([0.0, 1.0, 0.0]).expand(hl.shape)
    ho = torch.full(hl.shape[:-1], 2, dtype=torch.int32)
    return scene, hl, hn, ho


def _moved(scene, sx):
    spheres = scene.spheres.clone()
    spheres[1, 0] = sx
    return dataclasses.replace(scene, spheres=spheres)


def test_soft_gradient_matches_finite_difference():
    scene, hl, hn, ho = _shadow_setup()
    f = lambda sx: softvis.soft_direct_light(_moved(scene, sx), hl, hn, ho, 0.05).mean()
    x = torch.tensor(0.3, requires_grad=True)
    (g,) = torch.autograd.grad(f(x), x)
    with torch.no_grad():
        fd = (f(torch.tensor(0.3 + 1e-3)) - f(torch.tensor(0.3 - 1e-3))) / 2e-3
    assert np.isfinite(float(g))
    assert abs(float(g) - float(fd)) < 0.1 * max(abs(float(fd)), 1e-6), (float(g), float(fd))
    assert abs(float(g)) > 1e-4


def test_hard_visibility_gradient_is_zero():
    """The hard hit test gives no occluder gradient through `intersect`'s
    backward (the occluder is not hit where it casts its shadow), while
    the finite difference sees the shadow move."""
    scene, hl, hn, ho = _shadow_setup()

    def hard_loss(sx):
        sc = _moved(scene, sx)
        lv = sc.light[:3] - hl
        ndir = lv / gmath.length(lv)[..., None]
        _, tid = isect.intersect(sc, hl, ndir, ho)
        return ((tid == sc.light_id).to(torch.float32) * gmath.lambertian(hn, ndir)).mean()

    x = torch.tensor(0.3, requires_grad=True)
    loss = hard_loss(x)
    g = torch.autograd.grad(loss, x, allow_unused=True)[0] if loss.requires_grad else None
    g = 0.0 if g is None else float(g)
    with torch.no_grad():
        fd = (hard_loss(torch.tensor(0.35)) - hard_loss(torch.tensor(0.25))) / 0.1
    assert abs(float(fd)) > 1e-4
    assert abs(g) < 0.05 * abs(float(fd))


# ------------------------------------------------ tests/test_wavefront.py:306

@pytest.mark.parametrize("normal_mode", ["auto", "tetra"])
def test_wavefront_gradient_matches_finite_difference(normal_mode):
    """dL/d(radius) through 2 bounces of the XLA-style integrator (the path
    kernel is forward only) within rtol 0.15, atol 0.05 of the central
    difference; with "tetra" the normals are the sdf's gradient, whose own
    gradient (a second derivative of the distance field) joins the chain."""
    cfg = RenderConfig(width=12, height=12, max_depth=2, spp=4, path_backend="xla", normal_mode=normal_mode)
    base = sphere_scene([[0.0, 2.0, 6.0]], [1.0], [[0.6, 0.6, 0.6]], diffuse_energy=1.0, specular_energy=0.0,
                        with_floor=False, device=CPU)
    cam = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0), device=CPU)

    def loss(dr):
        spheres = base.spheres.clone()
        spheres[1, 3] = spheres[1, 3] + dr
        return wavefront.pathtrace(dataclasses.replace(base, spheres=spheres), cam, cfg, 0).sum()

    x = torch.tensor(0.0, requires_grad=True)
    (g,) = torch.autograd.grad(loss(x), x)
    with torch.no_grad():
        fd = (float(loss(1e-3)) - float(loss(-1e-3))) / 2e-3
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), fd, rtol=0.15, atol=0.05)


# ------------------------------------------- the pass gradient against JAX

@pytest.fixture(scope="module")
def jax_pass_gradient():
    """`jax.value_and_grad(loss_fn)` of the JAX package at the sphere scene,
    48×32, a default config, on a numpy-seeded target → (loss, grads,
    target)."""
    target = np.random.default_rng(0).uniform(0, 1, (32, 48, 3)).astype(np.float32)
    scene = jsphere_scene(CENTERS, RADII, ALBEDOS)
    cam = JCamera.create(loc=(0.0, 2.0, -2.0), orient=(-0.15, 0.0))
    loss, grads = jax.value_and_grad(jinv.loss_fn, allow_int=True)(
        jinv.extract_params(scene), scene, cam, jnp.asarray(target), jnp.asarray(0, jnp.int32), JConfig(48, 32))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}, target


def test_pass_gradient_matches_jax(jax_pass_gradient):
    """`value_and_grad` with a default config, the pass pipeline through
    `intersect`'s implicit-function backward, against `jax.grad(loss_fn)`:
    the loss within rtol 1e-5, each table within 2e-3·max."""
    loss_j, grads_j, target = jax_pass_gradient
    scene = _base()
    loss, grads = inverse.value_and_grad(inverse.extract_params(scene), scene, CAM, torch.from_numpy(target), 0,
                                         CFG)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    for k, a in grads_j.items():
        assert np.abs(a).max() > 0, k
        np.testing.assert_allclose(np_(grads[k]), a, rtol=0, atol=2e-3 * np.abs(a).max(), err_msg=k)


def _fused_case():
    scene = default_scene(device=CPU)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=CPU)
    cfg = RenderConfig(width=32, height=16, soft_shadows=0.05)
    params = inverse.extract_params(scene, ("spheres", "planes", "alb_const", "light_color"))
    target = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (16, 32, 3)).astype(np.float32))
    return scene, cam, cfg, params, target


def test_pass_gradient_matches_fused_routes(monkeypatch):
    """The pass pipeline's gradient (`shade_backend="xla"`) against the
    fused pipeline's two routes on the same loss, the generic one
    (`KPT_FUSED_LOSS=0`: K1 + K5, their plain versions here) and K6's:
    every table within 2e-3·max of the pass gradient."""
    scene, cam, cfg, params, target = _fused_case()
    loss_p, grads_p = inverse.value_and_grad(params, scene, cam, target, 0, cfg)
    fused = dataclasses.replace(cfg, pipeline="fused")
    monkeypatch.setenv("KPT_FUSED_LOSS", "0")
    routes = {"generic": inverse.value_and_grad(params, scene, cam, target, 0, fused)}
    monkeypatch.setenv("KPT_FUSED_LOSS", "1")
    routes["K6"] = inverse.value_and_grad(params, scene, cam, target, 0, fused)
    for route, (loss, grads) in routes.items():
        np.testing.assert_allclose(float(loss), float(loss_p), rtol=1e-4, err_msg=route)
        for k, a in grads_p.items():
            a = np_(a)
            assert np.abs(a).max() > 0, k
            np.testing.assert_allclose(np_(grads[k]), a, rtol=0, atol=2e-3 * np.abs(a).max(),
                                       err_msg=f"{route} {k}")


def test_kpt_fused_loss_switch(monkeypatch):
    """`KPT_FUSED_LOSS=0` sends a fused step through autograd of `loss_fn`
    (K1 forward, K5 backward) and not through K6; unset, the step is K6's."""
    scene, cam, cfg, params, target = _fused_case()
    cfg = dataclasses.replace(cfg, pipeline="fused")
    calls = {"loss": 0, "frame": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(lk, "loss_and_grad", counted("loss", lk.loss_and_grad))
    monkeypatch.setattr(fg, "frame_forward", counted("frame", fg.frame_forward))
    monkeypatch.setenv("KPT_FUSED_LOSS", "0")
    inverse.value_and_grad(params, scene, cam, target, 0, cfg)
    assert calls == {"loss": 0, "frame": 1}
    monkeypatch.delenv("KPT_FUSED_LOSS")
    inverse.value_and_grad(params, scene, cam, target, 0, cfg)
    assert calls == {"loss": 1, "frame": 1}


def test_run_recovery_pass_route_matches_jax():
    """`run_recovery` on the CPU takes the pass pipeline, as the JAX package
    does off its accelerator: 2 spheres, 2 views, 16×8, 2 β phases of 1 and
    2 steps. Each phase's loss and the errors of the final tables against
    the JAX package's, rtol 1e-4."""
    kw = dict(num_spheres=2, steps=4, width=16, height=8, views=2, betas=(0.05, 0.02))
    ref = jinv.run_recovery(**kw)
    before = (lk.LAUNCHES, fg.LAUNCHES)
    got = inverse.run_recovery(**kw, device="cpu")
    assert (lk.LAUNCHES, fg.LAUNCHES) == before
    for k in ("loss_initial", "loss_final", "err_position", "err_radius", "err_albedo"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    for a, b in zip(got["phases"], ref["phases"]):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert got["steps"] == ref["steps"] == 3


@pytest.mark.parametrize("kernel", ["geometry", "shade", "path"])
def test_forward_only_kernels_refuse_grad(kernel):
    """K3, K4 and K7 are forward only: their wrappers (here on the CPU, where
    the plain versions stand in for them) raise on an input that requires
    grad, naming the differentiable route, instead of returning a tensor
    that autograd cannot reach."""
    scene = default_scene(device=CPU)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=CPU)
    cfg = RenderConfig(width=16, height=8, pipeline="pass", shade_backend="pallas", spp=1)
    tracked = dataclasses.replace(scene, spheres=scene.spheres.clone().requires_grad_())
    if kernel == "geometry":
        call, route = lambda sc: gk.geometry_pass(sc, cam, 0, cfg), "gbuffer.geometry_pass"
    elif kernel == "shade":
        gb = gbuffer.geometry_pass(scene, cam, cfg)
        _, seed = passes._shade_common(scene, cfg, gb, cam, 0)
        call, route = lambda sc: sk.dual_mis(sc, gb, cam, seed, cfg), 'shade_backend="xla"'
    else:
        call, route = lambda sc: pk.pathtrace(sc, cam, cfg, 0), 'path_backend="xla"'
    call(scene)
    with pytest.raises(ValueError, match=route):
        call(tracked)
