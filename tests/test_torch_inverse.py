"""PyTorch port, inverse rendering (diff/inverse.py): the optimizer against
the optax chain of the JAX package (kylespathtracer_tpu/diff/inverse.py:
344-349), the first step of a seed-paired multi-view fit against
`jax.vjp` of the JAX package's plain reference (`frame_forward_jnp` →
`_composite_planes` → MSE), the fit and recovery loops at a tiny size, and
the entry points' default device.

Tolerances: the optimizer to atol 1e-7 over 20 steps; the loss to rtol
1e-5 and each gradient to max|Δ| ≤ 1e-4·max|ref|, with the MSE target
equal to the port's own image on ill-conditioned pixels (see
tests/test_torch_frame_grad.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_helpers import np_, to_torch_camera, to_torch_config, to_torch_scene
from kylespathtracer_tpu.diff import inverse as jinv
from kylespathtracer_tpu.ops import frame_kernel as jfk
from kylespathtracer_tpu.ops import loss_kernel as jlk
from kylespathtracer_tpu.scene.scene import sphere_scene as jsphere_scene
from kylespathtracer_tpu.utils.config import RenderConfig
import kylespathtracer_tpu_torch as port
from kylespathtracer_tpu_torch.app import driver
from kylespathtracer_tpu_torch.diff import inverse
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import loss_kernel as lk
from kylespathtracer_tpu_torch.render import camera, pipeline
from kylespathtracer_tpu_torch.render.passes import Channel
from kylespathtracer_tpu_torch.scene import scene as scene_mod
from test_torch_frame_grad import ill_conditioned

W, H = 32, 16
CFG = RenderConfig(width=W, height=H, soft_shadows=0.05, pipeline="fused")
CENTERS = np.array([[-0.6, 0.8, 6.0], [0.9, 1.1, 6.5]], np.float32)
RADII = np.array([0.6, 0.5], np.float32)
ALBEDOS = np.array([[0.7, 0.3, 0.2], [0.2, 0.5, 0.8]], np.float32)
EYES = ((0.0, 2.5, 0.0), (1.5, 4.0, 0.5))
S = 2  # seed-paired target realizations


# ----------------------------------------------------------------- optimizer

def _grad_sequence(n: int):
    """n gradient dicts whose global norm crosses 1 (the clip engages on
    some steps and not on others)."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        s = 0.05 if i % 3 == 0 else 0.6
        out.append({"alb_const": (rng.normal(size=(6, 3)) * s).astype(np.float32),
                    "spheres": (rng.normal(size=(4, 4)) * s).astype(np.float32)})
    return out


@pytest.mark.parametrize("clip", [None, 1.0])
def test_clipped_adam_matches_optax(clip):
    lr, steps, alpha = 2e-2, 20, 0.03
    rng = np.random.default_rng(5)
    p0 = {"alb_const": rng.uniform(-0.5, 0.5, (6, 3)).astype(np.float32),
          "spheres": rng.uniform(-0.5, 0.5, (4, 4)).astype(np.float32)}
    adam = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=alpha))
    chain = adam if clip is None else optax.chain(optax.clip_by_global_norm(clip), adam)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = chain.init(jp)
    opt = inverse.ClippedAdam(lr, steps, alpha, clip=clip)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = opt.init(tp)
    norms = []
    for g in _grad_sequence(steps):
        norms.append(float(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))))
        upd, js = chain.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        for k in p0:
            np.testing.assert_allclose(np_(tp[k]), np.asarray(jp[k]), atol=1e-7, rtol=0, err_msg=k)
    assert min(norms) < 1.0 < max(norms)


def test_clip_by_global_norm_has_no_epsilon():
    g = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0])}
    out = inverse.clip_by_global_norm(g, 1.0)
    ref = optax.clip_by_global_norm(1.0).update({"a": jnp.asarray([3.0, 4.0]), "b": jnp.asarray([0.0])},
                                                optax.EmptyState())[0]
    assert np_(out["a"]).tolist() == np.asarray(ref["a"]).tolist() == [0.6000000238418579, 0.800000011920929]
    kept = inverse.clip_by_global_norm({"a": torch.tensor([0.3, 0.4])}, 1.0)
    assert torch.equal(kept["a"], torch.tensor([0.3, 0.4]))


def test_cosine_decay_equals_optax():
    sched = optax.cosine_decay_schedule(0.02, 37, alpha=0.05)
    for count in (0, 1, 18, 36, 37, 50):
        np.testing.assert_allclose(0.02 * inverse.cosine_decay(count, 37, 0.05),
                                   float(sched(count)), rtol=1e-6)


# ------------------------------------------------------ the fit's first step

def _scenes():
    gt = jsphere_scene(CENTERS, RADII, ALBEDOS)
    start = jsphere_scene(CENTERS + np.float32(0.08), RADII * np.float32(0.9),
                          np.full_like(ALBEDOS, 0.5))
    return gt, start


def _cams():
    at = tuple(float(x) for x in CENTERS.mean(0))
    return [jinv.look_at(e, at) for e in EYES]


def _jax_view(params, scene, cam, frame, target):
    """One view's MSE through frame_forward_jnp and _composite_planes."""
    out = jfk.frame_forward_jnp(jinv.apply_params(scene, params), cam, jnp.int32(frame), CFG)
    img = jlk._composite_planes(
        tuple(out["alb"][..., c] for c in range(3)), tuple(out["ene"][..., c] for c in range(2)),
        tuple(out["add_d"][..., c] for c in range(3)), tuple(out["add_s"][..., c] for c in range(3)),
        CFG.brightness)
    return jnp.mean((jnp.stack(img, axis=-1) - target) ** 2), out


@functools.lru_cache(maxsize=None)
def _fit_reference():
    """(port scenes, stacked port cameras, target [V,S,H,W,3], JAX loss and
    gradients of step 0). The targets are the port's renders of the true
    scene at frames SEED_BASE+s; on ill-conditioned pixels of the start
    scene the step-0 target is the start scene's own image."""
    gt, start = _scenes()
    cams = _cams()
    sc_gt, sc0 = to_torch_scene(gt), to_torch_scene(start)
    cams_t = [to_torch_camera(c) for c in cams]
    cfg_t = to_torch_config(CFG)
    target = torch.stack([torch.stack([inverse.render_once(sc_gt, c, cfg_t, inverse.SEED_BASE + s)
                                       for s in range(S)]) for c in cams_t]).numpy().copy()
    params = jinv.extract_params(start)
    losses, grads = [], []
    for v, cam in enumerate(cams):
        (lv, out), vjp = jax.vjp(
            lambda p: _jax_view(p, start, cam, inverse.SEED_BASE, jnp.asarray(target[v, 0])), params)
        bad = ill_conditioned(out, start, CFG, cam=cam, frame=inverse.SEED_BASE)
        assert bad.sum() <= 2, f"{bad.sum()} ill-conditioned pixels"
        if bad.any():
            own = np_(inverse.render_once(sc0, cams_t[v], cfg_t, inverse.SEED_BASE))
            target[v, 0][bad] = own[bad]
            (lv, out), vjp = jax.vjp(
                lambda p: _jax_view(p, start, cam, inverse.SEED_BASE, jnp.asarray(target[v, 0])),
                params)
        zeros = {k: (np.zeros(a.shape, jax.dtypes.float0) if k == "oid" else jnp.zeros_like(a))
                 for k, a in out.items()}
        (g,) = vjp((jnp.float32(1.0), zeros))
        losses.append(float(lv))
        grads.append({k: np.asarray(a) for k, a in g.items()})
    ref_loss = float(np.mean(losses))
    ref_grads = {k: np.mean([g[k] for g in grads], axis=0) for k in params}
    return sc_gt, sc0, inverse.stack_cameras(cams_t), torch.from_numpy(target), ref_loss, ref_grads


def test_fit_step0_loss_and_gradients_match_jax():
    """2 spheres, 2 views, seed-paired S=2: the step's loss and gradients
    (one fused loss-and-gradient call per view, the plain version on the
    CPU) against JAX; `fit` takes that step and one Adam update."""
    _, sc0, cams, target, ref_loss, ref_grads = _fit_reference()
    cfg_t = to_torch_config(CFG)
    params = inverse.extract_params(sc0)
    loss, grads = inverse.value_and_grad(params, sc0, cams, target[:, 0], inverse.SEED_BASE, cfg_t)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    for k, ref in ref_grads.items():
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(np_(grads[k]), ref, rtol=0, atol=1e-4 * scale, err_msg=k)

    fitted, losses = inverse.fit(sc0, target, cams, cfg_t, steps=1)
    assert losses == [float(loss)]
    opt = inverse.ClippedAdam(2e-2, 1, 0.05)
    want = opt.update(grads, opt.init(params), params)
    for k, v in inverse.extract_params(fitted).items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_fit_takes_single_multi_view_and_seed_paired_targets():
    sc_gt, sc0, cams, target, _, _ = _fit_reference()
    cfg_t = to_torch_config(CFG)
    one = inverse.fit(sc0, target[0, 0], cams[0], cfg_t, steps=2, vary_seed=False)[1]
    multi = inverse.fit(sc0, target[:, 0], cams, cfg_t, steps=2)[1]
    paired = inverse.fit(sc0, target, cams, cfg_t, steps=2)[1]
    for losses in (one, multi, paired):
        assert len(losses) == 2 and all(np.isfinite(losses))
    # A multi-view loss is the mean of the single-view losses.
    per_view = [float(inverse.loss_fn(inverse.extract_params(sc0), sc0, cams[v], target[v, 0],
                                      inverse.SEED_BASE, cfg_t)) for v in range(2)]
    np.testing.assert_allclose(
        float(inverse.loss_fn(inverse.extract_params(sc0), sc0, cams, target[:, 0],
                              inverse.SEED_BASE, cfg_t)), np.mean(per_view), rtol=1e-6)
    assert paired[0] == pytest.approx(np.mean(per_view), rel=1e-5)


def test_train_step_is_one_generic_step():
    """train_step (autograd through the differentiable frame) takes the
    same step as the fused route."""
    _, sc0, cams, target, _, _ = _fit_reference()
    cfg_t = to_torch_config(CFG)
    params = inverse.extract_params(sc0)
    opt = inverse.ClippedAdam(2e-2, 10, 0.03, clip=1.0)
    new, _, loss = inverse.train_step(params, opt.init(params), opt, sc0, cams, target[:, 0],
                                      inverse.SEED_BASE, cfg_t)
    lf, gf = inverse.value_and_grad(params, sc0, cams, target[:, 0], inverse.SEED_BASE, cfg_t)
    np.testing.assert_allclose(float(loss), float(lf), rtol=1e-6)
    want = opt.update(gf, opt.init(params), params)
    for k in params:
        torch.testing.assert_close(new[k], want[k], rtol=0, atol=1e-6)


def test_run_recovery_tiny_on_the_cpu():
    before = (lk.LAUNCHES, fg.LAUNCHES)
    res = inverse.run_recovery(num_spheres=2, steps=4, width=16, height=8, views=2,
                               betas=(0.05, 0.02), device="cpu")
    assert (lk.LAUNCHES, fg.LAUNCHES) == before  # CPU: the plain versions
    # Phase steps int(4·w/Σw) for w = (1, 1.6): 1 and 2, as in the JAX package.
    assert res["completed_phases"] == 2 and res["steps"] == 3
    assert res["resolution"] == "16x8" and res["views"] == 2
    assert all(np.isfinite([res["loss_initial"], res["loss_final"], res["err_position"],
                            res["err_radius"], res["err_albedo"]]))
    with pytest.raises(NotImplementedError, match="checkpoint"):
        inverse.run_recovery(ckpt_dir="ckpt", device="cpu")


# ------------------------------------------------------------ default device

# Each entry point, called without `device=`, and one tensor it made.
ENTRY_POINTS = {
    "default_scene": lambda: scene_mod.default_scene().planes,
    "sphere_scene": lambda: scene_mod.sphere_scene(CENTERS, RADII, ALBEDOS).spheres,
    "default_materials": lambda: scene_mod.default_materials().s0,
    "Camera.create": lambda: camera.Camera.create().loc,
    "ndc_grid": lambda: camera.ndc_grid(8, 4),
    "Channel.zeros": lambda: Channel.zeros(4, 8).rgb,
    "init_history": lambda: pipeline.init_history(to_torch_config(CFG)).diffuse.rgb,
    "spline_cameras": lambda: driver.spline_cameras(2).loc,
    "look_at": lambda: inverse.look_at((0.0, 1.0, 0.0), (0.0, 1.0, 5.0)).orient,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Without `device=` an entry point makes its tensors on the card; with
    no card it raises, as torch does, and never falls back to the CPU."""
    assert port.DEFAULT_DEVICE == "cuda"
    if torch.cuda.is_available():
        assert ENTRY_POINTS[name]().device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            ENTRY_POINTS[name]()
