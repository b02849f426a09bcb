"""Inverse rendering: gradient descent on scene parameters.

Port of kylespathtracer_tpu/diff/inverse.py. Pixel gradients flow through
the composite, the dual-MIS shading and the analytic intersection to
sphere positions, radii and albedos; Adam recovers a scene from target
images. On the fused pipeline each step is one fused loss-and-gradient
kernel per view (ops/loss_kernel.py, K6); `loss_fn` is the same loss
through the differentiable frame (K1 forward, K5 backward) and autograd.

The optimizer is `torch.optim.Adam` with a cosine-decay `LambdaLR` and a
global-norm clip, written to equal the optax chain of the JAX package
(`ClippedAdam`). Checkpoint and resume are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE
from kylespathtracer_tpu_torch.ops import loss_kernel as lk
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.render.pipeline import init_history, render_frame
from kylespathtracer_tpu_torch.scene.types import Scene
from kylespathtracer_tpu_torch.utils.config import RenderConfig

Params = dict[str, torch.Tensor]

# Frame index where target-realization seeds start (seed-paired fitting,
# see `fit`): far from the 0..steps frames ordinary fitting consumes.
SEED_BASE = 1000


def extract_params(scene: Scene, keys=("spheres", "alb_const")) -> Params:
    """Pull the trainable tensors out of a scene."""
    out: Params = {}
    if "spheres" in keys:
        out["spheres"] = scene.spheres
    if "planes" in keys:
        out["planes"] = scene.planes
    if "alb_const" in keys:
        out["alb_const"] = scene.materials.alb_const
    if "light_color" in keys:
        out["light_color"] = scene.light_color
    return out


def apply_params(scene: Scene, params: Params) -> Scene:
    mats = scene.materials
    if "alb_const" in params:
        mats = dataclasses.replace(mats, alb_const=params["alb_const"])
    kw = {"materials": mats}
    for k in ("spheres", "planes", "light_color"):
        if k in params:
            kw[k] = params[k]
    return dataclasses.replace(scene, **kw)


def render_once(scene: Scene, camera: Camera, config, frame) -> torch.Tensor:
    """Single-frame render (fresh history), the differentiable forward. Uses
    the `no_history` frame: reprojecting an all-zero history is waste, and
    the image is the same."""
    config = dataclasses.replace(config, no_history=True)
    image, _ = render_frame(scene, camera, init_history(config, camera), frame, config)
    return image


def loss_fn(params: Params, scene: Scene, camera: Camera, target: torch.Tensor,
            frame, config) -> torch.Tensor:
    """MSE in tonemapped sRGB space against the target image.

    Multi-view: a 4-D target [V,H,W,3] with a stacked camera (leading [V])
    averages the per-view MSE; a few baselines remove the single-view
    ambiguities (sphere z against radius)."""
    sc = apply_params(scene, params)
    if target.ndim == 4:
        losses = [
            torch.mean((render_once(sc, camera[v], config, frame) - target[v]) ** 2)
            for v in range(int(target.shape[0]))
        ]
        return torch.mean(torch.stack(losses))
    return torch.mean((render_once(sc, camera, config, frame) - target) ** 2)


def stack_cameras(cams: list[Camera]) -> Camera:
    """List of cameras → one stacked camera (leading axis)."""
    return Camera(loc=torch.stack([c.loc for c in cams]),
                  orient=torch.stack([c.orient for c in cams]))


def look_at(loc, at, device=DEFAULT_DEVICE) -> Camera:
    """Camera at `loc` facing the point `at` (forward = rotate_xy(+z)):
    pitch = asin(d.y), yaw = atan2(d.x, d.z)."""
    d = np.asarray(at, np.float32) - np.asarray(loc, np.float32)
    d = d / max(float(np.linalg.norm(d)), 1e-8)
    return Camera.create(
        loc=loc, orient=(float(np.arcsin(d[1])), float(np.arctan2(d[0], d[2]))),
        device=device,
    )


# ------------------------------------------------------------ optimizer

def cosine_decay(count: int, decay_steps: int, alpha: float) -> float:
    """optax.cosine_decay_schedule's factor at `count` (exponent 1)."""
    count = min(count, decay_steps)
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps)) + alpha


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """optax.clip_by_global_norm: scale every gradient by max_norm/‖g‖ when
    the global norm ‖g‖ (over the keys in sorted order) is not below
    max_norm. Unlike torch's clip_grad_norm_, no epsilon joins the norm."""
    norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in sorted(grads)))
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm) * max_norm) for k, g in grads.items()}


@dataclasses.dataclass
class AdamState:
    """The optimizer's parameters (updated in place) and its torch state."""

    params: Params
    adam: torch.optim.Adam
    schedule: torch.optim.lr_scheduler.LambdaLR


@dataclasses.dataclass(frozen=True)
class ClippedAdam:
    """optax.chain(clip_by_global_norm(clip), adam(cosine_decay_schedule(
    lr, decay_steps, alpha))) in torch, or the plain cosine-decayed Adam
    with clip=None. `init` and `update` follow optax's shape."""

    lr: float
    decay_steps: int
    alpha: float
    clip: float | None = None

    def init(self, params: Params) -> AdamState:
        own = {k: v.detach().clone() for k, v in params.items()}
        # differentiable=True takes Adam's tensor path, which computes the
        # bias corrections 1-β^t in float32 as optax does; the float64
        # corrections of the default path differ from optax's by ~1e-5 of
        # the update in the first steps.
        adam = torch.optim.Adam(list(own.values()), lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                differentiable=True)
        schedule = torch.optim.lr_scheduler.LambdaLR(
            adam, lambda count: cosine_decay(count, self.decay_steps, self.alpha))
        return AdamState(own, adam, schedule)

    def update(self, grads: Params, state: AdamState, params: Params) -> Params:
        """One step from `params` along `grads` → the new parameters
        (state.params, updated in place)."""
        with torch.no_grad():
            for k, p in state.params.items():
                if params[k] is not p:
                    p.copy_(params[k])
            if self.clip is not None:
                grads = clip_by_global_norm(grads, self.clip)
            for k, p in state.params.items():
                p.grad = grads[k].detach().to(p.dtype)
            state.adam.step()
            state.schedule.step()
            for p in state.params.values():
                p.grad = None
        return state.params


# ------------------------------------------------------------- fitting

def value_and_grad(params: Params, scene0: Scene, camera: Camera, target: torch.Tensor,
                   frame, config) -> tuple[torch.Tensor, Params]:
    """The step's loss and its gradient in `params`. With the fused pipeline
    each view is one fused loss-and-gradient kernel (ops/loss_kernel.py)
    and the per-view losses and gradients are averaged, which is `loss_fn`
    and its gradient; otherwise autograd through `loss_fn`."""
    if config.pipeline != "fused":
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = loss_fn(p, scene0, camera, target, frame, config)
        return loss.detach(), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    sc = apply_params(scene0, params)
    views = [(camera, target)] if target.ndim == 3 else [
        (camera[v], target[v]) for v in range(int(target.shape[0]))]
    losses, grads = [], []
    for cam_v, tgt_v in views:
        lval, (d_scene, _) = lk.loss_and_grad(sc, cam_v, frame, config, target=tgt_v,
                                              keys=tuple(params))
        losses.append(lval)
        grads.append({k: d_scene[k] for k in params})
    loss = torch.mean(torch.stack(losses))
    return loss, {k: torch.mean(torch.stack([g[k] for g in grads]), dim=0) for k in params}


def fit(
    scene0: Scene,
    target: torch.Tensor,
    camera: Camera,
    config,
    keys=("spheres", "alb_const"),
    steps: int = 200,
    lr: float = 2e-2,
    vary_seed: bool = True,
    opt: ClippedAdam | None = None,
    opt_state: AdamState | None = None,
    return_state: bool = False,
):
    """Adam-descend scene params to match `target` → (scene, losses).

    Pass `opt`/`opt_state` to continue an optimizer across calls (the β
    continuation in run_recovery): resetting Adam's moments each phase lets
    the first steps after a reset random-walk weakly constrained parameters.

    Seed-paired matching: a 5-D target [V, S, H, W, 3] holds S target
    realizations per view, rendered at frames SEED_BASE..SEED_BASE+S-1.
    Step i renders with frame SEED_BASE + (i mod S) and matches the
    realization of the same seed, so the residual is exactly zero at the
    true parameters for every seed; a fixed target with varying seeds would
    add the variance of the render to the loss, and its gradient."""
    params = extract_params(scene0, keys)
    if opt is None:
        # Cosine-decayed Adam: large early steps to cross plateaus, small
        # late steps so the Monte Carlo gradient noise averages out.
        opt = ClippedAdam(lr, max(steps, 1), 0.05)
    if opt_state is None:
        opt_state = opt.init(params)
    paired = target.ndim == 5
    n_seeds = int(target.shape[1]) if paired else 0

    losses = []
    for i in range(steps):
        if paired:
            s = i % n_seeds
            frame, tgt = SEED_BASE + s, target[:, s]
        else:
            frame, tgt = (i if vary_seed else 0), target
        loss, grads = value_and_grad(params, scene0, camera, tgt, frame, config)
        params = opt.update(grads, opt_state, params)
        losses.append(loss)
    losses = torch.stack(losses).tolist() if losses else []
    fitted = apply_params(scene0, {k: v.detach().clone() for k, v in params.items()})
    if return_state:
        return fitted, losses, opt_state
    return fitted, losses


def _param_errors(scene_gt: Scene, fitted: Scene) -> dict:
    gt_p = extract_params(scene_gt)
    fit_p = extract_params(fitted)
    # Ignore the light row (index 0) when scoring sphere recovery.
    return {
        "err_position": float(
            (fit_p["spheres"][1:, :3] - gt_p["spheres"][1:, :3]).abs().mean()),
        "err_radius": float(
            (fit_p["spheres"][1:, 3] - gt_p["spheres"][1:, 3]).abs().mean()),
        "err_albedo": float(
            (fit_p["alb_const"] - gt_p["alb_const"]).abs().mean()),
    }


def recovery_scenes(num_spheres: int = 10, views: int = 3, seed: int = 0, perturb: float = 0.35,
                    device=DEFAULT_DEVICE) -> tuple[Scene, Scene, Camera]:
    """`run_recovery`'s problem → (ground-truth scene, perturbed start,
    stacked cameras [views])."""
    from kylespathtracer_tpu_torch.scene.scene import sphere_scene

    rng = np.random.default_rng(seed)
    centers = np.stack(
        [
            rng.uniform(-4.0, 4.0, num_spheres),
            rng.uniform(0.6, 3.0, num_spheres),
            rng.uniform(4.0, 10.0, num_spheres),
        ],
        axis=-1,
    )
    radii = rng.uniform(0.4, 0.9, num_spheres)
    albedos = rng.uniform(0.2, 0.9, (num_spheres, 3))
    scene_gt = sphere_scene(centers, radii, albedos, device=device)

    # Cameras on an arc around the sphere cloud's center, alternating two
    # heights for vertical parallax (position-z against radius).
    mid = centers.mean(axis=0)
    cameras = stack_cameras([
        look_at(
            (
                float(mid[0]) + 9.0 * np.sin(a),
                2.5 if i % 2 == 0 else 4.5,
                float(mid[2]) - 9.0 * np.cos(a),
            ),
            (float(mid[0]), float(mid[1]), float(mid[2])),
            device=device,
        )
        for i, a in enumerate(np.linspace(-0.7, 0.7, views))
    ])

    # Perturbed start: geometry jittered, albedos reset to gray.
    scene_i = sphere_scene(
        centers + rng.normal(0, perturb, centers.shape),
        np.clip(radii + rng.normal(0, perturb * 0.3, radii.shape), 0.2, 1.2),
        np.full_like(albedos, 0.5),
        device=device,
    )
    return scene_gt, scene_i, cameras


def run_recovery(
    num_spheres: int = 10,
    steps: int = 400,
    width: int = 192,
    height: int = 128,
    lr: float = 2e-2,
    seed: int = 0,
    log_every: int = 0,
    perturb: float = 0.35,
    betas: tuple = (0.05, 0.02, 0.008, 0.003),
    views: int = 3,
    ckpt_dir: str | None = None,
    resume: bool = False,
    max_phases: int | None = None,
    device=DEFAULT_DEVICE,
):
    """Recover an N-sphere scene's positions, radii and albedos from
    rendered targets, starting from a perturbed copy (the JAX package's
    north-star demo), on `device`, always through the fused pipeline.

    * β continuation: the soft-shadow smoothing is annealed over phases;
      wide β crosses silhouette plateaus, small β approaches the hard
      render, and each phase's targets are rendered at its β, so every
      phase's optimum is the ground-truth scene.
    * Multi-view targets: `views` cameras on an arc remove the single-view
      depth/radius ambiguity.
    * Per-phase error traces in the returned dict.

    `max_phases` stops after that many phases. `ckpt_dir`/`resume` are not
    ported yet and raise."""
    if ckpt_dir is not None or resume:
        raise NotImplementedError(
            "run_recovery: checkpoint/resume is not ported yet (ROADMAP Queue 1 #9)")
    scene_gt, scene_i, cameras = recovery_scenes(num_spheres, views, seed, perturb, device)

    # Weight steps toward the sharp-β phases: the wide-β phases only need to
    # cross silhouette plateaus; the precision comes late.
    w = np.linspace(1.0, 1.6, len(betas))
    phase_steps_all = [max(1, int(steps * wi / w.sum())) for wi in w]
    total_steps = sum(phase_steps_all)

    # One optimizer across all phases: per-phase restarts let the first
    # steps random-walk weakly constrained parameters (albedo). The clip
    # tames the sigmoid silhouette gradient spikes at small β.
    opt = ClippedAdam(lr, max(total_steps, 1), 0.03, clip=1.0)
    opt_state = None
    all_losses: list[float] = []
    trace = []
    # Seed-paired target realizations [V, S, H, W, 3] (see `fit`).
    n_seeds = 16

    for phase, beta in enumerate(betas):
        if max_phases is not None and phase >= max_phases:
            break
        config = RenderConfig(width=width, height=height, soft_shadows=float(beta),
                              pipeline="fused")
        with torch.no_grad():
            target = torch.stack([
                torch.stack([render_once(scene_gt, cameras[v], config, SEED_BASE + k)
                             for k in range(n_seeds)])
                for v in range(views)
            ])
        scene_i, losses, opt_state = fit(
            scene_i, target, cameras, config, steps=phase_steps_all[phase],
            opt=opt, opt_state=opt_state, return_state=True,
        )
        all_losses.extend(losses)
        errs = _param_errors(scene_gt, scene_i)
        trace.append({"beta": float(beta), "loss": losses[-1], **errs})
        if log_every:
            print(f"phase {phase} (beta={beta}): loss {losses[-1]:.3e} {errs}")

    return {
        "loss_initial": all_losses[0],
        "loss_final": all_losses[-1],
        **_param_errors(scene_gt, scene_i),
        "phases": trace,
        "completed_phases": len(trace),
        "views": views,
        "resolution": f"{width}x{height}",
        "steps": sum(phase_steps_all),
    }


def train_step(params: Params, opt_state: AdamState, opt: ClippedAdam, scene: Scene,
               camera: Camera, target: torch.Tensor, frame, config):
    """One optimization step through autograd of `loss_fn` (the generic
    differentiable frame: K1 forward, K5 backward) → (params, opt_state,
    loss)."""
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(p, scene, camera, target, frame, config)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    params = opt.update(grads, opt_state, params)
    return params, opt_state, loss.detach()
