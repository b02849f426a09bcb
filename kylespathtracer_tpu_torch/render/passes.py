"""Diffuse and specular temporal-accumulation passes.

Port of kylespathtracer_tpu/render/passes.py (diffuse.frag, specular.frag):
reproject the previous accumulation onto the current hits (the exact gather
of render/reproject.py), clamp the history by camera velocity, add emission
plus one MIS (or unbiased) estimate, bump the sample count. `Channel`,
`count_floor` and `_temporal_clamp` are shared with the fused frame.

The pass pipeline traces analytically (scene/intersect.py); the
sphere-traced intersector of scene/sdf.py waits for ROADMAP Queue 1 #11.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE
from kylespathtracer_tpu_torch.core import gmath, sampler
from kylespathtracer_tpu_torch.render import mis as mis_mod
from kylespathtracer_tpu_torch.render import reproject as rep_mod
from kylespathtracer_tpu_torch.scene import intersect as isect
from kylespathtracer_tpu_torch.scene import materials as mat_mod


@dataclasses.dataclass(frozen=True)
class Channel:
    """One accumulation buffer (diffuse or specular), SoA for the
    reference's RGBA texel with count+ID packed in alpha (common.glsl:629-635)."""

    rgb: torch.Tensor  # f32[H,W,3]
    cnt: torch.Tensor  # f32[H,W]
    oid: torch.Tensor  # i32[H,W] object ID at accumulation time

    @classmethod
    def zeros(cls, height: int, width: int, device=DEFAULT_DEVICE) -> "Channel":
        return cls(
            rgb=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
            cnt=torch.zeros((height, width), dtype=torch.float32, device=device),
            oid=torch.zeros((height, width), dtype=torch.int32, device=device),
        )

    def to(self, device) -> "Channel":
        return Channel(self.rgb.to(device), self.cnt.to(device), self.oid.to(device))


def channel_from_numpy(tree: dict, device=DEFAULT_DEVICE) -> Channel:
    """The port's `Channel` from a JAX `Channel` given as numpy arrays."""
    t = lambda k, dt: torch.as_tensor(np.array(tree[k], dt), device=device)
    return Channel(rgb=t("rgb", np.float32), cnt=t("cnt", np.float32),
                   oid=t("oid", np.int32))


def count_floor(cnt: torch.Tensor) -> torch.Tensor:
    """floor(count + 1e-4): the reprojected-sample-count floor
    (diffuse.frag:46) with the epsilon that keeps counts reconstructed as
    c·(1-1e-4) by f32 bilinear weights from dropping to c-1."""
    return torch.floor(cnt + 1e-4)


def _temporal_clamp(rep_rgb, rep_cnt, vv, config):
    """Velocity-adaptive history clamp (diffuse.frag:49-51):
    lvv = min(T-1, floor(T·2·sqrt(|vv|))); texels holding more than T-lvv
    samples are rescaled down to exactly T-lvv."""
    T = float(config.temporal)
    lvv = torch.clamp(torch.floor(T * 2.0 * torch.sqrt(vv)), max=T - 1.0)
    limit = T - lvv
    over = rep_cnt > limit
    scale = torch.where(over, limit / torch.clamp(rep_cnt, min=1e-6), 1.0)
    return rep_rgb * scale[..., None], torch.where(over, limit, rep_cnt)


def get_trace(config):
    """The intersector of the passes: analytic. The sphere trace
    (`intersect_mode="march"`) waits for the port of scene/sdf.py."""
    if config.intersect_mode != "analytic":
        raise NotImplementedError(
            f"intersect_mode={config.intersect_mode!r} needs scene/sdf.py, "
            "which waits for ROADMAP Queue 1 #11")
    return lambda scene, ro, rd, excl: isect.intersect(scene, ro, rd, excl)


def _shade_common(scene, config, gb, camera, frame):
    """Shading points hl = cam + rd·depth and the per-pixel seeds."""
    hl = camera.loc + gb.ray_dir * gb.depth[..., None]
    H, W = gb.obj_id.shape
    dev = gb.obj_id.device
    px = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    py = torch.arange(H, dtype=torch.int32, device=dev)[:, None].expand(H, W)
    return hl, sampler.gen_seed(frame, px, py, W, H)


def specular_anchor(scene, hl, rd, curv):
    """The specular reprojection anchor: the hit point hl pushed along the
    ray rd toward the virtual image by the curvature (specular.frag:45-49)."""
    light_dist = gmath.length(hl - scene.light[:3])
    fac = gmath.EPS / torch.sqrt(torch.clamp(curv, min=gmath.EPS))
    return hl + rd * (light_dist * fac)[..., None]


def _history(config, camera, prev_camera, prev: Channel, anchor, ho):
    """The previous accumulation at this frame's anchors: exact gather,
    count floor, velocity clamp; zeros with `no_history`."""
    if config.no_history:
        return (torch.zeros(ho.shape + (3,), dtype=torch.float32, device=ho.device),
                torch.zeros(ho.shape, dtype=torch.float32, device=ho.device))
    vv = gmath.length(camera.loc - prev_camera.loc)
    rgb, cnt = rep_mod.reproject(prev_camera.loc, prev_camera.orient, anchor, ho,
                                 prev.rgb, prev.cnt, prev.oid, config.fov)
    return _temporal_clamp(rgb, count_floor(cnt), vv, config)


def _shaded(scene, ho):
    """Pixels that get an estimate: hits other than the light (the
    reference skips the light; misses carry no normal)."""
    return (ho != scene.light_id) & (ho > 0)


def shade_passes(scene, config, gb, camera, prev_camera, prev_d: Channel,
                 prev_s: Channel, frame) -> tuple[Channel, Channel]:
    """Diffuse + specular accumulation in one pass, the shared work once:
    `mis.dual_mis` (`shade_backend="xla"`) or the shade kernel K4
    (`"pallas"`, ops/shade_kernel.dual_mis, which takes ONE sample per
    pixel on the raw seed, as the JAX kernel does, whatever the smp count).
    Falls back to `diffuse_pass` + `specular_pass` when the per-strategy
    sample counts differ or the unbiased estimators are on."""
    if not config.biased or not mis_mod._equal_smp(config):
        return (diffuse_pass(scene, config, gb, camera, prev_camera, prev_d, frame),
                specular_pass(scene, config, gb, camera, prev_camera, prev_s, frame))

    trace = get_trace(config)
    hl, seed = _shade_common(scene, config, gb, camera, frame)
    ho = gb.obj_id
    rep_rgb_d, rep_cnt_d = _history(config, camera, prev_camera, prev_d, hl, ho)
    rep_rgb_s, rep_cnt_s = _history(config, camera, prev_camera, prev_s,
                                    specular_anchor(scene, hl, gb.ray_dir, gb.curv), ho)

    _, emission, _ = mat_mod.surface(scene.materials, ho, hl)
    if config.shade_backend == "pallas":
        from kylespathtracer_tpu_torch.ops import shade_kernel as sk

        est_d, est_s = sk.dual_mis(scene, gb, camera, seed, config)  # masked already
    else:
        est_d, est_s = mis_mod.dual_mis(scene, trace, gb.ray_dir, hl, gb.normal, ho, seed, config)
        shade = _shaded(scene, ho)[..., None]
        est_d, est_s = torch.where(shade, est_d, 0.0), torch.where(shade, est_s, 0.0)
    return (Channel(rgb=rep_rgb_d + emission + est_d, cnt=rep_cnt_d + 1.0, oid=ho),
            Channel(rgb=rep_rgb_s + emission + est_s, cnt=rep_cnt_s + 1.0, oid=ho))


def diffuse_pass(scene, config, gb, camera, prev_camera, prev: Channel, frame) -> Channel:
    """(reference: diffuse.frag:26-79)"""
    trace = get_trace(config)
    hl, seed = _shade_common(scene, config, gb, camera, frame)
    ho, hn = gb.obj_id, gb.normal
    rep_rgb, rep_cnt = _history(config, camera, prev_camera, prev, hl, ho)
    _, emission, _ = mat_mod.surface(scene.materials, ho, hl)
    if config.biased:
        est = mis_mod.dmis(scene, trace, hl, hn, ho, seed, config)
    else:
        est = mis_mod.unbiased_lambertian(scene, trace, hl, hn, ho, seed, config)
    rgb = rep_rgb + emission + torch.where(_shaded(scene, ho)[..., None], est, 0.0)
    return Channel(rgb=rgb, cnt=rep_cnt + 1.0, oid=ho)


def specular_pass(scene, config, gb, camera, prev_camera, prev: Channel, frame) -> Channel:
    """(reference: specular.frag:26-83)"""
    trace = get_trace(config)
    hl, seed = _shade_common(scene, config, gb, camera, frame)
    ho, hn, rd = gb.obj_id, gb.normal, gb.ray_dir
    rep_rgb, rep_cnt = _history(config, camera, prev_camera, prev,
                                specular_anchor(scene, hl, gb.ray_dir, gb.curv), ho)
    _, emission, _ = mat_mod.surface(scene.materials, ho, hl)
    if config.biased:
        est = mis_mod.smis(scene, trace, rd, hl, hn, ho, seed, config)
    else:
        est = mis_mod.unbiased_phong(scene, trace, rd, hl, hn, ho, seed, config)
    rgb = rep_rgb + emission + torch.where(_shaded(scene, ho)[..., None], est, 0.0)
    return Channel(rgb=rgb, cnt=rep_cnt + 1.0, oid=ho)
