"""Signed-distance evaluation and sphere tracing.

Port of kylespathtracer_tpu/scene/sdf.py (reference: common.glsl:199-295):
the scene's distance field over every primitive at once, the 4+1-tap
tetrahedron normal and curvature, and the 255-step sphere trace as a
lockstep loop with a per-ray done mask.

Gradients: the march is not differentiated step by step. `march` is a
`torch.autograd.Function` whose backward is the implicit-function theorem
(`ift_backward`): at a hit f(o + t d, θ) = 0 defines t(o, d, θ), so

    ∂t/∂θ = -(∂f/∂θ) / (∇f·d),   ∂t/∂o = -∇f / (∇f·d),   ∂t/∂d = t ∂t/∂o

one extra sdf gradient at the hit point. The analytic intersector
(scene/intersect.py) shares the same backward.

The distance reductions keep JAX's gradients at ties: `torch.amin`,
`torch.maximum` and `torch.minimum` split the cotangent evenly among equal
operands, as `jnp.min`, `jnp.maximum` and `jnp.minimum` do (`torch.min(dim)`
would send all of it to one operand, and `torch.clamp` passes it whole at
equality).
"""

from __future__ import annotations

import dataclasses

import torch

from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.scene.types import Scene

_BIG = 1e9

# The march looks at its rays every CHECK_EVERY steps: it stops once every
# ray is done and otherwise carries on with the rays still live. A done ray
# is frozen, so t and the object ID do not depend on it; each look costs one
# host sync. Timed at 1, 4, 8, 16 and 32 on the 1080p G-buffer on an H100,
# over two runs of two views in two turns, 8 had the least median (145 ms a G-buffer; 16: 155, 4: 159, 32: 172, 1: 204), though
# 4-32 lie within the runs' noise.
CHECK_EVERY = 8
# Steps taken (summed over the rays' compacted batches, one per loop
# iteration) and host syncs made by `march` in this process.
STEPS = 0
SYNCS = 0


def _zero(x: torch.Tensor) -> torch.Tensor:
    return x.new_zeros(())


def _length(v: torch.Tensor) -> torch.Tensor:
    """`gmath.length`, sqrt(sum(v²)), with the root correctly rounded on the
    CPU too: torch's vectorised f32 sqrt there is an ulp off on ~0.5% of
    inputs (the card's and XLA's are correctly rounded), and the march sums
    hundreds of these distances. The f64 root rounded to f32 is exact."""
    s = (v * v).sum(-1)
    if s.device.type == "cpu" and s.dtype == torch.float32:
        return torch.sqrt(s.double()).float()
    return torch.sqrt(s)


def sd_box(p: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """Axis-aligned box signed distance (reference: common.glsl:215-218)."""
    d = p.abs() - half
    zero = _zero(d)
    outside = _length(torch.maximum(d, zero))
    inside = torch.minimum(torch.maximum(d[..., 0], torch.maximum(d[..., 1], d[..., 2])), zero)
    return inside + outside


def smin(a: torch.Tensor, b: torch.Tensor, k) -> torch.Tensor:
    """Polynomial smooth minimum (reference: common.glsl:206-209)."""
    h = torch.maximum(k - (a - b).abs(), _zero(a)) / k
    return torch.minimum(a, b) - h * h * k * 0.25


def smax(a: torch.Tensor, b: torch.Tensor, k) -> torch.Tensor:
    """Smooth maximum via smin (reference: common.glsl:211-213)."""
    return -smin(-a, -b, k)


def primitive_distances(scene: Scene, p: torch.Tensor) -> torch.Tensor:
    """Distances to every primitive; shape (..., 1+P+S+B). Slot 0 is the
    zfar "miss" sentinel with ID 0 (common.glsl:265); then planes, spheres
    and boxes in the reference's sdMin order."""
    parts = [torch.full(p.shape[:-1] + (1,), gmath.ZFAR, dtype=p.dtype, device=p.device)]
    if scene.planes.shape[0]:
        # dot(p, n) + d (common.glsl:266-269), as a mul+sum like the JAX code.
        parts.append((p[..., None, :] * scene.planes[:, :3]).sum(-1) + scene.planes[:, 3])
    if scene.spheres.shape[0]:
        # |p - c| - r (common.glsl:270).
        parts.append(_length(p[..., None, :] - scene.spheres[:, :3]) - scene.spheres[:, 3])
    if scene.boxes.shape[0]:
        # Rounded box: sdBox(p - c, half) - round (common.glsl:271).
        diff = p[..., None, :] - scene.boxes[:, :3]
        parts.append(sd_box(diff, scene.boxes[:, 3:6]) - scene.boxes[:, 6])
    return torch.cat(parts, dim=-1)


def primitive_ids(scene: Scene) -> torch.Tensor:
    """Object ID per distance slot; i32[1+P+S+B]."""
    zero = torch.zeros((1,), dtype=torch.int32, device=scene.plane_ids.device)
    return torch.cat([zero, scene.plane_ids, scene.sphere_ids, scene.box_ids])


def _exclude(exclude, p: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(exclude, dtype=torch.int32, device=p.device)


def sdf(scene: Scene, p: torch.Tensor, exclude=-1) -> tuple[torch.Tensor, torch.Tensor]:
    """Scene distance with self-exclusion → (distance, object_id).

    exclude: an ID, or an i32[...] of them, removed from consideration
    (common.glsl:264-273); -1 excludes nothing. The reference's sdMin chain
    `take = d_i <= d` over the slots in order makes the *later* primitive
    win a tie (common.glsl:199-203), and the zfar sentinel (slot 0) is
    never excluded. The chain's result is the minimum over the slots left,
    with the ID of the last slot that attains it, which is computed here in
    one pass over the slots."""
    dists = primitive_distances(scene, p)
    ids = primitive_ids(scene)
    excl = _exclude(exclude, p)[..., None]
    off = (ids == excl) & (torch.arange(ids.shape[0], device=p.device) > 0)
    dists = torch.where(off, _BIG, dists)
    d = torch.amin(dists, dim=-1)
    # The last slot equal to the minimum: first match in the reversed order.
    last = ids.shape[0] - 1 - torch.argmax((dists == d[..., None]).flip(-1).to(torch.uint8), dim=-1)
    return d, ids[last]


def sdf_dist(scene: Scene, p: torch.Tensor, exclude=-1) -> torch.Tensor:
    """Distance only, as the JAX `sdf_dist`: every slot whose ID equals
    `exclude` is masked (the sentinel too when `exclude` is 0), then the
    differentiable `amin`."""
    dists = primitive_distances(scene, p)
    ids = primitive_ids(scene)
    dists = torch.where(ids == _exclude(exclude, p)[..., None], _BIG, dists)
    return torch.amin(dists, dim=-1)


def norcurv(scene: Scene, p: torch.Tensor, ep: float = gmath.EPS
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """4-point tetrahedron normal + curvature (reference: common.glsl:276-281)
    → (normal[...,3], curvature[...]); no exclusion."""
    e = torch.tensor([[ep, -ep, -ep], [-ep, -ep, ep], [-ep, ep, -ep], [ep, ep, ep]],
                     dtype=p.dtype, device=p.device)
    t = torch.stack([sdf_dist(scene, p + e[i]) for i in range(4)], dim=-1)
    n = gmath.normalize((t[..., None] * e).sum(-2))
    c = 0.25 / ep * (t.sum(-1) - 4.0 * sdf_dist(scene, p))
    return n, c


def _march_fwd_loop(scene: Scene, ro: torch.Tensor, rd: torch.Tensor, excl: torch.Tensor,
                    steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference-faithful sphere trace (common.glsl:283-295): step by the
    scene distance, stop below eps (a hit) or beyond zfar (a miss → t=zfar,
    ID 0). All live rays step in lockstep with a done mask; every
    CHECK_EVERY steps the loop stops if every ray is done, and otherwise
    goes on with the rays not yet done."""
    global STEPS, SYNCS
    batch = ro.shape[:-1]
    n = batch.numel()
    dev = ro.device
    t = torch.zeros(n, dtype=ro.dtype, device=dev)
    hid = torch.zeros(n, dtype=torch.int32, device=dev)
    missed = torch.zeros(n, dtype=torch.bool, device=dev)
    live = torch.arange(n, device=dev)
    ro_l, rd_l, ex_l = ro.reshape(n, 3), rd.reshape(n, 3), excl.reshape(n)
    t_l, hid_l, miss_l = t, hid, missed
    done_l = torch.zeros(n, dtype=torch.bool, device=dev)
    i = 0
    while i < steps and live.numel():
        for _ in range(min(CHECK_EVERY, steps - i)):
            d, oid = sdf(scene, ro_l + rd_l * t_l[:, None], ex_l)
            hit_now = d < gmath.EPS
            t_new = torch.where(done_l, t_l, t_l + d)
            # A hit takes precedence over crossing zfar (common.glsl:289-292);
            # a ray records the ID of its last sample, 0 on a miss.
            miss_now = (t_new > gmath.ZFAR) & ~hit_now
            hid_l = torch.where(done_l, hid_l, torch.where(miss_now, 0, oid))
            miss_l = torch.where(done_l, miss_l, miss_now)
            done_l = done_l | hit_now | miss_now
            t_l = t_new
            i += 1
            STEPS += 1
        t[live], hid[live], missed[live] = t_l, hid_l, miss_l
        keep = torch.nonzero(~done_l).squeeze(1)
        SYNCS += 1
        live, ro_l, rd_l, ex_l = live[keep], ro_l[keep], rd_l[keep], ex_l[keep]
        t_l, hid_l, miss_l = t_l[keep], hid_l[keep], miss_l[keep]
        done_l = torch.zeros_like(miss_l)
    t = torch.where(missed, gmath.ZFAR, torch.clamp(t, max=gmath.ZFAR))
    return t.reshape(batch), hid.reshape(batch)


def ift_backward(scene: Scene, ro, rd, excl, t, hid, g_t, needs=(True,) * 5):
    """The implicit-function-theorem backward of any intersector whose
    result satisfies sdf(ro + t·rd, θ) ≈ 0 at its hits (the march and the
    analytic intersect) → the gradients of (planes, spheres, boxes, ro, rd),
    None where `needs` (a flag per input) is false. `g_t` is the cotangent
    of t; the object ID has none.

    ∇f·d at the hit point is one gradient of `sdf_dist` in p; it is negative
    at genuine hits (rays arrive from outside) and kept at least 1e-4 away
    from 0. Then dL/dx = Σ_rays scale_r · ∂f_r/∂x for x in (tables, ro, rd)
    with t held constant: one weighted `sdf_dist` gradient replaces
    differentiating the march's steps."""
    tables = (scene.planes, scene.spheres, scene.boxes)
    fixed = dataclasses.replace(scene, **dict(zip(("planes", "spheres", "boxes"), (x.detach() for x in tables))))
    ro, rd, t = ro.detach(), rd.detach(), t.detach()
    with torch.enable_grad():
        p = (ro + rd * t[..., None]).requires_grad_()
        (gp,) = torch.autograd.grad(sdf_dist(fixed, p, excl).sum(), p)
    denom = (gp * rd).sum(-1)
    denom = torch.where(denom < 0, torch.clamp(denom, max=-1e-4), torch.clamp(denom, min=1e-4))
    scale = torch.where(hid > 0, -g_t / denom, 0.0)

    leaves = [x.detach().requires_grad_(bool(need)) for x, need in zip(tables + (ro, rd), needs)]
    sc = dataclasses.replace(scene, planes=leaves[0], spheres=leaves[1], boxes=leaves[2])
    wanted = [x for x in leaves if x.requires_grad]
    if not wanted:
        return (None,) * 5
    with torch.enable_grad():
        d = sdf_dist(sc, leaves[3] + leaves[4] * t[..., None], excl)
        got = iter(torch.autograd.grad((d * scale).sum(), wanted, allow_unused=True))
    return tuple(next(got) if x.requires_grad else None for x in leaves)


class IntersectFunction(torch.autograd.Function):
    """An intersector `fwd(scene, ro, rd, excl) → (t, object_id)` made
    differentiable in the scene's planes, spheres and boxes, ro and rd by
    `ift_backward`. The Scene is rebuilt around the table tensors given,
    which autograd sees; `excl` (i32, broadcast to the rays) and `fwd` are
    not differentiated."""

    @staticmethod
    def forward(ctx, fwd, scene, excl, planes, spheres, boxes, ro, rd):
        scene = dataclasses.replace(scene, planes=planes, spheres=spheres, boxes=boxes)
        t, hid = fwd(scene, ro, rd, excl)
        ctx.scene = dataclasses.replace(scene, planes=None, spheres=None, boxes=None)
        ctx.save_for_backward(planes, spheres, boxes, ro, rd, excl, t, hid)
        ctx.mark_non_differentiable(hid)
        return t, hid

    @staticmethod
    def backward(ctx, g_t, _g_hid):
        planes, spheres, boxes, ro, rd, excl, t, hid = ctx.saved_tensors
        scene = dataclasses.replace(ctx.scene, planes=planes, spheres=spheres, boxes=boxes)
        grads = ift_backward(scene, ro, rd, excl, t, hid, g_t, ctx.needs_input_grad[3:])
        return (None, None, None, *grads)


def apply_intersector(fwd, scene: Scene, ro, rd, exclude=-1):
    """`fwd` through `IntersectFunction`, with `exclude` broadcast to the
    rays."""
    excl = torch.as_tensor(exclude, dtype=torch.int32, device=ro.device).expand(ro.shape[:-1])
    return IntersectFunction.apply(fwd, scene, excl, scene.planes, scene.spheres, scene.boxes, ro, rd)


def march(scene: Scene, ro: torch.Tensor, rd: torch.Tensor, exclude=-1, steps: int = 255
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sphere-trace the scene → (t[...], object_id[...]) for rays ro, rd
    f32[..., 3]; `exclude` an ID or an i32[...] of them; at most `steps`
    steps. Differentiable in the scene's planes, spheres and boxes, ro and
    rd through `ift_backward`."""
    fwd = lambda sc, o, d, ex: _march_fwd_loop(sc, o, d, ex, int(steps))
    return apply_intersector(fwd, scene, ro, rd, exclude)
