"""The differentiable fused frame: K1 forward, K5 backward.

Port of kylespathtracer_tpu/ops/frame_grad.py. `frame_forward` returns
the frame dict of `frame_kernel.frame_forward` through `FrameForward`, a
`torch.autograd.Function` whose forward is the frame kernel (K1) and whose
backward recomputes the frame and applies its vector-Jacobian product to
the incoming cotangent planes: `frame_backward`, which launches
csrc/frame_grad.cu (K5, one reverse-mode adjoint pass over the pixels) on
CUDA tensors and runs `frame_backward_plain` (autograd through
`frame_kernel.frame_forward_plain`) on CPU tensors. No activation is saved
between the two: the residuals are the scene, the camera and the frame
index.

Gradient semantics are those of the tensor code: analytic-intersection
derivatives, hard visibility tests contribute zero, and
`config.soft_shadows > 0` smooths the direct light's sphere occlusion.
Only the tables that need a gradient are computed, and only the output
planes that received a cotangent are read.

Row mode (`row_base`/`rows`, the sharded trainer's, parallel/shard.py):
the frame covers image rows [row_base, row_base+rows) with the full
image's NDC and seeds, the cotangent planes are [rows, W], and the
gradient is the tile's partial sum, which the trainer sums over the ranks.
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.scene.types import Scene

# Launches of the CUDA kernel by `frame_backward` in this process, and the
# row-mode launches among them.
LAUNCHES = 0
ROW_LAUNCHES = 0

# Indices into the 20 small operands (frame_kernel.small_operands order)
# that receive gradients: planes, spheres, boxes, light_color, light,
# mat_s0, mat_s1, alb_const, alb_scale, emission, en_const, en_scale, cam,
# orient. (ids, freq and frame are integer or piecewise constant.)
DIFF_IDX = (0, 2, 4, 6, 7, 9, 10, 12, 13, 14, 15, 16, 17, 18)
DIFF_NAMES = ("planes", "spheres", "boxes", "light_color", "light", "s0", "s1",
              "alb_const", "alb_scale", "emission", "en_const", "en_scale", "loc", "orient")
# The f32 tables of frame_kernel.pack_tables, in its order, by small
# operand index (11 is mat_freq, which has no gradient).
_PACK_IDX = (0, 2, 4, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18)

# The differentiable scene and camera tensors, by the names
# `assemble_grads` gives their gradients, and the DIFF_IDX positions each
# feeds (spheres also feeds `light`, spheres[light_index]).
GRAD_NAMES = ("planes", "spheres", "boxes", "light_color", "s0", "s1",
              "alb_const", "alb_scale", "emission", "en_const", "en_scale",
              "loc", "orient")
_NAME_POS = {"planes": (0,), "spheres": (1, 4), "boxes": (2,),
             "light_color": (3,), "s0": (5,), "s1": (6,), "alb_const": (7,),
             "alb_scale": (8,), "emission": (9,), "en_const": (10,),
             "en_scale": (11,), "loc": (12,), "orient": (13,)}

# The frame dict's keys in output order; the first six are differentiable.
OUT_KEYS = ("add_d", "add_s", "alb", "ene", "depth", "curv", "oid")


def needs_for(names) -> tuple:
    """The 14 DIFF_IDX flags that give the gradients of the named tensors
    (GRAD_NAMES); None names them all."""
    names = GRAD_NAMES if names is None else tuple(names)
    unknown = set(names) - set(GRAD_NAMES)
    if unknown:
        raise ValueError(f"no gradient for {sorted(unknown)}; known: {GRAD_NAMES}")
    pos = {p for n in names for p in _NAME_POS[n]}
    return tuple(i in pos for i in range(len(DIFF_IDX)))


def _table_shapes(scene: Scene) -> dict:
    """(rows, cols) of each f32 table in pack_tables, by small operand index."""
    P, S, B = fk._counts(scene)
    K = int(scene.materials.s0.shape[0])
    return {0: (P, 4), 2: (S, 4), 4: (B, 7), 6: (1, 3), 7: (1, 4), 9: (K, 1),
            10: (K, 1), 11: (K, 1), 12: (K, 3), 13: (K, 3), 14: (K, 3),
            15: (K, 2), 16: (K, 2), 17: (1, 3), 18: (1, 2)}


def _layout(scene: Scene) -> list:
    """(offset, rows, cols) of each DIFF_IDX table in the flat f32 table."""
    shapes = _table_shapes(scene)
    offsets, off = {}, 0
    for k in _PACK_IDX:
        offsets[k] = off
        off += shapes[k][0] * shapes[k][1]
    return [(offsets[k], *shapes[k]) for k in DIFF_IDX]


def seed_indices(scene: Scene, needs, device) -> torch.Tensor:
    """The flat-table entries whose gradients `needs` asks for, in order:
    the entries the gradient kernels write out (int32, on `device`)."""
    parts = [torch.arange(off, off + rows * cols, dtype=torch.int32, device=device)
             for (off, rows, cols), need in zip(_layout(scene), needs) if need]
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=device)
    return torch.cat(parts)


def unpack_grads(scene: Scene, needs, flat: torch.Tensor) -> tuple:
    """Per-seed gradients (seed_indices order) → DIFF_IDX-ordered tables in
    the small-operand shapes (zero-row geometry tables padded to one zero
    row), None where not needed."""
    out, pos = [], 0
    for (_, rows, cols), need in zip(_layout(scene), needs):
        if not need:
            out.append(None)
            continue
        g = flat[pos:pos + rows * cols].reshape(rows, cols)
        pos += rows * cols
        out.append(g if rows else torch.zeros((1, cols), dtype=flat.dtype, device=flat.device))
    return tuple(out)


def assemble_grads(scene: Scene, camera, grads, light_index: int):
    """DIFF_IDX-ordered gradient tables → (d_scene, d_camera): dicts of
    gradients in the scene's and camera's shapes, keyed by GRAD_NAMES
    (None where not computed). Crops the dummy rows of zero-row tables and
    folds the gradient of `light` into spheres[light_index]. Shared by
    `FrameForward`'s backward and the fused loss kernel (loss_kernel.py)."""
    (d_planes, d_spheres, d_boxes, d_lc, d_light, d_s0, d_s1,
     d_ac, d_as, d_em, d_ec, d_es, d_cam, d_or) = grads

    def crop(g, n):
        return None if g is None else g[:n]

    def flat(g, shape):
        return None if g is None else g.reshape(shape)

    d_spheres = crop(d_spheres, scene.spheres.shape[0])
    if d_light is not None:
        d_spheres = (torch.zeros_like(scene.spheres) if d_spheres is None
                     else d_spheres.clone())
        d_spheres[light_index] += d_light.reshape(4)
    d_scene = {
        "planes": crop(d_planes, scene.planes.shape[0]),
        "spheres": d_spheres,
        "boxes": crop(d_boxes, scene.boxes.shape[0]),
        "light_color": flat(d_lc, (3,)),
        "s0": flat(d_s0, (-1,)), "s1": flat(d_s1, (-1,)),
        "alb_const": d_ac, "alb_scale": d_as, "emission": d_em,
        "en_const": d_ec, "en_scale": d_es,
    }
    d_camera = {"loc": flat(d_cam, (3,)), "orient": flat(d_or, (2,))}
    return d_scene, d_camera


def _present_planes(g: dict):
    """The 13 float output planes' cotangents in output order (None where
    the caller's loss never touched the plane)."""
    planes = []
    for key, c in fk.FLOAT_PLANES:
        t = g.get(key)
        planes.append(None if t is None else (t if c is None else t[..., c]))
    return planes


def leaf_operands(scene: Scene, camera, frame, needs):
    """The 20 small operands with the tables `needs` asks for as fresh
    leaves that require grad → (operands, leaf indices); the plain versions
    of K5 and K6 differentiate frame_kernel.frame_planes in them."""
    ops = [o.detach() for o in fk.small_operands(scene, camera, frame)]
    leaves = [DIFF_IDX[i] for i, need in enumerate(needs) if need]
    for k in leaves:
        ops[k] = ops[k].clone().requires_grad_()
    return ops, leaves


def leaf_grads(ops, leaves, grads) -> tuple:
    """autograd.grad's results for `leaves` → DIFF_IDX-ordered gradients
    (zeros for an unused leaf, None for a table not asked for)."""
    by_k = {k: (torch.zeros_like(ops[k]) if d is None else d) for k, d in zip(leaves, grads)}
    return tuple(by_k.get(k) for k in DIFF_IDX)


def frame_backward_plain(scene: Scene, camera, frame, g: dict, config, needs=None,
                         row_base: int = 0, rows: int | None = None):
    """`frame_backward` as autograd through frame_kernel.frame_forward_plain
    (the plain version of K5) → DIFF_IDX-ordered gradients."""
    needs = needs_for(None) if needs is None else tuple(needs)
    cot = _present_planes(g)
    if not any(needs) or all(c is None for c in cot):
        n = seed_indices(scene, needs, scene.device).numel()
        return unpack_grads(scene, needs, torch.zeros(n, device=scene.device))
    ops, leaves = leaf_operands(scene, camera, frame, needs)
    with torch.enable_grad():
        outs = fk.frame_planes(ops, scene, frame, config, row_base, rows)
        pairs = [(o, c) for o, c in zip(outs[:13], cot) if c is not None]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], [ops[k] for k in leaves],
            [c.to(o.dtype) for o, c in pairs], allow_unused=True,
        )
    return leaf_grads(ops, leaves, grads)


def frame_backward(scene: Scene, camera, frame, g: dict, config, needs=None,
                   row_base: int = 0, rows: int | None = None):
    """The vector-Jacobian product of the fused frame → tuple of gradients
    in DIFF_IDX order, each in its small operand's shape (None where
    `needs`, 14 flags, does not ask for it; all by default).

    `g` maps frame-dict keys to cotangents of the same shape; a missing or
    None key is a plane the loss never touched, and is not read. With
    `rows`, the frame and the cotangents cover image rows [row_base,
    row_base+rows) only. The scene's device picks the route: CUDA launches
    K5 (or raises), CPU runs `frame_backward_plain`."""
    global LAUNCHES, ROW_LAUNCHES
    fk.check_planes_for_biased(scene, config)
    device = scene.device
    needs = needs_for(None) if needs is None else tuple(needs)
    if device.type == "cpu":
        return frame_backward_plain(scene, camera, frame, g, config, needs, row_base, rows)
    if device.type != "cuda":
        raise ValueError(f"frame_backward: unsupported device {device}")
    counts, shading = fk.kernel_args(scene, camera, config)
    H, W = (config.height if rows is None else int(rows)), config.width
    if H < 1 or row_base < 0 or row_base + H > config.height:
        raise ValueError(f"rows [{row_base}, {row_base + H}) outside the {config.height}-row image")
    cot = _present_planes(g)
    present = sum(1 << k for k, c in enumerate(cot) if c is not None)
    seeds = seed_indices(scene, needs, device)
    out_g = torch.zeros(seeds.numel(), dtype=torch.float32, device=device)
    if present and seeds.numel():
        planes = torch.stack([c for c in cot if c is not None]).to(torch.float32).contiguous()
        if planes.shape[1:] != (H, W) or planes.device != device:
            raise ValueError(f"cotangent planes must be [{H}, {W}] on {device}, "
                             f"got {tuple(planes.shape[1:])} on {planes.device}")
        ftab, itab = fk.pack_tables(scene, camera)
        err = _build.load().kpt_frame_backward(
            ftab.data_ptr(), itab.data_ptr(), seeds.data_ptr(), seeds.numel(),
            *counts, fk._wrap32(int(frame)), int(row_base), H, *shading, planes.data_ptr(),
            present, out_g.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
        _build.check(err, "kpt_frame_backward")
        LAUNCHES += 1
        ROW_LAUNCHES += H != config.height
    return unpack_grads(scene, needs, out_g)


def _inputs(scene: Scene, camera) -> tuple:
    """The differentiable tensors, in GRAD_NAMES order."""
    m = scene.materials
    return (scene.planes, scene.spheres, scene.boxes, scene.light_color,
            m.s0, m.s1, m.alb_const, m.alb_scale, m.emission, m.en_const,
            m.en_scale, camera.loc, camera.orient)


class FrameForward(torch.autograd.Function):
    """The fused frame with its recompute backward: forward is
    frame_kernel.frame_forward (K1), backward `frame_backward` (K5) for the
    inputs that need a gradient and the output planes that received one,
    over the same rows."""

    @staticmethod
    def forward(ctx, scene, camera, frame, config, row_base, rows, *tensors):
        ctx.set_materialize_grads(False)
        ctx.scene, ctx.camera, ctx.frame, ctx.config = scene, camera, frame, config
        ctx.row_base, ctx.rows = row_base, rows
        out = fk.frame_forward(scene, camera, frame, config, row_base, rows)
        ctx.mark_non_differentiable(out["oid"])
        return tuple(out[k] for k in OUT_KEYS)

    @staticmethod
    def backward(ctx, *grads):
        wanted = [n for n, need in zip(GRAD_NAMES, ctx.needs_input_grad[6:]) if need]
        none = (None,) * (6 + len(GRAD_NAMES))
        if not wanted:
            return none
        g = dict(zip(OUT_KEYS[:6], grads[:6]))
        tables = frame_backward(ctx.scene, ctx.camera, ctx.frame, g, ctx.config,
                                needs_for(wanted), ctx.row_base, ctx.rows)
        d_scene, d_camera = assemble_grads(ctx.scene, ctx.camera, tables,
                                           ctx.scene.light_index)
        d = {**d_scene, **d_camera}
        return none[:6] + tuple(d[n] if n in wanted else None for n in GRAD_NAMES)


def frame_forward(scene: Scene, camera, frame, config, row_base: int = 0,
                  rows: int | None = None) -> dict:
    """Differentiable fused frame: the outputs of
    frame_kernel.frame_forward (over image rows [row_base, row_base+rows)
    with `rows`), with gradients to the scene's and camera's float tables
    through `FrameForward`."""
    outs = FrameForward.apply(scene, camera, int(frame), config, int(row_base), rows,
                              *_inputs(scene, camera))
    return dict(zip(OUT_KEYS, outs))
