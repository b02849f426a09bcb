"""The fused loss-and-gradient kernel (K6) and its plain version.

Port of kylespathtracer_tpu/ops/loss_kernel.py. When the loss is known and
per pixel (MSE against a target image, or the plain image mean), the
frame, the fresh-history composite (ACES + sRGB), the loss and the
gradient collapse into one kernel: `render_loss_and_grad` launches
csrc/loss_kernel.cu on CUDA tensors and runs
`render_loss_and_grad_plain` (autograd through
frame_kernel.frame_forward_plain, `_composite_planes` and the loss) on CPU
tensors. Both return the loss and the same DIFF_IDX gradient tables as
frame_grad.frame_backward, for `frame_grad.assemble_grads`.

The composite here is the component-plane twin of
render/composite.composite_from + core/color for the fresh-history
single frame (both counts 1; config.no_history, render/pipeline.py).
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core.color import _ACES_IN, _ACES_OUT
from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.scene.types import Scene

# Launches of the CUDA kernel by `render_loss_and_grad` in this process.
LAUNCHES = 0


def _mat3_planes(v, m):
    """Row-vector × mat3 over component planes (core/color._mat3)."""
    x, y, z = v
    return tuple(x * m[r][0] + y * m[r][1] + z * m[r][2] for r in range(3))


def _composite_planes(alb, ene, add_d, add_s, brightness):
    """composite_from + aces_fitted + linear_srgb in component form, for the
    fresh-history case (both counts exactly 1; passthrough.frag:29-47)."""
    out = []
    for c in range(3):
        pos = alb[c] > 0.0
        alb_sqrt = torch.where(pos, torch.sqrt(torch.where(pos, alb[c], 1.0)), 0.0)
        out.append((add_d[c] * alb[c] * ene[0] + add_s[c] * alb_sqrt * ene[1]) * brightness)
    # ACES RRT/ODT (common.glsl:120-139).
    cpl = _mat3_planes(out, _ACES_IN)
    rat = []
    for c in range(3):
        a = cpl[c] * (cpl[c] + 0.0245786) - 0.000090537
        b = cpl[c] * (0.983729 * cpl[c] + 0.4329510) + 0.238081
        rat.append(a / b)
    cpl = _mat3_planes(rat, _ACES_OUT)
    img = []
    for c in range(3):
        x = torch.clamp(cpl[c], 0.0, 1.0)
        # linear → sRGB (common.glsl:111-113).
        lo = 12.92 * x
        hi = 1.055 * torch.pow(torch.clamp(x, min=1e-10), 1.0 / 2.4) - 0.055
        img.append(torch.where(x <= 0.0031308, lo, hi))
    return img


def _check_loss(loss: str, target, config) -> None:
    if loss not in ("mse", "mean"):
        raise ValueError(f"unknown loss {loss!r}")
    if loss == "mse":
        if target is None:
            raise ValueError("loss='mse' needs a target image")
        if tuple(target.shape) != (config.height, config.width, 3):
            raise ValueError(f"target must be [{config.height}, {config.width}, 3], "
                             f"got {tuple(target.shape)}")


def render_loss_and_grad_plain(scene: Scene, camera, frame, config, target=None,
                               loss: str = "mse", needs=None):
    """`render_loss_and_grad` as autograd through the plain frame, the
    composite and the loss (the plain version of K6)."""
    _check_loss(loss, target, config)
    needs = fg.needs_for(None) if needs is None else tuple(needs)
    ops, leaves = fg.leaf_operands(scene, camera, frame, needs)
    with torch.enable_grad():
        outs = fk.frame_planes(ops, scene, frame, config)
        img = _composite_planes(outs[6:9], outs[9:11], outs[0:3], outs[3:6],
                                float(config.brightness))
        if loss == "mse":
            total = sum(((img[c] - target[..., c]) ** 2).sum() for c in range(3))
        else:
            total = sum(img[c].sum() for c in range(3))
        lval = total / float(config.height * config.width * 3)
        grads = torch.autograd.grad(lval, [ops[k] for k in leaves], allow_unused=True) \
            if leaves else ()
    return lval.detach(), fg.leaf_grads(ops, leaves, grads)


def render_loss_and_grad(scene: Scene, camera, frame, config, target=None,
                         loss: str = "mse", needs=None):
    """One fused pass → (loss, grads) for the single-frame render.

    loss="mse": mean((image - target)**2) over H·W·3 (target f32[H,W,3]);
    loss="mean": mean(image). grads is a tuple in DIFF_IDX order
    (frame_grad.DIFF_IDX), None where `needs` (14 flags; all by default)
    does not ask for the table. The scene's device picks the route: CUDA
    launches K6 (or raises), CPU runs `render_loss_and_grad_plain`."""
    global LAUNCHES
    _check_loss(loss, target, config)
    fk.check_planes_for_biased(scene, config)
    device = scene.device
    needs = fg.needs_for(None) if needs is None else tuple(needs)
    if device.type == "cpu":
        return render_loss_and_grad_plain(scene, camera, frame, config, target, loss, needs)
    if device.type != "cuda":
        raise ValueError(f"render_loss_and_grad: unsupported device {device}")
    counts, shading = fk.kernel_args(scene, camera, config)
    seeds = fg.seed_indices(scene, needs, device)
    out_g = torch.zeros(seeds.numel(), dtype=torch.float32, device=device)
    out_loss = torch.zeros(1, dtype=torch.float32, device=device)
    mse = loss == "mse"
    tgt = target.to(torch.float32).permute(2, 0, 1).contiguous() if mse else out_loss
    if tgt.device != device:
        raise ValueError(f"target on {tgt.device}, scene on {device}")
    ftab, itab = fk.pack_tables(scene, camera)
    err = _build.load().kpt_loss_grad(
        ftab.data_ptr(), itab.data_ptr(), seeds.data_ptr(), seeds.numel(),
        *counts, fk._wrap32(int(frame)), *shading, float(config.brightness),
        int(mse), tgt.data_ptr(), out_loss.data_ptr(), out_g.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "kpt_loss_grad")
    LAUNCHES += 1
    n = float(config.height * config.width * 3)
    return out_loss[0] / n, fg.unpack_grads(scene, needs, out_g / n)


def loss_and_grad(scene: Scene, camera, frame, config, target=None,
                  loss: str = "mse", keys=None):
    """`render_loss_and_grad` with the gradients assembled into
    (d_scene, d_camera) dicts (frame_grad.assemble_grads), for the tensors
    named in `keys` (frame_grad.GRAD_NAMES; all by default)."""
    lval, grads = render_loss_and_grad(scene, camera, frame, config, target=target,
                                       loss=loss, needs=fg.needs_for(keys))
    return lval, fg.assemble_grads(scene, camera, grads, int(scene.light_index))
