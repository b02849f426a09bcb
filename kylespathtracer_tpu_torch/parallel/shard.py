"""Sharded rendering and training on torch.distributed.

Port of kylespathtracer_tpu/parallel/shard.py, its shard_map path. (Its
GSPMD `jit_render_sharded` has no counterpart: XLA placed that path's
collectives, and the tile path here serves the same frames.) SPMD: every
rank of the mesh (parallel/mesh.py) runs the same program on its own block
of rows = H / n image rows, on its own device, and calls the collectives
itself:

* `render_frame_tiled`: this rank's history rows in, this rank's image rows
  and new history rows out. The reprojection's 2×2 taps read the previous
  frame near the current pixel, so a rank needs its own history rows plus
  `halo` rows from each neighbour: one send and one receive each way per
  frame (`exchange_halo`), O(halo·W) bytes. Taps beyond the halo carry zero
  weight, which restarts the history there as an off-screen tap does
  (common.glsl:673-674); the velocity clamp already resets the history
  under fast motion (diffuse.frag:49-51).
* `train_step_tiled`: each rank's squared-error sum over its rows, over the
  global pixel count, differentiated through the frame kernel's backward in
  row mode (K5); the loss and the scene gradients are summed over the ranks
  (one all-reduce) and every rank applies the same Adam update.

`_render_row_block` renders one tile against a history row window; the
tests and chip_smoke.py also drive it in one process, a tile at a time, on
the windows `tile_window` cuts from a whole-image history.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.distributed as dist

from kylespathtracer_tpu_torch.core import gmath, sampler
from kylespathtracer_tpu_torch.diff import inverse
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import frame_hist as fh
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.parallel.mesh import Mesh
from kylespathtracer_tpu_torch.render import composite as comp_mod
from kylespathtracer_tpu_torch.render import gbuffer as gb_mod
from kylespathtracer_tpu_torch.render import mis as mis_mod
from kylespathtracer_tpu_torch.render import reproject as rep_mod
from kylespathtracer_tpu_torch.render.camera import ray_dirs_window
from kylespathtracer_tpu_torch.render.passes import (
    Channel,
    _shaded,
    _temporal_clamp,
    count_floor,
    get_trace,
    specular_anchor,
)
from kylespathtracer_tpu_torch.render.pipeline import History, init_history, split_temporal_frame
from kylespathtracer_tpu_torch.scene import materials as mat_mod

# The row block of the fused tile kernels (K2's and K8's tile modes): their
# tiles must hold a multiple of it, with a halo of exactly one block.
BLOCK_ROWS = rk.BLOCK_ROWS


def tile_rows(config, mesh: Mesh) -> int:
    """Image rows per rank; the height must divide over the ranks."""
    if config.height % mesh.size:
        raise ValueError(f"height {config.height} does not divide over {mesh.size} ranks")
    return config.height // mesh.size


def _pack(hist: History, rows: slice) -> torch.Tensor:
    """The rows `rows` of both channels' planes as one f32 [r, W, 10] tensor
    (rgb, cnt and the oid's bits, per channel)."""
    return torch.cat([t for ch in (hist.diffuse, hist.specular) for t in (
        ch.rgb[rows], ch.cnt[rows, :, None], ch.oid[rows, :, None].view(torch.float32))], dim=-1)


def _unpack(buf: torch.Tensor) -> tuple:
    return tuple(Channel(rgb=buf[..., k:k + 3], cnt=buf[..., k + 3],
                         oid=buf[..., k + 4].contiguous().view(torch.int32)) for k in (0, 5))


def _with_halo(hist: History, below: tuple, above: tuple) -> History:
    def join(ch: Channel, lo: Channel, hi: Channel) -> Channel:
        return Channel(*(torch.cat([a, b, c]).contiguous() for a, b, c in zip(
            (lo.rgb, lo.cnt, lo.oid), (ch.rgb, ch.cnt, ch.oid), (hi.rgb, hi.cnt, hi.oid))))

    return History(diffuse=join(hist.diffuse, below[0], above[0]),
                   specular=join(hist.specular, below[1], above[1]), camera=hist.camera)


def exchange_halo(hist: History, mesh: Mesh, halo: int) -> History:
    """This rank's history rows with `halo` rows of each neighbour around
    them: the last `halo` rows of the rank before, this rank's rows, the
    first `halo` rows of the rank after. The edge ranks get zeros there,
    which the gather's bounds already reject. One send and one receive each
    way (the JAX code's two ppermutes), both channels' planes packed into
    one message; with gloo on a CUDA device the rows pass through host
    memory."""
    if halo == 0:
        return hist
    rows = hist.diffuse.cnt.shape[0]
    r, n = mesh.rank, mesh.size
    to_next = mesh.stage(_pack(hist, slice(rows - halo, rows)))
    to_prev = mesh.stage(_pack(hist, slice(0, halo)))
    from_prev, from_next = torch.zeros_like(to_next), torch.zeros_like(to_prev)
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, to_prev, r - 1, tag=2), dist.P2POp(dist.irecv, from_prev, r - 1, tag=1)]
    if r < n - 1:
        ops += [dist.P2POp(dist.isend, to_next, r + 1, tag=1), dist.P2POp(dist.irecv, from_next, r + 1, tag=2)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    dev = hist.diffuse.cnt.device
    return _with_halo(hist, _unpack(from_prev.to(dev)), _unpack(from_next.to(dev)))


def tile_window(hist: History, row0: int, rows: int, halo: int) -> History:
    """The history window of the tile of image rows [row0, row0+rows) cut
    from a whole-image history: rows [row0-halo, row0+rows+halo), zeros
    beyond the image. What `exchange_halo` assembles on that tile's rank;
    for driving `_render_row_block` a tile at a time in one process."""
    H = hist.diffuse.cnt.shape[0]
    lo, hi = max(row0 - halo, 0), min(row0 + rows + halo, H)

    def cut(t: torch.Tensor) -> torch.Tensor:
        pad = (0, 0) * (t.ndim - 1) + (lo - (row0 - halo), row0 + rows + halo - hi)
        return torch.nn.functional.pad(t[lo:hi], pad)

    return History(diffuse=Channel(*map(cut, (hist.diffuse.rgb, hist.diffuse.cnt, hist.diffuse.oid))),
                   specular=Channel(*map(cut, (hist.specular.rgb, hist.specular.cnt, hist.specular.oid))),
                   camera=hist.camera)


def render_frame_tiled(scene, camera, history: History, frame, config, mesh: Mesh,
                       halo_rows: int = BLOCK_ROWS):
    """One frame, SPMD: every rank renders its block of image rows.

    `history` holds this rank's rows of the previous accumulation (see
    `mesh.shard_image_pytree`); the ranks exchange `halo` edge rows, so the
    reprojection's taps read [row0-halo, row0+rows+halo). Returns this
    rank's image rows and new history rows."""
    rows = tile_rows(config, mesh)
    if history.diffuse.cnt.shape[0] != rows:
        raise ValueError(f"render_frame_tiled: a history of {history.diffuse.cnt.shape[0]} rows; "
                         f"this rank's is {rows}")
    halo = min(halo_rows, rows) if mesh.size > 1 else 0
    row0 = mesh.rank * rows
    window = exchange_halo(history, mesh, halo)
    return _render_row_block(scene, camera, window, frame, config, row0, rows,
                             buffer_row0=row0 - halo, halo=halo)


def _render_row_block(scene, camera, prev_hist: History, frame, config, row0: int, rows: int,
                      buffer_row0: int = 0, halo: int = 0):
    """Render image rows [row0, row0+rows) against a previous-history row
    window whose first row is image row `buffer_row0` (a whole-image
    history when 0, a tile plus `halo` rows on each side from the halo
    exchange otherwise) → (image [rows,W,3], History of those rows).

    The fused temporal frame runs its tile kernels (K8's tile mode, or K1's
    row mode and K2's tile mode) when the tile is block-aligned; otherwise
    it warns and takes the differentiable frame (K1's row mode) and the
    exact gather, whose taps beyond the window restart the history. Any
    other pipeline is the pass pipeline's math on the tile (the G-buffer,
    analytic or sphere-traced, the exact gather, mis.dual_mis)."""
    W, H = config.width, config.height
    fused = config.pipeline == "fused"
    if fused:
        if not config.no_history and config.reproject_backend == "window":
            bh = BLOCK_ROWS
            aligned = (halo == bh and rows % bh == 0) or (halo == 0 and rows == H)
            if aligned and config.temporal_fusion == "mono":
                tile = {} if halo == 0 else dict(block_rows=bh, row_base=row0, rows=rows, hist_halo=halo)
                o = fh.frame_hist(scene, camera, prev_hist.camera, prev_hist.diffuse,
                                  prev_hist.specular, frame, config, **tile)
                d = Channel(rgb=o["d_rgb"], cnt=o["d_cnt"], oid=o["oid"])
                s = Channel(rgb=o["s_rgb"], cnt=o["s_cnt"], oid=o["oid"])
                image = comp_mod.composite_from(o["alb"], o["ene"], d, s, config)
                return image, History(diffuse=d, specular=s, camera=camera)
            if aligned:
                return split_temporal_frame(scene, camera, prev_hist, frame, config,
                                            row_base=row0, rows=rows, hist_halo=halo)
            warnings.warn(
                f"fused tiled path needs rows ({rows}) divisible by "
                f"{bh} and halo == {bh} (got {halo}); falling back to the "
                "per-tile frame kernel + exact reprojection gather",
                stacklevel=2,
            )
        # The differentiable frame on the tile's rows (K1 row mode; its
        # backward is K5 in row mode): train_step_tiled's gradient.
        out = fg.frame_forward(scene, camera, frame, config, row0, rows)
        oid, depth, curv = out["oid"], out["depth"], out["curv"]
    else:
        gb = gb_mod.geometry_pass(scene, camera, config, row0, rows)
        oid, depth, curv = gb.obj_id, gb.depth, gb.curv

    # The differentiable tile and the pass pipeline read the rays here; the
    # split frame's K2 builds its own.
    rd = ray_dirs_window(camera, W, H, row0, rows, config.fov)
    hl = camera.loc + rd * depth[..., None]
    if config.no_history:
        rep_rgb_d = rep_rgb_s = torch.zeros(oid.shape + (3,), dtype=torch.float32, device=oid.device)
        rep_cnt_d = rep_cnt_s = torch.zeros(oid.shape, dtype=torch.float32, device=oid.device)
    else:
        prev_cam = prev_hist.camera
        vv = gmath.length(camera.loc - prev_cam.loc)

        def carried(anchor, prev: Channel):
            rgb, cnt = rep_mod.reproject(prev_cam.loc, prev_cam.orient, anchor, oid, prev.rgb, prev.cnt,
                                         prev.oid, config.fov, image_size=(H, W), buffer_row0=buffer_row0)
            return _temporal_clamp(rgb, count_floor(cnt), vv, config)

        rep_rgb_d, rep_cnt_d = carried(hl, prev_hist.diffuse)
        rep_rgb_s, rep_cnt_s = carried(specular_anchor(scene, hl, rd, curv), prev_hist.specular)

    if fused:
        d = Channel(rgb=rep_rgb_d + out["add_d"], cnt=rep_cnt_d + 1.0, oid=oid)
        s = Channel(rgb=rep_rgb_s + out["add_s"], cnt=rep_cnt_s + 1.0, oid=oid)
        image = comp_mod.composite_from(out["alb"], out["ene"], d, s, config)
        return image, History(diffuse=d, specular=s, camera=camera)

    px = torch.arange(W, dtype=torch.int32, device=oid.device)[None, :].expand(rows, W)
    py = row0 + torch.arange(rows, dtype=torch.int32, device=oid.device)[:, None].expand(rows, W)
    seed = sampler.gen_seed(frame, px, py, W, H)
    _, emission, _ = mat_mod.surface(scene.materials, oid, hl)
    est_d, est_s = mis_mod.dual_mis(scene, get_trace(config), rd, hl, gb.normal, oid, seed, config)
    shade = _shaded(scene, oid)[..., None]
    d = Channel(rgb=rep_rgb_d + emission + torch.where(shade, est_d, 0.0), cnt=rep_cnt_d + 1.0, oid=oid)
    s = Channel(rgb=rep_rgb_s + emission + torch.where(shade, est_s, 0.0), cnt=rep_cnt_s + 1.0, oid=oid)
    image = comp_mod.composite(scene, config, gb, camera, d, s)
    return image, History(diffuse=d, specular=s, camera=camera)


def tile_loss_and_grad(params, scene, camera, target_rows: torch.Tensor, frame, config,
                       row0: int, rows: int):
    """One tile's share of the training loss → (loss, grads): the squared
    error of image rows [row0, row0+rows) against `target_rows`, summed and
    divided by the global pixel count, and its gradient in `params`, both
    partial sums over the tiles. A single fresh frame (`no_history`), so
    the frame is K1 in row mode and its backward K5 in row mode."""
    config = dataclasses.replace(config, no_history=True)
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        img, _ = _render_row_block(inverse.apply_params(scene, p), camera, init_history(config, camera),
                                   frame, config, row0, rows)
        loss = torch.sum((img - target_rows) ** 2) / (config.height * config.width * 3)
        grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), dict(zip(p, grads))


def train_step_tiled(params, opt_state, opt, scene, camera, target_rows: torch.Tensor, frame,
                     config, mesh: Mesh):
    """One inverse-rendering step, SPMD: each rank's loss and gradient on
    its rows (`tile_loss_and_grad`, `target_rows` this rank's rows of the
    target), summed over the ranks by one all-reduce, then the same update
    of `opt` (a `diff.inverse.ClippedAdam`) on every rank → (params,
    opt_state, loss), as `diff.inverse.train_step` on the whole image."""
    rows = tile_rows(config, mesh)
    loss, grads = tile_loss_and_grad(params, scene, camera, target_rows, frame, config,
                                     mesh.rank * rows, rows)
    loss, *summed = mesh.all_reduce_sum([loss, *grads.values()])
    params = opt.update(dict(zip(grads, summed)), opt_state, params)
    return params, opt_state, loss
