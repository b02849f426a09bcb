"""PyTorch port, the sharded renderer and trainer (parallel/shard.py), in
one process on the CPU (plain versions of the kernels):

- `ray_dirs_window`: its NDC grid bitwise JAX's, its directions within
  1e-6 of JAX's and bitwise the port's `ray_dirs` rows; the exact gather
  over a history row window (`reproject(buffer_row0=...)`) against JAX's,
  atol 1e-5 (rgb, with rtol 1e-5) / 1e-4 (count);
- K5's row mode (`frame_backward_plain` with `row_base`/`rows`) against
  `jax.vjp` of `frame_forward_jnp` with the cotangent zero outside the tile:
  1e-4·max per table;
- the tiles of `_render_row_block`, rendered one at a time against windows
  cut from the whole history (`tile_window`: what the halo exchange
  assembles) and stitched, against the port's unsharded `render_frame` over
  two frames of a moving camera from a populated history, for the split,
  mono and pass frames, at the JAX package's own bars
  (tests/test_sharding.py:90-96: image 1e-5, history 1e-4), with the
  fallback warning an error for the fused frames;
- `train_step_tiled` (and its tiles' summed loss and gradient) against the
  unsharded `train_step`'s: the update to 1e-4·max per parameter;
- the argument checks: where the JAX code raises, and the two faults of the
  JAX code that the port does not copy (ADVICE.md).
K2's and K8's tile modes against the JAX kernels are
tests/test_torch_shard_kernels.py's, the tiles against JAX's unsharded
frame tests/test_torch_shard_frames.py's, and the multi-process path (the
halo exchange, the all-reduce) tests/test_torch_multihost.py's."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (frame_anchors, np_, render_tiles, seeded_channel, sphere_case,
                            to_torch_camera, to_torch_config, to_torch_scene)
from kylespathtracer_tpu.ops import frame_hist as jfh
from kylespathtracer_tpu.ops import frame_kernel as jfk
from kylespathtracer_tpu.ops import reproject_kernel as jrk
from kylespathtracer_tpu.render import camera as jcam
from kylespathtracer_tpu.render import reproject as jrep
from kylespathtracer_tpu.render.passes import Channel as JChannel
from kylespathtracer_tpu.utils.config import RenderConfig as JConfig
from kylespathtracer_tpu_torch.diff import inverse
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import frame_hist as fh
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.parallel import shard
from kylespathtracer_tpu_torch.parallel.mesh import Mesh
from kylespathtracer_tpu_torch.render import camera as cam_mod
from kylespathtracer_tpu_torch.render import pipeline
from kylespathtracer_tpu_torch.render import reproject as rep_mod
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.render.pipeline import History
from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene
from kylespathtracer_tpu_torch.utils.config import RenderConfig

W, H = 64, 32
CPU = torch.device("cpu")
JCAM = jcam.Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))


# ------------------------------------------------------------ the ray grid

@pytest.mark.parametrize("row0,rows", [(0, 16), (16, 16), (8, 8), (5, 19)])
def test_ray_dirs_window_matches_jax(row0, rows):
    """The window's NDC grid bitwise JAX's, its directions within 1e-6 of
    JAX's `ray_dirs_window` (XLA's rsqrt and rotation part from torch's by
    an ulp, as for `ray_dirs`, tests/test_torch_scene.py) and bitwise the
    port's own `ray_dirs` rows."""
    cam = to_torch_camera(JCAM)
    np.testing.assert_array_equal(np_(cam_mod.ndc_grid(W, H, CPU, row0, rows)),
                                  np.asarray(jcam.ndc_grid(W, H))[row0:row0 + rows])
    got = cam_mod.ray_dirs_window(cam, W, H, row0, rows, 1.5)
    want = jcam.ray_dirs_window(JCAM, W, H, row0, rows, 1.5)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0, atol=1e-6)
    assert torch.equal(got, cam_mod.ray_dirs(cam, W, H, 1.5)[row0:row0 + rows])


# ------------------------------------------------- the exact windowed gather

def _anchors(row0: int, rows: int):
    return frame_anchors(JCAM, W, H, row0, rows)


PREV = jcam.Camera.create(loc=(3.01, 1.99, -3.0), orient=(-0.03, 0.704))


@pytest.mark.parametrize("row0,halo", [(0, 8), (16, 8), (8, 3)])
def test_reproject_buffer_window_matches_jax(row0, halo):
    """The gather of rows [row0, row0+16) over a history window whose first
    row is image row row0 - halo (its rows beyond the image zeros) against
    JAX's `reproject(..., image_size, buffer_row0)`; taps beyond the window
    restart the history on both sides. rgb to 1e-5 + 1e-5·|ref|: the
    history's rgb runs to 2, and XLA's projection rounds the bilinear
    weights an ulp away from torch's."""
    rows = 16
    hl, oid = _anchors(row0, rows)
    full = seeded_channel(_anchors(0, H)[1], 5)
    win = shard.tile_window(History(full, full, to_torch_camera(PREV)), row0, rows, halo).diffuse
    prev = to_torch_camera(PREV)
    got = rep_mod.reproject(prev.loc, prev.orient, hl, oid, win.rgb, win.cnt, win.oid, 1.5,
                                     image_size=(H, W), buffer_row0=row0 - halo)
    want = jrep.reproject(PREV.loc, PREV.orient, jnp.asarray(np_(hl)), jnp.asarray(np_(oid)),
                          jnp.asarray(np_(win.rgb)), jnp.asarray(np_(win.cnt)), jnp.asarray(np_(win.oid)),
                          1.5, image_size=(H, W), buffer_row0=row0 - halo)
    np.testing.assert_allclose(np_(got[0]), np.asarray(want[0]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np_(got[1]), np.asarray(want[1]), atol=1e-4)
    assert np_(got[1]).max() > 2, "no history carried; the check is vacuous"


# -------------------------------------------------------------- K5 row mode

def test_frame_backward_rows_matches_jax_vjp():
    """K5's row mode (plain version, and FrameForward through autograd) on
    image rows [4, 12) against jax.vjp of the whole frame with the
    cotangent zero outside those rows, on the sphere scene with soft
    shadows; ill-conditioned pixels (tests/test_torch_frame_grad.py) get no
    cotangent."""
    w, h, row0, rows, frame = 32, 16, 4, 8, 3
    scene_j = sphere_case()
    cfg = JConfig(width=w, height=h, soft_shadows=0.05)
    out, vjp = jax.vjp(lambda s, c: jfk.frame_forward_jnp(s, c, jnp.int32(frame), cfg), scene_j, JCAM)
    scene, cam, cfg_t = to_torch_scene(scene_j), to_torch_camera(JCAM), to_torch_config(cfg)
    plain = fk.frame_forward_plain(scene, cam, frame, cfg_t)
    bad = np_(fk.ill_conditioned(plain, {k: torch.tensor(np.asarray(v)) for k, v in out.items()}))
    rng = np.random.default_rng(7)
    keep = np.zeros((h, w), np.float32)
    keep[row0:row0 + rows] = 1.0
    keep[bad] = 0.0
    cots = {k: rng.normal(size=np.asarray(v).shape).astype(np.float32) * (keep[..., None] if v.ndim == 3 else keep)
            for k, v in out.items() if k != "oid"}
    d_scene, d_cam = vjp({**{k: jnp.asarray(v) for k, v in cots.items()},
                          "oid": np.zeros((h, w), jax.dtypes.float0)})
    want = {k: np.asarray(getattr(d_scene, k)) for k in ("planes", "spheres", "boxes", "light_color")}
    want.update({k: np.asarray(getattr(d_scene.materials, k)) for k in fg.GRAD_NAMES[4:11]})
    want.update(loc=np.asarray(d_cam.loc), orient=np.asarray(d_cam.orient))
    g = {k: torch.from_numpy(v[row0:row0 + rows]) for k, v in cots.items()}
    tables = fg.frame_backward(scene, cam, frame, g, cfg_t, row_base=row0, rows=rows)
    d_t, d_c = fg.assemble_grads(scene, cam, tables, scene.light_index)
    got = {**d_t, **d_c}

    # The same through autograd: FrameForward in row mode.
    leaves = {k: t.detach().clone().requires_grad_() for k, t in zip(fg.GRAD_NAMES, fg._inputs(scene, cam))}
    mats = dataclasses.replace(scene.materials, **{k: leaves[k] for k in fg.GRAD_NAMES[4:11]})
    sc = dataclasses.replace(scene, materials=mats, **{k: leaves[k] for k in fg.GRAD_NAMES[:4]})
    fwd = fg.frame_forward(sc, Camera(loc=leaves["loc"], orient=leaves["orient"]), frame, cfg_t, row0, rows)
    assert fwd["oid"].shape == (rows, w)
    outs = [(fwd[k], g[k]) for k in g]
    auto = dict(zip(leaves, torch.autograd.grad([o for o, _ in outs], list(leaves.values()),
                                                [c for _, c in outs], allow_unused=True)))
    for name in fg.GRAD_NAMES:
        b = want[name]
        tol = max(1e-4 * float(np.abs(b).max(initial=0.0)), 1e-10)
        np.testing.assert_allclose(np_(got[name]), b, rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(np_(auto[name]), b, rtol=0, atol=tol, err_msg=f"autograd {name}")
    assert np.abs(want["spheres"]).max() > 0


# ----------------------------------------------- stitched tiles vs the frame

def _pan(device=CPU):
    return [Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=device),
            Camera.create(loc=(3.01, 1.995, -3.005), orient=(-0.02, 0.703), device=device)]


FRAMES = {"split": dict(pipeline="fused"), "mono": dict(pipeline="fused", temporal_fusion="mono"),
          "pass": dict(pipeline="pass")}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", list(FRAMES))
def test_tiles_match_unsharded_frame(kind, n):
    """n tiles of 16 or 8 rows (block-aligned: the fused frames run K8's
    tile mode, or K1's row mode and K2's tile mode) against `render_frame`
    over two frames of a moving camera from a populated history."""
    scene = default_scene(device=CPU)
    cfg = RenderConfig(width=W, height=H, **FRAMES[kind])
    cams = _pan()
    oid = fk.frame_forward_plain(scene, cams[0], 0, RenderConfig(width=W, height=H))["oid"]
    hist_r = hist_t = History(seeded_channel(oid, 1), seeded_channel(oid, 2), cams[0])
    for i, cam in enumerate(cams, start=1):
        img_r, hist_r = pipeline.render_frame(scene, cam, hist_r, i, cfg)
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="fused tiled path")
            img_t, hist_t = render_tiles(scene, cam, hist_t, i, cfg, n)
        np.testing.assert_allclose(np_(img_t), np_(img_r), atol=1e-5, err_msg=f"image {i}")
        for name in ("diffuse", "specular"):
            a, b = getattr(hist_t, name), getattr(hist_r, name)
            np.testing.assert_allclose(np_(a.rgb), np_(b.rgb), atol=1e-4, err_msg=f"{name} rgb {i}")
            np.testing.assert_allclose(np_(a.cnt), np_(b.cnt), atol=1e-4, err_msg=f"{name} cnt {i}")
            assert torch.equal(a.oid, b.oid)
    assert hist_r.diffuse.cnt.max() > 2, "history not carried"


def test_misaligned_tiles_warn_and_take_the_exact_gather():
    """8 tiles of 4 rows: the fused frame warns (the JAX text), takes K1's
    row mode and the exact gather over a 4-row halo, and matches the
    unsharded frame wherever the taps stay inside the window."""
    scene = default_scene(device=CPU)
    cfg = RenderConfig(width=W, height=H, pipeline="fused")
    cams = _pan()
    oid = fk.frame_forward_plain(scene, cams[0], 0, cfg)["oid"]
    hist = History(seeded_channel(oid, 1), seeded_channel(oid, 2), cams[0])
    with pytest.warns(UserWarning, match=r"fused tiled path needs rows \(4\) divisible by 8 and halo == 8 \(got 4\)"):
        img_t, hist_t = render_tiles(scene, cams[1], hist, 1, cfg, 8)
    img_r, hist_r = pipeline.render_frame(scene, cams[1], hist, 1, cfg)
    same = (img_t - img_r).abs().amax(-1) <= 1e-5
    assert same.float().mean() > 0.9 and torch.equal(hist_t.diffuse.oid, hist_r.diffuse.oid)


# ---------------------------------------------------------- the train step

def _train_case():
    """The train step of tests/test_sharding.py:99 with a real target: two
    spheres rendered as the target, a perturbed start, 64×32, fused."""
    cam = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0), device=CPU)
    cfg = RenderConfig(width=W, height=H, pipeline="fused", soft_shadows=0.05)
    truth = sphere_scene([[0.0, 1.0, 6.0], [2.0, 1.0, 7.0]], [1.0, 0.8], [[0.6, 0.3, 0.2], [0.2, 0.5, 0.6]],
                         device=CPU)
    start = sphere_scene([[0.3, 1.1, 6.2], [1.8, 0.9, 6.8]], [0.9, 0.85], [[0.5, 0.4, 0.3], [0.3, 0.4, 0.5]],
                         device=CPU)
    return start, cam, cfg, inverse.render_once(truth, cam, cfg, 0)


def _close(a, b, what):
    a, b = np_(a), np_(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * (np.abs(b).max() + 1e-8), err_msg=what)


def test_train_step_tiled_matches_unsharded():
    """Two tiles' summed loss and gradient, and `train_step_tiled` on a
    one-rank mesh, against `inverse.train_step` on the whole image: loss,
    gradients and the ClippedAdam update to 1e-4·max; every frame through
    K1's and K5's row modes (their plain versions here)."""
    start, cam, cfg, target = _train_case()
    opt = inverse.ClippedAdam(1e-2, 10, 0.1, clip=1.0)
    params = inverse.extract_params(start)

    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss_r = inverse.loss_fn(p, start, cam, target, 0, cfg)
    grads_r = dict(zip(p, torch.autograd.grad(loss_r, list(p.values()))))
    tiles = [shard.tile_loss_and_grad(params, start, cam, target[r0:r0 + 16], 0, cfg, r0, 16) for r0 in (0, 16)]
    _close(sum(t[0] for t in tiles), loss_r, "loss")
    for k in params:
        _close(sum(t[1][k] for t in tiles), grads_r[k], f"grad {k}")
        assert grads_r[k].abs().max() > 0

    ref, _, loss_1 = inverse.train_step(params, opt.init(params), opt, start, cam, target, 0, cfg)
    ref = {k: v.clone() for k, v in ref.items()}
    one = Mesh(rank=0, size=1, device=CPU)
    got, _, loss_t = shard.train_step_tiled(params, opt.init(params), opt, start, cam, target, 0, cfg, one)
    _close(loss_t, loss_1, "loss")
    for k in params:
        _close(got[k], ref[k], f"params {k}")
        assert not torch.equal(got[k], params[k]), "the step moved nothing"


def test_train_step_tiled_needs_the_fused_frame():
    """With the pass pipeline the step differentiates `intersect`, which the
    port does not yet (ROADMAP Queue 1 #1): it raises, as `train_step`
    does."""
    start, cam, cfg, target = _train_case()
    opt = inverse.ClippedAdam(1e-2, 10, 0.1)
    params = inverse.extract_params(start)
    with pytest.raises(NotImplementedError, match="intersect is forward only"):
        shard.train_step_tiled(params, opt.init(params), opt, start, cam, target, 0,
                               dataclasses.replace(cfg, pipeline="pass"), Mesh(0, 1, CPU))


# ------------------------------------------------------ the argument checks

def _k2_args(rows=16, window_rows=None, row0=0):
    hl, oid = _anchors(row0, rows)
    ch = seeded_channel(torch.zeros((window_rows or rows + 16, W), dtype=torch.int32), 0)
    return (to_torch_camera(PREV), hl, hl, oid, ch, ch, 1.5)


K2_REFUSALS = {
    # (rows, history rows, keyword arguments, message): the JAX kernel's checks
    "rows_not_multiple": (12, 28, dict(image_height=H, row_base=0, hist_halo=8), "divisible by block_rows"),
    "halo_not_multiple": (16, 24, dict(image_height=H, row_base=0, hist_halo=4), "divisible by block_rows"),
    "halo_below_k": (16, 16, dict(image_height=H, row_base=0, hist_halo=0), r"hist_halo \(0\) < reprojection"),
    # ADVICE.md, reproject_kernel.py:211: a halo on a history that spans the
    # image (the JAX kernel reads the window shifted).
    "halo_full_span": (32, 48, dict(image_height=H, row_base=0, hist_halo=8), "need.*tile mode"),
    "halo_no_height": (32, 48, dict(hist_halo=8), "need.*tile mode"),
    "history_rows": (16, 24, dict(image_height=H, row_base=0, hist_halo=8), "expected 16 query rows"),
}


@pytest.mark.parametrize("case", list(K2_REFUSALS))
def test_reproject_tile_refusals(case):
    rows, window_rows, kw, msg = K2_REFUSALS[case]
    with pytest.raises(ValueError, match=msg):
        rk.reproject_window(*_k2_args(rows, window_rows), window=4, **kw)


def test_reproject_tile_refusals_match_jax():
    """The JAX kernel refuses the first three K2 cases too, and (its fault)
    takes the fourth as a full frame."""
    hl = jnp.zeros((16, W, 3))
    ch = JChannel(rgb=jnp.zeros((24, W, 3)), cnt=jnp.zeros((24, W)), oid=jnp.zeros((24, W), jnp.int32))
    for rows, halo, msg in ((12, 8, "divisible by block_rows"), (16, 4, "divisible by block_rows"),
                            (16, 0, "reprojection window K")):
        with pytest.raises(ValueError, match=msg):
            jrk.reproject_pallas(PREV, hl[:rows], hl[:rows], jnp.zeros((rows, W), jnp.int32), ch, ch, 1.5,
                                 window=4, block_rows=8, interpret=True, image_height=H, hist_halo=halo)


K8_REFUSALS = {
    "rows_not_multiple": (dict(rows=12, hist_halo=8, block_rows=8), "divisible by block_rows"),
    "halo_not_multiple": (dict(rows=16, hist_halo=4, block_rows=8), "divisible by block_rows"),
    "halo_below_k": (dict(rows=16, hist_halo=0, block_rows=8), r"hist_halo \(0\) < reprojection"),
    "rows_outside": (dict(row_base=24, rows=16, hist_halo=8, block_rows=8), "outside the 32-row image"),
    "halo_without_rows": (dict(hist_halo=8), "need rows"),
}


@pytest.mark.parametrize("case", list(K8_REFUSALS))
def test_frame_hist_tile_refusals(case):
    kw, msg = K8_REFUSALS[case]
    with pytest.raises(ValueError, match=msg):
        fh.tile_window_k(RenderConfig(width=W, height=H), **kw)


def test_frame_hist_auto_block_rows_divides_rows():
    """ADVICE.md, frame_hist.py:248: with no block_rows, the JAX kernel takes
    min(32, rows) rows at 64 wide and then refuses 40 rows (40 % 32); the
    port takes the largest multiple of 8 dividing rows and the halo."""
    cfg = RenderConfig(width=W, height=64)
    assert fh.auto_block_rows(cfg, 40, 8) == 8
    assert fh.auto_block_rows(cfg, 32, 16) == 16
    assert fh.auto_block_rows(cfg, 64, 32) == 32
    assert fh.auto_block_rows(cfg) == 32
    assert fh.tile_window_k(cfg, None, 8, 40, 8) == 4
    with pytest.raises(ValueError, match="divisible by block_rows"):
        jfh.frame_hist_pallas(None, None, None, None, None, 0, JConfig(width=W, height=64), interpret=True,
                              row_base=8, rows=40, hist_halo=8)


def test_render_frame_tiled_refusals():
    scene = default_scene(device=CPU)
    cam = _pan()[0]
    cfg = RenderConfig(width=W, height=30, pipeline="fused")
    with pytest.raises(ValueError, match="does not divide over 4 ranks"):
        shard.render_frame_tiled(scene, cam, pipeline.init_history(cfg, cam), 0, cfg, Mesh(0, 4, CPU))
    cfg = dataclasses.replace(cfg, height=H)
    with pytest.raises(ValueError, match="this rank's is 32"):
        shard.render_frame_tiled(scene, cam, shard.tile_window(pipeline.init_history(cfg, cam), 0, 16, 0), 0,
                                 cfg, Mesh(0, 1, CPU))
