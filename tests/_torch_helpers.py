"""Shared helpers of the PyTorch-port tests: carry JAX objects across to the
port as numpy trees, through the port's own converters."""

from __future__ import annotations

import dataclasses

import numpy as np

from kylespathtracer_tpu_torch.render.camera import camera_from_numpy
from kylespathtracer_tpu_torch.render.passes import channel_from_numpy
from kylespathtracer_tpu_torch.render.pipeline import history_from_numpy
from kylespathtracer_tpu_torch.scene.types import scene_from_numpy

_MAT_FIELDS = ("s0", "s1", "freq", "alb_const", "alb_scale", "emission",
               "en_const", "en_scale", "bsdf", "ior")
_SCENE_FIELDS = ("planes", "plane_ids", "spheres", "sphere_ids", "boxes",
                 "box_ids", "light_color")


def scene_tree(scene) -> dict:
    m = scene.materials
    tree = {k: np.asarray(getattr(scene, k)) for k in _SCENE_FIELDS}
    tree["materials"] = {
        k: np.asarray(getattr(m, k)) for k in _MAT_FIELDS
        if getattr(m, k) is not None
    }
    tree["light_index"] = int(scene.light_index)
    return tree


def camera_tree(cam) -> dict:
    return {"loc": np.asarray(cam.loc), "orient": np.asarray(cam.orient)}


def channel_tree(ch) -> dict:
    return {"rgb": np.asarray(ch.rgb), "cnt": np.asarray(ch.cnt),
            "oid": np.asarray(ch.oid)}


def to_torch_scene(scene, device="cpu"):
    return scene_from_numpy(scene_tree(scene), device)


def to_torch_camera(cam, device="cpu"):
    return camera_from_numpy(camera_tree(cam), device)


def to_torch_channel(ch, device="cpu"):
    return channel_from_numpy(channel_tree(ch), device)


def to_torch_history(hist, device="cpu"):
    return history_from_numpy({
        "diffuse": channel_tree(hist.diffuse),
        "specular": channel_tree(hist.specular),
        "camera": camera_tree(hist.camera),
    }, device)


def to_torch_config(cfg):
    """The port's RenderConfig with the JAX config's field values."""
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    return RenderConfig(**dataclasses.asdict(cfg))


def np_(t) -> np.ndarray:
    """A torch tensor or JAX array as a numpy array."""
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _default_path_case():
    from kylespathtracer_tpu.render.camera import Camera
    from kylespathtracer_tpu.scene import default_scene
    from kylespathtracer_tpu.utils.config import RenderConfig

    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    return default_scene(), cam, RenderConfig(width=64, height=48, spp=2, max_depth=3)


def _dielectric_path_case():
    """The dielectric sphere scene of tests/test_path_kernel.py:49-56."""
    from kylespathtracer_tpu.render.camera import Camera
    from kylespathtracer_tpu.scene.scene import sphere_scene
    from kylespathtracer_tpu.utils.config import RenderConfig

    scene = sphere_scene(
        centers=[[0.0, 1.0, 6.0], [2.0, 1.2, 7.0], [-2.0, 1.0, 6.5]],
        radii=[1.0, 0.8, 0.9],
        albedos=[[0.7, 0.3, 0.2], [0.9, 0.9, 0.9], [0.95, 0.95, 0.95]],
        kinds=[0, 2, 3],  # diffuse, mirror, dielectric
    )
    cam = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0))
    return scene, cam, RenderConfig(width=48, height=32, spp=2, max_depth=4)


# The path tracer's JAX comparison cases, as tests/test_path_kernel.py runs
# them: (JAX scene, JAX camera, JAX RenderConfig).
PATH_CASES = {"default": _default_path_case, "dielectric": _dielectric_path_case}


def assert_path_bar(img, ref) -> None:
    """tests/test_path_kernel.py:38-41: finite, median |Δ| < 1e-6, under
    0.2% of the components beyond 1e-3."""
    d = np.abs(img - ref)
    assert np.isfinite(img).all()
    assert np.median(d) < 1e-6
    assert (d > 1e-3).mean() < 0.002, f"{(d > 1e-3).mean():.3%} differ"


def pan_cameras(n: int):
    """JAX cameras of an n-frame pan from (3,2,-3)/(0,0.7): per frame ~1.5 px
    up and ~0.5 px sideways at 32 rows, plus a small translation that
    engages the velocity clamp → n + 1 cameras."""
    import jax.numpy as jnp

    from kylespathtracer_tpu.render.camera import Camera

    cams = [Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))]
    for _ in range(n):
        c = cams[-1]
        cams.append(c.replace(orient=c.orient + jnp.asarray([-0.03, 0.004], jnp.float32),
                              loc=c.loc + jnp.asarray([0.001, -0.0015, 0.001], jnp.float32)))
    return cams


def populated_history(oid, camera):
    """A JAX History with numpy-seeded rgb in [0, 2) and integer counts in
    [0, 16] on the object IDs `oid` (i32[H,W]) that `camera` sees."""
    import jax.numpy as jnp

    from kylespathtracer_tpu.render.passes import Channel
    from kylespathtracer_tpu.render.pipeline import History

    H, W = oid.shape

    def channel(seed):
        r = np.random.default_rng(seed)
        return Channel(rgb=jnp.asarray(r.uniform(0.0, 2.0, (H, W, 3)), jnp.float32),
                       cnt=jnp.asarray(r.integers(0, 17, (H, W)).astype(np.float32)), oid=oid)

    return History(diffuse=channel(1), specular=channel(2), camera=camera)


def sphere_case():
    """The JAX sphere scene of the mono-frame tests: three spheres over the
    floor, no rounded box (the JAX kernels' interpret mode compiles the
    box's 26 candidates for minutes)."""
    from kylespathtracer_tpu.scene.scene import sphere_scene

    return sphere_scene([[5.5, 1.0, 0.0], [4.0, 0.5, 1.0], [6.0, 2.5, -1.5]], [1.0, 0.5, 0.7],
                        [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]])


def history_at(scene, camera, cfg):
    """`populated_history` on the object IDs `camera` sees (JAX's plain
    frame, frame 0)."""
    import jax.numpy as jnp

    from kylespathtracer_tpu.ops import frame_kernel as jfk

    return populated_history(jfk.frame_forward_jnp(scene, camera, jnp.int32(0), cfg)["oid"], camera)


def pass_pan_matches_jax(kw: dict, width: int = 32, height: int = 16) -> None:
    """`render_frame` with `pipeline="pass"` and the config fields `kw`,
    port against JAX frame by frame over `pan_cameras(3)` from a
    `populated_history`: image and both history channels to atol 2e-4
    (rtol 1e-5), oid exact."""
    import jax
    import jax.numpy as jnp
    import torch

    from kylespathtracer_tpu.render import gbuffer as jgb
    from kylespathtracer_tpu.render import pipeline as jpl
    from kylespathtracer_tpu.scene import default_scene
    from kylespathtracer_tpu.utils.config import RenderConfig
    from kylespathtracer_tpu_torch.render import pipeline

    tol = dict(atol=2e-4, rtol=1e-5)
    scene = default_scene()
    cfg = RenderConfig(width=width, height=height, pipeline="pass", **kw)
    cams = pan_cameras(3)
    hist_j = populated_history(jgb.geometry_pass(scene, cams[0], cfg).obj_id, cams[0])
    jframe = jax.jit(jpl.render_frame, static_argnames=("config",))
    scene_t, cfg_t, hist_t = to_torch_scene(scene), to_torch_config(cfg), to_torch_history(hist_j)
    for i, cam in enumerate(cams[1:], start=1):
        img_j, hist_j = jframe(scene, cam, hist_j, jnp.int32(i), config=cfg)
        img_t, hist_t = pipeline.render_frame(scene_t, to_torch_camera(cam), hist_t, i, cfg_t)
        assert img_t.shape == (height, width, 3) and torch.isfinite(img_t).all()
        np.testing.assert_allclose(np_(img_t), np.asarray(img_j), err_msg=f"image {i}", **tol)
        for name in ("diffuse", "specular"):
            a, b = getattr(hist_t, name), getattr(hist_j, name)
            np.testing.assert_allclose(np_(a.rgb), np.asarray(b.rgb), err_msg=f"{name} rgb {i}", **tol)
            np.testing.assert_allclose(np_(a.cnt), np.asarray(b.cnt), err_msg=f"{name} cnt {i}", **tol)
            np.testing.assert_array_equal(np_(a.oid), np.asarray(b.oid))
    top = np_(hist_t.diffuse.cnt).max()
    assert top == 1.0 if cfg.no_history else top > 2, "history not carried"


def _stitch(parts: list):
    """Tiles' History objects stacked by rows in order → one History."""
    from kylespathtracer_tpu_torch.render.passes import Channel
    from kylespathtracer_tpu_torch.render.pipeline import History
    import torch

    def cat(get):
        return torch.cat([get(h) for h in parts])

    return History(
        diffuse=Channel(cat(lambda h: h.diffuse.rgb), cat(lambda h: h.diffuse.cnt), cat(lambda h: h.diffuse.oid)),
        specular=Channel(cat(lambda h: h.specular.rgb), cat(lambda h: h.specular.cnt),
                         cat(lambda h: h.specular.oid)),
        camera=parts[0].camera)


def render_tiles(scene, camera, hist, frame, config, n: int, halo_rows: int = 8):
    """The n tiles of `parallel.shard.render_frame_tiled`, one at a time in
    this process, each on the window `shard.tile_window` cuts from the
    whole (port) history → the stitched (image, History)."""
    import torch

    from kylespathtracer_tpu_torch.parallel import shard

    rows = config.height // n
    halo = min(halo_rows, rows) if n > 1 else 0
    outs = [shard._render_row_block(scene, camera, shard.tile_window(hist, r * rows, rows, halo), frame, config,
                                    r * rows, rows, buffer_row0=r * rows - halo, halo=halo) for r in range(n)]
    return torch.cat([o[0] for o in outs]), _stitch([o[1] for o in outs])


def seeded_channel(oid, seed: int):
    """A port Channel with numpy-seeded rgb in [0, 2) and integer counts in
    [0, 16] on the object IDs `oid` (a torch i32[rows, W])."""
    import torch

    from kylespathtracer_tpu_torch.render.passes import Channel

    r = np.random.default_rng(seed)
    rows, width = oid.shape
    return Channel(rgb=torch.from_numpy(r.uniform(0.0, 2.0, (rows, width, 3)).astype(np.float32)),
                   cnt=torch.from_numpy(r.integers(0, 17, (rows, width)).astype(np.float32)),
                   oid=oid.clone())


def jax_channel(ch):
    """A port Channel as a JAX Channel."""
    import jax.numpy as jnp

    from kylespathtracer_tpu.render.passes import Channel

    return Channel(rgb=jnp.asarray(np_(ch.rgb)), cnt=jnp.asarray(np_(ch.cnt)), oid=jnp.asarray(np_(ch.oid)))


def frame_anchors(cam_j, width: int, height: int, row0: int, rows: int):
    """(hit points f32[rows,W,3], oid i32[rows,W]) of image rows [row0,
    row0+rows) of the default scene seen by the JAX camera `cam_j`, through
    the port's plain frame (torch, on the CPU)."""
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.render.camera import ray_dirs_window
    from kylespathtracer_tpu_torch.scene.scene import default_scene
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    cam = to_torch_camera(cam_j)
    cfg = RenderConfig(width=width, height=height, pipeline="fused")
    out = fk.frame_forward_plain(default_scene(device="cpu"), cam, 3, cfg, row0, rows)
    return cam.loc + ray_dirs_window(cam, width, height, row0, rows, cfg.fov) * out["depth"][..., None], out["oid"]
