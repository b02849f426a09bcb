"""The plain reference against the program at a tiny size on the CPU, where
the program runs its kernels' plain versions; and, on a card, against the
kernels themselves.

    python -m pytest kpt_bench/tests -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kpt_bench import scenes
from kpt_bench.kinds.temporal import _hist_dict, compare
from kpt_bench.reference import adam as ref_adam
from kpt_bench.reference import frame as rf

W, H = 32, 16
RC = dict(width=W, height=H, fov=1.5, gloss=5.0, smp=1, biased=True, soft_shadows=0.0, brightness=10.0,
          reproject_window=4, temporal=16, pipeline="fused")


def _port_scene(tree, device="cpu"):
    from kylespathtracer_tpu_torch.scene.types import scene_from_numpy

    return scene_from_numpy(tree, device=device)


def _frames(device, n):
    """n split temporal frames of the program along the pose spline, each
    with the reference's frame from the same previous history."""
    from kylespathtracer_tpu_torch.render.camera import Camera
    from kylespathtracer_tpu_torch.render.pipeline import init_history, render_frame
    from kpt_bench.harness import port_config

    rc = dict(RC, width=64, height=32) if device != "cpu" else RC
    tree = scenes.default_scene()
    scene, cfg, sc = _port_scene(tree, device), port_config(rc), rf.scene_tables(tree, device)
    cams = [scenes.pose_spline(0.05 * (100 + i)) for i in range(n)]
    cam = lambda i: Camera(torch.tensor(cams[i][0], device=device), torch.tensor(cams[i][1], device=device))
    hist = init_history(cfg, cam(0))
    out = []
    for i in range(n):
        img, new = render_frame(scene, cam(i), hist, 5000 + i, cfg)
        ref_img, ref_new = rf.temporal_frame(sc, cam(i).loc, cam(i).orient, _hist_dict(hist), 5000 + i, rc)
        out.append((img, _hist_dict(new), ref_img, ref_new))
        hist = new
    return out


def test_temporal_frame_is_bitwise_the_programs_plain_frame():
    for img, new, ref_img, ref_new in _frames("cpu", 4):
        assert torch.equal(img, ref_img)
        for k in ("d", "s"):
            for f in ("rgb", "cnt", "oid"):
                assert torch.equal(new[k][f], ref_new[k][f])


def test_loss_and_gradient_match_the_programs_plain_k6():
    from kylespathtracer_tpu_torch.render.camera import Camera
    from kylespathtracer_tpu_torch.ops import loss_kernel as lk
    from kpt_bench.harness import port_config

    prob = scenes.recovery_scenes(10, 5, 2**31 + 77, 0.35)
    rc = dict(RC, soft_shadows=0.003)
    cam = Camera(torch.tensor(prob["cam_loc"][3]), torch.tensor(prob["cam_orient"][3]))
    target = rf.fresh_image(rf.scene_tables(prob["truth"], "cpu"), cam.loc, cam.orient, 1004, rc, 5)
    lval, (ds, _) = lk.loss_and_grad(_port_scene(prob["start"]), cam, 1004,
                                     port_config(rc, no_history=True), target=target, keys=("spheres", "alb_const"))
    sc = rf.scene_tables(prob["start"], "cpu", grad_keys=("spheres", "alb_const"))
    rl, rg = rf.mse_loss_and_grad(sc, cam.loc, cam.orient, 1004, rc, target, block_rows=5)
    assert float(rl) == pytest.approx(float(lval), rel=1e-6)
    for k, d in (("spheres", ds["spheres"]), ("alb_const", ds["alb_const"])):
        assert torch.allclose(rg[k], d, rtol=1e-4, atol=1e-6 * float(d.abs().max()))


def test_batched_targets_match_single_frames():
    prob = scenes.recovery_scenes(10, 5, 11, 0.35)
    sc = rf.scene_tables(prob["truth"], "cpu")
    loc, orient = torch.tensor(prob["cam_loc"][0]), torch.tensor(prob["cam_orient"][0])
    rc = dict(RC, soft_shadows=0.003)
    batch = rf.fresh_image(sc, loc, orient, torch.arange(1000, 1003), rc, 7)
    for s in range(3):
        assert torch.allclose(batch[s], rf.fresh_image(sc, loc, orient, 1000 + s, rc, 16), atol=1e-6)


def test_adam_matches_the_programs_clipped_adam():
    from kylespathtracer_tpu_torch.diff.inverse import ClippedAdam

    g = torch.Generator().manual_seed(3)
    p0 = {"spheres": torch.randn(4, 4, generator=g), "alb_const": torch.rand(6, 3, generator=g)}
    opt = ClippedAdam(0.02, 798, 0.03, clip=1.0)
    state = opt.init({k: v.clone() for k, v in p0.items()})
    ref = ref_adam.Adam(p0, 0.02, 798, 0.03, 1.0)
    params = state.params
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * 0.7 for k, v in p0.items()}
        params = opt.update(grads, state, params)
        ref.update(grads)
    for k in p0:
        assert torch.allclose(params[k], ref.params[k], rtol=1e-5, atol=1e-6)
    # Resumed from the program's state (as the window's last step is), the
    # reference takes the program's next step.
    sd = state.state_dict()
    m = {k: sd["adam"]["state"][i]["exp_avg"] for i, k in enumerate(sd["params"])}
    v = {k: sd["adam"]["state"][i]["exp_avg_sq"] for i, k in enumerate(sd["params"])}
    resumed = ref_adam.Adam({k: t.clone() for k, t in params.items()}, 0.02, 798, 0.03, 1.0)
    resumed.resume(m, v, 3)
    grads = {k: torch.randn(t.shape, generator=g) * 0.7 for k, t in p0.items()}
    params = opt.update(grads, state, params)
    resumed.update(grads)
    for k in p0:
        assert torch.allclose(params[k], resumed.params[k], rtol=1e-5, atol=1e-6)


def test_inputs_match_the_programs_builders():
    from kylespathtracer_tpu_torch.diff.inverse import recovery_scenes
    from kylespathtracer_tpu_torch.render.camera import camera_pose_spline
    from kylespathtracer_tpu_torch.scene.scene import default_scene

    port = default_scene(device="cpu")
    tree = scenes.default_scene()
    for k in ("planes", "spheres", "boxes", "light_color"):
        assert np.array_equal(getattr(port, k).numpy(), tree[k])
    for k in ("s0", "s1", "freq", "alb_const", "alb_scale", "emission", "en_const", "en_scale"):
        assert np.array_equal(getattr(port.materials, k).numpy(), tree["materials"][k])
    gt, start, cams = recovery_scenes(10, 5, 2**31 + 9, 0.35, device="cpu")
    prob = scenes.recovery_scenes(10, 5, 2**31 + 9, 0.35)
    for port_s, key in ((gt, "truth"), (start, "start")):
        assert np.array_equal(port_s.spheres.numpy(), prob[key]["spheres"])
        assert np.array_equal(port_s.materials.alb_const.numpy(), prob[key]["materials"]["alb_const"])
    assert np.array_equal(cams.loc.numpy(), prob["cam_loc"]) and np.array_equal(cams.orient.numpy(), prob["cam_orient"])
    for t in (0.0, 3.35, 11.95):
        loc, orient = camera_pose_spline(t)
        assert np.allclose(loc.numpy(), scenes.pose_spline(t)[0], atol=1e-6)
        assert np.allclose(orient.numpy(), scenes.pose_spline(t)[1], atol=1e-6)


@pytest.mark.cuda
def test_kernels_against_the_reference_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 have no CPU mode")
    for img, new, ref_img, ref_new in _frames("cuda", 3):
        far = compare(img, new, ref_img, ref_new)
        assert far["oid_mismatch"] < 1e-2 and far["image_far"] < 2e-2, far
