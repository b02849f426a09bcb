"""PyTorch port, the multi-process path of the sharded renderer and trainer
(parallel/multihost.py, parallel/mesh.py, parallel/shard.py) on the CPU.

The main test starts 2 processes of this file, joined into one gloo
process group by `initialize_from_env` through the KPT_* launch contract
(tests/test_multihost.py's, which only sums across the processes). Each
rank holds 16 rows of a 64×32 image (block-aligned, so the fused frames run
the tile modes' plain versions, the fallback warning an error), renders two
split and two mono frames from a populated history through
`render_frame_tiled` (one halo exchange a frame) and takes one
`train_step_tiled` (one all-reduce). Rank 0 gathers the rows
(`gather_rows`) and holds them against the unsharded frames and the
unsharded `train_step` at the JAX package's own bars (image 1e-5, history
1e-4, the update 1e-4·max), then prints what it measured for this test to
hold again. The other tests run the single-process branches."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import warnings

import pytest
import torch

from kylespathtracer_tpu_torch.parallel import mesh as mesh_mod
from kylespathtracer_tpu_torch.parallel import multihost, shard
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.render.pipeline import History, init_history
from kylespathtracer_tpu_torch.utils.config import RenderConfig

W, H = 64, 32
CPU = torch.device("cpu")
KPT_ENV = ("KPT_COORDINATOR", "KPT_NUM_PROCESSES", "KPT_PROCESS_ID")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cases():
    """(scene, cameras of a 3-frame pan, populated start history, train
    case), built alike on every rank."""
    from _torch_helpers import seeded_channel
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene

    scene = default_scene(device=CPU)
    cams = [Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=CPU),
            Camera.create(loc=(3.01, 1.995, -3.005), orient=(-0.02, 0.703), device=CPU),
            Camera.create(loc=(3.02, 1.99, -3.01), orient=(-0.04, 0.706), device=CPU)]
    oid = fk.frame_forward_plain(scene, cams[0], 0, RenderConfig(width=W, height=H))["oid"]
    hist = History(seeded_channel(oid, 1), seeded_channel(oid, 2), cams[0])
    cam_t = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0), device=CPU)
    cfg_t = RenderConfig(width=W, height=H, pipeline="fused", soft_shadows=0.05)
    truth = sphere_scene([[0.0, 1.0, 6.0], [2.0, 1.0, 7.0]], [1.0, 0.8], [[0.6, 0.3, 0.2], [0.2, 0.5, 0.6]],
                         device=CPU)
    start = sphere_scene([[0.3, 1.1, 6.2], [1.8, 0.9, 6.8]], [0.9, 0.85], [[0.5, 0.4, 0.3], [0.3, 0.4, 0.5]],
                         device=CPU)
    return scene, cams, hist, (start, cam_t, cfg_t, inverse.render_once(truth, cam_t, cfg_t, 0))


def _worker() -> None:
    """One rank of the 2-process run (see the module docstring)."""
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.render.pipeline import render_frame

    assert multihost.initialize_from_env(device="cpu"), "the environment did not ask for processes"
    info = multihost.process_info()
    assert info["process_count"] == 2 and info["backend"] == "gloo", info
    mesh = multihost.global_mesh(device="cpu")
    rows = H // mesh.size
    scene, cams, hist0, (start, cam_t, cfg_t, target) = _cases()
    report = {"rank": mesh.rank}
    for fusion in ("split", "mono"):
        cfg = RenderConfig(width=W, height=H, pipeline="fused", temporal_fusion=fusion)
        hist_t, hist_r = mesh_mod.shard_image_pytree(hist0, mesh, H), hist0
        assert hist_t.diffuse.cnt.shape == (rows, W)
        for i, cam in enumerate(cams[1:], start=1):
            with warnings.catch_warnings():
                warnings.filterwarnings("error", message="fused tiled path")
                img_t, hist_t = shard.render_frame_tiled(scene, cam, hist_t, i, cfg, mesh)
            img_r, hist_r = render_frame(scene, cam, hist_r, i, cfg)
        img, hist = mesh_mod.gather_rows((img_t, hist_t), mesh, rows)
        if mesh.rank == 0:
            report[fusion] = {
                "image": (img - img_r).abs().max().item(),
                "history": max((getattr(hist, n).rgb - getattr(hist_r, n).rgb).abs().max().item()
                               for n in ("diffuse", "specular")),
                "count": max((getattr(hist, n).cnt - getattr(hist_r, n).cnt).abs().max().item()
                             for n in ("diffuse", "specular")),
                "oid_equal": bool(torch.equal(hist.diffuse.oid, hist_r.diffuse.oid)),
                "max_count": hist_r.diffuse.cnt.max().item(),
            }

    opt = inverse.ClippedAdam(1e-2, 10, 0.1, clip=1.0)
    params = inverse.extract_params(start)
    got, _, loss = shard.train_step_tiled(params, opt.init(params), opt, start, cam_t, target[
        mesh.rank * rows:(mesh.rank + 1) * rows], 0, cfg_t, mesh)
    if mesh.rank == 0:
        ref, _, loss_r = inverse.train_step(params, opt.init(params), opt, start, cam_t, target, 0,
                                            cfg_t)
        report["train"] = {"loss": abs(loss.item() - loss_r.item()) / abs(loss_r.item()), **{
            k: (got[k] - ref[k]).abs().max().item() / (ref[k].abs().max().item() + 1e-8) for k in params}}
        report["moved"] = all(not torch.equal(got[k], params[k]) for k in params)
        print("MULTIHOST " + json.dumps(report), flush=True)
    torch.distributed.destroy_process_group()
    print("RANK_OK", flush=True)


def test_two_process_gloo_render_and_train():
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items() if k not in KPT_ENV}
        env.update(KPT_COORDINATOR=f"127.0.0.1:{port}", KPT_NUM_PROCESSES="2", KPT_PROCESS_ID=str(pid),
                   GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2",
                   PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__)], env=env, cwd=root,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240) + (p,))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out, err, p in outs:
        assert p.returncode == 0, f"a rank failed:\n{out}\n{err[-3000:]}"
        assert "RANK_OK" in out, out
    line = next(ln for ln in outs[0][0].splitlines() if ln.startswith("MULTIHOST "))
    report = json.loads(line.split(" ", 1)[1])
    for fusion in ("split", "mono"):
        r = report[fusion]
        assert r["image"] <= 1e-5 and r["history"] <= 1e-4 and r["count"] <= 1e-4, r
        assert r["oid_equal"] and r["max_count"] > 2, r
    assert all(v <= 1e-4 for v in report["train"].values()), report["train"]
    assert report["moved"]


def test_initialize_from_env_single_process(monkeypatch):
    """No KPT_* variables: one process, nothing to initialize; part of them:
    the JAX code's refusal."""
    for k in KPT_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not multihost.initialize_from_env(device="cpu")
    assert multihost.process_info() == {"process_index": 0, "process_count": 1, "local_devices": 1,
                                        "global_devices": 1, "backend": None}
    monkeypatch.setenv("KPT_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="KPT_COORDINATOR, KPT_NUM_PROCESSES and KPT_PROCESS_ID"):
        multihost.initialize_from_env(device="cpu")
    assert not torch.distributed.is_initialized()


def test_mesh_without_a_process_group():
    """One rank: the whole image, collectives that return their inputs, no
    halo; a rank's rows cut by `shard_image_pytree` for any rank and size."""
    mesh = multihost.global_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1, CPU)
    assert mesh_mod.make_mesh().device.type == "cuda"  # the card unless asked
    hist = _ramp_history()
    assert torch.equal(mesh_mod.shard_image_pytree(hist, mesh, H).diffuse.rgb, hist.diffuse.rgb)
    half = mesh_mod.shard_image_pytree(hist, mesh_mod.Mesh(rank=1, size=2, device=CPU), H)
    assert torch.equal(half.diffuse.rgb, hist.diffuse.rgb[16:]) and half.camera.loc is hist.camera.loc
    assert torch.equal(mesh_mod.gather_rows(hist, mesh, H).diffuse.rgb, hist.diffuse.rgb)
    assert shard.exchange_halo(hist, mesh, 0) is hist
    (s,) = mesh.all_reduce_sum([torch.ones(3)])
    assert torch.equal(s, torch.ones(3))
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        mesh_mod.shard_image_pytree(hist, mesh_mod.Mesh(rank=0, size=3, device=CPU), H)


def _ramp_history() -> History:
    """A zero history whose diffuse rgb counts up through its elements."""
    hist = init_history(RenderConfig(width=W, height=H), Camera.create(device=CPU))
    rgb = torch.arange(H * W * 3, dtype=torch.float32).reshape(H, W, 3)
    return dataclasses.replace(hist, diffuse=dataclasses.replace(hist.diffuse, rgb=rgb))


def test_tile_window_is_what_the_exchange_assembles():
    """`tile_window` of a whole history: the tile's rows with `halo` rows of
    each neighbour, zeros beyond the image, for every tile of 4."""
    hist = _ramp_history()
    rgb = hist.diffuse.rgb
    for r in range(4):
        win = shard.tile_window(hist, 8 * r, 8, 8).diffuse.rgb
        assert win.shape == (24, W, 3)
        lo, hi = max(8 * r - 8, 0), min(8 * r + 16, H)
        assert torch.equal(win[lo - (8 * r - 8):hi - (8 * r - 8)], rgb[lo:hi])
        assert not win[:lo - (8 * r - 8)].any() and not win[hi - (8 * r - 8):].any()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _worker()
