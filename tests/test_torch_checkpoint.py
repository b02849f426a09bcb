"""PyTorch port, checkpoint and resume (utils/checkpoint.py) on the CPU:

- a `History` round trip (tests/test_app.py:104-116), every tensor equal;
- the optimizer state (`ClippedAdam`'s `AdamState`): two more steps after
  a restore into a fresh `init` bitwise the uninterrupted ones;
- the newest-step scan, `FileNotFoundError` on an empty directory, a file
  that needs pickling refused (`weights_only=True`), and no `step_{n}` left
  by a write that fails;
- `run_recovery`'s kill and resume with the JAX test's own arguments
  (tests/test_inverse_resume.py:14-17): equal to the port's uninterrupted
  run (rtol 1e-6) and to the JAX package's (rtol 1e-4); a torn pair falls
  back to a fresh start;
- the sharded trainer: `train_step_tiled` on an in-process mesh
  checkpointed after step 1 and resumed in fresh objects, step 2 bitwise
  the uninterrupted one (the counterpart of tests/test_sharding.py:126).
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from kylespathtracer_tpu.diff import inverse as jinv
from kylespathtracer_tpu_torch.diff import inverse
from kylespathtracer_tpu_torch.parallel import shard
from kylespathtracer_tpu_torch.parallel.mesh import Mesh
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.render.pipeline import History, init_history
from kylespathtracer_tpu_torch.scene.scene import sphere_scene
from kylespathtracer_tpu_torch.utils import checkpoint as ck
from kylespathtracer_tpu_torch.utils.config import RenderConfig

CPU = torch.device("cpu")
# tests/test_inverse_resume.py:14-17.
KW = dict(num_spheres=2, steps=4, width=32, height=24, views=1, seed=3, betas=(0.05, 0.02))


def _history() -> History:
    rng = np.random.default_rng(0)
    h = init_history(RenderConfig(width=8, height=8), Camera.create(loc=(1.0, 2.0, 3.0), device=CPU))
    ch = lambda c: dataclasses.replace(
        c, rgb=torch.from_numpy(rng.random((8, 8, 3), np.float32)),
        cnt=torch.from_numpy(rng.integers(0, 17, (8, 8)).astype(np.float32)),
        oid=torch.from_numpy(rng.integers(-1, 9, (8, 8)).astype(np.int32)))
    return dataclasses.replace(h, diffuse=ch(h.diffuse), specular=ch(h.specular))


def test_history_round_trip(tmp_path):
    h = _history()
    assert ck.save(tmp_path, 7, {"history": h}) == str(tmp_path.resolve() / "step_7")
    like = {"history": init_history(RenderConfig(width=8, height=8), Camera.create(device=CPU))}
    step, state = ck.restore(tmp_path, like=like)
    got = state["history"]
    assert step == 7 and isinstance(got, History) and isinstance(got.camera, Camera)
    assert got.diffuse.rgb.shape == (8, 8, 3)
    for name in ("diffuse", "specular"):
        for k in ("rgb", "cnt", "oid"):
            a, b = getattr(getattr(got, name), k), getattr(getattr(h, name), k)
            assert a.dtype == b.dtype and torch.equal(a, b), f"{name}.{k}"
    assert torch.equal(got.camera.loc, h.camera.loc) and torch.equal(got.camera.orient, h.camera.orient)
    _, tree = ck.restore(tmp_path)  # no `like`: the saved tree
    assert torch.equal(tree["history"]["diffuse"]["cnt"], h.diffuse.cnt)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.normal(0, 1, tuple(v.shape)).astype(np.float32)) for k, v in params.items()}


def test_adam_state_round_trip(tmp_path):
    """Three steps, a checkpoint, two more steps; against a restore of the
    checkpoint into a fresh `init` and the same two steps: bitwise, with
    Adam's step count and the schedule's count restored."""
    opt = inverse.ClippedAdam(2e-2, 10, 0.03, clip=1.0)
    params = inverse.extract_params(sphere_scene([[0.0, 1.0, 6.0], [2.0, 1.0, 7.0]], [1.0, 0.8],
                                                 [[0.6, 0.3, 0.2], [0.2, 0.5, 0.6]], device=CPU))
    state = opt.init(params)
    for i in range(3):
        params = opt.update(_grads(params, i), state, params)
    ck.save(tmp_path, 3, {"params": params, "opt_state": state})
    ref = params
    for i in range(3, 5):
        ref = opt.update(_grads(ref, i), state, ref)
    ref = {k: v.clone() for k, v in ref.items()}

    fresh = inverse.extract_params(sphere_scene([[9.0, 9.0, 9.0], [8.0, 8.0, 8.0]], [0.5, 0.5],
                                                [[0.5, 0.5, 0.5]] * 2, device=CPU))
    step, restored = ck.restore(tmp_path, like={"params": fresh, "opt_state": opt.init(fresh)})
    got, st = restored["params"], restored["opt_state"]
    assert step == 3 and st.schedule.last_epoch == 3 and st.schedule._step_count == 4
    assert all(float(s["step"]) == 3.0 for s in st.adam.state.values())
    for i in range(3, 5):
        got = opt.update(_grads(got, i), st, got)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert st.adam.param_groups[0]["lr"] == state.adam.param_groups[0]["lr"]


def test_restore_takes_the_newest_step(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path)
    for s in (3, 10, 7):
        ck.save(tmp_path, s, {"x": torch.full((2,), float(s))})
    (tmp_path / "step_notes").write_text("not a step")
    assert ck.steps(tmp_path) == [3, 7, 10]
    step, state = ck.restore(tmp_path)
    assert step == 10 and torch.equal(state["x"], torch.full((2,), 10.0))
    assert ck.restore(tmp_path, step=3)[1]["x"][0] == 3.0


def test_restore_refuses_pickled_objects(tmp_path):
    torch.save({"obj": Mesh(rank=0, size=1, device=CPU)}, tmp_path / "step_1")
    with pytest.raises(pickle.UnpicklingError):
        ck.restore(tmp_path)


def test_failed_write_leaves_no_step(tmp_path, monkeypatch):
    def torn(obj, path):
        open(path, "wb").write(b"partial")
        raise OSError("killed")

    monkeypatch.setattr(ck.torch, "save", torn)
    with pytest.raises(OSError):
        ck.save(tmp_path, 1, {"x": torch.zeros(2)})
    assert ck.steps(tmp_path) == []


# ------------------------------------------------------------ run_recovery

@pytest.fixture(scope="module")
def full_run():
    return inverse.run_recovery(**KW, device="cpu")


def _same_run(got, want, rtol):
    for k in ("loss_initial", "loss_final", "err_position", "err_radius", "err_albedo"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    assert len(got["phases"]) == len(want["phases"])
    for a, b in zip(got["phases"], want["phases"]):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)


def test_recovery_kill_and_resume(tmp_path, full_run):
    """tests/test_inverse_resume.py:19-33 on the port; then the resumed run
    against the JAX package's uninterrupted run, as
    tests/test_torch_grad.py:283-298 holds run_recovery."""
    d = str(tmp_path / "ckpt")
    part = inverse.run_recovery(**KW, ckpt_dir=d, max_phases=1, device="cpu")
    assert part["completed_phases"] == 1
    resumed = inverse.run_recovery(**KW, ckpt_dir=d, resume=True, device="cpu")
    assert resumed["completed_phases"] == 2
    _same_run(resumed, full_run, 1e-6)
    _same_run(resumed, jinv.run_recovery(**KW), 1e-4)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["meta_1.json", "meta_2.json", "step_1",
                                                                      "step_2"]


def test_recovery_torn_pair_falls_back(tmp_path, full_run):
    """tests/test_inverse_resume.py:36-50 on the port: without its sidecar a
    step is passed over (here for a fresh start)."""
    d = tmp_path / "ckpt"
    inverse.run_recovery(**KW, ckpt_dir=str(d), max_phases=1, device="cpu")
    (d / "meta_1.json").unlink()
    resumed = inverse.run_recovery(**KW, ckpt_dir=str(d), resume=True, device="cpu")
    assert resumed["completed_phases"] == 2
    _same_run(resumed, full_run, 1e-6)


def test_recovery_resume_needs_a_directory():
    with pytest.raises(ValueError, match="ckpt_dir"):
        inverse.run_recovery(**KW, resume=True, device="cpu")


# --------------------------------------------------------- sharded resume

def test_train_step_tiled_resume_is_bitwise(tmp_path):
    """The train step of tests/test_torch_shard.py:_train_case on a one-rank
    in-process mesh (fused frame: K1's and K5's row modes, their plain
    versions here): (params, opt_state) checkpointed after step 1 and
    restored into fresh objects; step 2 from them equals the uninterrupted
    step 2 bitwise."""
    cam = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0), device=CPU)
    cfg = RenderConfig(width=32, height=16, pipeline="fused", soft_shadows=0.05)
    truth = sphere_scene([[0.0, 1.0, 6.0], [2.0, 1.0, 7.0]], [1.0, 0.8], [[0.6, 0.3, 0.2], [0.2, 0.5, 0.6]],
                         device=CPU)
    start = sphere_scene([[0.3, 1.1, 6.2], [1.8, 0.9, 6.8]], [0.9, 0.85], [[0.5, 0.4, 0.3], [0.3, 0.4, 0.5]],
                         device=CPU)
    target = inverse.render_once(truth, cam, cfg, 0)
    mesh = Mesh(rank=0, size=1, device=CPU)
    opt = inverse.ClippedAdam(1e-2, 10, 0.1, clip=1.0)
    params = inverse.extract_params(start)
    state = opt.init(params)
    params, state, _ = shard.train_step_tiled(params, state, opt, start, cam, target, 0, cfg, mesh)
    ck.save(tmp_path, 1, {"params": params, "opt_state": state})
    ref, _, loss_ref = shard.train_step_tiled(params, state, opt, start, cam, target, 1, cfg, mesh)
    ref = {k: v.clone() for k, v in ref.items()}

    fresh = inverse.extract_params(start)
    _, restored = ck.restore(tmp_path, like={"params": fresh, "opt_state": opt.init(fresh)})
    got, _, loss = shard.train_step_tiled(restored["params"], restored["opt_state"], opt, start, cam, target, 1,
                                          cfg, mesh)
    assert torch.equal(loss, loss_ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert not torch.equal(got["spheres"], fresh["spheres"]), "the steps moved nothing"
