"""PyTorch port, the application layer on the CPU, against the JAX package:

- the fly controller (`update_controller`) over 64 seeded input frames from
  the reference's start pose and from a pose at the pitch clamp and the yaw
  wrap with a velocity over the cap, step by step, atol 1e-6;
  `playback_cameras` against the JAX scan run op by op, and against the
  compiled scan off the dead stop's knife edge (a reference quirk, held by
  its own test), atol 1e-6; the three controller cases of
  tests/test_app.py:20-58 on the port;
- the fly-cam's `parse_keys` equal to JAX's on tests/test_app.py's byte
  strings and on seeded random ones; `frame_to_ansi` the same string;
  `TerminalPreview` writes its caption;
- `fly_step` at 32×24 (pass pipeline) against JAX's: the state within 1e-6,
  the image within the temporal-frame bar (atol 2e-4);
- `render_animation`: resume after a checkpoint bitwise the uninterrupted
  run (tests/test_app.py:174-200 on the port), and its preview;
- the CLI in process with `--device cpu`: `info`, `invert --ckpt-dir …
  --resume`, `render --checkpoint-every 2 --resume`, `fly` without a tty;
- utils/metrics.py: `Timer`, `time_fn`, `profiler_trace`'s trace file.
"""

import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import np_, to_torch_config, to_torch_history, to_torch_scene
from kylespathtracer_tpu.app import controller as jctl
from kylespathtracer_tpu.app import driver as jdriver
from kylespathtracer_tpu.app import fly as jfly
from kylespathtracer_tpu.render import pipeline as jpipeline
from kylespathtracer_tpu.scene import default_scene as jdefault_scene
from kylespathtracer_tpu.utils import preview as jpreview
from kylespathtracer_tpu.utils.config import RenderConfig as JConfig
from kylespathtracer_tpu_torch.app import cli, driver, fly
from kylespathtracer_tpu_torch.app import controller as ctl
from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.scene.scene import default_scene
from kylespathtracer_tpu_torch.utils import metrics, preview
from kylespathtracer_tpu_torch.utils.config import RenderConfig

CPU = torch.device("cpu")
TOL = dict(atol=1e-6, rtol=0)


def _script(seed: int, n: int = 64):
    """n seeded input frames as numpy: moves in {-1, 0, 1}³ (diagonals
    included), drags of ~300 px (0.6 rad a frame at ROT_SPEED, so the pitch
    clamps and the yaw wraps), the button held on ~60% of the frames."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 2, (n, 3)).astype(np.float32),
            rng.normal(0.0, 300.0, (n, 2)).astype(np.float32),
            rng.random(n) < 0.6)


def _state_tree(st) -> dict:
    return {k: np.asarray(getattr(st, k)) for k in ("loc", "vel", "orient", "was_down")}


def _start_states():
    """(JAX state, port state) pairs: the reference's start pose, and a pose
    at the pitch clamp and the yaw wrap, mouse held, moving over the cap."""
    plain = jctl.ControllerState.create()
    edge = jctl.ControllerState.create(loc=(1.0, 2.0, 3.0), orient=(1.5, 3.1)).replace(
        vel=jnp.asarray([3.0, -1.0, 2.0], jnp.float32), was_down=jnp.asarray(True))
    return [(s, ctl.controller_state_from_numpy(_state_tree(s), CPU)) for s in (plain, edge)]


def _assert_state(got, want, what):
    for k, v in _state_tree(want).items():
        np.testing.assert_allclose(np_(getattr(got, k)), v, err_msg=f"{what}: {k}", **TOL)


@pytest.mark.parametrize("start", [0, 1], ids=["start_pose", "clamp_wrap_cap"])
def test_update_controller_matches_jax(start):
    jst, st = _start_states()[start]
    move, delta, down = _script(start)
    wrapped = clamped = 0
    for i in range(len(move)):
        jst = jctl.update_controller(jst, jctl.InputFrame.create(move[i], delta[i], down[i]))
        st = ctl.update_controller(st, ctl.InputFrame.create(move[i], delta[i], down[i], device=CPU))
        _assert_state(st, jst, f"frame {i}")
        assert st.loc.dtype == st.vel.dtype == st.orient.dtype == torch.float32
        wrapped += abs(float(st.orient[1])) > 2.5
        clamped += abs(float(st.orient[0])) == np.float32(gmath.HPI)
    assert wrapped and clamped, "the script reached neither the yaw wrap nor the pitch clamp"


def _playbacks(start: int, seed: int, forward: bool = False):
    """(JAX start state, JAX script, port cameras of `playback_cameras`) for
    a seeded script from start state `start`; `forward` holds w throughout."""
    jst, st = _start_states()[start]
    move, delta, down = _script(seed)
    if forward:
        move[:, 2] = 1.0
    jinputs = jctl.InputFrame(move=jnp.asarray(move), mouse_delta=jnp.asarray(delta), mouse_down=jnp.asarray(down))
    cams = driver.playback_cameras(st, ctl.InputFrame(torch.from_numpy(move), torch.from_numpy(delta),
                                                      torch.from_numpy(down)))
    assert cams.loc.shape == (64, 3) and cams.orient.shape == (64, 2)
    return jst, jinputs, cams


@pytest.mark.parametrize("start", [0, 1], ids=["start_pose", "clamp_wrap_cap"])
def test_playback_cameras_matches_jax(start):
    """Against JAX's scan run op by op (jax.disable_jit), as the port runs
    it: see test_dead_stop_is_a_knife_edge_from_rest for the compiled scan."""
    jst, jinputs, cams = _playbacks(start, 10 + start)
    with jax.disable_jit():
        jcams = jdriver.playback_cameras(jst, jinputs)
    np.testing.assert_allclose(np_(cams.loc), np.asarray(jcams.loc), **TOL)
    np.testing.assert_allclose(np_(cams.orient), np.asarray(jcams.orient), **TOL)


def test_playback_cameras_matches_compiled_jax():
    """Against JAX's compiled scan, from the moving start with w held, so
    that the speed never comes back to the dead stop's threshold (from rest
    the compiled scan parts from the op-by-op step on one rounding:
    test_dead_stop_is_a_knife_edge_from_rest)."""
    jst, jinputs, cams = _playbacks(1, 11, forward=True)
    jcams = jdriver.playback_cameras(jst, jinputs)
    speeds = torch.linalg.norm(torch.diff(cams.loc, dim=0), dim=-1)
    assert speeds.min() > 2 * ctl.ACCEL_SPEED
    np.testing.assert_allclose(np_(cams.loc), np.asarray(jcams.loc), **TOL)
    np.testing.assert_allclose(np_(cams.orient), np.asarray(jcams.orient), **TOL)


def test_dead_stop_is_a_knife_edge_from_rest():
    """A reference quirk: from rest, one step of any intent gives a speed
    of ACCEL_SPEED to within an ulp (the normalized intent times
    ACCEL_SPEED, rotated), and the dead stop `speed < ACCEL_SPEED`
    (main.cpp:283-293) decides on that ulp. So one rounding stops or moves
    the camera by ACCEL_SPEED: JAX's compiled step and its op-by-op step
    part there on the seeded scripts, and the port follows the op-by-op
    one. Each diagonal and axis from the start pose: the port's speed
    within an ulp of ACCEL_SPEED and its step equal to JAX's op by op."""
    accel = np.float32(ctl.ACCEL_SPEED)
    for move in [(0, 0, 1), (1, 0, 0), (1, 1, -1), (-1, 1, 1), (0, -1, 1), (1, 0, 1)]:
        jst, st = _start_states()[0]
        st = ctl.update_controller(st, ctl.InputFrame.create(move=move, device=CPU))
        jst = jctl.update_controller(jst, jctl.InputFrame.create(move=move))
        _assert_state(st, jst, f"move {move}")
        m = np.asarray(move, np.float64)
        assert abs(np.linalg.norm(m / max(np.linalg.norm(m), 1.0)) * accel - accel) <= np.spacing(accel)


def test_controller_cases_of_the_jax_tests():
    """tests/test_app.py:20-58 on the port: forward motion to the terminal
    speed; dead stop and speed cap; the mouse-look gate, clamp and wrap."""
    st = ctl.ControllerState.create(loc=(0.0, 0.0, 0.0), orient=(0.0, 0.0), device=CPU)
    forward = ctl.InputFrame.create(move=(0.0, 0.0, 1.0), device=CPU)
    for _ in range(200):
        st = ctl.update_controller(st, forward)
    assert abs(float(torch.linalg.norm(st.vel)) - ctl.ACCEL_SPEED / 0.1) < 1e-3
    assert float(st.loc[2]) > 10.0
    assert abs(float(st.loc[0])) < 1e-4 and abs(float(st.loc[1])) < 1e-4

    st = ctl.ControllerState.create(loc=(0.0, 0.0, 0.0), orient=(0.0, 0.0), device=CPU)
    st = ctl.update_controller(st, forward)
    idle = ctl.InputFrame.create(device=CPU)
    for _ in range(60):
        st = ctl.update_controller(st, idle)
    assert float(torch.linalg.norm(st.vel)) == 0.0
    st = ctl.update_controller(st.replace(vel=torch.tensor([9.0, 0.0, 0.0])), idle)
    assert float(torch.linalg.norm(st.vel)) <= ctl.MAX_SPEED + 1e-5

    st = ctl.ControllerState.create(orient=(0.0, 0.0), device=CPU)
    down = ctl.InputFrame.create(mouse_delta=(4000.0, -4000.0), mouse_down=True, device=CPU)
    st = ctl.update_controller(st, down)
    assert np.allclose(np_(st.orient), [0.0, 0.0])
    st = ctl.update_controller(st, down)
    assert abs(float(st.orient[0]) - gmath.HPI) < 1e-5
    assert -gmath.PI <= float(st.orient[1]) <= gmath.PI


# ------------------------------------------------------- keys and preview

KEY_STRINGS = [b"w", b"wd \x1b[C\x1b[A", b"ss", b"q", b"\x1b", b"\x1b[D"]


def test_parse_keys_matches_jax():
    rng = np.random.default_rng(5)
    tokens = [b"w", b"a", b"s", b"d", b"W", b"A", b"S", b"D", b" ", b"c", b"C", b"q", b"Q", b"x",
              b"\x1b", b"\x1b[A", b"\x1b[B", b"\x1b[C", b"\x1b[D", b"\x1b[Z", b"\x1b["]
    random = [b"".join(tokens[k] for k in rng.integers(0, len(tokens), 12)) for _ in range(200)]
    random += [rng.integers(0, 256, 24).astype(np.uint8).tobytes() for _ in range(50)]
    for data in KEY_STRINGS + random:
        assert fly.parse_keys(data) == jfly.parse_keys(data), data
    move, look, q = fly.parse_keys(b"wd \x1b[C\x1b[A")
    assert move == [1.0, 1.0, 1.0] and look == [fly.ARROW_PX, -fly.ARROW_PX] and not q


@pytest.mark.parametrize("cells", [(32, 12), (100, 48), (7, 5)])
def test_frame_to_ansi_matches_jax(cells):
    img = np.random.default_rng(0).random((48, 64, 3)).astype(np.float32)
    assert preview.frame_to_ansi(img, *cells) == jpreview.frame_to_ansi(img, *cells)


def test_terminal_preview_writes_its_caption():
    img = np.random.default_rng(0).random((48, 64, 3)).astype(np.float32)
    buf = io.StringIO()
    tp = preview.TerminalPreview(max_w=16, max_h=8, stream=buf)
    tp.show(img, caption="f0")
    tp.show(img, caption="f1")
    out = buf.getvalue()
    assert "f0" in out and "f1" in out and "\x1b[38;2;" in out


# ---------------------------------------------------------------- fly step

def test_fly_step_matches_jax():
    """Three fly steps (forward, a look with the pre-armed button, a
    diagonal climb) at 32×24 on the pass pipeline, carrying the history."""
    jcfg = JConfig(width=32, height=24)
    jscene = jdefault_scene()
    jst = jctl.ControllerState.create()
    jhist = jpipeline.init_history(jcfg, jst.camera)
    jstep = jfly.fly_step(jcfg)
    st = ctl.controller_state_from_numpy(_state_tree(jst), CPU)
    hist = to_torch_history(jhist)
    step = fly.fly_step(to_torch_config(jcfg))
    scene = to_torch_scene(jscene)
    for i, keys in enumerate([b"w", b"\x1b[C", b"wd "]):
        move, look, _ = fly.parse_keys(keys)
        looking = bool(look[0] or look[1])
        if looking:
            jst = jst.replace(was_down=jnp.asarray(True))
            st = st.replace(was_down=torch.tensor(True))
        jst, jimg, jhist = jstep(jscene, jst, jctl.InputFrame.create(move, look, looking), jhist,
                                 jnp.asarray(i, jnp.int32))
        st, img, hist = step(scene, st, ctl.InputFrame.create(move, look, looking, device=CPU), hist, i)
        _assert_state(st, jst, f"step {i}")
        assert img.shape == (24, 32, 3) and torch.isfinite(img).all()
        np.testing.assert_allclose(np_(img), np.asarray(jimg), atol=2e-4, rtol=1e-5, err_msg=f"image {i}")
    assert float(torch.linalg.norm(st.loc - torch.tensor([-2.0, 2.5, -5.0]))) > 0.0


# ------------------------------------------------------------------ driver

def test_render_animation_resume_matches_uninterrupted(tmp_path):
    """tests/test_app.py:174-200 on the port: 4 frames with a checkpoint at
    frame 3, then a relaunch with resume=True to frame 6, bitwise the
    uninterrupted 6 frames (image and history)."""
    scene = default_scene(device=CPU)
    cfg = RenderConfig(width=32, height=24)
    ck = tmp_path / "ck"
    ref, ref_hist = driver.render_animation(scene, cfg, num_frames=6)
    driver.render_animation(scene, cfg, num_frames=4, checkpoint_dir=ck, checkpoint_every=3)
    assert sorted(p.name for p in ck.iterdir()) == ["step_3"]
    img, hist = driver.render_animation(scene, cfg, num_frames=6, checkpoint_dir=ck, resume=True)
    np.testing.assert_array_equal(np_(img), np_(ref))
    for name in ("diffuse", "specular"):
        for k in ("rgb", "cnt", "oid"):
            a, b = getattr(getattr(hist, name), k), getattr(getattr(ref_hist, name), k)
            assert torch.equal(a, b), f"{name}.{k}"


def test_render_animation_preview(capsys):
    driver.render_animation(default_scene(device=CPU), RenderConfig(width=16, height=8), num_frames=2,
                            preview=True)
    out = capsys.readouterr().out
    assert "frame 0" in out and "frame 1" in out and "Mrays/s" in out and "\x1b[48;2;" in out


# --------------------------------------------------------------------- CLI

def test_cli_info(capsys):
    cli.main(["info"])
    info = json.loads(capsys.readouterr().out)
    assert set(info) == {"version", "backend", "devices", "native_lib"}
    assert info["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert info["devices"] and isinstance(info["native_lib"], bool)


def test_cli_invert_resume(tmp_path, capsys):
    args = ["invert", "--device", "cpu", "--width", "16", "--height", "8", "--spheres", "2", "--steps", "4",
            "--views", "1", "--betas", "0.05", "0.02", "--log-every", "0", "--ckpt-dir", str(tmp_path)]
    cli.main(args)
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["completed_phases"] == 2 and first["resolution"] == "16x8"
    cli.main(args + ["--resume"])
    resumed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert resumed == first


def test_cli_render_checkpoint_resume(tmp_path, capsys):
    base = ["render", "--device", "cpu", "--width", "16", "--height", "8", "--out", str(tmp_path / "out"),
            "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2", "--metrics",
            str(tmp_path / "m.jsonl")]
    cli.main(base + ["--frames", "3"])
    (tmp_path / "out" / "final.png").unlink()
    cli.main(base + ["--frames", "5", "--resume"])
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    assert (tmp_path / "out" / "final.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    frames = [json.loads(line)["frame"] for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert frames == [0, 1, 2, 3, 4]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_2", "step_4"]


def test_cli_fly_without_a_tty(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    cli.main(["fly", "--device", "cpu", "--width", "16", "--height", "8"])
    assert "stdin is not a tty" in capsys.readouterr().err


# ----------------------------------------------------------------- metrics

def test_timer_and_time_fn():
    calls = []
    with metrics.Timer() as t:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert t.elapsed > 0.0
    per_call = metrics.time_fn(lambda n: calls.append(n), 3, iters=4, warmup=2)
    assert calls == [3] * 6 and per_call >= 0.0


def test_profiler_trace_writes_a_trace(tmp_path):
    with metrics.profiler_trace(tmp_path / "prof"):
        torch.ones(256, 256) @ torch.ones(256, 256)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
