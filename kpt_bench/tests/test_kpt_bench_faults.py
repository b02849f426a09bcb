"""`correct` has to come out false when the timed path is broken, and the
control (the plain reference in bfloat16 in the program's place) has to fail
the limits. Each test skips the harness's look for a card and drives the
rest of a run at a tiny size on the CPU, with the program broken underneath:
a step that returns its state unchanged, half of the views left out with the
mean taken over the rest, an answer altered where it is produced; and, for
the training cell, each of its faults switched on only once set-up is done,
so that only the window's steps carry it.

    python -m pytest kpt_bench/tests -q
"""

from __future__ import annotations

import pytest
import torch

from kpt_bench import harness
from kpt_bench.tests._tiny import SEED, tiny_cell
from kpt_bench.tests._tiny import run as tiny_run


def failed(out: dict) -> list:
    return [k for k, c in out["checks"].items() if not (c["value"] <= c["limit"])]


def test_temporal_state_left_unchanged(monkeypatch):
    from kylespathtracer_tpu_torch.render import pipeline

    real = pipeline.render_frame

    def stale(scene, camera, history, frame, config):
        image, _ = real(scene, camera, history, frame, config)
        return image, history

    monkeypatch.setattr(pipeline, "render_frame", stale)
    out = tiny_run(tiny_cell("temporal.spline1080"))
    assert out["correct"] is False and "history_far" in failed(out), out["checks"]


def test_temporal_answer_altered_where_produced(monkeypatch):
    from kylespathtracer_tpu_torch.ops import frame_kernel

    real = frame_kernel.frame_forward

    def brighter(*args, **kw):
        out = real(*args, **kw)
        return dict(out, add_d=out["add_d"] * 1.01)

    monkeypatch.setattr(frame_kernel, "frame_forward", brighter)
    out = tiny_run(tiny_cell("temporal.spline1080"))
    assert out["correct"] is False and "image_far" in failed(out), out["checks"]


def _after_setup(cls, name: str, broken):
    """Replace cls.name by `broken` (built from the real one) once the
    program's set-up steps have run: the window's `fit` calls alone see it."""
    from kylespathtracer_tpu_torch.diff import inverse

    real, real_fit = getattr(cls, name), inverse.fit
    bad = broken(real)
    calls = {"fit": 0}
    setup_calls = 1  # set-up takes its first steps in one `fit` call

    def counting_fit(*args, **kw):
        calls["fit"] += 1
        return real_fit(*args, **kw)

    def switch(*args, **kw):
        return (bad if calls["fit"] > setup_calls else real)(*args, **kw)

    return counting_fit, switch


def _unchanged(real):
    def no_step(self, grads, state, params):
        before = {k: v.detach().clone() for k, v in state.params.items()}
        real(self, grads, state, params)
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(before[k])
        return state.params

    return no_step


def _half(real):
    def half(params, scene0, camera, target, frame, config):
        v = (int(target.shape[0]) + 1) // 2
        return real(params, scene0, camera[:v], target[:v], frame, config)

    return half


def test_fit_state_left_unchanged(monkeypatch):
    from kylespathtracer_tpu_torch.diff import inverse

    monkeypatch.setattr(inverse.ClippedAdam, "update", _unchanged(inverse.ClippedAdam.update))
    out = tiny_run(tiny_cell("inverse10.views1080"))
    assert out["correct"] is False and {"step_gap", "window_step_gap"} <= set(failed(out)), out["checks"]


def test_fit_half_the_views_left_out(monkeypatch):
    from kylespathtracer_tpu_torch.diff import inverse

    monkeypatch.setattr(inverse, "value_and_grad", _half(inverse.value_and_grad))
    out = tiny_run(tiny_cell("inverse10.views1080"))
    assert out["correct"] is False and {"loss_gap", "grad_gap"} & set(failed(out)), out["checks"]


@pytest.mark.parametrize("fault", ["state_left_unchanged", "half_the_views_left_out"])
def test_fit_fault_only_in_the_window(monkeypatch, fault):
    """Set-up's first steps are sound and pass; the window's steps carry the
    fault, and the check of the window's last step fails."""
    from kylespathtracer_tpu_torch.diff import inverse

    if fault == "state_left_unchanged":
        counting_fit, switch = _after_setup(inverse.ClippedAdam, "update", _unchanged)
        monkeypatch.setattr(inverse.ClippedAdam, "update", switch)
        expect = {"window_step_gap"}
    else:
        counting_fit, switch = _after_setup(inverse, "value_and_grad", _half)
        monkeypatch.setattr(inverse, "value_and_grad", switch)
        expect = {"window_loss_gap", "window_grad_gap"}
    monkeypatch.setattr(inverse, "fit", counting_fit)
    out = tiny_run(tiny_cell("inverse10.views1080"))
    bad = set(failed(out))
    assert not bad & {"loss_gap", "grad_gap", "step_gap"}, out["checks"]
    assert out["correct"] is False and expect & bad, out["checks"]


def _limits(name):
    return {k: float(v) for k, v in tiny_cell(name).traffic["limits"].items()}


def test_the_temporal_control_fails_the_limits():
    cell = tiny_cell("temporal.spline1080")
    kind = harness.kind_class("temporal")(cell, SEED, "cpu")
    kind.window(0.0, 0)
    got, lim = kind.faults()["control"], _limits("temporal.spline1080")
    assert any(got[k] > lim[k] for k in lim), got


def test_the_training_control_and_fault_fail_the_limits():
    cell = tiny_cell("inverse10.views1080")
    kind = harness.kind_class(cell.traffic["kind"])(cell, SEED, "cpu")
    kind.window(0.0, 0)
    lim = _limits("inverse10.views1080")
    for side, got in kind.faults().items():
        for part in ("", "window_"):
            names = [part + k for k in ("loss_gap", "grad_gap", "step_gap")]
            assert any(not (got[k] <= lim[k]) for k in names), (side, part, got)
