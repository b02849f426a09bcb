"""The span reader (kpt_bench/spans.py) and the per-layer metrics over it, on
hand-made Chrome traces whose numbers are worked by hand.

    python -m pytest kpt_bench/tests/test_kpt_bench_spans.py -q
"""

from __future__ import annotations

import pytest

from kpt_bench import harness, spans
from kpt_bench.trace import Traced

HOST = {"pid": 1, "tid": 1}
DEV = {"pid": 0, "tid": 7}


def _x(name, ts, dur, cat, where=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **where, "args": args}


def _launch(ts, corr, name="cudaLaunchKernel", cat="cuda_runtime"):
    return _x(name, ts, 2, cat, correlation=corr)


def _kernel(name, ts, dur, corr=None, cat="kernel"):
    return _x(name, ts, dur, cat, DEV, **({} if corr is None else {"correlation": corr}))


def _frame(t0: int, ac2g: bool) -> list:
    """One frame at host µs t0 + [10, 400): its five stages, a plain launch
    under an aten op, K1's ctypes launch (a runtime call and no op), two K2
    launches under a span nested in frame.reproject (the second a
    `cuLaunchKernel`, a copy), and the tail's kernel running past the frame's end.
    With `ac2g`, K1's kernel carries no `correlation` and the flow events
    link it to its launch."""
    c = t0 // 10
    k1 = _kernel("kpt::frame_kernel(kpt::TableParts)", t0 + 80, 100, None if ac2g else c + 2)
    ev = [_x("frame", t0 + 10, 390, "user_annotation"),
          _x("frame.ray_dirs", t0 + 20, 40, "user_annotation"),
          _x("aten::mul", t0 + 25, 10, "cpu_op"), _launch(t0 + 30, c + 1),
          _kernel("void at::native::mul(float)", t0 + 40, 10, c + 1),
          _x("frame.k1", t0 + 60, 140, "user_annotation"),
          _launch(t0 + 70, c + 2), k1,
          _x("frame.anchors", t0 + 200, 50, "user_annotation"), _launch(t0 + 210, c + 4),
          _kernel("void at::native::add(float)", t0 + 215, 10, c + 4),
          _x("frame.reproject", t0 + 250, 100, "user_annotation"),
          _x("frame.reproject.head", t0 + 255, 50, "user_annotation"),
          _launch(t0 + 260, c + 5), _kernel("kpt::reproject_kernel(int*)", t0 + 262, 20, c + 5),
          _launch(t0 + 300, c + 6, "cuLaunchKernel", "cuda_driver"),
          _kernel("Memcpy DtoD", t0 + 330, 10, c + 6, "gpu_memcpy"),
          _x("frame.tail", t0 + 350, 40, "user_annotation"), _launch(t0 + 355, c + 7),
          _kernel("void at::native::where(float)", t0 + 395, 25, c + 7)]
    if ac2g:
        ev += [{"ph": "s", "id": 999, "cat": "ac2g", "name": "ac2g", "ts": t0 + 70, **HOST},
               {"ph": "f", "id": 999, "cat": "ac2g", "name": "ac2g", "ts": t0 + 80, "bp": "e", **DEV}]
    return ev


def frames_trace() -> Traced:
    """Two frames, at 0 and at 500, in a 1000 µs window; between them the
    loop launches one kernel (at 450, run 460-465) and calls cudaMalloc (at
    470); frame 1 calls cudaMalloc once, in frame.k1.

    Device busy: 2 × (10 + 100 + 10 + 20 + 10 + 25) + 5 = 355 µs, so 645 µs
    idle. Idle under each stage (gaps 0-40, 50-80, 180-215, 225-262, 282-330,
    340-395 and the same + 500): ray_dirs 20 + 10, k1 20 + 20, anchors 15 +
    25, reproject 12 + 48 + 10, tail 40; 220 a frame, so 645 - 440 outside."""
    t = Traced()
    t.events = ([_x("kpt_bench.window", 0, 1000, "user_annotation")] + _frame(0, False) + _frame(500, True)
                + [_launch(450, 500), _kernel("void at::native::fill(float)", 460, 5, 500),
                   _x("cudaMalloc", 65, 3, "cuda_runtime", correlation=501),
                   _x("cudaMalloc", 470, 3, "cuda_runtime", correlation=502)])
    t.window_us, t.window_s = (0.0, 1000.0), 1e-3
    return t


def fit_trace() -> Traced:
    """One optimizer step: fit.value_and_grad holding two fit.view spans of a
    K6 launch each (100 µs) and the mean (10 µs), then fit.update with two
    launches (5 µs each), in a 300 µs window."""
    t = Traced()
    t.events = [_x("kpt_bench.window", 0, 300, "user_annotation"), _x("fit.step", 5, 290, "user_annotation"),
                _x("fit.value_and_grad", 10, 230, "user_annotation"),
                _x("fit.view", 12, 20, "user_annotation"), _launch(15, 1),
                _kernel("kpt::loss_grad_kernel(float*)", 20, 100, 1),
                _x("fit.view", 32, 20, "user_annotation"), _launch(35, 2),
                _kernel("kpt::loss_grad_kernel(float*)", 120, 100, 2),
                _launch(60, 3), _kernel("void at::native::mean(float)", 220, 10, 3),
                _x("fit.update", 240, 50, "user_annotation"), _launch(245, 4), _launch(250, 5),
                _kernel("void at::native::adam(float)", 255, 5, 4), _kernel("void at::native::adam(float)", 270, 5, 5)]
    t.window_us, t.window_s = (0.0, 300.0), 3e-4
    return t


BENCH = harness.load_bench()
NEW = [m for m in BENCH["per_layer"] if m["source"] == "program_span"]


def read(name, traced, steps=2):
    return harness.load_reader(name)(harness.Context(traced, steps, {}, {}))


def test_frames_by_stage():
    s = spans.split(frames_trace(), "frame")
    assert s["steps"] == 2 and s["mallocs"] == pytest.approx(0.5)
    want = {"frame.ray_dirs": (10, 1, 30), "frame.k1": (100, 1, 40), "frame.anchors": (10, 1, 40),
            "frame.reproject": (30, 2, 70), "frame.tail": (25, 1, 40), "frame.outside": (2.5, 0.5, 102.5)}
    assert set(s["stages"]) == set(want)
    for stage, (us, n, idle_us) in want.items():
        got = s["stages"][stage]
        assert got["device_ms"] == pytest.approx(us / 1e3), stage
        assert got["launches"] == pytest.approx(n), stage
        assert got["idle_ms"] == pytest.approx(idle_us / 1e3), stage
    total_idle = sum(v["idle_ms"] for v in s["stages"].values())
    assert total_idle == pytest.approx(0.645 / 2)


def test_the_frame_metrics_read_the_split():
    t = frames_trace()
    assert read("frame.k1.device_ms", t) == pytest.approx(0.1)
    assert read("frame.reproject.launches", t) == 2
    assert read("frame.reproject.idle_ms", t) == pytest.approx(0.07)
    assert read("frame.outside.idle_ms", t) == pytest.approx(0.1025)
    assert read("frame.cuda_mallocs", t) == pytest.approx(0.5)
    five = [f"frame.{s}.launches" for s in ("ray_dirs", "k1", "anchors", "reproject", "tail")]
    assert sum(read(n, t) for n in five) == 6


def test_an_optimizer_step_by_stage():
    """fit.view rolls up into fit.value_and_grad; the step span is no stage."""
    s = spans.split(fit_trace(), "fit.step")
    assert s["steps"] == 1 and set(s["stages"]) == {"fit.value_and_grad", "fit.update", "fit.step.outside"}
    vg, up = s["stages"]["fit.value_and_grad"], s["stages"]["fit.update"]
    assert (vg["device_ms"], vg["launches"]) == (pytest.approx(0.21), 3)
    assert (up["device_ms"], up["launches"]) == (pytest.approx(0.01), 2)
    # Idle: 0-20 (10-20 under value_and_grad), 230-255 (230-240, 240-255),
    # 260-270 (update), 275-300 (275-290 update); outside 0-10, 290-300.
    assert vg["idle_ms"] == pytest.approx(0.02)
    assert up["idle_ms"] == pytest.approx(0.015 + 0.01 + 0.015)
    assert s["stages"]["fit.step.outside"]["idle_ms"] == pytest.approx(0.01 + 0.01)
    assert read("fit.value_and_grad.launches", fit_trace(), 1) == 3
    assert read("fit.update.device_ms", fit_trace(), 1) == pytest.approx(0.01)


def test_no_spans_no_numbers():
    """A trace without the program's spans, or without device events, gives
    None from every new reader: a renamed span shows as a missing metric."""
    bare = frames_trace()
    bare.events = [e for e in bare.events if not e["name"].startswith(("frame", "fit."))]
    host_only = frames_trace()
    host_only.events = [e for e in host_only.events if e.get("pid") != DEV["pid"]]
    for m in NEW:
        for t in (bare, host_only, Traced()):
            assert read(m["name"], t) is None, m["name"]
    # A metric reads None from a trace without its family's spans: the
    # frame's from the optimizer step's trace, the step's from the frames'.
    for m in NEW:
        family = m["name"].split(".")[0]
        for t in (frames_trace(), fit_trace()):
            if not any(e["name"].split(".")[0] == family for e in t.events if e["cat"] == "user_annotation"):
                assert read(m["name"], t) is None, m["name"]


def test_every_new_metric_loads_its_reader():
    """Every span metric of BENCHMARK.json has a reader file of its own name,
    and every cell it lists (every cell, where it lists none) reports the
    end-to-end metric it moves."""
    assert NEW
    for m in NEW:
        assert callable(harness.load_reader(m["name"]))
        assert harness.metric_file(m["name"]).name == m["name"] + ".py"
        cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
        assert cells, m["name"]
        for cell in cells:
            assert m["moves"] in {e["name"] for e in harness.load_cell(cell).end_to_end}, (m["name"], cell)
