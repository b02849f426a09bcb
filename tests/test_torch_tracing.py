"""PyTorch port, the program's profiler spans (utils/metrics.py:span): each
frame of render_frame is one `frame` span holding the split temporal
frame's stages in order (render/pipeline.py:STAGES), each optimizer
step of `fit` one `fit.step` span holding `fit.value_and_grad` (a
`fit.view` a view) and then `fit.update` (diff/inverse.py:FIT_STAGES),
each path-traced image one `pathtrace` span holding `pathtrace.paths` and
then `pathtrace.tonemap` (render/wavefront.py:STAGES); with no profiler
active a span never reaches `record_function`, and the frame and the image
are bitwise the same with and without one. CPU, 16×8."""

import json

import torch
from torch.profiler import ProfilerActivity, profile

from kylespathtracer_tpu_torch.diff import inverse
from kylespathtracer_tpu_torch.render import pipeline, wavefront
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene
from kylespathtracer_tpu_torch.scene.types import BSDF
from kylespathtracer_tpu_torch.utils.config import RenderConfig
from kylespathtracer_tpu_torch.utils.metrics import span

W, H = 16, 8
CFG = RenderConfig(width=W, height=H, pipeline="fused")


def _frames(n=2):
    """n fused temporal frames from an empty history → (image, history)."""
    scene = default_scene(device="cpu")
    hist = pipeline.init_history(CFG, Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device="cpu"))
    img = None
    for i in range(n):
        cam = Camera.create(loc=(3.0, 2.0, -3.0 + 0.01 * i), orient=(0.0, 0.7 - 0.02 * i), device="cpu")
        img, hist = pipeline.render_frame(scene, cam, hist, i, CFG)
    return img, hist


def _fit(steps=2, views=3):
    truth, start, cams = inverse.recovery_scenes(num_spheres=2, views=views, seed=0, device="cpu")
    target = torch.stack([inverse.render_once(truth, cams[v], CFG, 0) for v in range(views)])
    return inverse.fit(start, target, cams, CFG, steps=steps)


def _pathtraced():
    """One path-traced image of a mirror, a glass and a diffuse sphere."""
    scene = sphere_scene([[-1.5, 1.0, 6.0], [1.5, 1.2, 6.5], [0.0, 0.8, 4.5]], [1.0, 1.2, 0.8],
                         [[0.9, 0.9, 0.9], [0.7, 0.8, 0.9], [0.9, 0.6, 0.5]],
                         kinds=[BSDF.MIRROR, BSDF.DIELECTRIC, BSDF.DIFFUSE], device="cpu")
    cam = Camera.create(loc=(0.0, 2.0, -2.0), orient=(-0.1, 0.0), device="cpu")
    return wavefront.render_pathtraced(scene, cam, RenderConfig(width=W, height=H, spp=1, max_depth=3), 7)


def _spans(fn, tmp_path, prefixes=("frame", "fit.")) -> list:
    """The program's spans (named with one of `prefixes`; torch's own, such
    as Optimizer.step's, left out) of fn() under torch.profiler → [(name,
    start, end)] by start, a parent before its children."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    rows = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in ev
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith(prefixes)]
    return sorted(rows, key=lambda r: (r[1], -r[2]))


def _children(rows, parent) -> list:
    """The spans directly inside `parent`, in order."""
    inside = [r for r in rows if r is not parent and parent[1] <= r[1] and r[2] <= parent[2] + 0.01]
    return [r for r in inside if not any(o is not r and o[1] <= r[1] and r[2] <= o[2] + 0.01 for o in inside)]


def test_each_frame_is_one_span_holding_the_five_stages_in_order(tmp_path):
    rows = _spans(_frames, tmp_path)
    frames = [r for r in rows if r[0] == "frame"]
    assert len(frames) == 2
    for f in frames:
        assert [c[0] for c in _children(rows, f)] == list(pipeline.STAGES)
    assert len(rows) == 2 * (1 + len(pipeline.STAGES))


def test_each_optimizer_step_holds_its_views_then_the_update(tmp_path):
    rows = _spans(_fit, tmp_path)
    steps = [r for r in rows if r[0] == "fit.step"]
    assert len(steps) == 2
    for s in steps:
        kids = _children(rows, s)
        assert [c[0] for c in kids] == list(inverse.FIT_STAGES)
        assert [c[0] for c in _children(rows, kids[0])] == ["fit.view"] * 3
        assert _children(rows, kids[1]) == []


def test_a_path_traced_image_is_one_span_holding_its_two_stages_in_order(tmp_path):
    rows = _spans(_pathtraced, tmp_path, ("pathtrace",))
    assert [r[0] for r in rows] == ["pathtrace", *wavefront.STAGES]
    assert [c[0] for c in _children(rows, rows[0])] == list(wavefront.STAGES)
    assert wavefront.STAGES == ("pathtrace.paths", "pathtrace.tonemap")


def test_no_profiler_no_record_function_and_the_same_image(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    img = _pathtraced()
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        img_p = _pathtraced()
    assert calls == ["pathtrace", *wavefront.STAGES]
    assert torch.equal(img, img_p)


def test_no_profiler_no_record_function_and_the_same_frame(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    img, hist = _frames()
    _fit(steps=1, views=2)
    with span("x"):
        pass
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        img_p, hist_p = _frames()
    assert calls.count("frame") == 2 and calls.count("frame.k1") == 2
    assert torch.equal(img, img_p)
    for a, b in ((hist.diffuse, hist_p.diffuse), (hist.specular, hist_p.specular)):
        for f in ("rgb", "cnt", "oid"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
