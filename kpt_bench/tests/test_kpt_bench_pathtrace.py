"""The cell pathtrace.spp4_1080 on the CPU: its loop at a tiny size, where the
program runs K7's plain version; `correct` false under each planted fault and
for the control; the configuration's scene as the program's bench builds
config 3; K7's operation count by hand; the `pathtrace.*` span metrics on a
hand-made trace; a reference that imports nothing of the program.

    python -m pytest kpt_bench/tests/test_kpt_bench_pathtrace.py -q
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from kpt_bench import harness, roofline, scenes
from kpt_bench.kinds import pathtrace as loop
from kpt_bench.tests._tiny import SEED, tiny_cell
from kpt_bench.tests._tiny import run as tiny_run
from kpt_bench.tests.test_kpt_bench_harness import _scan
from kpt_bench.tests.test_kpt_bench_spans import _kernel, _launch, _x
from kpt_bench.trace import Traced

CELL = "pathtrace.spp4_1080"


def failed(out: dict) -> list:
    return [k for k, c in out["checks"].items() if not (c["value"] <= c["limit"])]


def test_the_tiny_cell_runs_correct():
    out = tiny_run(tiny_cell(CELL))
    assert out["correct"] is True and out["attempted"] > 0, out["checks"]
    assert list(out["checks"]) == list(loop.CHECKS)
    assert set(out["metrics"]) == {"frame_ms", "setup_s"}
    out = tiny_run(tiny_cell(CELL), trace=True)
    assert out["correct"] is True and out["device"]["window_s"] > 0
    assert set(out["metrics"]) <= {m["name"] for m in harness.load_cell(CELL).per_layer}


def _planted(real, fault: str):
    """render/wavefront.pathtrace with `fault`: half the samples, one bounce
    fewer, or the frame index ignored (frame 0 every image)."""
    def broken(scene, camera, config, frame=0):
        if fault == "half_samples":
            config = dataclasses.replace(config, spp=config.spp // 2)
        elif fault == "one_bounce_fewer":
            config = dataclasses.replace(config, max_depth=config.max_depth - 1)
        else:
            frame = 0
        return real(scene, camera, config, frame)

    return broken


@pytest.mark.parametrize("fault", ["half_samples", "one_bounce_fewer", "frame_ignored"])
def test_each_planted_fault_turns_correct_false(monkeypatch, fault):
    """At 64×32. The bounce left out is the second, the one that carries what
    the mirror shows: at the cell's depth 6 the sixth vertex moves the image
    by at most ~5e-4, under FAR, so the check cannot tell a depth-5 image
    from the program's (PERF.md §2); a bounce that carries light it
    catches."""
    from kylespathtracer_tpu_torch.render import wavefront

    monkeypatch.setattr(wavefront, "pathtrace", _planted(wavefront.pathtrace, fault))
    cell = tiny_cell(CELL, 64, 32)
    if fault == "one_bounce_fewer":
        cell.traffic["max_depth"] = 2
    out = tiny_run(cell)
    assert out["correct"] is False and "far_share" in failed(out), out["checks"]


def test_the_control_and_the_faults_read_beyond_the_limits():
    cell = tiny_cell(CELL, 64, 32)
    kind = harness.kind_class(cell.traffic["kind"])(cell, SEED, "cpu")
    kind.window(0.0, 0)
    lim = {k: float(v) for k, v in cell.traffic["limits"].items()}
    got = kind.faults()
    assert set(got) == {"control", "half_samples", "one_bounce_fewer", "frame_ignored"}
    for side in ("control", "half_samples", "frame_ignored"):
        assert got[side]["far_share"] > lim["far_share"], (side, got[side])


def test_the_configuration_is_the_programs_config3():
    from kylespathtracer_tpu_torch.bench_configs import config3_case
    from kylespathtracer_tpu_torch.scene.types import scene_from_numpy

    cell = harness.load_cell(CELL)
    ours = scene_from_numpy(loop.scene_tree(cell.config["scene"]), device="cpu")
    scene, cam, cfg = config3_case("cpu")
    for f in ("planes", "plane_ids", "spheres", "sphere_ids", "boxes", "box_ids", "light_color"):
        assert torch.equal(getattr(ours, f), getattr(scene, f)), f
    for f in dataclasses.fields(scene.materials):
        assert torch.equal(getattr(ours.materials, f.name), getattr(scene.materials, f.name)), f.name
    assert cam.loc.tolist() == cell.config["camera"]["loc"]
    assert torch.equal(cam.orient, torch.tensor(cell.config["camera"]["orient"]))
    rc = harness.load_cell(CELL).render
    assert (cfg.spp, cfg.max_depth, cfg.gloss, cfg.brightness, cfg.fov) == \
        (rc["spp"], rc["max_depth"], rc["gloss"], rc["brightness"], rc["fov"])
    assert (cell.traffic["spp"], cell.traffic["max_depth"]) == (rc["spp"], rc["max_depth"])


def test_k7_operation_count_by_hand():
    """One plane, two spheres, no box."""
    k7 = harness.load_module(harness.metric_file("k7_roofline"))
    tree = scenes.sphere_scene([[0, 1, 5]], [0.5], [[0.5, 0.5, 0.5]])
    # A trace 12 + 2 × 22; a vertex 246 and a light test 20 + 12 + 2 × 20.
    assert k7.trace_ops(tree) == 56 and sum(k7.VERTEX.values()) == 246
    facts = {"tree": tree, "pixels": 10, "spp": 2, "traced": 15, "hits": 9, "per_step": {"k7": 1}, "step_s": 5e-4}
    ops, nbytes = k7.work(facts)
    assert ops == 10 * (34 + 3 + 2 * 3) + 15 * 56 + 9 * (246 + 72)
    # The tables 368 B, 4 ids' kinds and iors, 12 B a pixel.
    assert nbytes == 368 + 4 * 8 + 10 * 12
    t = Traced()
    t.events = [_kernel("kpt::path_kernel(kpt::TableParts, int const*)", 0, 100)]
    t.window_us, t.window_s = (0.0, 200.0), 2e-4
    ctx = harness.Context(t, 1, facts, {"path_kernel": 1.0})
    least = roofline.least_seconds(ops, nbytes)
    assert harness.load_reader("k7_roofline")(ctx) == pytest.approx(100 * least / 100e-6)
    assert harness.load_reader("mfu.pathtrace")(ctx) == pytest.approx(100 * ops / (5e-4 * roofline.F32_FLOPS))
    assert harness.load_reader("kernel.launches_per_step.pathtrace")(ctx) == 1
    assert harness.load_reader("k7_roofline")(harness.Context(t, 1, {}, {})) is None


def images_trace() -> Traced:
    """Two images, at 0 and at 500, in a 1000 µs window, each a `pathtrace`
    span: `pathtrace.paths` (host 20-50) launches K7 (run 40-340),
    `pathtrace.tonemap` (host 50-80) two plain kernels (run 340-360 and
    360-370). Per image: paths 300 µs on the device in 1 launch and 20 µs
    idle under its host interval (20-40, 520-540); tonemap 30 µs in 2
    launches, none idle under it; the rest of the idle time (0-20, 370-520,
    870-1000: 300 µs) outside."""
    t = Traced()
    ev = [_x("kpt_bench.window", 0, 1000, "user_annotation")]
    for t0 in (0, 500):
        c = t0 // 10
        ev += [_x("pathtrace", t0 + 10, 80, "user_annotation"),
               _x("pathtrace.paths", t0 + 20, 30, "user_annotation"), _launch(t0 + 30, c + 1),
               _kernel("kpt::path_kernel(kpt::TableParts)", t0 + 40, 300, c + 1),
               _x("pathtrace.tonemap", t0 + 50, 30, "user_annotation"), _launch(t0 + 60, c + 2),
               _kernel("void at::native::mul(float)", t0 + 340, 20, c + 2), _launch(t0 + 70, c + 3),
               _kernel("void at::native::pow(float)", t0 + 360, 10, c + 3)]
    t.events = ev
    t.window_us, t.window_s = (0.0, 1000.0), 1e-3
    return t


def test_the_pathtrace_stage_metrics_read_the_split():
    read = lambda name: harness.load_reader(name)(harness.Context(images_trace(), 2, {}, {}))
    assert read("pathtrace.paths.device_ms") == pytest.approx(0.3)
    assert read("pathtrace.paths.idle_ms") == pytest.approx(0.02)
    assert read("pathtrace.tonemap.device_ms") == pytest.approx(0.03)
    assert read("pathtrace.tonemap.launches") == 2
    assert read("pathtrace.outside.idle_ms") == pytest.approx(0.15)
    assert read("device.idle_share.pathtrace") == pytest.approx(100 * (1 - 660 / 1000))


def test_the_path_reference_imports_nothing_of_the_program():
    out = _scan("import kpt_bench.reference.path", harness.BANNED + ("kylespathtracer_tpu_torch",))
    assert "CLEAN" in out, out
