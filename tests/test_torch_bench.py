"""PyTorch port, the benches (kylespathtracer_tpu_torch/bench.py,
bench_configs.py, bench_profile.py, dryrun.py) on the CPU.

What runs without a card: the port's copy of the GLSL oracle's building
blocks against kylespathtracer_tpu/cpu_reference/glslref.py bit for bit on
numpy-seeded inputs; config 1's direct-light oracle on the port's scene
against root bench_configs.py's on the JAX scene of the same numbers
(numpy on both sides); config 1's render at 64×64 through the plain
versions within config 1's bars of that oracle; the slope arithmetic of
the timing detail on fixed totals; config 4's classification of differing
pixels on a synthetic image with known edges; the profile's summary of a
hand-made Chrome trace; the sharded witness on 2 gloo ranks of the CPU at
64×16. And what must fail without a card: the timing helpers raise on a
CPU device, and each entry point exits non-zero with nothing on stdout
(no fallback to the CPU); `--out` refuses a path that exists.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_configs as jbc
from kylespathtracer_tpu import Camera as JCamera
from kylespathtracer_tpu.cpu_reference import glslref as jref
from kylespathtracer_tpu.scene.scene import sphere_scene as jsphere_scene
from kylespathtracer_tpu_torch import bench, bench_configs, bench_profile, dryrun
from kylespathtracer_tpu_torch.cpu_reference import glslref as ref

CPU = torch.device("cpu")
ENTRY_POINTS = ("bench", "bench_configs", "bench_profile", "dryrun")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this test holds what happens without a card")


def _glsl_inputs(name, rng):
    """Arguments of glslref.<name> made from numpy seeds."""
    n = 257
    vec = lambda lo, hi: rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    unit = lambda: (lambda v: (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32))(vec(-1, 1))
    seeds = rng.integers(-2**31, 2**31, n).astype(np.int32)
    return {
        "gen_seed": lambda: (7, rng.integers(0, 1920, n), rng.integers(0, 1080, n), 1920, 1080),
        "weyl3": lambda: (seeds,),
        "uniform_cone_dir": lambda: (vec(-8, 8), np.float32(1.0), seeds),
        "basis": lambda: (unit(),),
        "rotate_xy": lambda: (vec(-2, 2), rng.uniform(-3, 3, (n, 2)).astype(np.float32)),
        "linear_angle": lambda: (rng.uniform(0.5, 20, n).astype(np.float32), np.float32(1.0)),
        "solid_angle": lambda: (rng.uniform(0.5, 400, n).astype(np.float32), np.float32(1.0)),
        "linear_srgb": lambda: (rng.uniform(-0.01, 1.2, (n, 3)).astype(np.float32),),
        "aces_fitted": lambda: (rng.uniform(0, 30, (n, 3)).astype(np.float32),),
    }[name]()


@pytest.mark.parametrize("name", ["gen_seed", "weyl3", "uniform_cone_dir", "basis", "rotate_xy", "linear_angle",
                                  "solid_angle", "linear_srgb", "aces_fitted"])
def test_glslref_copy_matches_the_jax_package_bitwise(name):
    """Each function of the port's copy equals the JAX package's oracle bit
    for bit on the same numpy-seeded inputs, and so do the constants."""
    args = _glsl_inputs(name, np.random.default_rng(11))
    got, want = getattr(ref, name)(*args), getattr(jref, name)(*args)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want)), strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True), name
    for const in ("EPS", "IEPS", "ZFAR", "FOV", "TWOPI"):
        assert getattr(ref, const) == getattr(jref, const) and type(getattr(ref, const)) is np.float32


def test_oracle_direct_light_matches_the_jax_bench():
    """config 1's oracle on the port's 64×64 scene and camera equals root
    bench_configs.py's on the JAX scene built from the same numbers (numpy
    on both sides, no JAX compile)."""
    scene, cam, _ = bench_configs.config1_case(CPU, 64)
    got = bench_configs.oracle_direct_light(scene, cam, 64, 64)
    jscene = jsphere_scene(centers=[[0.0, 1.0, 6.0]], radii=[1.0], albedos=[[0.7, 0.3, 0.2]])
    want = jbc._oracle_direct_light(jscene, JCamera.create(loc=(0.0, 2.0, -2.0), orient=(-0.15, 0.0)), 64, 64)
    assert got.shape == (64, 64, 3) and (got > 0.05).mean() > 0.3
    np.testing.assert_array_equal(got, want)


def test_config1_render_meets_its_bars_on_the_cpu():
    """config 1 at 64×64 through the plain versions: within config 1's bars
    (median |Δ| < 1e-5, under 1% beyond 3e-2) of the oracle."""
    r = bench_configs.config1(CPU, 64)
    assert r["passed"], r
    assert r["diff"]["finite"] and r["diff"]["median_abs"] < 1e-5 and r["diff"]["frac_gt_3e-2"] < 0.01


@pytest.mark.parametrize("totals,linear", [
    ([[10.0, 10.5], [42.0, 41.0], [73.0, 75.0]], True),   # sub-slopes 1.9375, 2.0
    ([[10.0], [26.0], [90.0]], False),                     # 1.0 vs 4.0
])
def test_timing_detail_slope_arithmetic(totals, linear):
    """The detail line on fixed repetition totals over K = (4, 20, 36): the
    best of each K's repetitions, their least-squares slope, the sub-slopes
    and linear_ok (within 20% + 0.1 ms) either way."""
    ks = (4, 20, 36)
    d = bench.timing_detail("fwd_fused", ks, totals, 1.5, {"frame_forward": 1.0}, blocked_ms=3.0)
    best = [min(t) for t in totals]
    assert d["totals_ms"] == best and d["rep_totals_ms"] == totals
    assert d["sub_slopes_ms"] == pytest.approx([(best[1] - best[0]) / 16, (best[2] - best[1]) / 16])
    assert d["slope_ms"] == pytest.approx(np.polyfit(ks, best, 1)[0])
    assert d["linear_ok"] is linear
    assert d["metric"] == "fwd_fused_timing_detail" and d["method"] == "event-slope"
    assert d["reps"] == len(totals[0]) and d["compile_s"] == 1.5 and d["launches_per_step"] == {"frame_forward": 1.0}
    assert d["blocked_single_dispatch_ms"] == 3.0 and d["slope_within_blocked"] is (d["slope_ms"] <= 3.6)


def _checker_scene(H=40, W=48):
    """A synthetic G-buffer: the floor (oid 2) below row 20 with unit checker
    cells at columns 16 and 32, the box (oid 4) above; counts all 3 but for
    one cell of 5."""
    oid = np.where(np.arange(H)[:, None] < 20, 2, 4).astype(np.int32) * np.ones((1, W), np.int32)
    hl = np.zeros((H, W, 3), np.float32)
    hl[..., 0] = np.arange(W)[None, :] / 16.0 + 0.01   # floor cells change at 16 and 32
    hl[..., 2] = 0.5
    hl[20:, :, 0] = 0.1                                 # one box cell
    cnt = np.full((H, W), 3.0, np.float32)
    cnt[30, 40] = 5.0
    return oid, hl, cnt


def test_classify_flips_on_known_edges():
    """Pixels that part on the object edge (row 19/20), a floor checker edge
    (column 16), next to the odd count and within 2 px of them are on the
    mask; the interior agrees exactly → boundary_ok. One flip in the
    interior → its share beyond 1e-3 fails the gate."""
    oid, hl, cnt = _checker_scene()
    d = np.zeros(oid.shape + (3,), np.float32)
    d[19, 5, 0] = d[21, 7, 1] = 0.5       # object edge, 1 px off
    d[10, 17, 2] = 0.2                    # checker edge at column 16, 1 px off
    d[30, 42, 0] = 0.1                    # 2 px from the odd count
    r = bench_configs.classify_flips(d, [(oid, hl)], [(cnt, cnt)])
    assert r["boundary_ok"] and r["flagged_on_mask_frac"] == 1.0 and r["interior_max_abs"] == 0.0
    assert r["flagged_px_frac"] == pytest.approx(4 / oid.size) and r["mask_frac"] < 0.6
    d[5, 40, 0] = 0.01                    # interior: far from every edge
    r2 = bench_configs.classify_flips(d, [(oid, hl)], [(cnt, cnt)])
    assert not r2["boundary_ok"] and r2["interior_max_abs"] == pytest.approx(0.01)
    assert r2["interior_frac_gt_1e-3"] > 1e-4


def test_summarize_trace_on_a_hand_made_trace():
    """The device events of a Chrome trace over 2 frames: the union of
    overlapping intervals, the span from first start to last end, the busy
    and idle shares, the events by name; host events and instants are not
    the device's."""
    ev = lambda name, ts, dur, cat="kernel": {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [
        ev("k1", 0, 100), ev("k2", 50, 100),             # overlap: union 150
        ev("k1", 300, 100), ev("memcpy", 450, 50, "gpu_memcpy"),
        ev("aten::add", 0, 5000, "cpu_op"), {"ph": "i", "cat": "kernel", "name": "x", "ts": 10},
    ]
    s = bench_profile.summarize_trace(events, frames=2)
    assert s["device_per_frame_ms"] == pytest.approx(300 / 1e3 / 2)
    assert s["span_per_frame_ms"] == pytest.approx(500 / 1e3 / 2)
    assert s["busy_share"] == pytest.approx(0.6) and s["idle_share"] == pytest.approx(0.4)
    assert s["device_events"] == 4
    top = {e["name"]: e for e in s["top_device_events"]}
    assert list(top) == ["k1", "k2", "memcpy"]
    assert top["k1"] == {"name": "k1", "total_ms": 0.2, "count": 2, "per_frame_ms": 0.1}
    with pytest.raises(ValueError, match="no device event"):
        bench_profile.summarize_trace(events[4:], frames=2)


@pytest.mark.parametrize("helper", ["event_slope", "roundtrip_ms", "profile_frames", "dryrun_multichip"])
def test_measurements_raise_without_a_card(helper, tmp_path):
    """The timing helpers raise on a CPU device; the profile and the cuda
    witness refuse to start without a card."""
    call = {
        "event_slope": lambda: bench.event_slope(lambda c, i: c, None, (1, 2, 3), "t", CPU),
        "roundtrip_ms": lambda: bench.roundtrip_ms(CPU),
        "profile_frames": lambda: (_no_card(), bench_profile.profile_frames(tmp_path)),
        "dryrun_multichip": lambda: (_no_card(), dryrun.dryrun_multichip(2, "cuda")),
    }[helper]
    with pytest.raises(RuntimeError, match="CUDA device"):
        call()


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_points_fail_without_a_card(module):
    """`python -m kylespathtracer_tpu_torch.<module>` exits non-zero without
    a card and prints no result: no measurement falls back to the CPU."""
    _no_card()
    proc = subprocess.run([sys.executable, "-m", f"kylespathtracer_tpu_torch.{module}"], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == "" and "CUDA device" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.parametrize("module", ["bench", "bench_configs", "bench_profile"])
def test_out_refuses_an_existing_path(module, tmp_path):
    """`--out` takes a new path only: one that exists (here the directory
    itself, or a file in it) is refused before anything runs."""
    main = {"bench": bench.main, "bench_configs": bench_configs.main, "bench_profile": bench_profile.main}[module]
    existing = tmp_path / "taken"
    existing.write_text("keep")
    with pytest.raises(SystemExit) as e:
        main(["--out", str(existing)])
    assert "exists" in str(e.value.code)
    assert existing.read_text() == "keep"


def test_dryrun_on_two_gloo_ranks_of_the_cpu():
    """dryrun_multichip(2, "cpu"): two processes joined through the KPT_*
    contract on gloo, 64×16; every check within the JAX tolerances, the
    report naming the backend and the GSPMD step's absence."""
    report = dryrun.dryrun_multichip(2, "cpu", timeout=240)
    assert report["ok"] and report["ranks"] == 2 and report["backend"] == "gloo" and not report["failed"]
    names = [c[0] for c in report["checks"]]
    assert len(names) == 12 and "tiled fused temporal image" in names and "fused train_step_tiled grads[spheres]" in names
    assert "GSPMD" in report["summary"] and report["summary"].startswith("dryrun_multichip OK")
