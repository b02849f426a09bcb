"""The harness on the CPU: every entry of BENCHMARK.json loads by name, the
metric readers read a synthetic trace, the copied operation counts match
hand-worked values, the result line keeps its schema, and nothing a run
loads is JAX or the JAX package.

    python -m pytest kpt_bench/tests -q
"""

from __future__ import annotations

import importlib
import importlib.util
import io
import json
import re
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

from kpt_bench import harness, roofline, run, scenes
from kpt_bench.tests._tiny import run as tiny_run
from kpt_bench.tests._tiny import tiny_cell
from kpt_bench.trace import Traced, idle_gaps, summarize_trace, union_us

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def loop_module(kind: str):
    """kinds/<kind>.py, the module of the loop a traffic mix names."""
    return importlib.import_module(harness.kind_class(kind).__module__)


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kpt_bench"] and 1 <= BENCH["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s", "step_ms", "frame_ms"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert m["moves"] in {e["name"] for e in harness.load_cell(cell).end_to_end}, (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    kind = c.traffic["kind"]
    assert harness.kind_class(kind).__module__ == f"kpt_bench.kinds.{kind}"
    checks = loop_module(kind).CHECKS
    assert len(set(checks)) == len(checks) and all(NAME.match(k) for k in checks)
    assert set(c.traffic["limits"]) == set(checks)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(harness.load_reader(m["name"]))
    assert c.config["chips"] == c.chips


def test_the_harness_names_no_cell_loop_or_metric():
    """A new cell, loop, metric or kernel is new files and entries: nothing
    of one is named in the harness's own code or in the tests' cutting of a
    cell for the CPU, and a split metric finds its base's reader."""
    names = [w["name"] for w in BENCH["workloads"]] + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    loops = {harness.load_cell(w["name"]).traffic["kind"] for w in BENCH["workloads"]}
    kernels = [m.__name__.rsplit(".", 1)[1] for m in harness.counted_modules()]
    for src in ("harness.py", "run.py", "tests/_tiny.py"):
        text = (harness.HERE / src).read_text()
        # setup_s is every cell's, by the benchmark's contract.
        assert not [n for n in names if n != "setup_s" and (f'"{n}"' in text or f"'{n}'" in text)], src
        # A loop named: imported, keyed, or branched on.
        assert not [k for k in loops if f"kinds.{k}" in text or f"{k}:" in text or f'== "{k}"' in text
                    or f"== '{k}'" in text], src
        assert not [k for k in kernels if k in text], src
    assert harness.metric_file("mfu.frame") == harness.metric_file("mfu.step") == harness.HERE / "metrics" / "mfu.py"
    assert harness.metric_file("k1_roofline").name == "k1_roofline.py"
    with pytest.raises(SystemExit):
        harness.metric_file("no_such.metric")
    with pytest.raises(SystemExit):
        harness.kind_class("no_such_loop")


def test_every_kernel_counter_is_read():
    """launch_counters reads `LAUNCHES` of every module of the program's ops
    package that sets one at its top level, and imports no other module."""
    ops = Path(importlib.util.find_spec(harness.OPS).submodule_search_locations[0])
    have = sorted(p.stem for p in ops.glob("*.py") if re.search(r"^LAUNCHES\s*=", p.read_text(), re.M))
    assert len(have) >= 9 and {"frame_kernel", "reproject_kernel", "loss_kernel", "path_kernel"} <= set(have)
    counters = harness.launch_counters()
    assert sorted(counters) == have
    # Read live: a launch counted in a module shows in the next reading.
    for m in harness.counted_modules():
        name = m.__name__.rsplit(".", 1)[1]
        m.LAUNCHES += 3
        try:
            assert harness.launch_counters()[name] == counters[name] + 3
        finally:
            m.LAUNCHES -= 3


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def synthetic() -> Traced:
    """Two steps: K1 (100 µs), K2 (2 × 20), a plain kernel (30), a memcpy (10),
    K6 (200), K5 (50), an NCCL kernel (40), with idle gaps, in a 1000 µs window."""
    t = Traced()
    t.events = [_ev("kpt::frame_kernel(kpt::TableParts)", 0, 100), _ev("kpt::reproject_kernel(int*)", 100, 20),
                _ev("kpt::reproject_kernel(int*)", 150, 20), _ev("void at::native::add(float)", 200, 30),
                _ev("Memcpy DtoD", 240, 10, "gpu_memcpy"), _ev("kpt::loss_grad_kernel(float*)", 300, 200),
                _ev("kpt::frame_grad_kernel(float*)", 520, 50), _ev("ncclDevKernel_AllReduce", 600, 40),
                _ev("aten::mul", 170, 25, "cpu_op"), _ev("kpt_bench.window", 0, 1000, "user_annotation")]
    t.window_us, t.window_s = (0.0, 1000.0), 1e-3
    return t


def ctx(facts=None, counters=None):
    return harness.Context(synthetic(), 2, facts or {}, counters or {})


def test_readers_on_a_synthetic_trace():
    read = lambda n, c: harness.load_reader(n)(c)
    busy = 100 + 20 + 20 + 30 + 10 + 200 + 50 + 40
    assert union_us([(0, 2), (1, 3), (5, 6)]) == 4
    for name in ("device.idle_share.step", "device.idle_share.frame"):
        assert read(name, ctx()) == pytest.approx(100 * (1 - busy / 1000))
    for name in ("device.ms_per_step.step", "device.ms_per_step.frame"):
        assert read(name, ctx()) == pytest.approx(busy / 1e3 / 2)
    assert read("pipeline.launches_per_step", ctx()) == 4
    assert read("pipeline.plain_ms_per_step", ctx()) == pytest.approx((busy - 140) / 1e3 / 2)
    assert read("fit.plain_ms_per_step", ctx()) == pytest.approx((busy - 200) / 1e3 / 2)
    for name in ("kernel.launches_per_step.step", "kernel.launches_per_step.frame"):
        assert read(name, ctx(counters={"k1": 1.0, "k2": 2.0})) == 3
    tree = scenes.default_scene()
    rc = {"smp": 1, "biased": True, "soft_shadows": 0.0}
    facts = {"tree": tree, "rc": rc, "pixels": 1000, "shaded": 600, "per_step": {"k1": 1, "k2": 2}, "step_s": 5e-4}
    ops = roofline.frame_ops(tree, rc, 1000, 600)
    least = max(ops / roofline.F32_FLOPS, (roofline.table_bytes(tree) + 1000 * 56) / roofline.HBM_BYTES)
    assert read("k1_roofline", ctx(facts)) == pytest.approx(100 * least / 100e-6)
    for name in ("mfu.step", "mfu.frame"):
        assert read(name, ctx(facts)) == pytest.approx(100 * ops / (5e-4 * roofline.F32_FLOPS))
    assert 0 < read("k6_roofline", ctx(facts)) < 100
    k5_ops, k5_bytes = 3 * ops, 2 * roofline.table_bytes(tree) + 1000 * 11 * 4
    assert read("k5_roofline", ctx(facts)) == pytest.approx(
        100 * max(k5_ops / roofline.F32_FLOPS, k5_bytes / roofline.HBM_BYTES) / 50e-6)
    assert read("mfu.shard", ctx(dict(facts, per_step={"k1": 1, "k5": 1}))) == pytest.approx(
        100 * (ops + k5_ops) / (5e-4 * roofline.F32_FLOPS))
    assert read("shard.allreduce_ms", ctx()) == pytest.approx(40 / 1e3 / 2)
    assert read("shard.allreduce_ms", harness.Context(Traced(), 1, facts, {})) is None
    assert read("kernel.launches_per_step.shard", ctx(counters={"k1": 1.0, "k2": 0.0, "k5": 1.0, "k6": 0.0})) == 2
    assert read("k1_roofline", harness.Context(Traced(), 1, facts, {})) is None
    assert read("frame_ms_p95", ctx({"frame_times_ms": [float(i) for i in range(1, 101)]})) == pytest.approx(95.05)
    assert read("frame_ms_p95", ctx()) is None
    s = summarize_trace(synthetic().events, 2)
    assert s["device_events"] == 8 and s["top_device_events"][0]["name"].startswith("kpt::loss_grad")
    gaps = dict(idle_gaps(synthetic().events, (0.0, 1000.0)))
    assert gaps["aten::mul"] == pytest.approx(30e-6) and sum(gaps.values()) == pytest.approx((1000 - busy) / 1e6)


def test_operation_counts_by_hand():
    """One plane, two spheres, no box."""
    tree = scenes.sphere_scene([[0, 1, 5]], [0.5], [[0.5, 0.5, 0.5]])
    assert roofline.counts(tree) == (1, 2, 0)
    assert roofline.trace_ops(tree) == 12 + 2 * 20
    assert roofline.occlusion_ops(tree) == 20 + 12 + 2 * 20
    # direct 60 + 72, two plane strategies 150, four roulettes 4 × (2 + 144 + 65).
    assert roofline.shade_ops(tree, {"smp": 1, "biased": True, "soft_shadows": 0.0}, 4) == 4 * (132 + 150 + 4 * 211)
    assert roofline.frame_ops(tree, {"smp": 1, "biased": True, "soft_shadows": 0.0}, 10, 4) == 10 * 117 + 4 * 1126
    # Soft shadows trace the direct light: 60 + 52 + 30 × 2.
    assert roofline.shade_ops(tree, {"smp": 2, "biased": True, "soft_shadows": 0.01}, 1) == 2 * (172 + 150 + 844)
    assert roofline.least_seconds(67e12, 0) == 1.0 and roofline.least_seconds(0, 3.35e12) == 1.0
    # K5 in row mode: 3 × the frame on the tile's pixels; the tables read and
    # their gradients written, 11 cotangent planes read a pixel.
    k5 = harness.load_module(harness.metric_file("k5_roofline")).work(
        {"tree": tree, "rc": {"smp": 1, "biased": True, "soft_shadows": 0.0}, "pixels": 10, "shaded": 4})
    assert k5 == (3 * (10 * 117 + 4 * 1126), 2 * roofline.table_bytes(tree) + 10 * 44)
    # Geometry 4 + 1 + 8 + 2 + 3 floats, 4 materials' 64, the camera's 10.
    assert roofline.table_bytes(tree) == 4 * (18 + 64) + 4 * 10


def test_result_line_schema():
    cell = tiny_cell("temporal.spline1080")
    out = tiny_run(cell)
    err, buf = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        assert run.report(out) == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"frame_ms", "setup_s"}
    assert list(line["checks"]) == list(loop_module(cell.traffic["kind"]).CHECKS)
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    tail = err.getvalue().strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


def test_traced_run_reports_per_layer_metrics():
    out = tiny_run(tiny_cell("inverse10.views1080"), trace=True)
    assert out["correct"] and "breakdown" in out and out["device"]["window_s"] > 0
    assert set(out["metrics"]) <= {m["name"] for m in harness.load_cell("inverse10.views1080").per_layer}


# Top-level names no process of a run may hold, compared whole.
SCAN = """
import sys, time
from kpt_bench import harness
from kpt_bench.tests._tiny import tiny_cell, run
{body}
bad = sorted({{m.split('.')[0] for m in sys.modules}} & {{{banned}}})
print('BAD' if bad else 'CLEAN', bad)
"""


def _scan(body: str, banned) -> str:
    code = SCAN.format(body=body, banned=", ".join(repr(b) for b in banned))
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                          cwd=str(harness.ROOT)).stdout


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = _scan("import kpt_bench.run, kpt_bench.calibrate\nrun(tiny_cell('temporal.spline1080'))",
                harness.BANNED)
    assert "CLEAN" in out, out
    assert harness.BANNED == ("jax", "jaxlib", "flax", "kylespathtracer_tpu")


def test_the_reference_imports_nothing_of_the_program():
    out = _scan("import kpt_bench.reference.frame, kpt_bench.reference.adam, kpt_bench.scenes, "
                "kpt_bench.roofline, kpt_bench.trace", harness.BANNED + ("kylespathtracer_tpu_torch",))
    assert "CLEAN" in out, out


def test_no_card_exits_nonzero_without_a_result():
    p = subprocess.run([sys.executable, "-m", "kpt_bench.run", "--workload", "temporal.spline1080", "--seed",
                        str(2**31 + 5), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=str(harness.ROOT))
    assert p.returncode != 0 and p.stdout.strip() == ""
