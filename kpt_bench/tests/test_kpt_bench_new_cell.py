"""A cell, its loop and its per-layer metrics enter the benchmark as new files
and entries only.

In a copy of kpt_bench/ and BENCHMARK.json under a temporary directory, the
test adds a throwaway cell: a loop kinds/<loop>.py that drives the port's
`render/wavefront.render_pathtraced` (K7's plain route on the CPU) at 16x8,
its configuration and traffic files, one workload, one `program_span` metric
and one `<kernel>_roofline` metric with a reader file each, and the cell's
name appended to `frame_ms`'s workloads; it changes no other file. Then, on
that copy, it runs the benchmark's per-cell and per-metric test files as
they are, and a traced run of the new cell. The cell never enters the
repository's BENCHMARK.json, and nothing is written outside the copy.

    python -m pytest kpt_bench/tests/test_kpt_bench_new_cell.py -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from kpt_bench import harness

LOOP = "toy_paths"
CONFIG = "toy_paths"
TRAFFIC = "toy_paths16"
CELL = "toy_paths.spp2_16"
SPAN_METRIC = "toy.paths.launches"
ROOFLINE = "toy_k7_roofline"
# The test files that run once per cell or once per metric of BENCHMARK.json.
PER_CELL_TESTS = ("test_kpt_bench_harness.py", "test_kpt_bench_spans.py")

FILES = {
    f"kinds/{LOOP}.py": '''"""A throwaway loop: frames of the port's wavefront path tracer, K7's plain
route on the CPU. Check: every frame compared is rendered again from its
frame number and must match to the bit."""

from __future__ import annotations

import time

import torch

from kpt_bench import harness, scenes
from kpt_bench.kinds import Kind

CHECKS = ("repeat_far",)


class Loop(Kind):
    @classmethod
    def tiny(cls, cell) -> None:
        cell.config["render"] = dict(cell.config["render"], spp=1)

    def __init__(self, cell, seed: int, device):
        from kylespathtracer_tpu_torch.render import wavefront
        from kylespathtracer_tpu_torch.render.camera import Camera
        from kylespathtracer_tpu_torch.scene.types import scene_from_numpy
        from kylespathtracer_tpu_torch.utils.config import RenderConfig

        self.cell, self.device, self.render = cell, torch.device(device), wavefront.render_pathtraced
        tr, rc = cell.traffic, cell.config["render"]
        self.scene = scene_from_numpy(scenes.default_scene(), device=self.device)
        self.camera = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=self.device)
        self.config = RenderConfig(width=int(tr["width"]), height=int(tr["height"]), spp=int(rc["spp"]),
                                   max_depth=int(rc["max_depth"]))
        self.base = seed % 1000
        self.kept = [(self.base, self.render(self.scene, self.camera, self.config, self.base))]

    def window(self, seconds: float, trace_steps: int) -> dict:
        from kpt_bench import trace as tr_mod

        out, n = {}, 0
        t0 = time.perf_counter()
        if trace_steps:
            with tr_mod.profiled(self.device) as traced:
                for _ in range(trace_steps):
                    img = self.render(self.scene, self.camera, self.config, self.base + 1 + n)
                    n += 1
            out.update(traced=traced, traced_steps=trace_steps)
        while n == 0 or time.perf_counter() - t0 < seconds:
            img = self.render(self.scene, self.camera, self.config, self.base + 1 + n)
            n += 1
        self.kept.append((self.base + n, img))
        out.update(steps=n, metrics={"frame_ms": (time.perf_counter() - t0) * 1e3 / n})
        return out

    def check(self) -> list:
        far = max(float((self.render(self.scene, self.camera, self.config, f) != img).float().mean())
                  for f, img in self.kept)
        return [harness.Check("repeat_far", far, float(self.cell.traffic["limits"]["repeat_far"]))]

    def facts(self) -> dict:
        return {"pixels": self.config.width * self.config.height, "spp": self.config.spp,
                "depth": self.config.max_depth, "per_step": {"k7": 1}}
''',
    f"configs/{CONFIG}.json": json.dumps({
        "name": CONFIG, "chips": 1, "scene": {"kind": "default"},
        "render": {"spp": 2, "max_depth": 3}, "reduced": []}, indent=1) + "\n",
    f"traffic/{TRAFFIC}.json": json.dumps({
        "kind": LOOP, "width": 16, "height": 8, "trace_steps": 4, "limits": {"repeat_far": 0.0}}, indent=1) + "\n",
    f"metrics/{SPAN_METRIC}.py": '''"""toy.paths.launches (count a frame): launches inside a `toy.paths` stage
of a `toy` span. The port has no such span, so this reads nothing."""

from kpt_bench.spans import stage_value


def read(ctx):
    return stage_value(ctx, "toy", "toy.paths", "launches")
''',
    f"metrics/{ROOFLINE}.py": '''"""toy_k7_roofline (%): a toy count of K7's work over its device time (events
whose name starts with `kpt::path_kernel(`); nothing to read on the CPU."""

from kpt_bench import roofline

MATCH = "kpt::path_kernel("


def work(f):
    return f["pixels"] * f["spp"] * f["depth"] * 100, f["pixels"] * 12


def read(ctx):
    n = ctx.traced.kernel_count(lambda name: name.startswith(MATCH))
    t = ctx.traced.kernel_seconds(lambda name: name.startswith(MATCH))
    if not n or t <= 0 or "pixels" not in ctx.facts:
        return None
    ops, nbytes = work(ctx.facts)
    return 100.0 * roofline.least_seconds(ops * n, nbytes * n) / t
''',
}


def entries() -> dict:
    """The cell's new BENCHMARK.json entries, by group."""
    return {
        "configs": [{"name": CONFIG, "source": "https://github.com/CamelCaseKyle/KylesPathtracer",
                     "file": f"kpt_bench/configs/{CONFIG}.json", "reduced": [],
                     "why": "a throwaway configuration of the wavefront path tracer"}],
        "workloads": [{"name": CELL, "config": CONFIG, "traffic": TRAFFIC, "chips": 1,
                       "why": "a throwaway cell: frames of the wavefront path tracer, K7"}],
        "per_layer": [{"name": SPAN_METRIC, "unit": "count", "better": "lower", "source": "program_span",
                       "layer": "render/wavefront", "moves": "frame_ms", "workloads": [CELL]},
                      {"name": ROOFLINE, "unit": "%", "better": "higher", "source": "device_trace",
                       "layer": "ops/path_kernel (K7)", "moves": "frame_ms", "workloads": [CELL]}],
    }


def tree(root: Path) -> dict:
    """{relative path: bytes} of the files under root, caches left out."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def add_cell(root: Path) -> None:
    """Write the new cell's files and entries into the copy at `root`."""
    for rel, text in FILES.items():
        path = root / "kpt_bench" / rel
        assert not path.exists(), rel
        path.write_text(text)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for group, new in entries().items():
        bench[group] = bench[group] + new
    frame_ms = next(m for m in bench["end_to_end"] if m["name"] == "frame_ms")
    frame_ms["workloads"] = frame_ms["workloads"] + [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1) + "\n")


def env_for(root: Path) -> dict:
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    env["PYTHONPATH"] = os.pathsep.join([str(root), str(harness.ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


TRACED = """
import json, sys
from kpt_bench import harness
from kpt_bench.tests._tiny import tiny_cell, run
cell = tiny_cell({cell!r}, 16, 8)
out = run(cell, trace=True)
out.pop("_checks")
loop = sys.modules[harness.kind_class(cell.traffic["kind"]).__module__]
print(json.dumps({{"harness": harness.__file__, "out": out, "per_layer": [m["name"] for m in cell.per_layer],
                   "checks": list(loop.CHECKS)}}))
"""


def test_a_new_cell_enters_as_new_files_and_entries(tmp_path):
    repo_before = tree(harness.HERE), (harness.ROOT / "BENCHMARK.json").read_bytes()
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "kpt_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = tree(root)
    add_cell(root)
    after = tree(root)
    # New files and BENCHMARK.json's entries, nothing else.
    assert {k for k in before if after[k] != before[k]} == {"BENCHMARK.json"}
    assert set(after) - set(before) == {f"kpt_bench/{rel}" for rel in FILES}
    old, new = (json.loads(t) for t in (before["BENCHMARK.json"], after["BENCHMARK.json"]))
    for group in ("configs", "workloads", "per_layer"):
        assert new[group] == old[group] + entries()[group]
    assert [dict(m, workloads=[c for c in m.get("workloads", []) if c != CELL]) for m in new["end_to_end"]] == \
        [dict(m, workloads=m.get("workloads", [])) for m in old["end_to_end"]]
    assert {k: v for k, v in new.items() if k not in entries() and k != "end_to_end"} == \
        {k: v for k, v in old.items() if k not in entries() and k != "end_to_end"}

    # The per-cell and per-metric tests, as they are, on the copy.
    tests = [f"kpt_bench/tests/{t}" for t in PER_CELL_TESTS]
    p = subprocess.run([sys.executable, "-m", "pytest", *tests, "-v", "-p", "no:cacheprovider", "-p", "no:randomly",
                        "--rootdir", str(root)], cwd=str(root), env=env_for(root), capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stdout[-6000:] + p.stderr[-3000:]
    assert f"rootdir: {root}" in p.stdout, p.stdout[:2000]
    passed = [ln.split(" ")[0] for ln in p.stdout.splitlines() if " PASSED" in ln]
    per_cell = [t for t in passed if "[temporal.spline1080]" in t]
    assert per_cell, p.stdout[-3000:]
    for t in per_cell:
        assert t.replace("[temporal.spline1080]", f"[{CELL}]") in passed, (t, p.stdout[-3000:])

    # A traced run of the new cell on the copy.
    p = subprocess.run([sys.executable, "-c", TRACED.format(cell=CELL)], cwd=str(root), env=env_for(root),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert Path(got["harness"]).resolve() == (root / "kpt_bench" / "harness.py").resolve()
    out = got["out"]
    assert out["correct"] is True and out["attempted"] > 0 and "breakdown" in out and out["device"]["window_s"] > 0
    assert list(out["checks"]) == got["checks"] == ["repeat_far"]
    assert set(got["per_layer"]) == {SPAN_METRIC, ROOFLINE} and set(out["metrics"]) <= set(got["per_layer"])

    # The repository's own benchmark is as it was.
    assert (tree(harness.HERE), (harness.ROOT / "BENCHMARK.json").read_bytes()) == repo_before
    assert CELL not in {w["name"] for w in harness.load_bench()["workloads"]}
