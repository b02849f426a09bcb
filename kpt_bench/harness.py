"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name `BENCHMARK.json` gives it:
`configs/<config>.json` (named by the configuration's `file`),
`traffic/<traffic>.json`, `metrics/<metric>.py`. A traffic mix names its
`kind`, the loop that drives it (the class `Loop` of `kinds/<kind>.py`),
and holds that loop's parameters and the limits of its check. The loop
reports its end-to-end metrics by name; the run prints those that
`BENCHMARK.json` lists for the cell. A per-layer metric split by the
end-to-end metric it moves (`<metric>.<split>`, as `mfu.frame` and
`mfu.step`) is read by `metrics/<metric>.py` where it has no file of its
own. The program's launch counters that the readers get are `LAUNCHES` of
every module of its ops package that keeps one (`counted_modules`), so a
cell on another kernel needs no edit here either.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that no process of a run may hold once its window
# has closed: JAX, and the JAX package the port was made from. Compared
# whole, since the port's own name begins with the JAX package's.
BANNED = ("jax", "jaxlib", "flax", "kylespathtracer_tpu")
# The program's package of kernel wrappers, and the line by which one of its
# modules keeps a launch counter.
OPS = "kylespathtracer_tpu_torch.ops"
COUNTER = re.compile(r"^LAUNCHES\s*=", re.M)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def render(self) -> dict:
        """The render knobs: the configuration's, then the traffic's."""
        return {**self.config["render"], **self.traffic.get("render", {})}


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def with_pending(root: Path = ROOT) -> dict:
    """BENCHMARK.json, with the entries of each pending/<cell>.json whose
    names it lacks: a cell built and kept out of it, which a run can still
    name and which a later change admits by copying those entries over."""
    bench = load_bench(root)
    for path in sorted((HERE / "pending").glob("*.json")):
        entries = json.loads(path.read_text())
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            have = {e["name"] for e in bench[group]}
            bench[group] = bench[group] + [e for e in entries.get(group, []) if e["name"] not in have]
    return bench


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = with_pending(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"kpt_bench: no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_file(metric: str) -> Path:
    """metrics/<metric>.py, or for a split metric `<base>.<split>` without a
    file of its own, metrics/<base>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = HERE / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    if not path.exists():
        raise SystemExit(f"kpt_bench: no reader for the metric {metric!r} under {HERE / 'metrics'}")
    return path


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location("kpt_bench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str):
    """The `read` of the metric's file."""
    return load_module(metric_file(metric)).read


def kind_class(kind: str):
    """The loop a traffic mix names: `Loop` of kinds/<kind>.py."""
    if not (HERE / "kinds" / f"{kind}.py").exists():
        raise SystemExit(f"kpt_bench: no loop kinds/{kind}.py")
    return importlib.import_module(f"kpt_bench.kinds.{kind}").Loop


def port_config(rc: dict, **over):
    """The program's RenderConfig for the render knobs `rc`."""
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    smp = int(rc["smp"])
    kw = dict(width=int(rc["width"]), height=int(rc["height"]), biased=bool(rc["biased"]),
              temporal=int(rc.get("temporal", 16)), gloss=float(rc["gloss"]), brightness=float(rc["brightness"]),
              fov=float(rc["fov"]), pipeline=rc["pipeline"], soft_shadows=float(rc.get("soft_shadows", 0.0)),
              reproject_backend=rc.get("reproject_backend", "window"),
              reproject_window=int(rc.get("reproject_window", 4)),
              temporal_fusion=rc.get("temporal_fusion", "split"),
              decorrelate_samples=bool(rc.get("decorrelate_samples", False)),
              **{k: smp for k in ("smp_direct_lambert", "smp_lambert_surface_lambert", "smp_lambert_surface_phong",
                                  "smp_direct_phong", "smp_phong_surface_lambert", "smp_phong_surface_phong")})
    kw.update(over)
    return RenderConfig(**kw)


@dataclasses.dataclass
class Check:
    """One number the check compares, with its limit (lower passes)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def banned_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


class Context:
    """What a per-layer metric's reader reads: the traced window (`traced`, a
    trace.Traced), the steps in it, the kind's facts (the scene's tables,
    the render knobs, pixels and shaded pixels a launch, kernels a step, the
    traced time a step) and the program's launch counters per step."""

    def __init__(self, traced, steps: int, facts: dict, counters: dict):
        self.traced, self.steps, self.facts, self.counters = traced, steps, facts, counters


@functools.cache
def counted_modules() -> tuple:
    """Every module of the program's ops package that keeps a launch counter:
    one whose source sets a top-level `LAUNCHES`. Found by reading the
    sources, so a new kernel's module is counted with no edit here, and a
    module without a counter is not imported."""
    root = Path(importlib.util.find_spec(OPS).submodule_search_locations[0])
    names = sorted(p.stem for p in root.glob("*.py") if COUNTER.search(p.read_text()))
    return tuple(importlib.import_module(f"{OPS}.{n}") for n in names)


def launch_counters() -> dict:
    """The program's own launch counters, `LAUNCHES` of each counted module,
    by the module's name."""
    return {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in counted_modules()}


def note(what: str, since: float) -> float:
    """Log a stage of the set-up and its seconds on stderr → the time now."""
    now = time.perf_counter()
    print(f"kpt_bench: {what} {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def over_ranks(mem: int, busy: float, device) -> tuple:
    """(the largest memory peak, the mean busy seconds, the number of ranks)
    over the ranks of the run's process group; this rank's own and 1 where
    there is none."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return mem, busy, 1
    on = device if dist.get_backend() == "nccl" else "cpu"
    peak = torch.tensor([float(mem)], dtype=torch.float64, device=on)
    total = torch.tensor([float(busy)], dtype=torch.float64, device=on)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    dist.all_reduce(total)
    return int(peak.item()), float(total.item()) / dist.get_world_size(), dist.get_world_size()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run → the result dict (`correct`, `attempted`, `failed`,
    `metrics`, `device`, `breakdown`, `checks`). `t0` is the wall-clock time
    (time.time()) the run's process started."""
    print(f"kpt_bench: set-up: process start, imports, the card {time.time() - t0:.3f} s", file=sys.stderr)
    kind = kind_class(cell.traffic["kind"])(cell, seed, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t0
    c0 = launch_counters()
    trace_steps = int(cell.traffic["trace_steps"]) if trace else 0
    win = kind.window(float(seconds), trace_steps)
    counters = {k: v - c0[k] for k, v in launch_counters().items()}
    launched = {k: v for k, v in counters.items() if v}
    print(f"kpt_bench: kernel launches in the window, by module: {launched}", file=sys.stderr)
    mem = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    # Read before the check frees the program's state; the readers run
    # after it, once the check has found its frames' hits.
    mem, busy, count = over_ranks(mem, win["traced"].busy_s() if trace else 0.0, device)
    if trace:
        window_s = win["traced"].window_s
    t = time.perf_counter()
    checks = kind.check()
    note("the check (not set-up)", t)
    metrics = {}
    if trace:
        ctx = Context(win["traced"], win["traced_steps"],
                      {**kind.facts(), "step_s": window_s / max(win["traced_steps"], 1)},
                      {k: v / max(win["steps"], 1) for k, v in counters.items()})
        for m in cell.per_layer:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, **win["metrics"]}
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in e2e]
        if missing:
            raise SystemExit(f"kpt_bench: the loop {cell.traffic['kind']!r} reports {sorted(e2e)}, not {missing}")
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else "cpu",
           "count": count, "memory_peak_bytes": int(mem)}
    out = {"correct": all(c.ok for c in checks), "attempted": int(win["steps"]),
           "failed": int(win["steps"]) if not all(c.ok for c in checks) else 0,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = float(busy)
        dev["window_s"] = float(window_s)
        from kpt_bench import trace as tr

        top = (tr.summarize_trace(win["traced"].events, max(win["traced_steps"], 1))["top_device_events"]
               if tr.device_events(win["traced"].events) else [])
        out["breakdown"] = {"device_ops": [[t["name"], t["total_ms"] / 1e3] for t in top],
                            "idle_gaps": tr.idle_gaps(win["traced"].events, win["traced"].window_us)}
    out["checks"] = {c.name: {"value": float(c.value), "limit": float(c.limit)} for c in checks}
    out["_checks"] = checks
    return out
