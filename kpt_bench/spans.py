"""Device time, launches and device idle time by stage, read from the
program's own spans in a torch.profiler trace.

The program wraps each step in one parent span (`frame` around a frame of
render/pipeline.py:render_frame, `fit.step` around an optimizer step of
diff/inverse.py:fit) and its stages in child spans (`frame.*`, `fit.*`),
all `user_annotation` events on the host's clock, the clock the trace puts
the device's events on. `split(traced, prefix)` reads the traced window:

- a stage is a direct child of a parent span, on the same thread, named in
  the parent's family (`frame.` for `frame`, `fit.` for `fit.step`); spans
  nested in a stage (`fit.view`) roll up into it;
- device time and launches: each device event is joined to the CUDA API
  call that launched it (`cuda_runtime` or `cuda_driver`) by its
  `correlation` arg (in a trace without it, by the `ac2g` flow events,
  which carry the same link), and charged to the stage that holds that
  call on the same thread. That holds for the ctypes launches of the
  hand-written kernels too: CUPTI records their runtime calls. Work
  launched under no stage goes to `<prefix>.outside`;
- idle time: the window less the union of the device's intervals, cut by
  each stage's host interval; what falls under no stage (the loop between
  steps, a step's own code between its stages) goes to `<prefix>.outside`;
- the `cudaMalloc` calls inside the parent spans.

Steps are the parent spans that start inside the window, not the loop's
count. Every number is per step. The stages of one window are taken to run
on one host thread, so their intervals do not overlap.
"""

from __future__ import annotations

import bisect
import collections
import weakref

from kpt_bench.trace import DEVICE_CATEGORIES

HOST_CALLS = ("cuda_runtime", "cuda_driver")
ANNOTATION = "user_annotation"
MALLOC = "cudaMalloc"
# Slack (µs) for a child's end against its parent's: the trace rounds each
# start and duration to the nanosecond.
EPS_US = 0.01

_SPLITS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _complete(events: list, cats) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e]


def _thread(e: dict) -> tuple:
    return e.get("pid"), e.get("tid")


def _span(e: dict) -> tuple:
    s = float(e["ts"])
    return s, s + float(e["dur"])


def family(prefix: str) -> str:
    """The stage names' family of a parent span: `frame.` for `frame`,
    `fit.` for `fit.step`."""
    return prefix.split(".")[0] + "."


def launch_points(events: list) -> dict:
    """id() of each device event → (thread, host µs) of the call that
    launched it, by `correlation`, else by the `ac2g` flow events."""
    calls = {}
    for e in _complete(events, HOST_CALLS):
        c = e.get("args", {}).get("correlation")
        if c is not None:
            calls[c] = (_thread(e), float(e["ts"]))
    starts, ends = {}, {}
    for e in events:
        if e.get("cat") == "ac2g" and e.get("ph") in ("s", "f"):
            (starts if e["ph"] == "s" else ends)[e["id"]] = e
    by_end = {(_thread(f), float(f["ts"])): i for i, f in ends.items()}
    out = {}
    for d in _complete(events, DEVICE_CATEGORIES):
        c = d.get("args", {}).get("correlation")
        if c in calls:
            out[id(d)] = calls[c]
            continue
        s = starts.get(by_end.get((_thread(d), float(d["ts"]))))
        if s is not None:
            out[id(d)] = (_thread(s), float(s["ts"]))
    return out


class _Intervals:
    """Non-overlapping named host intervals by thread: which holds a point."""

    def __init__(self, rows):
        self.by = collections.defaultdict(list)
        for thread, s, e, name in sorted(rows, key=lambda r: r[1]):
            self.by[thread].append((s, e, name))
        self.starts = {t: [r[0] for r in by] for t, by in self.by.items()}

    def at(self, thread, t: float):
        rows = self.by.get(thread)
        if not rows:
            return None
        i = bisect.bisect_right(self.starts[thread], t) - 1
        return rows[i][2] if i >= 0 and t < rows[i][1] else None


def stages_of(events: list, prefix: str, window: tuple) -> tuple:
    """The parent spans named `prefix` that start in `window` and their
    direct children of the family → (parents, stages), each a list of
    (thread, start, end, name)."""
    notes = _complete(events, (ANNOTATION,))
    parents = [(_thread(e), *_span(e), e["name"]) for e in notes
               if e["name"] == prefix and window[0] <= float(e["ts"]) <= window[1]]
    fam = family(prefix)
    kids = collections.defaultdict(list)
    for e in notes:
        if e["name"].startswith(fam) and e["name"] != prefix:
            kids[_thread(e)].append((*_span(e), e["name"]))
    for rows in kids.values():
        rows.sort(key=lambda r: (r[0], -r[1]))  # a parent before its children
    starts = {t: [r[0] for r in rows] for t, rows in kids.items()}
    stages = []
    for thread, ps, pe, _ in parents:
        rows = kids.get(thread, [])
        end = None
        for s, e, name in rows[bisect.bisect_left(starts.get(thread, []), ps):]:
            if s >= pe:
                break
            if e > pe + EPS_US or (end is not None and s < end):
                continue  # not inside the parent, or nested in a stage
            stages.append((thread, s, e, name))
            end = e
    return parents, stages


def _idle(events: list, window: tuple, stages: list) -> tuple:
    """Idle µs in the window under each stage → (by stage name, total)."""
    dev = sorted(_span(d) for d in _complete(events, DEVICE_CATEGORIES))
    gaps, end = [], window[0]
    for s, e in dev:
        if s > end:
            gaps.append((end, min(s, window[1])))
        end = max(end, e)
        if end >= window[1]:
            break
    if window[1] > end:
        gaps.append((end, window[1]))
    gaps = [(a, b) for a, b in gaps if b > a]
    rows = sorted((s, e, name) for _, s, e, name in stages)
    by, j = collections.Counter(), 0
    for a, b in gaps:
        while j < len(rows) and rows[j][1] <= a:
            j += 1
        k = j
        while k < len(rows) and rows[k][0] < b:
            s, e, name = rows[k]
            by[name] += max(0.0, min(b, e) - max(a, s))
            k += 1
    return by, sum(b - a for a, b in gaps)


def split(traced, prefix: str):
    """The traced window by stage of the steps named `prefix` → {"steps",
    "mallocs" (a step), "stages": {stage: {"device_ms", "launches",
    "idle_ms"} a step}, with `<prefix>.outside` among the stages}; None
    where the window holds no such span or the trace no device event."""
    cached = _SPLITS.setdefault(traced, {})
    if prefix not in cached:
        cached[prefix] = _split(traced.events, traced.window_us, prefix)
    return cached[prefix]


def _split(events: list, window: tuple, prefix: str):
    inside = lambda t: window[0] <= t <= window[1]
    points = launch_points(events)
    # The window's device events: launched in it, or, where the launch is
    # not in the trace, starting in it.
    dev = [d for d in _complete(events, DEVICE_CATEGORIES)
           if inside(points[id(d)][1] if id(d) in points else float(d["ts"]))]
    parents, stages = stages_of(events, prefix, window)
    if not parents or not dev:
        return None
    outside = f"{prefix}.outside"
    held = _Intervals(stages)
    in_step = _Intervals(parents)
    ms, launches = collections.Counter(), collections.Counter()
    for d in dev:
        p = points.get(id(d))
        name = (held.at(*p) if p else None) or outside
        ms[name] += float(d["dur"])
        launches[name] += 1
    idle, total = _idle(events, window, stages)
    idle[outside] = total - sum(idle.values())
    mallocs = sum(1 for e in _complete(events, HOST_CALLS)
                  if e["name"] == MALLOC and in_step.at(_thread(e), float(e["ts"])) is not None)
    n = len(parents)
    names = sorted({name for *_, name in stages} | {outside})
    return {"steps": n, "mallocs": mallocs / n,
            "stages": {k: {"device_ms": ms[k] / 1e3 / n, "launches": launches[k] / n, "idle_ms": idle[k] / 1e3 / n}
                       for k in names}}


def stage_value(ctx, prefix: str, stage: str, what: str):
    """One number of `split` for a metric's reader: `what` of `stage` a
    step, None where the stage's span is not in the trace."""
    s = split(ctx.traced, prefix)
    if s is None or stage not in s["stages"]:
        return None
    return s["stages"][stage][what]
