"""A cell on several cards, on the CPU: the rank launcher (kpt_bench/ranks.py)
with a stand-in body on 2 gloo ranks, and the row-sharded loop
(kinds/rows.py) on 2 gloo ranks at 64x32 through harness.run_cell, sound and
with each fault planted in the program; in one process, its control and the
faults the reference stands in for fail the limits.

    python -m pytest kpt_bench/tests -q
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from kpt_bench import harness
from kpt_bench.kinds import rows
from kpt_bench.tests import _rank_worker as worker
from kpt_bench.tests._rank_worker import ROWS
from kpt_bench.tests._tiny import SEED, tiny_cell
from kpt_bench.tests._tiny import run as tiny_run
from kpt_bench.tests.test_kpt_bench_harness import NAME

KPT_ENV = ("KPT_COORDINATOR", "KPT_NUM_PROCESSES", "KPT_PROCESS_ID")


def start(*args, timeout: float = 240):
    """Rank 0 of the worker → (exit code, stdout lines, stderr, pids of the
    ranks)."""
    env = {k: v for k, v in os.environ.items() if k not in KPT_ENV}
    env.update(GLOO_SOCKET_IFNAME="lo", PYTHONPATH=str(harness.ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-m", "kpt_bench.tests._rank_worker", *map(str, args)], env=env,
                       cwd=str(harness.ROOT), capture_output=True, text=True, timeout=timeout)
    pids = [int(m) for m in re.findall(r"^pid (\d+) rank", p.stdout + p.stderr, re.M)]
    return p.returncode, p.stdout.strip().splitlines(), p.stderr, pids


def gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_only_rank_0_prints_the_result():
    rc, out, err, pids = start("stub", "ok", 2, 120)
    assert rc == 0, err[-3000:]
    assert json.loads(out[-1]) == {"rank": 0}
    assert not [ln for ln in out if "rank 1" in ln] and "rank 1" in err
    assert len(pids) == 2 and all(gone(p) for p in pids)


@pytest.mark.parametrize("mode", ["fail", "hang", "raise"])
def test_a_failed_rank_leaves_no_result_and_no_process(mode):
    """Rank 1 exits non-zero, or hangs past the limit (here 20 s), or rank 0's
    own body raises: no result line, a non-zero exit, every rank gone."""
    rc, out, err, pids = start("stub", mode, 2, 20)
    assert rc != 0 and not any(ln.startswith("{") for ln in out), (rc, out, err[-3000:])
    assert len(pids) == 2 and all(gone(p) for p in pids), pids
    if mode == "hang":
        assert "not done within 20 s" in err


def _failed(line: dict) -> set:
    return {k for k, c in line["checks"].items() if not (c["value"] <= c["limit"])}


@pytest.mark.parametrize("fault", [worker.SOUND, *worker.FAULTS])
def test_the_loop_on_two_ranks(fault):
    """Sound, the check reads `correct` and the ranks' parameters agree to the
    bit; each fault planted in the program turns it false."""
    rc, out, err, pids = start("rows", fault, 2)
    assert rc == 0, err[-4000:]
    line = json.loads(out[-1])
    assert line["device"]["count"] == 2 and line["attempted"] > 0
    assert set(line["checks"]) == set(rows.CHECKS) and set(line["metrics"]) == {"shard_step_ms", "setup_s"}
    bad = _failed(line)
    expect = {worker.SOUND: set(), "grad_left_out": {"grad_gap"}, "params_changed": {"rank_param_gap"},
              "state_left_unchanged": {"step_gap"}, "half_tiles_left_out": {"loss_gap"},
              "exchange_left_out": {"loss_gap", "rank_param_gap"}}[fault]
    if fault == worker.SOUND:
        assert line["correct"] is True and not bad and line["checks"]["rank_param_gap"]["value"] == 0.0, line
    else:
        assert line["correct"] is False and expect <= bad, (fault, line["checks"])
    assert all(gone(p) for p in pids)


def test_the_cell_loads_from_its_files():
    """Kept out of BENCHMARK.json, the cell loads by name from its pending
    entries, which name a loop, its checks and readers for its metrics, and
    would pass BENCHMARK.json's own rules once copied there."""
    c = harness.load_cell(ROWS)
    assert c.chips == 4 == c.config["chips"] and harness.kind_class(c.traffic["kind"]) is rows.Loop
    assert set(c.traffic["limits"]) == set(rows.CHECKS)
    assert {m["name"] for m in c.end_to_end} == {"shard_step_ms", "setup_s"} and c.per_layer
    for m in c.per_layer:
        assert callable(harness.load_reader(m["name"])) and m["moves"] == "shard_step_ms"
    bench, merged = harness.load_bench(), harness.with_pending()
    assert ROWS not in {w["name"] for w in bench["workloads"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in merged[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert sum(w["chips"] == 4 for w in merged["workloads"]) <= max(1, len(merged["workloads"]) // 4)
    assert all(len(e["why"]) <= 200 for e in merged["configs"] + merged["workloads"])


def test_the_control_and_the_faults_fail_the_limits():
    cell = tiny_cell(ROWS)
    kind = harness.kind_class("rows")(cell, SEED, "cpu")
    kind.window(0.0, 0)
    lim = {k: float(v) for k, v in cell.traffic["limits"].items()}
    sides = kind.faults()
    assert set(sides) == {"control", "one_tile", "half_tiles"}
    for side, got in sides.items():
        assert any(not (got[k] <= lim[k]) for k in ("loss_gap", "grad_gap", "step_gap")), (side, got)


def test_one_rank_traced():
    """The loop on one rank (no process group) with --trace 1: correct, a
    breakdown, and only the cell's per-layer metrics."""
    cell = tiny_cell(ROWS)
    out = tiny_run(cell, trace=True)
    assert out["correct"] and "breakdown" in out and out["device"]["window_s"] > 0
    assert out["device"]["count"] == 1
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
