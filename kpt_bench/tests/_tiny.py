"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests:
the program's plain versions stand in for its kernels there."""

from __future__ import annotations

import time

from kpt_bench import harness

SEED = 2**31 + 4099
# The row-sharded cell, kept out of BENCHMARK.json (pending/<cell>.json).
ROWS = "inverse10_rows4.step1080"


def tiny_cell(name: str, width: int = 32, height: int = 16):
    cell = harness.load_cell(name)
    kind = cell.traffic["kind"]
    cell.traffic.update(width=width, height=height, block_rows=8, target_rows=8, trace_steps=2)
    if kind == "temporal":
        cell.traffic.update(warmup_frames=2, check_within=3, check_frames=2)
    else:
        cell.config["optimizer"] = dict(cell.config["optimizer"], realizations=2)
    if kind == "fit":
        cell.traffic.update(chunk_steps=2)
    if kind == "rows":
        cell.traffic.update(warm_steps=2)
    return cell


def run(cell, trace: bool = False, seconds: float = 0.2, seed: int = SEED) -> dict:
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.time())
