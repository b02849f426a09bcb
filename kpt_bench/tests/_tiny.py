"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests:
the program's plain versions stand in for its kernels there."""

from __future__ import annotations

import time

from kpt_bench import harness

SEED = 2**31 + 4099
# The blocks of image rows a traffic renders its targets and its reference in.
ROW_BLOCKS = ("block_rows", "target_rows")


def tiny_cell(name: str, width: int = 32, height: int = 16):
    """The cell `name` at width × height, 2 traced steps, blocks of 8 rows
    where its traffic has them; the rest its loop cuts (`Loop.tiny`)."""
    cell = harness.load_cell(name)
    cell.traffic.update(width=width, height=height, trace_steps=2)
    cell.traffic.update({k: 8 for k in ROW_BLOCKS if k in cell.traffic})
    harness.kind_class(cell.traffic["kind"]).tiny(cell)
    return cell


def run(cell, trace: bool = False, seconds: float = 0.2, seed: int = SEED) -> dict:
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.time())
