"""Structured metrics: one JSONL record per step.

The `MetricsLogger` of kylespathtracer_tpu/utils/metrics.py (numpy- and
jax-free there too), copied; its `jax.profiler` helpers have the
torch.profiler spans of render/pipeline.py (STAGES) as their counterpart.
"""

from __future__ import annotations

import json
import sys
import time


class MetricsLogger:
    """Append-only JSONL metrics sink (a file, else stderr)."""

    def __init__(self, path=None, echo: bool = False):
        self._file = open(path, "a") if path else None
        self._echo = echo or path is None
        self._t0 = time.perf_counter()

    def log(self, **record) -> None:
        record.setdefault("t", round(time.perf_counter() - self._t0, 6))
        line = json.dumps(record)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._file:
            self._file.close()
