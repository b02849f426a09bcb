"""The loops that drive a cell's traffic, one module per kind of traffic.

A kind is the class `Loop` of kinds/<kind>.py, named by a traffic mix's
`kind`. It is built once per run (its set-up), then `window(seconds,
trace_steps)` runs the measured window and returns {"steps", "metrics"
(its end-to-end metrics by name) and, when tracing, "traced" (a
trace.Traced) and "traced_steps"}; `check()` frees the
program's state and compares what the timed path produced with the plain
reference (a list of harness.Check); `faults()` gives, by side, the
numbers of the check with the control, and each fault the reference stands
in for, in the program's place (kpt_bench/calibrate.py); `facts()` gives
the per-layer metrics' readers the work of a step.
"""

from __future__ import annotations


class Kind:
    def facts(self) -> dict:
        return {}
