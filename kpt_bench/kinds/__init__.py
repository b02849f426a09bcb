"""The loops that drive a cell's traffic, one module per kind of traffic.

A kind is the module kinds/<kind>.py, named by a traffic mix's `kind`. Its
`CHECKS` names, in order, the numbers its check compares: the keys of the
traffic's `limits`. Its class `Loop` is built once per run (its set-up),
then `window(seconds, trace_steps)` runs the measured window and returns
{"steps", "metrics" (its end-to-end metrics by name) and, when tracing,
"traced" (a trace.Traced) and "traced_steps"}; `check()` frees the
program's state and compares what the timed path produced with the plain
reference (a list of harness.Check, one for each of `CHECKS`); `faults()`
gives, by side, the numbers of the check with the control, and each fault
the reference stands in for, in the program's place
(kpt_bench/calibrate.py); `facts()` gives the per-layer metrics' readers
the work of a step; `Loop.tiny(cell)` cuts what belongs to this loop in a
harness.Cell to a size the CPU runs in seconds, for the benchmark's tests
(kpt_bench/tests/_tiny.py cuts the image and the traced steps).
"""

from __future__ import annotations


class Kind:
    @classmethod
    def tiny(cls, cell) -> None:
        """Cut the loop's own parameters in `cell` for the CPU; none by
        default."""

    def facts(self) -> dict:
        return {}
