"""Run one cell of the benchmark once.

    python3 -m kpt_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run makes its inputs from the seed, sets
up and warms the cell's shapes (`setup_s`), measures for `--seconds`, checks
what the timed path produced against the plain reference (`correct`), and
prints one JSON line last on standard output; the numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key. `--trace 1` is a run of its own under torch.profiler and reports
the per-layer metrics. A cell on n > 1 cards runs as n ranks, one a card
(kpt_bench/ranks.py): this process is rank 0 and starts the others, and
only rank 0 reports. The run exits non-zero, and prints no result, with
fewer CUDA cards than the cell asks for, if JAX or the JAX package was
loaded on any rank, or if a rank fails.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Kernel caches live inside the checkout, at fixed paths (the program's own
# nvcc build goes to build/kernels/ there).
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(out: dict) -> int:
    """Print the checks on stderr and the result on stdout; → exit code."""
    from kpt_bench import harness

    bad = harness.banned_modules()
    if bad:
        print(f"kpt_bench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    checks = out.pop("_checks")
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from kpt_bench import harness, ranks

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"kpt_bench: {args.workload} needs {cell.chips} CUDA card(s), found {n}", file=sys.stderr)
        return 2

    def body(rank: int) -> dict:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        return harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T0)

    if cell.chips == 1:
        return report(body(0))
    if ranks.rank() == 0:
        # One build of the kernels, before the other ranks start and load it.
        from kylespathtracer_tpu_torch.ops import _build

        _build.build()
    argv = ["--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
            "--trace", str(args.trace)]
    return ranks.run(cell.chips, [sys.executable, "-m", "kpt_bench.run", *argv], ranks.limit_s(args.seconds),
                     join_group, body, report, cwd=str(ROOT))


def join_group(rank: int) -> None:
    """Join the run's process group through the program's launch contract
    (parallel/multihost.py), on the rank's card."""
    from kylespathtracer_tpu_torch.parallel import mesh, multihost

    if not multihost.initialize_from_env(device=mesh.local_device(rank)):
        raise SystemExit("kpt_bench: the ranks' environment does not name a process group")


if __name__ == "__main__":
    sys.exit(main())
