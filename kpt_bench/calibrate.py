"""The readings that the limits of `correct` are set from, on the card.

    python3 -m kpt_bench.calibrate --workload <cell> --seeds <n>... [--control <n>...]
        [--seconds S] [--out FILE]

In one process, to pay the set-up's fixed costs once: for each seed of
`--seeds`, the cell's set-up and a window of `--seconds` (none by default)
through the program, then its check (the program's readings, the lower end
of each limit); for each seed of `--control`, the same numbers with the
control in the program's place (the plain reference in bfloat16, the upper
end), and for a training cell the faults that the reference can stand in
for, as the loop's `faults()` names them. A state left unchanged reads 1 by
the training measure and needs no run. A cell on n > 1 cards runs as its
benchmark runs, as n ranks (kpt_bench/ranks.py), and rank 0 writes. One
JSON line per reading, on stdout and appended to FILE. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from kpt_bench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"kpt_bench.calibrate: needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2

    def body(rank: int) -> int:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)

        def emit(rec):
            if rank:
                return
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")

        for seed in args.seeds + [s for s in args.control if s not in args.seeds]:
            t0 = time.time()
            kind = harness.kind_class(cell.traffic["kind"])(cell, seed, device)
            setup = time.time() - t0
            kind.window(args.seconds, 0)
            if seed in args.seeds:
                keep = list(kind.kept) if hasattr(kind, "kept") else None
                checks = kind.check()
                emit({"cell": args.workload, "seed": seed, "side": "program", "setup_s": setup,
                      **{c.name: c.value for c in checks}})
                if keep is not None:
                    kind.kept = keep
            if seed in args.control:
                for side, nums in kind.faults().items():
                    emit({"cell": args.workload, "seed": seed, "side": side, **nums})
            del kind
            torch.cuda.empty_cache()
        return 0

    if cell.chips == 1:
        return body(0)
    from kpt_bench import ranks
    from kpt_bench.run import join_group

    seeds = len(set(args.seeds + args.control))
    return ranks.run(cell.chips, [sys.executable, "-m", "kpt_bench.calibrate", *(argv or sys.argv[1:])],
                     ranks.limit_s(args.seconds) + ranks.START_S * seeds, join_group, body, lambda code: code,
                     cwd=str(harness.ROOT))


if __name__ == "__main__":
    sys.exit(main())
